from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                         clip_by_global_norm, global_norm)

__all__ = ["Optimizer", "adamw", "apply_updates", "clip_by_global_norm",
           "global_norm"]
