from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                         clip_by_global_norm, global_norm, sgd)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup_cosine

__all__ = ["Optimizer", "adamw", "apply_updates", "clip_by_global_norm",
           "cosine_schedule", "global_norm", "linear_warmup_cosine", "sgd"]
