from repro_torch.checkpoint.store import CheckpointStore, load_pytree, save_pytree

__all__ = ["CheckpointStore", "save_pytree", "load_pytree"]
