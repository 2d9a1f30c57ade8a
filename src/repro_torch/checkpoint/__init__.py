from .checkpoint import (latest_step, load_checkpoint, prune_checkpoints,
                         restore, save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step", "restore",
           "prune_checkpoints"]
