from .adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                    warmup_cosine)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "warmup_cosine"]
