from .adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                    warmup_cosine)
from .compression import (CompressionState, compress_error_feedback,
                          dequantize_int8, quantize_int8)

__all__ = ["AdamWConfig", "CompressionState", "adamw_init", "adamw_update",
           "compress_error_feedback", "dequantize_int8", "global_norm",
           "quantize_int8", "warmup_cosine"]
