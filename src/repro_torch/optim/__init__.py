"""The optimizer of the port: AdamW, its warmup-cosine schedule and
global-norm clipping (``optimizer``), over the model's parameter trees,
and int8 error-feedback gradient compression (``compression``)."""
from .compression import (CompressionState, compress_error_feedback,
                          int8_dequantize, int8_quantize)
from .optimizer import (AdamWConfig, adamw_init, adamw_update,
                        clip_by_global_norm, global_norm, tree_leaves,
                        tree_map, warmup_cosine)

__all__ = ["AdamWConfig", "CompressionState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "compress_error_feedback", "global_norm",
           "int8_dequantize", "int8_quantize", "tree_leaves", "tree_map",
           "warmup_cosine"]
