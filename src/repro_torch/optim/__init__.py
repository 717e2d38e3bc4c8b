"""The optimizer of the port: AdamW, its warmup-cosine schedule and
global-norm clipping (``optimizer``), over the model's parameter trees."""
from .optimizer import (AdamWConfig, adamw_init, adamw_update,
                        clip_by_global_norm, tree_leaves, tree_map,
                        warmup_cosine)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "tree_leaves", "tree_map",
           "warmup_cosine"]
