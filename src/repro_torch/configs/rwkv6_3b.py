"""rwkv6-3b [ssm] — 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536 — Finch, data-dependent decay. [arXiv:2404.05892; hf]

Attention-free: time-mix (data-dependent per-channel decay, head_size 64)
+ channel-mix. Sub-quadratic: runs the long_500k shape. 40 heads
(2560/64) padded to 48 under TP=16."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_head=64,
    d_ff=8960, vocab_size=65536, head_size=64,
    notes="attention-free; heads = d_model/head_size = 40.",
)
