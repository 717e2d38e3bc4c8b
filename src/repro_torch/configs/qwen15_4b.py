"""qwen1.5-4b [dense] — 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936, QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]

20 heads are not divisible by TP=16; the launch layer zero-pads query
heads to 32 at apply time (outputs unchanged — DESIGN.md §4)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab_size=151936, qkv_bias=True, rope_theta=1e6,
    notes="QKV bias; heads padded 20->32 under TP=16.",
)
