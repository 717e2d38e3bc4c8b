"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

40 heads padded to 48 under TP=16; MoE uses sort-based dispatch
(the paper's intra-layer reordering analogue — DESIGN.md §5)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048, rope_theta=5e5,
    n_experts=16, experts_per_token=1,
    notes="MoE 16e top-1; heads padded 40->48 under TP=16.",
)
