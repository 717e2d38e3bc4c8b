"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention block.
[arXiv:2411.15242; unverified]

Structure: 81 Mamba2 layers; ONE weight-shared attention+MLP block applied
after every 6 Mamba layers (13 applications; 3 trailing Mamba layers).
Sub-quadratic: runs the long_500k shape."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000, ssm_state=64, attn_interval=6,
    notes="Mamba2 + shared attn; d_head=112 (=3584/32).",
)
