"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Backbone only; the vision tower is a stub (input_specs() provides
precomputed patch embeddings (B, 2048, 4096)). Every 5th layer adds
gated cross-attention to the image tokens (8 cross layers in 40)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256, rope_theta=5e5,
    cross_attn_interval=5, n_image_tokens=2048, d_image=4096,
    notes="8 gated cross-attn layers; vision tower stubbed.",
)
