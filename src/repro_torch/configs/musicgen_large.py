"""musicgen-large [audio] — 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

The EnCodec frontend is a stub: input_specs() provides precomputed frame
embeddings (B, S, d_model); the loss head predicts the next frame's
codebook-0 token (vocab 2048). LayerNorm + GELU (GPT-style), per the
MusicGen transformer."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048, norm="ln", mlp_kind="gelu",
    notes="decoder over EnCodec frames; frontend stubbed.",
)
