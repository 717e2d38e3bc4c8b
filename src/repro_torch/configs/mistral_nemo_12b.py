"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_head=128, d_ff=14336, vocab_size=131072, rope_theta=1e6,
    notes="GQA kv=8 (replicated to 16 under TP=16); d_head=128 (not "
          "d_model/n_heads=160 — Nemo uses head_dim 128).",
)
