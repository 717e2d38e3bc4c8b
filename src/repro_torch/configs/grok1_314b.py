"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]

The largest assigned arch (~314B params); its optimizer moments are kept
in bf16 (opt_moment_dtype)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab_size=131072, rope_theta=1e4,
    n_experts=8, experts_per_token=2,
    opt_moment_dtype="bfloat16",
    notes="MoE 8e top-2; bf16 Adam moments to fit one pod.",
)
