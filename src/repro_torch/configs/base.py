"""Architecture configs of the LM stack: the port's copy of the JAX
package's ``configs/base.py``, with no JAX.

``ArchConfig`` captures an exact published architecture; ``reduced()``
derives the family-preserving smoke-test variant (tiny widths, same code
paths). ``SHAPES`` is the assigned input-shape set; ``input_specs`` builds
``meta``-device stand-ins for every model input of a shape (no
allocation), and ``dummy_inputs`` small concrete batches drawn from
``np.random.default_rng(seed)`` in the reference's order, so both packages
get the same numbers.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["ArchConfig", "Shape", "SHAPES", "input_specs", "dummy_inputs"]


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm: str = "rms"            # rms | ln
    mlp_kind: str = "swiglu"     # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25   # dropless serving sets >= n_experts
    # SSM / hybrid / rwkv
    ssm_state: int = 0
    attn_interval: int = 0       # zamba2: shared attn every k mamba layers
    head_size: int = 64          # rwkv
    # VLM
    cross_attn_interval: int = 0
    n_image_tokens: int = 0
    d_image: int = 0
    # execution attributes (not architecture)
    dtype: str = "bfloat16"
    remat: bool = True
    tp: int = 1                  # set by the launch layer
    batch_axes: tuple = ()       # DP mesh axes for activation constraints
    dp_shards: int = 1           # DP device count (local MoE routing)
    q_chunk: int = 512
    kv_chunk: int = 1024
    opt_moment_dtype: str = "float32"   # bf16 for grok-1 (DESIGN.md §4)
    notes: str = ""

    # ---- derived ----
    @property
    def jdtype(self) -> torch.dtype:
        """The parameters' and activations' torch dtype."""
        return getattr(torch, self.dtype)

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(1, self.n_heads))

    def head_layout(self):
        """TP-divisible head layout preserving the GQA q->kv grouping.

        Returns (eff_heads, eff_kv, repeat, slots) where ``slots[i]`` is the
        position of real query head i in the padded layout. Two regimes:
          * MHA (group==1): end-pad q and kv together to ceil(H, tp);
          * GQA with kv < tp: repeat each kv head r=tp/kv times and give
            each ORIGINAL kv head a contiguous band of r*g' q slots
            (g'=ceil(g/r)), so padded-layout group math lands every real
            q head on its original kv head (slot = (i//g)*r*g' + i%g).
        Plain end-padding would silently remap q heads to the wrong kv
        heads. ``models/lm.py`` arranges the attention weights into this
        layout (``_eff_attn_params``); a kv count that divides neither way
        raises ``ValueError``.
        """
        hq, hkv, tp = self.n_heads, self.n_kv_heads, self.tp
        if tp <= 1 or (hq % tp == 0 and hkv % tp == 0):
            return hq, hkv, 1, tuple(range(hq))
        g = hq // hkv
        if g == 1:
            eff = _ceil_to(hq, tp)
            return eff, eff, 1, tuple(range(hq))
        if hkv % tp == 0:
            return hq, hkv, 1, tuple(range(hq))
        if tp % hkv:
            raise ValueError(f"{self.name}: kv={hkv} incompatible with "
                             f"tp={tp}")
        r = tp // hkv
        g2 = -(-g // r)
        eff_kv = tp
        eff_q = tp * g2
        slots = tuple((i // g) * (r * g2) + (i % g) for i in range(hq))
        return eff_q, eff_kv, r, slots

    @property
    def eff_heads(self) -> int:
        return self.head_layout()[0]

    @property
    def eff_kv_heads(self) -> int:
        return self.head_layout()[1]

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("hybrid", "ssm")

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        dh = self.head_dim
        attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
            + self.n_heads * dh * d
        if self.mlp_kind == "swiglu":
            ffn = 3 * d * f
        else:
            ffn = 2 * d * f
        if self.family == "moe":
            ffn = self.n_experts * 3 * d * f + d * self.n_experts
        per_block = attn + ffn
        if self.family == "hybrid":
            d_in = 2 * d
            h = d_in // 64
            mamba = d * (2 * d_in + 2 * self.ssm_state + h) + d_in * d \
                + 4 * (d_in + 2 * self.ssm_state)
            n_attn = 1   # shared
            return v * d * (1 if self.tie_embeddings else 2) \
                + self.n_layers * mamba + n_attn * per_block
        if self.family == "ssm":
            per_block = 6 * d * d + 2 * d * f
        total = self.n_layers * per_block
        if self.family == "vlm":
            g = self.n_layers // self.cross_attn_interval
            cross = d * self.n_heads * dh + 2 * self.d_image \
                * self.n_kv_heads * dh + self.n_heads * dh * d
            total += g * cross + self.d_image * self.d_image
        return total + v * d * (1 if self.tie_embeddings else 2)

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dense_ffn = self.n_experts * 3 * d * f
        active_ffn = self.experts_per_token * 3 * d * f
        return self.n_params() - self.n_layers * (dense_ffn - active_ffn)

    def reduced(self) -> "ArchConfig":
        """Family-preserving tiny variant for CPU smoke tests."""
        r = dict(
            n_layers=min(self.n_layers, 2), d_model=64, n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            d_head=16, d_ff=128, vocab_size=512, dtype="float32",
            remat=False, tp=1, q_chunk=32, kv_chunk=32,
            name=self.name + "-reduced",
        )
        if self.family == "moe":
            r.update(n_experts=4,
                     experts_per_token=min(2, self.experts_per_token),
                     capacity_factor=8.0)   # dropless at smoke scale
        if self.family == "hybrid":
            r.update(n_layers=5, attn_interval=2, ssm_state=16)
        if self.family == "ssm":
            r.update(head_size=16, d_head=0, n_heads=4)
        if self.family == "vlm":
            r.update(n_layers=4, cross_attn_interval=2, n_image_tokens=32,
                     d_image=48)
        return dataclasses.replace(self, **r)


@dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape_name) -> dict:
    """``meta``-device stand-ins (shapes and dtypes, no storage) for every
    model input of a given shape (a name of :data:`SHAPES`, or a
    :class:`Shape`).

    Modality frontends are stubs per the assignment: ``audio`` receives
    precomputed EnCodec frame embeddings, ``vlm`` receives precomputed
    patch/image embeddings.
    """
    shape = (shape_name if isinstance(shape_name, Shape)
             else SHAPES[shape_name])
    b, s = shape.global_batch, shape.seq_len
    out: dict = {}
    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            out["embeds"] = _meta((b, s, cfg.d_model), cfg.jdtype)
        else:
            out["ids"] = _meta((b, s), torch.int32)
        if cfg.family == "vlm":
            out["image_embeds"] = _meta(
                (b, cfg.n_image_tokens, cfg.d_image), cfg.jdtype)
        if shape.kind == "train":
            out["labels"] = _meta((b, s), torch.int32)
        return out
    # decode: one new token against a cache of seq_len
    from repro_torch.models import lm  # local import to avoid cycles
    out = {"cache": lm.init_cache(cfg, b, s, device="meta"),
           "pos": _meta((), torch.int32)}
    if cfg.family == "audio":
        out["embeds1"] = _meta((b, 1, cfg.d_model), cfg.jdtype)
    else:
        out["ids1"] = _meta((b, 1), torch.int32)
    if cfg.family == "vlm":
        out["image_embeds"] = _meta((b, cfg.n_image_tokens, cfg.d_image),
                                    cfg.jdtype)
    return out


def dummy_inputs(cfg: ArchConfig, kind: str, batch: int, seq: int,
                 seed: int = 0, *, device=None) -> dict:
    """Small concrete inputs for smoke tests (mirrors ``input_specs``), on
    ``device`` (the card unless ``device="cpu"``). The draws come from
    ``np.random.default_rng(seed)`` in the reference's order, so the JAX
    package's ``dummy_inputs`` gives the same numbers."""
    from repro_torch.models.backend import resolve_device
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def tensor(a, dtype):
        return torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dtype)

    ids = tensor(rng.integers(0, cfg.vocab_size, (batch, seq)), torch.int32)

    def emb(b, s):
        return tensor(rng.normal(size=(b, s, cfg.d_model)) * 0.3,
                      cfg.jdtype)
    out: dict = {}
    if kind in ("train", "prefill"):
        if cfg.family == "audio":
            out["embeds"] = emb(batch, seq)
        else:
            out["ids"] = ids
        if kind == "train":
            out["labels"] = tensor(
                rng.integers(0, cfg.vocab_size, (batch, seq)), torch.int32)
    elif kind == "decode":
        from repro_torch.models import lm
        out = {"cache": lm.init_cache(cfg, batch, seq, device=dev),
               "pos": torch.tensor(seq - 1, dtype=torch.int32, device=dev)}
        if cfg.family == "audio":
            out["embeds1"] = emb(batch, 1)
        else:
            out["ids1"] = ids[:, :1]
    if cfg.family == "vlm":
        out["image_embeds"] = tensor(
            rng.normal(size=(batch, cfg.n_image_tokens, cfg.d_image)),
            cfg.jdtype)
    return out
