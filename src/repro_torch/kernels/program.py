"""Weight-stationary crossbar programs, and the fused kernel's launch geometry.

In the Pointer accelerator, MLP weights are programmed into the ReRAM
crossbars once and stay resident while activations stream through. The
port keeps the JAX package's program layout bit for bit: every layer of one
MLP is quantized and offset-binary plane-encoded exactly once, padded to a
uniform ``d_pad`` edge (a multiple of 128), and the stacked tensors live as
buffers of a :class:`CrossbarProgram` module, so ``.to(device)`` moves the
programmed crossbars to the card.

Launch geometry (replaces the JAX package's 16 MB VMEM planner). The TPU
kernel kept the whole ``(M, d_pad)`` activation panel in VMEM and picked
one of four dataflows to fit it. On Hopper a block has at most 227 KB of
shared memory, so no panel fits on chip; the kernel
(``csrc/fused_mlp.cu``) instead runs one launch per layer over
``BLOCK_M x BLOCK_N`` output tiles, stepping K in ``BLOCK_K``-byte slabs
staged in shared memory, with the activation panel in device memory (and
mostly in the 50 MB L2). The only choice left per layer is how far K and N
need to run: ``k_lim``/``n_lim`` stop at the real widths rounded up to the
tile edges, because every column beyond a layer's real width is zero on
input and masked on output — skipping it drops only zero terms.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from .ref import combine_planes

__all__ = [
    "BLOCK_K", "BLOCK_M", "BLOCK_N", "CROSSBAR", "CrossbarProgram",
    "LaunchGeometry", "build_program", "encode_planes", "plan_launch",
    "quantize_tensor",
]

#: Crossbar edge — every program dimension is padded to this (the JAX
#: package's layout, kept so programs are bitwise comparable).
CROSSBAR = 128

#: Output tile of one block of the fused-MLP kernel, and its K slab (bytes).
BLOCK_M, BLOCK_N, BLOCK_K = 64, 64, 32


def _scale(absmax: torch.Tensor, qmax: float) -> torch.Tensor:
    """``max(absmax / qmax, 1e-12)`` in float32, as the JAX package
    computes it (true division, then the floor). The divisor is a tensor
    on ``absmax``'s device: PyTorch's CUDA division by a Python scalar
    multiplies by the scalar's reciprocal instead, which is off by an ulp
    for some values."""
    return torch.clamp_min(absmax / torch.full_like(absmax, qmax), 1e-12)


def _quantize(x: torch.Tensor, scale: torch.Tensor,
              qmax: float) -> torch.Tensor:
    """``clip(round(x / scale), ±qmax)`` as int32: true division and
    round-half-to-even, like ``jnp.round``."""
    return torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int32)


def quantize_tensor(x: torch.Tensor, bits: int = 8):
    """Symmetric per-tensor quantization -> (int32 values, float32 scale).

    NaN/Inf inputs are rejected: a single NaN poisons the ``max(|x|)``
    scale and silently zeroes the whole tensor."""
    x = torch.as_tensor(x)
    if not bool(torch.isfinite(x).all()):
        raise ValueError("quantize_tensor: input contains NaN/Inf — a "
                         "non-finite value poisons the quantization scale")
    qmax = float(2 ** (bits - 1) - 1)
    scale = _scale(x.abs().amax(), qmax)
    return _quantize(x, scale, qmax), scale


def encode_planes(w_int: torch.Tensor, weight_bits: int = 8,
                  cell_bits: int = 2) -> torch.Tensor:
    """Signed int weights -> (P, K, N) int8 offset-binary cell planes."""
    u = w_int.to(torch.int64) + (1 << (weight_bits - 1))
    n_planes = -(-weight_bits // cell_bits)
    mask = (1 << cell_bits) - 1
    return torch.stack([((u >> (cell_bits * p)) & mask).to(torch.int8)
                        for p in range(n_planes)])


def _ceil_to(v: int, m: int) -> int:
    return -(-v // m) * m


class CrossbarProgram(nn.Module):
    """One MLP, programmed. All layers padded to a uniform ``d_pad`` edge.

    planes  : (L, P, d_pad, d_pad) int8 offset-binary 2-bit cell planes
    bias    : (L, d_pad) float32, zero beyond each layer's real width
    w_scale : (L, 1) float32 per-layer weight quantization scale
    col_mask: (L, d_pad) float32, 1.0 on each layer's real output columns
    widths  : (d0, ..., dL) — the original float MLP widths
    """

    def __init__(self, planes, bias, w_scale, col_mask,
                 widths: Sequence[int], weight_bits: int = 8,
                 cell_bits: int = 2):
        super().__init__()
        self.register_buffer("planes", planes)
        self.register_buffer("bias", bias)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("col_mask", col_mask)
        self.widths = tuple(int(w) for w in widths)
        self.weight_bits = weight_bits
        self.cell_bits = cell_bits

    @property
    def n_layers(self) -> int:
        return len(self.widths) - 1

    @property
    def n_planes(self) -> int:
        return -(-self.weight_bits // self.cell_bits)

    @property
    def d_pad(self) -> int:
        return self.planes.shape[-1]

    def int_weights(self) -> list[torch.Tensor]:
        """Per-layer signed int32 weights recombined from the cell planes
        (exact inverse of the encode step, real shapes restored)."""
        return [combine_planes(self.planes[l], self.cell_bits,
                               self.weight_bits)[:k, :n]
                for l, (k, n) in enumerate(zip(self.widths[:-1],
                                               self.widths[1:]))]

    def weights(self) -> list[torch.Tensor]:
        """Per-layer dequantized float32 weights."""
        return [w.to(torch.float32) * self.w_scale[l, 0]
                for l, w in enumerate(self.int_weights())]

    def biases(self) -> list[torch.Tensor]:
        return [self.bias[l, :n] for l, n in enumerate(self.widths[1:])]


def build_program(layers: Sequence, *, weight_bits: int = 8,
                  cell_bits: int = 2) -> CrossbarProgram:
    """Program an MLP into crossbars: quantize + plane-encode every layer
    exactly once, pad to the 128x128 geometry, stack into one module (on
    the device the weights lie on).

    ``layers``: sequence of ``{"w": (k, n), "b": (n,)}`` dicts or
    ``(w, b)`` tuples."""
    wbs = []
    for lyr in layers:
        w, b = (lyr["w"], lyr["b"]) if isinstance(lyr, dict) else lyr
        wbs.append((torch.as_tensor(w, dtype=torch.float32),
                    torch.as_tensor(b, dtype=torch.float32)))
    widths = [wbs[0][0].shape[0]]
    for w, b in wbs:
        if w.shape[0] != widths[-1]:
            raise ValueError(f"MLP widths do not chain: {tuple(w.shape)} "
                             f"after {widths}")
        if tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"bias {tuple(b.shape)} does not match weight "
                             f"{tuple(w.shape)}")
        widths.append(w.shape[1])
    d = _ceil_to(max(widths), CROSSBAR)
    dev = wbs[0][0].device

    n_planes = -(-weight_bits // cell_bits)
    planes = torch.zeros((len(wbs), n_planes, d, d), dtype=torch.int8,
                         device=dev)
    bias = torch.zeros((len(wbs), d), dtype=torch.float32, device=dev)
    mask = torch.zeros((len(wbs), d), dtype=torch.float32, device=dev)
    scale = []
    for l, (w, b) in enumerate(wbs):
        w_int, sw = quantize_tensor(w, bits=weight_bits)
        k, n = w.shape
        planes[l, :, :k, :n] = encode_planes(w_int, weight_bits, cell_bits)
        bias[l, :n] = b
        mask[l, :n] = 1.0
        scale.append(sw)
    return CrossbarProgram(planes, bias,
                           torch.stack(scale).reshape(-1, 1), mask,
                           widths, weight_bits=weight_bits,
                           cell_bits=cell_bits)


@dataclass(frozen=True)
class LaunchGeometry:
    """Per-layer extent of the fused-MLP launches for ``m_real`` rows:
    ``m_pad`` rows (a multiple of ``BLOCK_M``), and for layer l the K
    extent ``k_lims[l]`` (real input width rounded up to ``BLOCK_K``) and
    N extent ``n_lims[l]`` (real output width rounded up to ``BLOCK_N``).
    Layer l's grid is ``(n_lims[l] / BLOCK_N, m_pad / BLOCK_M, B)``."""

    m_pad: int
    k_lims: tuple[int, ...]
    n_lims: tuple[int, ...]


def plan_launch(program: CrossbarProgram, m_rows: int) -> LaunchGeometry:
    """The fused kernel's launch geometry for ``m_rows`` activation rows."""
    w = program.widths
    return LaunchGeometry(
        m_pad=_ceil_to(max(int(m_rows), 1), BLOCK_M),
        k_lims=tuple(min(_ceil_to(k, BLOCK_K), program.d_pad)
                     for k in w[:-1]),
        n_lims=tuple(min(_ceil_to(n, BLOCK_N), program.d_pad)
                     for n in w[1:]))
