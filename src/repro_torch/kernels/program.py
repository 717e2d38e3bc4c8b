"""Weight-stationary crossbar programs, and the fused kernel's launch geometry.

In the Pointer accelerator, MLP weights are programmed into the ReRAM
crossbars once and stay resident while activations stream through. The
port keeps the JAX package's program layout bit for bit: every layer of one
MLP is quantized and offset-binary plane-encoded exactly once, padded to a
uniform ``d_pad`` edge (a multiple of 128), and the stacked tensors live as
buffers of a :class:`CrossbarProgram` module, so ``.to(device)`` moves the
programmed crossbars to the card.

Dataflow choice. The JAX package picks one of four dataflows per MLP and
row count (:data:`FUSED_MODES`) by a 16 MB VMEM budget;
:func:`plan_fused_mlp` here is a copy of that arithmetic
(``repro/kernels/program.py:283-459``, without ``policy=``), so the same
MLP runs the same dataflow in both packages. The modes map to kernels:
'whole' and 'tiled' to K1 (``csrc/fused_mlp.cu``), 'mtiled' to K2
(``csrc/fused_mlp_mtiled.cu``), 'wstat' to K3 (``csrc/fused_mlp_wstat.cu``).
The TPU's tile edges (``block_n``/``block_k``) only steer that choice; they
are not taken as arguments and do not shape the Hopper launches.

Launch geometry. On Hopper a block has at most 227 KB of shared memory, so
no panel fits on chip; the kernels run one launch per layer, because the
next layer's scale is a max over the whole grid. Per layer, K and N run
only as far as they need to: ``k_lim``/``n_lim`` stop at the real widths
rounded up to ``BLOCK_K``/``BLOCK_N``, because every column beyond a
layer's real width is zero on input and masked on output — skipping it
drops only zero terms. Every mode shares ``m_pad`` (rows rounded up to
``BLOCK_M``, the stripe of one block) and ``k_lims``/``n_lims``.

The crossbar kernels (K1, K2, K3 and K6) multiply on the tensor cores
(``csrc/crossbar_mma.cuh``) with s8 weights that a pre-pass combines from
the planes once per call (``combine_weights`` in ``csrc/fused_mlp.cu``:
once per MLP call for K1, K2 and K3). K1 and K2: a block owns ``BLOCK_M``
rows as an int8 stripe in shared memory and computes ``MMA_BLOCK_N``-column
chunks, streaming ``MMA_BLOCK_K``-byte slabs of s8 weights through a ring
of ``MMA_STAGES`` slabs. A chunk that passes ``n_lim`` masks the columns
beyond it. K1's grid is ``(ceil(n_lim / MMA_BLOCK_N), m_pad / BLOCK_M, B)``
per layer, its stripe one layer's ``k_lim`` wide up to ``MMA_STRIPE_K``
bytes; a wider layer runs K in ranges of ``MMA_STRIPE_K``, so K1 takes any
width. K2's grid is ``(m_pad / BLOCK_M, B)``: launch j recomputes layers
``0 .. j-1`` of its stripe from the int8 input into two int8 stripes of the
widest ``k_lim`` (scales from the maxima earlier launches published), so no
intermediate panel leaves the chip. Where two such stripes do not fit in
``MAX_SMEM_BYTES`` (the widest ``k_lim`` above 1536), 'mtiled' runs K1's
launches instead (:func:`mtiled_on_chip`). K1 and K2 take any number of
layers. K3 swaps the operands' roles: a block holds one chunk of s8
weights, all of the layer's ``k_lim``, in shared memory and streams its
share of the rows through a ring of ``WSTAT_STAGES`` activation slabs of
``WSTAT_BLOCK_K`` bytes; its grid is ``(ceil(n_lim / cols), row_groups)``
(:func:`wstat_chunk`, :func:`wstat_row_groups`). The chunk is
``WSTAT_BLOCK_N`` columns wide, narrowed to 64 or 32 where the weights do
not fit, and past that runs K in ranges of ``MMA_STRIPE_K``, so K3 takes
any width too. :class:`LaunchGeometry`'s ``smem_bytes`` is each launch's
dynamic shared memory.

K6, the per-layer crossbar matmul, has no program: :func:`plan_reram`
splits its K over blocks where its row tiles and column chunks alone would
leave the SMs idle, or K is wider than one stripe.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from .ref import combine_planes

__all__ = [
    "BLOCK_K", "BLOCK_M", "BLOCK_N", "CROSSBAR", "CrossbarProgram",
    "FUSED_MODES", "FusedPlan", "LaunchGeometry", "MAX_SMEM_BYTES",
    "MMA_BLOCK_K", "MMA_BLOCK_N", "MMA_STAGES", "MMA_STRIPE_K",
    "ReramSplit", "SM_SMEM_BYTES", "VMEM_BUDGET_BYTES", "WSTAT_BLOCK_K",
    "WSTAT_BLOCK_N", "WSTAT_STAGES",
    "build_program", "encode_planes", "fused_vmem_bytes", "mtiled_on_chip",
    "plan_fused_mlp", "plan_launch", "plan_reram", "quantize_tensor",
    "require_finite", "wstat_chunk", "wstat_row_groups",
]

#: Crossbar edge — every program dimension is padded to this (the JAX
#: package's layout, kept so programs are bitwise comparable).
CROSSBAR = 128

#: Rows of one block (every kernel), and the edges the fused MLP's layer
#: extents are rounded up to: ``n_lims`` to ``BLOCK_N``, ``k_lims`` to
#: ``BLOCK_K`` (bytes).
BLOCK_M, BLOCK_N, BLOCK_K = 64, 64, 32

#: K1's, K2's and K6's output chunk, weight slab (bytes), slabs in flight,
#: and the widest K range of a stripe (``csrc/crossbar_mma.cuh``).
MMA_BLOCK_N, MMA_BLOCK_K, MMA_STAGES, MMA_STRIPE_K = 128, 64, 3, 2048

#: K3's widest output chunk, activation slab (bytes) and activation slabs
#: in flight (``csrc/fused_mlp_wstat.cu``).
WSTAT_BLOCK_N, WSTAT_BLOCK_K, WSTAT_STAGES = 128, 64, 4

#: Dynamic shared memory a block may take on Hopper: the 227 KB a block may
#: opt in to, less 1 KB kept for static shared memory.
MAX_SMEM_BYTES = 232448 - 1024

#: Shared memory of one SM (228 KB), which its resident blocks share, each
#: with 1 KB reserved beside its own.
SM_SMEM_BYTES = 233472

#: The TPU's per-core VMEM budget that the JAX package's dataflow choice is
#: made against; kept so that both packages choose alike.
VMEM_BUDGET_BYTES = 16 * 2 ** 20

#: The four fused-MLP dataflows of the JAX package, in its order. Kernels:
#: 'whole'/'tiled' -> K1, 'mtiled' -> K2, 'wstat' -> K3.
FUSED_MODES = ("whole", "tiled", "mtiled", "wstat")

#: The TPU's activation stripe height, which the VMEM accounting assumes.
_TPU_BLOCK_M = CROSSBAR


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


def require_finite(x: torch.Tensor) -> None:
    """Raise ``ValueError`` if ``x`` holds a NaN or an Inf (a host sync on
    a CUDA tensor): a single NaN poisons the ``max(|x|)`` quantization
    scale and silently zeroes the whole tensor. A call being captured into
    a CUDA graph cannot read its values back, so there the check is
    skipped, as the reference's cannot raise on a traced value under
    jit."""
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    if not bool(torch.isfinite(x).all()):
        raise ValueError("quantize_tensor: input contains NaN/Inf — a "
                         "non-finite value poisons the quantization scale")


def quantize_tensor(x: torch.Tensor, bits: int = 8, *,
                    check_finite: bool = True):
    """Symmetric per-tensor quantization -> (int32 values, float32 scale).

    NaN/Inf inputs are rejected (:func:`require_finite`). A caller that
    has checked ``x`` already, as the 'reram' backend checks its weights
    once when it is built, passes ``check_finite=False`` and saves the
    host sync."""
    x = torch.as_tensor(x)
    if check_finite:
        require_finite(x)
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
    """Per-layer extent of the fused-MLP launches for ``m_real`` rows under
    dataflow ``mode``: ``m_pad`` rows (a multiple of ``BLOCK_M``, the same
    in every mode), and for layer l the K extent ``k_lims[l]`` (real input
    width rounded up to ``BLOCK_K``), the N extent ``n_lims[l]`` (real
    output width rounded up to ``BLOCK_N``) and the dynamic shared memory
    of one block in launch l, ``smem_bytes[l]``. Launch l's grid is
    ``(ceil(n_lims[l] / MMA_BLOCK_N), m_pad / BLOCK_M, B)`` for K1,
    ``(m_pad / BLOCK_M, B)`` for K2 (a block recomputes layers ``0 .. l-1``
    of its stripe and walks every N-chunk of layer l) and
    ``(ceil(n_lims[l] / cols), row_groups)`` for K3 (``cols`` from
    :func:`wstat_chunk`, ``row_groups`` from :func:`wstat_row_groups`)."""

    m_pad: int
    k_lims: tuple[int, ...]
    n_lims: tuple[int, ...]
    mode: str = "whole"
    smem_bytes: tuple[int, ...] = ()


def _stripe_bytes(k_lim: int) -> int:
    """One ``BLOCK_M``-row int8 stripe of K1/K2 at ``k_lim`` bytes a row
    (row pitch ``k_lim + 16``)."""
    return BLOCK_M * (k_lim + 16)


def wstat_chunk(k_lim: int) -> tuple[int, int]:
    """K3's chunk at input extent ``k_lim``: ``(columns, resident K
    bytes)``. The widest of ``WSTAT_BLOCK_N``, 64 and 32 columns whose
    ``k_lim``-deep s8 weights (row pitch ``k_lim + 16``) fit in
    ``MAX_SMEM_BYTES`` beside the activation ring; past that 64 columns
    with K in ranges of ``MMA_STRIPE_K`` bytes, each range's weights
    reloaded for every row tile."""
    ring = WSTAT_STAGES * BLOCK_M * (WSTAT_BLOCK_K + 16)
    cols = WSTAT_BLOCK_N
    while cols >= 32:
        if cols * (k_lim + 16) + ring <= MAX_SMEM_BYTES:
            return cols, k_lim
        cols //= 2
    return 64, MMA_STRIPE_K


def _smem_bytes(mode: str, k_lim: int) -> int:
    """Dynamic shared memory of one block (``csrc/*_smem``): K1 one input
    stripe of ``k_lim`` bytes a row (at most ``MMA_STRIPE_K``) and the
    weight ring; K2 two stripes of the widest ``k_lim`` and the ring; K3 a
    chunk of s8 weights (:func:`wstat_chunk`, row pitch its resident K plus
    16) and its ring of activation slabs."""
    if mode == "wstat":
        cols, kr = wstat_chunk(k_lim)
        return (cols * (kr + 16)
                + WSTAT_STAGES * BLOCK_M * (WSTAT_BLOCK_K + 16))
    ring = MMA_STAGES * MMA_BLOCK_N * (MMA_BLOCK_K + 16)
    if mode == "mtiled":
        return 2 * _stripe_bytes(k_lim) + ring
    return _stripe_bytes(min(k_lim, MMA_STRIPE_K)) + ring


def mtiled_on_chip(geom: LaunchGeometry) -> bool:
    """Whether K2's two stripes of the widest ``k_lim`` fit in a block's
    shared memory (the widest ``k_lim`` at most 1536); where they do not,
    'mtiled' runs K1's launches, which compute the same function."""
    return max(geom.smem_bytes) <= MAX_SMEM_BYTES


def plan_launch(program: CrossbarProgram, m_rows: int,
                mode: str = "whole") -> LaunchGeometry:
    """The launch geometry of dataflow ``mode`` for ``m_rows`` rows."""
    if mode not in FUSED_MODES:
        raise ValueError(f"mode={mode!r} must be one of {FUSED_MODES}")
    return _plan_launch(program.widths, program.d_pad,
                        max(int(m_rows), 1), mode)


@functools.lru_cache(maxsize=256)
def _plan_launch(w: tuple, d_pad: int, m_rows: int,
                 mode: str) -> LaunchGeometry:
    k_lims = tuple(min(_ceil_to(k, BLOCK_K), d_pad) for k in w[:-1])
    # K2's stripes hold the widest input of any layer in every launch
    smem_k = (max(k_lims),) * len(k_lims) if mode == "mtiled" else k_lims
    return LaunchGeometry(
        m_pad=_ceil_to(m_rows, BLOCK_M),
        k_lims=k_lims,
        n_lims=tuple(min(_ceil_to(n, BLOCK_N), d_pad) for n in w[1:]),
        mode=mode,
        smem_bytes=tuple(_smem_bytes(mode, k) for k in smem_k))


#: Blocks of K3 per SM that its grid aims at: its kernel is built for two
#: (``__launch_bounds__(256, 2)``: at most 128 registers a thread).
WSTAT_BLOCKS_PER_SM = 2


def wstat_blocks_per_sm(smem_bytes: int) -> int:
    """K3's resident blocks per SM at ``smem_bytes`` of dynamic shared
    memory: :data:`WSTAT_BLOCKS_PER_SM`, or fewer where the SM's shared
    memory holds fewer (one at model2's head, k_lim 1024)."""
    return max(1, min(WSTAT_BLOCKS_PER_SM,
                      SM_SMEM_BYTES // (smem_bytes + 1024)))


def wstat_row_groups(n_chunks: int, row_tiles: int, sms: int,
                     smem_bytes: int) -> int:
    """K3's second grid dimension: enough row groups that the ``n_chunks x
    row_groups`` blocks fill every resident slot of the ``sms`` SMs once
    (:func:`wstat_blocks_per_sm` at the launch's ``smem_bytes``), and no
    more groups than row tiles. Each block loads its chunk of weights once
    and streams ``row_tiles / row_groups`` row tiles."""
    slots = wstat_blocks_per_sm(smem_bytes) * sms
    return max(1, min(row_tiles, -(-slots // max(n_chunks, 1))))


@dataclass(frozen=True)
class ReramSplit:
    """How K6 (``csrc/reram_mlp.cu``) covers one ``(m, k) x (k, n)``
    product: blocks of ``BLOCK_M`` rows, ``MMA_BLOCK_N`` columns and one K
    range of ``k_step`` bytes, over the s8 weights' row pitch ``k_pad`` (K
    rounded up to 16; zeros beyond K). More than one K range (``split``)
    makes the blocks add their partial sums into the zeroed output."""

    m: int
    k: int
    n: int
    k_pad: int
    k_step: int

    @property
    def split(self) -> int:
        return -(-self.k_pad // self.k_step)

    def k_ranges(self) -> list[tuple[int, int]]:
        """The real K ranges, one per grid layer, in order."""
        return [(kb, min(self.k, kb + self.k_step))
                for kb in range(0, self.k_pad, self.k_step)]

    def n_ranges(self) -> list[tuple[int, int]]:
        """The column chunks, one per grid column, in order."""
        return [(n0, min(self.n, n0 + MMA_BLOCK_N))
                for n0 in range(0, self.n, MMA_BLOCK_N)]


def plan_reram(m: int, k: int, n: int, sms: int) -> ReramSplit:
    """K6's split of K: where the ``ceil(n / MMA_BLOCK_N) x ceil(m /
    BLOCK_M)`` blocks fill at most half of the ``sms`` SMs (the head's 8
    or 1 rows), K splits into up to ``sms // blocks`` ranges of whole
    ``MMA_BLOCK_K`` slabs, at most one range a slab, so that one wave of
    blocks covers the card; a range never exceeds ``MMA_STRIPE_K``, so any
    K runs."""
    k_pad = _ceil_to(max(k, 1), 16)
    slabs = -(-k_pad // MMA_BLOCK_K)
    blocks = -(-n // MMA_BLOCK_N) * -(-m // BLOCK_M)
    want = max(1, sms // max(blocks, 1))
    per = -(-slabs // min(slabs, want))
    per = min(per, MMA_STRIPE_K // MMA_BLOCK_K)
    return ReramSplit(m=m, k=k, n=n, k_pad=k_pad, k_step=per * MMA_BLOCK_K)


# ---------------------------------------------------------------------------
# the dataflow choice: a copy of the JAX package's VMEM accounting
# ---------------------------------------------------------------------------

def fused_vmem_bytes(d_pad: int, n_planes: int, m_pad: int, block_m: int,
                     block_n: int, mode: str = "tiled") -> int:
    """Per-grid-step VMEM residency of the TPU kernel at tile edge
    ``block_n`` under dataflow ``mode``: double-buffered operand blocks
    plus persistent scratch (the JAX package's formula, unchanged)."""
    if mode not in FUSED_MODES:
        raise ValueError(f"mode={mode!r} must be one of {FUSED_MODES}")
    if mode == "mtiled":
        blocks = (n_planes * d_pad * block_n     # int8 plane tile
                  + block_m * d_pad              # int8 input stripe
                  + 2 * 4 * block_n)             # f32 bias + col-mask tiles
        scratch = (4 * block_m * d_pad           # f32 staged stripe
                   + 4 * block_m * d_pad         # int32 stripe snapshot
                   + 4 * block_m)                # int32 stripe row sums
        return 2 * blocks + scratch
    blocks = (n_planes * d_pad * block_n         # int8 plane tile
              + block_m * d_pad                  # int8 input stripe
              + 4 * block_m * block_n            # f32 output tile
              + 2 * 4 * block_n)                 # f32 bias + col-mask tiles
    if mode == "wstat":
        scratch = (4 * m_pad * d_pad             # f32 activation panel
                   + m_pad * d_pad               # int8 snapshot panel
                   + 4 * m_pad)                  # int32 panel row sums
    else:                                        # whole / tiled
        scratch = (4 * m_pad * d_pad             # f32 activation panel
                   + 4 * block_m * d_pad         # int32 stripe snapshot
                   + 4 * block_m)                # int32 stripe row sums
    return 2 * blocks + scratch


def _edge_candidates(mode: str, d: int) -> range:
    """TPU tile edges a mode may take, largest first."""
    if mode == "whole":
        return range(d, d + 1)
    if mode == "mtiled":
        return range(d, 0, -CROSSBAR)
    return range(d - CROSSBAR, 0, -CROSSBAR)


@dataclass(frozen=True)
class FusedPlan:
    """The dataflow chosen for one MLP at one row count: ``mode`` (one of
    :data:`FUSED_MODES`), and the TPU tile edge and VMEM residency the
    choice rests on (``tpu_block_n``, ``vmem_bytes``, against ``budget``,
    for ``d_pad`` and the TPU's ``m_pad`` rows of ``n_planes`` planes).
    ``fits_budget`` is False only when nothing fits and 'mtiled' is the
    fallback. The ``*_per_layer`` properties are the JAX package's HBM
    accounting of that TPU dataflow (what its ``stats()`` reports), not
    Hopper quantities: the Hopper kernels tile by their own edges."""

    mode: str
    tpu_block_n: int
    vmem_bytes: int
    budget: int
    d_pad: int
    m_pad: int
    n_planes: int

    @property
    def fits_budget(self) -> bool:
        return self.vmem_bytes <= self.budget

    @property
    def plane_tile_fetches_per_layer(self) -> int:
        """``(P, d_pad, tpu_block_n)`` plane tiles crossing HBM to VMEM per
        layer and batch element: once per N-tile for 'wstat', once for
        'whole' or a single N-tile, else once per M-stripe and N-tile."""
        n_steps = self.d_pad // self.tpu_block_n
        if self.mode == "wstat":
            return n_steps
        if self.mode == "whole" or n_steps == 1:
            return 1
        return (self.m_pad // _TPU_BLOCK_M) * n_steps

    @property
    def plane_hbm_bytes_per_layer(self) -> int:
        return (self.plane_tile_fetches_per_layer * self.n_planes
                * self.d_pad * self.tpu_block_n)

    @property
    def act_hbm_bytes_per_layer(self) -> int:
        """The float32 activation stripe read and written once per layer
        by 'mtiled'; zero for the dataflows whose panel stays in VMEM."""
        return 8 * self.m_pad * self.d_pad if self.mode == "mtiled" else 0


def plan_fused_mlp(program: CrossbarProgram, m_rows: int, *,
                   mode: str | None = None) -> FusedPlan:
    """Choose the dataflow for ``m_rows`` activation rows as the JAX
    package's ``plan_fused_mlp`` does with its defaults: the first of
    whole -> wstat -> tiled -> mtiled that fits the VMEM budget at some tile
    edge, or 'mtiled' with ``fits_budget`` False when none does. ``mode``
    pins the dataflow instead."""
    d, p = program.d_pad, program.n_planes
    if mode is not None and mode not in FUSED_MODES:
        raise ValueError(f"mode={mode!r} must be one of {FUSED_MODES}")
    m_pad = _ceil_to(max(int(m_rows), 1), _TPU_BLOCK_M)

    def bytes_at(md: str, bn: int) -> int:
        return fused_vmem_bytes(d, p, m_pad, _TPU_BLOCK_M, bn, mode=md)

    def largest_fitting_edge(md: str) -> int | None:
        for cand in _edge_candidates(md, d):
            if d % cand == 0 and bytes_at(md, cand) <= VMEM_BUDGET_BYTES:
                return cand
        return None

    if mode is not None:
        bn = d if mode == "whole" else largest_fitting_edge(mode) or CROSSBAR
    else:
        mode, bn = "mtiled", CROSSBAR
        for cand in ("whole", "wstat", "tiled", "mtiled"):
            found = largest_fitting_edge(cand)
            if found is not None:
                mode, bn = cand, found
                break
    return FusedPlan(mode=mode, tpu_block_n=bn, vmem_bytes=bytes_at(mode, bn),
                     budget=VMEM_BUDGET_BYTES, d_pad=d, m_pad=m_pad,
                     n_planes=p)
