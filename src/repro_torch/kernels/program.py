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
(``repro/kernels/program.py:283-459``, ``policy=`` and the tile-edge pins
included), so the TPU's choice can be reported beside the port's. The port
launches its own choice, made over the Hopper quantities below:
:meth:`~repro_torch.core.policy.PlanPolicy.select_launch` ranks K1
('whole'; 'tiled' is the same kernel), K2 ('mtiled', ``csrc/
fused_mlp_mtiled.cu``) and K3 ('wstat', ``csrc/fused_mlp_wstat.cu``) by
the time their launches take (:func:`launch_work`).

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

from .record import capturing
from .ref import combine_planes

__all__ = [
    "BLOCK_K", "BLOCK_M", "BLOCK_N", "CROSSBAR", "CrossbarProgram",
    "FUSED_MODES", "FusedPlan", "LaunchGeometry", "LaunchWork",
    "MAX_SMEM_BYTES",
    "MMA_BLOCK_K", "MMA_BLOCK_N", "MMA_STAGES", "MMA_STRIPE_K",
    "ReramSplit", "SM_SMEM_BYTES", "VMEM_BUDGET_BYTES", "WSTAT_BLOCK_K",
    "WSTAT_BLOCK_N", "WSTAT_STAGES",
    "build_program", "combine_bytes", "encode_planes", "fused_vmem_bytes",
    "launch_bytes", "launch_count", "launch_work",
    "mtiled_on_chip", "plan_fused_mlp", "plan_launch", "plan_reram",
    "quantize_tensor", "require_finite", "wstat_chunk", "wstat_row_groups",
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
    skipped (and inside :func:`~.record.as_captured`), as the reference's
    cannot raise on a traced value under jit."""
    if capturing(x):
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
    ecc     : an :class:`~repro_torch.reliability.ecc.EccSpec` when the
              planes carry Hamming parity in their spare columns
              (``build_program(..., ecc=...)``); None for bare programs
    """

    def __init__(self, planes, bias, w_scale, col_mask,
                 widths: Sequence[int], weight_bits: int = 8,
                 cell_bits: int = 2, ecc=None):
        super().__init__()
        self.register_buffer("planes", planes)
        self.register_buffer("bias", bias)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("col_mask", col_mask)
        self.widths = tuple(int(w) for w in widths)
        self.weight_bits = weight_bits
        self.cell_bits = cell_bits
        self.ecc = ecc

    def replace(self, **tensors) -> "CrossbarProgram":
        """A new program with some of ``planes``, ``bias``, ``w_scale``,
        ``col_mask`` and ``ecc`` replaced (``dataclasses.replace`` of the
        JAX package's program); the rest shared with this one."""
        fields = {"planes": self.planes, "bias": self.bias,
                  "w_scale": self.w_scale, "col_mask": self.col_mask,
                  "ecc": self.ecc}
        unknown = set(tensors) - set(fields)
        if unknown:
            raise TypeError(f"cannot replace {sorted(unknown)}")
        fields.update(tensors)
        ecc = fields.pop("ecc")
        return CrossbarProgram(**fields, widths=self.widths,
                               weight_bits=self.weight_bits,
                               cell_bits=self.cell_bits, ecc=ecc)

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
                  cell_bits: int = 2, ecc=None) -> CrossbarProgram:
    """Program an MLP into crossbars: quantize + plane-encode every layer
    exactly once, pad to the 128x128 geometry, stack into one module (on
    the device the weights lie on).

    ``layers``: sequence of ``{"w": (k, n), "b": (n,)}`` dicts or
    ``(w, b)`` tuples. ``ecc``: an
    :class:`~repro_torch.reliability.ecc.EccConfig` (or True for the
    default) Hamming-encodes the planes' spare columns here
    (:func:`~repro_torch.reliability.ecc.protect_program`); the products
    do not change."""
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
    program = CrossbarProgram(planes, bias,
                              torch.stack(scale).reshape(-1, 1), mask,
                              widths, weight_bits=weight_bits,
                              cell_bits=cell_bits)
    if ecc is not None and ecc is not False:
        # deferred: reliability sits above kernels in the layering
        from repro_torch.reliability.ecc import protect_program
        program = protect_program(program, ecc)
    return program


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
# what one call of a Hopper dataflow does: launches, blocks, work, bytes
# ---------------------------------------------------------------------------

def combine_bytes(program: CrossbarProgram, geom: LaunchGeometry) -> int:
    """Device-memory bytes of the s8 pre-pass: the planes of each layer's
    ``(k_lim, n_lim)`` read once, its s8 weights written once."""
    return sum((program.n_planes + 1) * k * n
               for k, n in zip(geom.k_lims, geom.n_lims))


@dataclass(frozen=True)
class LaunchWork:
    """One kernel launch of a fused-MLP call, as the cost model
    (:meth:`~repro_torch.core.policy.PlanPolicy.launch_cost`) reads it.
    ``blocks`` is the grid (0 for a grid-stride pass: the s8 pre-pass, K3's
    snapshot pass); one block runs, one after another, ``slabs`` products of
    ``BLOCK_M`` rows x ``MMA_BLOCK_N`` columns x ``MMA_BLOCK_K`` bytes,
    ``tiles`` epilogues of ``BLOCK_M x MMA_BLOCK_N`` outputs (dequantized
    and stored, or requantized into shared memory) and requantizes
    ``requant`` float32 inputs as it loads them; ``bytes`` is what the
    launch moves in device memory if every re-read inside it hits L2, each
    tensor counted once."""

    blocks: int
    slabs: float
    tiles: float
    requant: int
    bytes: int


def launch_work(program: CrossbarProgram, m_rows: int, mode: str, *,
                batch: int = 1, sms: int = 132) -> tuple[LaunchWork, ...]:
    """The launches of one call of ``batch`` elements of ``m_rows`` rows
    under ``mode``, as its kernels are written (:class:`LaunchGeometry`'s
    grids on ``sms`` SMs). All modes start with the pre-pass
    (:func:`combine_bytes`). K1 ('whole'/'tiled'), per layer: a block one
    ``MMA_BLOCK_N`` chunk of one row tile over ``k_lim``, loading its input
    as int8 (layer 0) or requantizing the float32 panel; moving the input,
    s8 weights, bias and mask, and the float32 output panel. K2 ('mtiled'),
    launch j: a block one row tile through layers ``0 .. j``, every
    N-chunk of each; moving the int8 input, the weights, bias and mask of
    layers ``0 .. j``, and the float32 output in the last launch only. K3
    ('wstat'), per layer: the snapshot pass after layer 0 (the float32
    panel read, the int8 snapshot written), then a block one chunk of
    ``cols`` columns (:func:`wstat_chunk`) over its share of the row
    tiles; moving the int8 input, weights, bias, mask and float32 output.
    'mtiled' where K2's stripes do not fit on chip is K1, which runs in its
    place."""
    geom = plan_launch(program, m_rows, mode)
    if mode == "tiled" or (mode == "mtiled" and not mtiled_on_chip(geom)):
        mode = "whole"
    rows = batch * geom.m_pad
    row_tiles = rows // BLOCK_M
    ks, ns = geom.k_lims, geom.n_lims
    slabs = [-(-k // MMA_BLOCK_K) for k in ks]
    chunks = [-(-n // MMA_BLOCK_N) for n in ns]
    out = [LaunchWork(0, 0, 0, 0, combine_bytes(program, geom))]
    for l, (k, n, smem) in enumerate(zip(ks, ns, geom.smem_bytes)):
        wbytes = k * n + 8 * n
        if mode == "whole":
            out.append(LaunchWork(
                chunks[l] * row_tiles, slabs[l], 1,
                BLOCK_M * k if l else 0,
                rows * k * (4 if l else 1) + wbytes + 4 * rows * n))
        elif mode == "mtiled":
            last = l == len(ks) - 1
            out.append(LaunchWork(
                row_tiles,
                sum(s * c for s, c in zip(slabs[:l + 1], chunks[:l + 1])),
                sum(chunks[:l + 1]), 0,
                rows * ks[0] + sum(a * b + 8 * b for a, b in
                                   zip(ks[:l + 1], ns[:l + 1]))
                + (4 * rows * ns[-1] if last else 0)))
        else:
            if l:
                out.append(LaunchWork(0, 0, 0, 0, 5 * rows * k))
            cols = wstat_chunk(k)[0]
            n_chunks = -(-n // cols)
            groups = wstat_row_groups(n_chunks, row_tiles, sms, smem)
            tiles = -(-row_tiles // groups) * cols / MMA_BLOCK_N
            out.append(LaunchWork(n_chunks * groups, tiles * slabs[l], tiles,
                                  0, rows * k + wbytes + 4 * rows * n))
    return tuple(out)


def launch_bytes(program: CrossbarProgram, m_rows: int, mode: str, *,
                 batch: int = 1) -> int:
    """A model, not a measurement: the device-memory bytes one call moves
    under ``mode``, summed over its launches (:func:`launch_work`)."""
    return sum(w.bytes for w in launch_work(program, m_rows, mode,
                                            batch=batch))


def launch_count(program: CrossbarProgram, mode: str) -> int:
    """Kernel launches of one call: the pre-pass and one per layer; K3
    also a snapshot pass per layer after the first."""
    n_layers = program.n_layers
    return 1 + n_layers + (n_layers - 1 if mode == "wstat" else 0)


# ---------------------------------------------------------------------------
# the TPU's dataflow choice: a copy of the JAX package's VMEM accounting
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


def _largest_fitting_edge(d, edges, bytes_at, vmem_budget):
    """Largest tile edge among ``edges`` that divides ``d_pad`` and fits."""
    for cand in edges:
        if d % cand == 0 and bytes_at(cand) <= vmem_budget:
            return cand
    return None


def _edge_candidates(mode: str, d: int) -> range:
    """TPU tile edges a mode may take, largest first: 'whole' is the single
    N-tile, 'wstat'/'tiled' only make sense split, 'mtiled' may keep the
    full edge."""
    if mode == "whole":
        return range(d, d + 1)
    if mode == "mtiled":
        return range(d, 0, -CROSSBAR)
    return range(d - CROSSBAR, 0, -CROSSBAR)


@dataclass(frozen=True)
class FusedPlan:
    """The TPU dataflow chosen for one MLP at one row count, field for
    field the JAX package's ``FusedPlan``: the TPU kernel's launch
    geometry (``block_m``/``block_n``/``block_k`` tile edges over
    ``d_pad`` and ``m_pad``) and its per-grid-step VMEM residency
    (``vmem_bytes``, against ``budget``; ``whole_bytes`` what 'whole' would
    have taken). ``fits_budget`` is False only when nothing fits and
    'mtiled' is the fallback. The ``*_per_layer`` properties are the JAX
    package's HBM accounting of that TPU dataflow, not Hopper quantities:
    the Hopper kernels tile by their own edges (:class:`LaunchGeometry`)
    and the port launches the Hopper choice
    (:meth:`~repro_torch.core.policy.PlanPolicy.select_launch`)."""

    d_pad: int
    m_pad: int
    block_m: int
    block_n: int
    block_k: int
    vmem_bytes: int
    whole_bytes: int
    budget: int = VMEM_BUDGET_BYTES
    mode: str = "whole"
    n_planes: int = 4

    @property
    def tiled(self) -> bool:
        """True when the N dimension is split (``block_n < d_pad``)."""
        return self.block_n < self.d_pad

    @property
    def fits_budget(self) -> bool:
        return self.vmem_bytes <= self.budget

    @property
    def n_steps(self) -> int:
        return self.d_pad // self.block_n

    @property
    def m_steps(self) -> int:
        return self.m_pad // self.block_m

    @property
    def plane_tile_fetches_per_layer(self) -> int:
        """``(P, d_pad, block_n)`` plane tiles crossing HBM to VMEM per
        layer and batch element: once per N-tile for 'wstat', once for
        'whole' or a single N-tile, else once per M-stripe and N-tile."""
        if self.mode == "wstat":
            return self.n_steps
        if self.mode == "whole" or self.n_steps == 1:
            return 1
        return self.m_steps * self.n_steps

    @property
    def plane_hbm_bytes_per_layer(self) -> int:
        return (self.plane_tile_fetches_per_layer
                * self.n_planes * self.d_pad * self.block_n)

    @property
    def act_hbm_bytes_per_layer(self) -> int:
        """The float32 activation stripe read and written once per layer
        by 'mtiled'; zero for the dataflows whose panel stays in VMEM."""
        return 8 * self.m_pad * self.d_pad if self.mode == "mtiled" else 0


def plan_fused_mlp(program: CrossbarProgram, m_rows: int, *,
                   mode: str | None = None, block_m: int = CROSSBAR,
                   block_n: int | None = None, block_k: int | None = None,
                   vmem_budget: int | None = None,
                   policy=None) -> FusedPlan:
    """The JAX package's TPU dataflow choice for ``m_rows`` activation
    rows (``repro/kernels/program.py::plan_fused_mlp``, the same
    arithmetic and the same result field for field).

    Unpinned, it walks whole -> wstat -> tiled -> mtiled and takes the
    first dataflow with a tile edge that fits the VMEM budget ('mtiled'
    with ``fits_budget`` False when none does). ``policy`` (a
    :class:`~repro_torch.core.policy.PlanPolicy`, read through its
    ``fused_cost``/``vmem_budget``) ranks every fitting dataflow by its
    roofline cost instead, ties in that order; without an explicit
    ``vmem_budget`` the policy's budget applies. ``mode`` pins the
    dataflow (its largest fitting edge still picked), ``block_n`` and
    ``block_k`` pin tile edges (validated against the crossbar geometry);
    an explicit ``block_n`` without ``mode`` selects 'whole' at ``block_n
    == d_pad``, else 'tiled'. The Hopper kernels launched for the chosen
    mode tile by their own edges; none of these arguments shapes them."""
    d = program.d_pad
    p = program.n_planes
    if vmem_budget is None:
        vmem_budget = (getattr(policy, "vmem_budget", None)
                       if policy is not None else None) or VMEM_BUDGET_BYTES
    if block_m % 8 != 0 or block_m <= 0:
        raise ValueError(f"block_m={block_m} must be a positive multiple "
                         f"of 8 (f32 sublane tiling)")
    if mode is not None and mode not in FUSED_MODES:
        raise ValueError(f"mode={mode!r} must be one of {FUSED_MODES}")
    m_pad = -(-max(int(m_rows), 1) // block_m) * block_m

    def bytes_at(md, bn):
        return fused_vmem_bytes(d, p, m_pad, block_m, bn, mode=md)

    whole = bytes_at("whole", d)
    if block_k is None:
        bk = min(d, 4 * CROSSBAR)
    else:
        bk = block_k
        if bk <= 0 or bk % CROSSBAR != 0 or d % bk != 0:
            raise ValueError(f"block_k={bk} must be a multiple of "
                             f"{CROSSBAR} dividing d_pad={d}")

    def plan_at(md, bn):
        return FusedPlan(
            d_pad=d, m_pad=m_pad, block_m=block_m, block_n=bn, block_k=bk,
            vmem_bytes=bytes_at(md, bn), whole_bytes=whole,
            budget=vmem_budget, mode=md, n_planes=p)

    if block_n is not None:
        bn = block_n
        if bn <= 0 or bn % CROSSBAR != 0 or d % bn != 0:
            raise ValueError(f"block_n={bn} must be a multiple of "
                             f"{CROSSBAR} dividing d_pad={d}")
        if mode is None:
            mode = "whole" if bn == d else "tiled"
        elif mode == "whole" and bn != d:
            raise ValueError(f"mode='whole' is the single-N-tile dataflow; "
                             f"block_n={bn} != d_pad={d}")
    elif mode is not None:
        if mode == "whole":
            bn = d
        else:
            bn = _largest_fitting_edge(d, _edge_candidates(mode, d),
                                       lambda c: bytes_at(mode, c),
                                       vmem_budget) or CROSSBAR
    else:
        fitting: list[tuple[str, int]] = []
        for cand_mode in ("whole", "wstat", "tiled", "mtiled"):
            found = _largest_fitting_edge(
                d, _edge_candidates(cand_mode, d),
                lambda c: bytes_at(cand_mode, c), vmem_budget)
            if found is not None:
                fitting.append((cand_mode, found))
        if not fitting:
            mode, bn = "mtiled", CROSSBAR
        elif policy is None:
            mode, bn = fitting[0]
        else:
            mode, bn = min(
                enumerate(fitting),
                key=lambda t: (policy.fused_cost(plan_at(*t[1])), t[0]))[1]
    return plan_at(mode, bn)
