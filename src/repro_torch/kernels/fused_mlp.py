"""K1, K2, K3: the fused bit-sliced INT8 crossbar MLP in three dataflows.

Replace the TPU kernels of ``repro/kernels/fused_mlp.py``: ``_kernel``
('whole'/'tiled') by K1 (``csrc/fused_mlp.cu``), ``_kernel_mtiled`` by K2
(``csrc/fused_mlp_mtiled.cu``) and ``_kernel_wstat`` by K3
(``csrc/fused_mlp_wstat.cu``). All three compute one function. The whole
L-layer MLP of one programmed :class:`~.program.CrossbarProgram` runs on
int8 activations:

1. quantize the input once per batch element (plain torch, as in the JAX
   package, where it runs outside the kernel);
2. per layer: int8 input times the four 2-bit offset-binary planes,
   shift-and-add, minus ``rowsum << 7`` — the same integer as the input
   times the s8 weights ``combine_planes(planes)``; dequantize
   ``float(y_int) * (s * w_scale) + bias``; ReLU; mask padded columns and
   rows; a running ``max|y|`` gives the next layer's scale
   ``max(mx / 127, 1e-12)``; requantize ``clip(round(act / s), ±127)``.

Every kernel runs one launch per layer (K3 two: a requantize pass and the
product) and keeps the running max on the device. All three multiply on
the H100's tensor cores (``mma.sync`` s8 x s8) with s8 weights that a
pre-pass (``combine_weights`` in ``csrc/fused_mlp.cu``,
:func:`combine_weights_cuda`) combines from the planes once per MLP call;
one C call per MLP launches the pre-pass and every layer. K2 keeps the
stripe's intermediate layers on chip by recomputing them in each launch;
K3 holds one chunk of weights per block in shared memory while the rows
stream through. All three take any number of layers, K1 and K3 any width;
where K2's two stripes do not fit on chip (the widest layer input above
1536), 'mtiled' runs K1 (:func:`~.program.mtiled_on_chip`). On the H100
all three are bound by bytes (the int8 input and weights, the float32
output: 0.032 ms over model1's three MLPs, 0.040 ms at model2 SA-1, 0.023
ms at model2 SA-2); the source notes in ``csrc/`` say how each dataflow
moves its data and what its design does about the bound. The plain version
below runs the same steps in torch, the integer products through
:func:`~.ref.ref_reram_matmul_int` (exact), and is the plain version of all
three kernels: they agree with it, and so with each other, bit for bit.
Against the JAX package they agree bit for bit with zero biases; with
biases XLA may contract the dequant multiply-add into an FMA, which moves
the result by about an ulp.

``mode`` picks the dataflow; by default :func:`~.program.plan_fused_mlp`
chooses it as the JAX package does. On CPU tensors the wrappers run the
plain version; on CUDA tensors they launch the mode's kernel (or raise).
``LAUNCHES`` counts, per kernel, MLP calls that launched it (``"mlp"``,
``"mtiled"``, ``"wstat"``), layers run (``"layer"``, ``"mtiled_layer"``,
``"wstat_layer"``), and the weight pre-pass's launches (``"combine"``, one
per MLP call).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .program import (BLOCK_M, FUSED_MODES, MMA_BLOCK_K, MMA_BLOCK_N,
                      MMA_STRIPE_K, WSTAT_BLOCK_K, WSTAT_BLOCK_N,
                      CrossbarProgram, LaunchGeometry, _quantize, _scale,
                      _smem_bytes, mtiled_on_chip, plan_fused_mlp,
                      plan_launch, wstat_chunk, wstat_row_groups)
from .ref import combine_planes, ref_reram_matmul_int

__all__ = ["LAUNCHES", "combine_weights_cuda",
           "combine_weights_plain", "fused_mlp", "fused_mlp_cuda",
           "fused_mlp_mtiled_cuda", "fused_mlp_plain",
           "fused_mlp_wstat_cuda", "prepare_input", "reram_mlp_fused",
           "reram_mlp_fused_batched", "weight_regions"]

#: Kernel launches, per kernel: MLP calls and layers, and the weight
#: pre-pass (plain runs never count).
LAUNCHES = {"mlp": 0, "layer": 0, "mtiled": 0, "mtiled_layer": 0,
            "wstat": 0, "wstat_layer": 0, "combine": 0}


def _qmax(program: CrossbarProgram) -> float:
    return float(2 ** (program.weight_bits - 1) - 1)


def _check_bits(program: CrossbarProgram) -> None:
    if program.weight_bits > 8:
        raise ValueError(
            f"the fused MLP streams int8 activations; weight_bits="
            f"{program.weight_bits} > 8 would overflow them")


def prepare_input(x, program: CrossbarProgram):
    """Quantize ``(B, m, d0)`` float rows with one scale per batch element
    and pad them into the kernels' int8 ``(B, m_pad, d_pad)`` layout.
    Returns ``(x_p, sx)``, ``sx`` the ``(B,)`` float32 scales."""
    _check_bits(program)
    batch, m0, d0 = x.shape
    qmax = _qmax(program)
    sx = _scale(x.abs().amax(dim=(1, 2)), qmax)
    x_int = _quantize(x, sx[:, None, None], qmax)
    geom = plan_launch(program, m0)
    x_p = torch.zeros((batch, geom.m_pad, program.d_pad), dtype=torch.int8,
                      device=x.device)
    x_p[:, :m0, :d0] = x_int.to(torch.int8)
    return x_p, sx


def fused_mlp_plain(x_p, sx, program: CrossbarProgram, *, m_real: int,
                    final_relu: bool = True):
    """The plain torch version: ``(B, m_pad, d_pad)`` int8 + ``(B,)``
    scales -> float32 ``(B, m_real, d_L)``, step by step. Each layer runs
    over its real widths only: the padded input columns are zero and the
    padded output columns masked, so they add nothing to the result or to
    the running max."""
    qmax = _qmax(program)
    n_layers = program.n_layers
    widths = program.widths
    rows_ok = (torch.arange(x_p.shape[1], device=x_p.device)
               < m_real)[None, :, None]
    s, act, mx = sx, None, None
    for l in range(n_layers):
        k, n = widths[l], widths[l + 1]
        if l == 0:
            xq = x_p[..., :k]
        else:
            s = _scale(mx, qmax)
            xq = _quantize(act, s[:, None, None], qmax)
        y_int = ref_reram_matmul_int(xq, program.planes[l, :, :k, :n],
                                     program.cell_bits, program.weight_bits)
        c = s * program.w_scale[l, 0]
        y = y_int.to(torch.float32) * c[:, None, None] + program.bias[l, :n]
        if l < n_layers - 1 or final_relu:
            y = torch.clamp_min(y, 0.0)
        y = y * program.col_mask[l, :n]
        y = torch.where(rows_ok, y, 0.0)
        mx = y.abs().amax(dim=(1, 2))
        act = y
    return act[:, :m_real]


def weight_regions(wt, geom: LaunchGeometry) -> list:
    """The part of a pre-pass buffer ``(L, d_pad, d_pad)`` that holds
    weights: layer l's ``[:n_lims[l], :k_lims[l]]``."""
    return [wt[l, :n, :k] for l, (k, n) in enumerate(zip(geom.k_lims,
                                                         geom.n_lims))]


def combine_weights_plain(program: CrossbarProgram,
                          geom: LaunchGeometry):
    """The pre-pass's plain version: every layer's s8 weights
    ``combine_planes(planes).to(int8)`` over ``(k_lim, n_lim)``, transposed
    to ``[n][k]``, in a ``(L, d_pad, d_pad)`` int8 buffer that is zero
    elsewhere."""
    d = program.d_pad
    wt = torch.zeros((program.n_layers, d, d), dtype=torch.int8,
                     device=program.planes.device)
    for l, (k, n) in enumerate(zip(geom.k_lims, geom.n_lims)):
        wt[l, :n, :k] = combine_planes(
            program.planes[l, :, :k, :n], program.cell_bits,
            program.weight_bits).T.to(torch.int8)
    return wt


# ---------------------------------------------------------------------------
# the kernels' bindings
# ---------------------------------------------------------------------------

#: C functions of each source: name -> (pointer args, int args), each
#: followed by the stream.
_FUNCTIONS = {
    "fused_mlp": {"fused_mlp_run": (12, 9), "combine_weights": (5, 6)},
    "fused_mlp_mtiled": {"fused_mlp_mtiled_run": (11, 9)},
    "fused_mlp_wstat": {"fused_mlp_wstat_run": (13, 9)},
}

#: Tile edges each source reports (``{name}_tile``): rows, widest output
#: chunk, K slab (bytes), widest K range.
_TILES = {
    "fused_mlp": (BLOCK_M, MMA_BLOCK_N, MMA_BLOCK_K, MMA_STRIPE_K),
    "fused_mlp_mtiled": (BLOCK_M, MMA_BLOCK_N, MMA_BLOCK_K, MMA_STRIPE_K),
    "fused_mlp_wstat": (BLOCK_M, WSTAT_BLOCK_N, WSTAT_BLOCK_K, MMA_STRIPE_K),
}

#: The dataflow whose shared memory each source reports (``{name}_smem``).
_SMEM_MODE = {"fused_mlp": "whole", "fused_mlp_mtiled": "mtiled",
              "fused_mlp_wstat": "wstat"}


@functools.cache
def _lib(name: str):
    """The library of ``csrc/{name}.cu``, its functions typed, after
    checking that its tile edges, stripe width and shared-memory sizes
    agree with ``program.py``'s."""
    lib = _build.library(name)
    for fn, (n_ptrs, n_ints) in _FUNCTIONS[name].items():
        _build.bind(lib, fn, n_ptrs, n_ints)
    tiles = tuple(_build.int_fn(lib, f"{name}_tile")(i) for i in range(4))
    if tiles != _TILES[name]:
        raise RuntimeError(f"{name}.cu tiles {tiles} disagree with "
                           f"program.py's {_TILES[name]}")
    if name in _SMEM_MODE:
        mode = _SMEM_MODE[name]
        smem = _build.int_fn(lib, f"{name}_smem")
        # every K3 chunk width and its K ranges, and K1's stripe cap
        for k_lim in (32, 512, 1024, 2048, 4096, 8192):
            if smem(k_lim) != _smem_bytes(mode, k_lim):
                raise RuntimeError(f"{name}.cu needs {smem(k_lim)} bytes of "
                                   f"shared memory at k_lim {k_lim}; "
                                   f"program.py says "
                                   f"{_smem_bytes(mode, k_lim)}")
    return lib


def _check_launch(x_p, sx, program: CrossbarProgram, m_real: int,
                  mode: str) -> LaunchGeometry:
    """Validate the kernels' inputs; return the mode's launch geometry."""
    batch, m_pad, d = x_p.shape
    geom = plan_launch(program, m_real, mode)
    if x_p.dtype != torch.int8 or sx.dtype != torch.float32:
        raise TypeError(f"need int8 rows and float32 scales; got "
                        f"{x_p.dtype}, {sx.dtype}")
    if d != program.d_pad or m_pad != geom.m_pad or sx.shape != (batch,):
        raise ValueError(f"input {tuple(x_p.shape)} / scales "
                         f"{tuple(sx.shape)} do not match the program "
                         f"(d_pad {program.d_pad}, m_pad {geom.m_pad})")
    if (m_pad // BLOCK_M > 65535 or batch > 65535
            or program.n_layers > 65535):
        raise ValueError("too many rows, batch elements or layers for one "
                         "launch")
    bufs = (x_p, sx, program.planes, program.bias, program.col_mask,
            program.w_scale)
    if not all(t.is_contiguous() for t in bufs):
        raise ValueError("the fused-MLP kernels need contiguous tensors")
    return geom


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _lims(geom: LaunchGeometry, device) -> tuple[int, int]:
    """The layers' ``k_lims`` then ``n_lims``: the addresses of a device
    copy (read by the kernels) and a host copy (read by the C side for the
    grids), both kept for later calls and never written."""
    vals = geom.k_lims + geom.n_lims
    return (_device_ints(vals, torch.device(device)).data_ptr(),
            ctypes.addressof(_int_array(vals)))


@functools.lru_cache(maxsize=256)
def _int_array(vals: tuple):
    return (ctypes.c_int * len(vals))(*vals)


@functools.lru_cache(maxsize=256)
def _device_ints(vals: tuple, device: torch.device):
    # a blocking copy: done before any stream can launch a kernel on it
    return torch.tensor(vals, dtype=torch.int32).to(device)


def combine_weights_cuda(program: CrossbarProgram, geom: LaunchGeometry):
    """The s8 weight pre-pass of K1, K2 and K3 alone, one launch: a ``(L,
    d_pad, d_pad)`` int8 buffer holding layer l's ``combine_planes`` weights
    transposed to ``[n][k]`` over ``(k_lims[l], n_lims[l])``; the rest is
    left unwritten (:func:`weight_regions` cuts out what is written). The
    kernels launch the same kernel from their own entry points."""
    planes = program.planes
    if not planes.is_contiguous():
        raise ValueError("the pre-pass takes contiguous planes")
    d = program.d_pad
    wt = torch.empty((program.n_layers, d, d), dtype=torch.int8,
                     device=planes.device)
    with torch.cuda.device(planes.device):
        err = _lib("fused_mlp").combine_weights(
            planes.data_ptr(), wt.data_ptr(), None,
            *_lims(geom, planes.device), 0, program.n_layers,
            program.n_planes, program.cell_bits, program.weight_bits, d,
            _build.stream_of(planes))
    _raise_on(err, "combine_weights")
    LAUNCHES["combine"] += 1
    return wt


def _scratch(program: CrossbarProgram, batch: int, extra: int, device):
    """One int8 scratch buffer of a K1/K2/K3 call: ``extra`` bytes (K1's
    second float32 panel, K3's int8 snapshot; a multiple of 256), the
    ``(B, L)`` running maxima and the pre-pass's ``(L, d_pad, d_pad)`` s8
    weights. Returns it and the maxima's and weights' addresses (each
    256-byte aligned)."""
    d, n_layers = program.d_pad, program.n_layers
    mx_bytes = -(-4 * batch * n_layers // 256) * 256
    buf = torch.empty(extra + mx_bytes + n_layers * d * d, dtype=torch.int8,
                      device=device)
    base = buf.data_ptr()
    return buf, base + extra, base + extra + mx_bytes


def _common_args(program: CrossbarProgram, sx, geom: LaunchGeometry):
    """The arguments the kernels' entry points share after their buffers:
    planes, bias, mask, w_scale, sx, the layer extents (device and host),
    the layer count and the plane, cell and weight bit counts."""
    return (program.planes.data_ptr(), program.bias.data_ptr(),
            program.col_mask.data_ptr(), program.w_scale.data_ptr(),
            sx.data_ptr(), *_lims(geom, sx.device), program.n_layers,
            program.n_planes, program.cell_bits, program.weight_bits)


def fused_mlp_cuda(x_p, sx, program: CrossbarProgram, *, m_real: int,
                   final_relu: bool = True):
    """K1 ('whole'/'tiled') on CUDA tensors laid out as
    :func:`prepare_input` makes them -> float32 ``(B, m_real, d_L)``: one
    C call that launches the s8 pre-pass and then one launch per layer.
    Activations ping-pong between two float32 panels; the last layer's is
    the output."""
    geom = _check_launch(x_p, sx, program, m_real, "whole")
    batch, m_pad, d = x_p.shape
    n_layers = program.n_layers
    out = torch.empty((batch, m_pad, d), dtype=torch.float32,
                      device=x_p.device)
    other = 4 * batch * m_pad * d if n_layers > 1 else 0
    buf, mx, wt = _scratch(program, batch, other, x_p.device)
    # layer l writes panel l % 2: the output must be the last layer's
    panels = (out.data_ptr(), buf.data_ptr())
    if n_layers % 2 == 0:
        panels = panels[::-1]
    with torch.cuda.device(x_p.device):
        err = _lib("fused_mlp").fused_mlp_run(
            x_p.data_ptr(), *panels, wt, mx,
            *_common_args(program, sx, geom), batch, m_pad, m_real, d,
            int(final_relu), _build.stream_of(x_p))
    _raise_on(err, "fused_mlp")
    LAUNCHES["combine"] += 1
    LAUNCHES["layer"] += n_layers
    LAUNCHES["mlp"] += 1
    return out[:, :m_real, :program.widths[-1]]


def fused_mlp_mtiled_cuda(x_p, sx, program: CrossbarProgram, *, m_real: int,
                          final_relu: bool = True):
    """K2 ('mtiled'): one C call that launches the s8 pre-pass and then one
    launch per layer. Launch j recomputes layers ``0 .. j-1`` of each
    block's stripe on chip from the int8 input and the maxima earlier
    launches published, computes layer j and publishes its max; only the
    last launch writes the float32 output. Same layout and result as
    :func:`fused_mlp_cuda`, which runs in its place (and counts as K1)
    where the two stripes do not fit on chip."""
    geom = _check_launch(x_p, sx, program, m_real, "mtiled")
    if not mtiled_on_chip(geom):
        return fused_mlp_cuda(x_p, sx, program, m_real=m_real,
                              final_relu=final_relu)
    batch, m_pad, d = x_p.shape
    n_layers = program.n_layers
    out = torch.empty((batch, m_pad, geom.n_lims[-1]), dtype=torch.float32,
                      device=x_p.device)
    buf, mx, wt = _scratch(program, batch, 0, x_p.device)
    with torch.cuda.device(x_p.device):
        err = _lib("fused_mlp_mtiled").fused_mlp_mtiled_run(
            x_p.data_ptr(), out.data_ptr(), wt, mx,
            *_common_args(program, sx, geom), batch, m_pad, m_real, d,
            int(final_relu), _build.stream_of(x_p))
    _raise_on(err, "fused_mlp_mtiled")
    LAUNCHES["combine"] += 1
    LAUNCHES["mtiled_layer"] += n_layers
    LAUNCHES["mtiled"] += 1
    return out[:, :m_real, :program.widths[-1]]


def fused_mlp_wstat_cuda(x_p, sx, program: CrossbarProgram, *, m_real: int,
                         final_relu: bool = True):
    """K3 ('wstat'): one C call that launches the s8 pre-pass and then, per
    layer, an int8 snapshot of the float32 panel (layers > 0) and the
    product, each block holding one chunk of s8 weights in shared memory
    while its share of all rows streams through. Output in place on one
    float32 panel. Same layout and result as :func:`fused_mlp_cuda`."""
    geom = _check_launch(x_p, sx, program, m_real, "wstat")
    batch, m_pad, d = x_p.shape
    n_layers = program.n_layers
    panel = torch.empty((batch, m_pad, d), dtype=torch.float32,
                        device=x_p.device)
    snapshot = batch * m_pad * d if n_layers > 1 else 0
    buf, mx, wt = _scratch(program, batch, snapshot, x_p.device)
    sms = _build.sm_count(x_p)
    row_tiles = batch * m_pad // BLOCK_M
    groups = tuple(
        wstat_row_groups(-(-n // wstat_chunk(k)[0]), row_tiles, sms, smem)
        for k, n, smem in zip(geom.k_lims, geom.n_lims, geom.smem_bytes))
    with torch.cuda.device(x_p.device):
        err = _lib("fused_mlp_wstat").fused_mlp_wstat_run(
            x_p.data_ptr(), panel.data_ptr(), buf.data_ptr(), wt, mx,
            ctypes.addressof(_int_array(groups)),
            *_common_args(program, sx, geom), batch, m_pad, m_real, d,
            int(final_relu), _build.stream_of(x_p))
    _raise_on(err, "fused_mlp_wstat")
    LAUNCHES["combine"] += 1
    LAUNCHES["wstat_layer"] += n_layers
    LAUNCHES["wstat"] += 1
    return panel[:, :m_real, :program.widths[-1]]


#: The kernel of each dataflow.
KERNEL_OF_MODE = {"whole": fused_mlp_cuda, "tiled": fused_mlp_cuda,
                  "mtiled": fused_mlp_mtiled_cuda,
                  "wstat": fused_mlp_wstat_cuda}


def fused_mlp(x_p, sx, program: CrossbarProgram, *, m_real: int,
              final_relu: bool = True, mode: str = "whole"):
    """Dispatch: the plain version on CPU tensors, the kernel of dataflow
    ``mode`` on CUDA."""
    if mode not in FUSED_MODES:
        raise ValueError(f"mode={mode!r} must be one of {FUSED_MODES}")
    if _build.runs_plain(x_p, sx, program.planes):
        return fused_mlp_plain(x_p, sx, program, m_real=m_real,
                               final_relu=final_relu)
    return KERNEL_OF_MODE[mode](x_p, sx, program, m_real=m_real,
                                final_relu=final_relu)


def _run(x2, program: CrossbarProgram, final_relu: bool, mode):
    m = x2.shape[1]
    if mode is None:
        mode = plan_fused_mlp(program, m).mode
    x_p, sx = prepare_input(x2, program)
    return fused_mlp(x_p, sx, program, m_real=m, final_relu=final_relu,
                     mode=mode)


def reram_mlp_fused(x, program: CrossbarProgram, *, final_relu: bool = True,
                    mode: str | None = None):
    """Float ``(…, d0)`` through the whole programmed MLP -> ``(…, dL)``,
    all rows under one input scale. ``mode`` pins the dataflow; by default
    :func:`~.program.plan_fused_mlp` picks it for the row count."""
    widths = program.widths
    lead = x.shape[:-1]
    out = _run(x.reshape(1, -1, widths[0]), program, final_relu, mode)
    return out[0].reshape(*lead, widths[-1])


def reram_mlp_fused_batched(x, program: CrossbarProgram, *,
                            final_relu: bool = True,
                            mode: str | None = None):
    """Float ``(B, …, d0)`` -> ``(B, …, dL)``, the batch in the kernel's
    grid: each batch element keeps its own input scale and its own
    inter-layer scales. The dataflow is chosen for one element's rows."""
    widths = program.widths
    batch, lead = x.shape[0], x.shape[1:-1]
    out = _run(x.reshape(batch, -1, widths[0]), program, final_relu, mode)
    return out.reshape(batch, *lead, widths[-1])
