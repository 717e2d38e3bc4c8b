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
   shift-and-add, minus ``rowsum << 7``; dequantize
   ``float(y_int) * (s * w_scale) + bias``; ReLU; mask padded columns and
   rows; a running ``max|y|`` gives the next layer's scale
   ``max(mx / 127, 1e-12)``; requantize ``clip(round(act / s), ±127)``.

Each kernel runs one launch per layer (K3 two: a requantize pass and the
product) and keeps the running max on the device; the source notes in
``csrc/`` say how each dataflow moves its data. The plain version below
runs the same steps in torch, the integer products through
:func:`~.ref.ref_reram_matmul_int` (exact), and is the plain version of all
three kernels: they agree with it, and so with each other, bit for bit.
Against the JAX package they agree bit for bit with zero biases; with
biases XLA may contract the dequant multiply-add into an FMA, which moves
the result by about an ulp.

``mode`` picks the dataflow; by default :func:`~.program.plan_fused_mlp`
chooses it as the JAX package does. On CPU tensors the wrappers run the
plain version; on CUDA tensors they launch the mode's kernel (or raise).
``LAUNCHES`` counts, per kernel, MLP calls that launched it (``"mlp"``,
``"mtiled"``, ``"wstat"``) and layers run (``"layer"``, ``"mtiled_layer"``,
``"wstat_layer"``).
"""
from __future__ import annotations

import functools

import torch

from . import _build
from .program import (BLOCK_K, BLOCK_M, BLOCK_N, FUSED_MODES,
                      CrossbarProgram, LaunchGeometry, _quantize, _scale,
                      _smem_bytes, plan_fused_mlp, plan_launch,
                      wstat_row_groups)
from .ref import ref_reram_matmul_int

__all__ = ["LAUNCHES", "fused_mlp", "fused_mlp_cuda",
           "fused_mlp_mtiled_cuda", "fused_mlp_plain",
           "fused_mlp_wstat_cuda", "prepare_input", "reram_mlp_fused",
           "reram_mlp_fused_batched"]

#: Kernel launches, per kernel: MLP calls and layers (plain runs never
#: count).
LAUNCHES = {"mlp": 0, "layer": 0, "mtiled": 0, "mtiled_layer": 0,
            "wstat": 0, "wstat_layer": 0}


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


# ---------------------------------------------------------------------------
# the kernels' bindings
# ---------------------------------------------------------------------------

#: C functions of each source: name -> (pointer args, int args), each
#: followed by the stream.
_FUNCTIONS = {
    "fused_mlp": {"fused_mlp_layer": (9, 12)},
    "fused_mlp_mtiled": {"fused_mlp_mtiled_layer": (8, 12)},
    "fused_mlp_wstat": {"fused_mlp_wstat_requant": (3, 7),
                        "fused_mlp_wstat_layer": (8, 13)},
}


@functools.cache
def _lib(name: str):
    """The library of ``csrc/{name}.cu``, its functions typed, after
    checking that its tile edges and shared-memory sizes agree with
    ``program.py``'s."""
    lib = _build.library(name)
    for fn, (n_ptrs, n_ints) in _FUNCTIONS[name].items():
        _build.bind(lib, fn, n_ptrs, n_ints)
    if name == "fused_mlp":
        tiles = tuple(_build.int_fn(lib, "fused_mlp_tile")(i)
                      for i in range(3))
        if tiles != (BLOCK_M, BLOCK_N, BLOCK_K):
            raise RuntimeError(f"crossbar.cuh tiles {tiles} disagree with "
                               f"program.py's {(BLOCK_M, BLOCK_N, BLOCK_K)}")
    else:
        mode = name.rsplit("_", 1)[1]
        smem = _build.int_fn(lib, f"{name}_smem")
        for k_lim in (BLOCK_K, 512, 1024):
            if smem(k_lim) != _smem_bytes(mode, k_lim):
                raise RuntimeError(f"{name}.cu needs {smem(k_lim)} bytes of "
                                   f"shared memory at k_lim {k_lim}; "
                                   f"program.py says "
                                   f"{_smem_bytes(mode, k_lim)}")
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    if m_pad // BLOCK_M > 65535 or batch > 65535:
        raise ValueError("too many rows or batch elements for one launch")
    bufs = (x_p, sx, program.planes, program.bias, program.col_mask,
            program.w_scale)
    if not all(t.is_contiguous() for t in bufs):
        raise ValueError("the fused-MLP kernels need contiguous tensors")
    return geom


def _raise_on(err: int, what: str, layer: int) -> None:
    if err:
        raise RuntimeError(f"{what} layer {layer} launch failed: CUDA error "
                           f"{err}")


def _layer_args(program: CrossbarProgram, l: int) -> tuple[int, ...]:
    return (program.planes[l].data_ptr(), program.bias[l].data_ptr(),
            program.col_mask[l].data_ptr(), program.w_scale[l].data_ptr())


def _relu(program: CrossbarProgram, l: int, final_relu: bool) -> int:
    return int(l < program.n_layers - 1 or final_relu)


def fused_mlp_cuda(x_p, sx, program: CrossbarProgram, *, m_real: int,
                   final_relu: bool = True):
    """K1 ('whole'/'tiled'), one launch per layer, on CUDA tensors laid out
    as :func:`prepare_input` makes them -> float32 ``(B, m_real, d_L)``.
    Activations ping-pong between two float32 panels."""
    geom = _check_launch(x_p, sx, program, m_real, "whole")
    batch, m_pad, d = x_p.shape
    n_layers = program.n_layers
    panels = [torch.empty((batch, m_pad, d), dtype=torch.float32,
                          device=x_p.device)
              for _ in range(min(2, n_layers))]
    mx = torch.zeros((batch, n_layers), dtype=torch.int32, device=x_p.device)
    lib = _lib("fused_mlp")
    stream = _build.stream_of(x_p)
    with torch.cuda.device(x_p.device):
        for l in range(n_layers):
            src = panels[(l - 1) % 2].data_ptr() if l else None
            err = lib.fused_mlp_layer(
                x_p.data_ptr(), src, panels[l % 2].data_ptr(),
                *_layer_args(program, l), sx.data_ptr(), mx.data_ptr(),
                l, n_layers, program.n_planes, program.cell_bits,
                program.weight_bits, batch, m_pad, m_real, d,
                geom.k_lims[l], geom.n_lims[l],
                _relu(program, l, final_relu), stream)
            _raise_on(err, "fused_mlp", l)
            LAUNCHES["layer"] += 1
    LAUNCHES["mlp"] += 1
    return panels[(n_layers - 1) % 2][:, :m_real, :program.widths[-1]]


def fused_mlp_mtiled_cuda(x_p, sx, program: CrossbarProgram, *, m_real: int,
                          final_relu: bool = True):
    """K2 ('mtiled'), one launch per layer, in place on one float32 panel:
    each block keeps its int8 stripe in shared memory and walks every
    N-tile of the layer over it. Same layout and result as
    :func:`fused_mlp_cuda`."""
    geom = _check_launch(x_p, sx, program, m_real, "mtiled")
    batch, m_pad, d = x_p.shape
    n_layers = program.n_layers
    panel = torch.empty((batch, m_pad, d), dtype=torch.float32,
                        device=x_p.device)
    mx = torch.zeros((batch, n_layers), dtype=torch.int32, device=x_p.device)
    lib = _lib("fused_mlp_mtiled")
    stream = _build.stream_of(x_p)
    with torch.cuda.device(x_p.device):
        for l in range(n_layers):
            err = lib.fused_mlp_mtiled_layer(
                x_p.data_ptr(), panel.data_ptr(), *_layer_args(program, l),
                sx.data_ptr(), mx.data_ptr(), l, n_layers, program.n_planes,
                program.cell_bits, program.weight_bits, batch, m_pad, m_real,
                d, geom.k_lims[l], geom.n_lims[l],
                _relu(program, l, final_relu), stream)
            _raise_on(err, "fused_mlp_mtiled", l)
            LAUNCHES["mtiled_layer"] += 1
    LAUNCHES["mtiled"] += 1
    return panel[:, :m_real, :program.widths[-1]]


def fused_mlp_wstat_cuda(x_p, sx, program: CrossbarProgram, *, m_real: int,
                         final_relu: bool = True):
    """K3 ('wstat'): per layer, an int8 snapshot of the float32 panel
    (layers > 0), then the product, each block holding one N-tile of
    combined weights in shared memory while its share of all rows streams
    through. Output in place on one float32 panel. Same layout and result
    as :func:`fused_mlp_cuda`."""
    geom = _check_launch(x_p, sx, program, m_real, "wstat")
    batch, m_pad, d = x_p.shape
    n_layers = program.n_layers
    panel = torch.empty((batch, m_pad, d), dtype=torch.float32,
                        device=x_p.device)
    xq = torch.empty_like(x_p) if n_layers > 1 else None
    mx = torch.zeros((batch, n_layers), dtype=torch.int32, device=x_p.device)
    lib = _lib("fused_mlp_wstat")
    stream = _build.stream_of(x_p)
    row_tiles = batch * m_pad // BLOCK_M
    sms = _sm_count(x_p.device.index if x_p.device.index is not None
                    else torch.cuda.current_device())
    with torch.cuda.device(x_p.device):
        for l in range(n_layers):
            src = x_p
            if l:
                err = lib.fused_mlp_wstat_requant(
                    panel.data_ptr(), xq.data_ptr(), mx.data_ptr(), l,
                    n_layers, program.weight_bits, batch, m_pad, d,
                    geom.k_lims[l], stream)
                _raise_on(err, "fused_mlp_wstat requantize", l)
                src = xq
            groups = wstat_row_groups(geom.n_lims[l] // BLOCK_N, row_tiles,
                                      sms)
            err = lib.fused_mlp_wstat_layer(
                src.data_ptr(), panel.data_ptr(), *_layer_args(program, l),
                sx.data_ptr(), mx.data_ptr(), l, n_layers, program.n_planes,
                program.cell_bits, program.weight_bits, batch, m_pad, m_real,
                d, geom.k_lims[l], geom.n_lims[l], groups,
                _relu(program, l, final_relu), stream)
            _raise_on(err, "fused_mlp_wstat", l)
            LAUNCHES["wstat_layer"] += 1
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
