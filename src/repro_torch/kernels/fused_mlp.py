"""K1: the fused bit-sliced INT8 crossbar MLP (``csrc/fused_mlp.cu``).

Replaces the TPU kernel ``repro/kernels/fused_mlp.py::_kernel`` (the
'whole'/'tiled' dataflows of ``reram_mlp_fused[_batched]``). The whole
L-layer MLP of one programmed :class:`~.program.CrossbarProgram` runs on
int8 activations:

1. quantize the input once per batch element (plain torch, as in the JAX
   package, where it runs outside the kernel);
2. per layer: int8 input times the four 2-bit offset-binary planes,
   shift-and-add, minus ``rowsum << 7``; dequantize
   ``float(y_int) * (s * w_scale) + bias``; ReLU; mask padded columns and
   rows; a running ``max|y|`` gives the next layer's scale
   ``max(mx / 127, 1e-12)``; requantize ``clip(round(act / s), ±127)``.

The CUDA kernel runs one launch per layer and keeps the running max on the
device (see the source note in ``csrc/fused_mlp.cu``); the plain version
below runs the same steps in torch, with the integer products as float64
matmuls (exact: every partial sum is an integer below 2^53). The two agree
bit for bit. Against the JAX package they agree bit for bit with zero
biases; with biases XLA may contract the dequant multiply-add into an FMA,
which moves the result by about an ulp.

On CPU tensors the wrappers run the plain version; on CUDA tensors they
launch the kernel (or raise). ``LAUNCHES`` counts MLP calls that launched
the kernel (``"mlp"``) and layer launches (``"layer"``) separately.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .program import (BLOCK_K, BLOCK_M, BLOCK_N, CrossbarProgram,
                      _quantize, _scale, plan_launch)

__all__ = ["LAUNCHES", "fused_mlp", "fused_mlp_cuda", "fused_mlp_plain",
           "prepare_input", "reram_mlp_fused", "reram_mlp_fused_batched"]

#: Kernel launches: MLP calls and per-layer launches (plain runs never
#: count).
LAUNCHES = {"mlp": 0, "layer": 0}


def _qmax(program: CrossbarProgram) -> float:
    return float(2 ** (program.weight_bits - 1) - 1)


def _check_bits(program: CrossbarProgram) -> None:
    if program.weight_bits > 8:
        raise ValueError(
            f"the fused MLP streams int8 activations; weight_bits="
            f"{program.weight_bits} > 8 would overflow them")


def prepare_input(x, program: CrossbarProgram):
    """Quantize ``(B, m, d0)`` float rows with one scale per batch element
    and pad them into the kernel's int8 ``(B, m_pad, d_pad)`` layout.
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
    scales -> float32 ``(B, m_real, d_L)``, step by step."""
    qmax = _qmax(program)
    n_layers = program.n_layers
    wb, cb = program.weight_bits, program.cell_bits
    rows_ok = (torch.arange(x_p.shape[1], device=x_p.device)
               < m_real)[None, :, None]
    s, act, mx = sx, None, None
    for l in range(n_layers):
        if l == 0:
            xq = x_p.to(torch.int64)
        else:
            s = _scale(mx, qmax)
            xq = _quantize(act, s[:, None, None], qmax).to(torch.int64)
        row_sums = xq.sum(dim=-1, keepdim=True)
        xf = xq.to(torch.float64)
        acc = torch.zeros(xq.shape, dtype=torch.int64, device=x_p.device)
        for p in range(program.n_planes):
            part = torch.matmul(xf, program.planes[l, p].to(torch.float64))
            acc += part.to(torch.int64) << (cb * p)
        y_int = acc - (row_sums << (wb - 1))
        c = s * program.w_scale[l, 0]
        y = y_int.to(torch.float32) * c[:, None, None] + program.bias[l]
        if l < n_layers - 1 or final_relu:
            y = torch.clamp_min(y, 0.0)
        y = y * program.col_mask[l]
        y = torch.where(rows_ok, y, 0.0)
        mx = y.abs().amax(dim=(1, 2))
        act = y
    return act[:, :m_real, :program.widths[-1]]


def _lib():
    lib = _build.library("fused_mlp")
    if lib.fused_mlp_layer.argtypes is None:
        lib.fused_mlp_tile.restype = ctypes.c_int
        lib.fused_mlp_tile.argtypes = [ctypes.c_int]
        tiles = tuple(lib.fused_mlp_tile(i) for i in range(3))
        if tiles != (BLOCK_M, BLOCK_N, BLOCK_K):
            raise RuntimeError(f"fused_mlp.cu tiles {tiles} disagree with "
                               f"program.py's {(BLOCK_M, BLOCK_N, BLOCK_K)}")
        fn = lib.fused_mlp_layer
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 \
            + [ctypes.c_void_p]
    return lib


def fused_mlp_cuda(x_p, sx, program: CrossbarProgram, *, m_real: int,
                   final_relu: bool = True):
    """Launch the kernel, one launch per layer, on CUDA tensors laid out as
    :func:`prepare_input` makes them -> float32 ``(B, m_real, d_L)``."""
    batch, m_pad, d = x_p.shape
    geom = plan_launch(program, m_real)
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
        raise ValueError("fused_mlp_cuda needs contiguous tensors")
    n_layers = program.n_layers
    panels = [torch.empty((batch, m_pad, d), dtype=torch.float32,
                          device=x_p.device)
              for _ in range(min(2, n_layers))]
    mx = torch.zeros((batch, n_layers), dtype=torch.int32, device=x_p.device)
    lib = _lib()
    stream = _build.stream_of(x_p)
    with torch.cuda.device(x_p.device):
        for l in range(n_layers):
            src = panels[(l - 1) % 2].data_ptr() if l else None
            dst = panels[l % 2]
            err = lib.fused_mlp_layer(
                x_p.data_ptr(), src, dst.data_ptr(),
                program.planes[l].data_ptr(), program.bias[l].data_ptr(),
                program.col_mask[l].data_ptr(),
                program.w_scale[l].data_ptr(), sx.data_ptr(), mx.data_ptr(),
                l, n_layers, program.n_planes, program.cell_bits,
                program.weight_bits, batch, m_pad, m_real, d,
                geom.k_lims[l], geom.n_lims[l],
                int(l < n_layers - 1 or final_relu), stream)
            if err:
                raise RuntimeError(f"fused_mlp layer {l} launch failed: "
                                   f"CUDA error {err}")
            LAUNCHES["layer"] += 1
    LAUNCHES["mlp"] += 1
    return panels[(n_layers - 1) % 2][:, :m_real, :program.widths[-1]]


def fused_mlp(x_p, sx, program: CrossbarProgram, *, m_real: int,
              final_relu: bool = True):
    """Dispatch: the plain version on CPU tensors, the kernel on CUDA."""
    if _build.runs_plain(x_p, sx, program.planes):
        return fused_mlp_plain(x_p, sx, program, m_real=m_real,
                               final_relu=final_relu)
    return fused_mlp_cuda(x_p, sx, program, m_real=m_real,
                          final_relu=final_relu)


def reram_mlp_fused(x, program: CrossbarProgram, *,
                    final_relu: bool = True):
    """Float ``(…, d0)`` through the whole programmed MLP -> ``(…, dL)``,
    all rows under one input scale."""
    widths = program.widths
    lead = x.shape[:-1]
    x2 = x.reshape(1, -1, widths[0])
    x_p, sx = prepare_input(x2, program)
    out = fused_mlp(x_p, sx, program, m_real=x2.shape[1],
                    final_relu=final_relu)
    return out[0].reshape(*lead, widths[-1])


def reram_mlp_fused_batched(x, program: CrossbarProgram, *,
                            final_relu: bool = True):
    """Float ``(B, …, d0)`` -> ``(B, …, dL)``, the batch in the kernel's
    grid: each batch element keeps its own input scale and its own
    inter-layer scales."""
    widths = program.widths
    batch, lead = x.shape[0], x.shape[1:-1]
    x2 = x.reshape(batch, -1, widths[0])
    x_p, sx = prepare_input(x2, program)
    out = fused_mlp(x_p, sx, program, m_real=x2.shape[1],
                    final_relu=final_relu)
    return out.reshape(batch, *lead, widths[-1])
