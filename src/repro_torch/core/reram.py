"""Functional + capacity model of the ReRAM crossbar MLP engine — the
port's copy of the JAX package's ``repro.core.reram`` (NumPy only).

Two halves:

1. **Functional model** (NumPy; the torch twin lives in
   ``repro_torch.kernels.reram_mlp`` / ``repro_torch.kernels.ref``): symmetric INT8
   weight quantization, offset-binary encoding, decomposition of each 8-bit
   weight into four 2-bit cell planes, plane-wise integer MVM and shift-add
   recombination. Integer-exact: ``crossbar_matmul(x, *encode(w)) ==
   x @ dequant(quant(w))`` bit-for-bit, which is the paper's
   "no accuracy variation" property at the arithmetic level.

2. **Capacity/mapping model**: how many 128x128 arrays a given MLP needs
   (used by the simulator for latency/energy and to check the paper's
   96 IMA x 8 array budget).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .energy import HWParams, DEFAULT_HW
from .workload import PointNetConfig

__all__ = [
    "quantize_weights",
    "bit_slice",
    "crossbar_matmul",
    "CrossbarMapping",
    "map_mlp_to_arrays",
]


def quantize_weights(w: np.ndarray, bits: int = 8):
    """Symmetric per-tensor quantization. Returns (w_int, scale) with
    ``w ~ w_int * scale`` and w_int in [-2^(b-1)+1, 2^(b-1)-1].

    Rejects NaN/Inf inputs: a single non-finite entry poisons the
    ``max(|w|)`` scale (NaN scale quantizes everything to garbage)."""
    w = np.asarray(w)
    if not np.all(np.isfinite(w)):
        raise ValueError("quantize_weights: input contains NaN/Inf — a "
                         "non-finite value poisons the quantization scale")
    qmax = 2 ** (bits - 1) - 1
    scale = float(np.max(np.abs(w))) / qmax if np.any(w) else 1.0
    scale = scale or 1.0
    w_int = np.clip(np.round(w / scale), -qmax, qmax).astype(np.int32)
    return w_int, scale


def bit_slice(w_int: np.ndarray, weight_bits: int = 8, cell_bits: int = 2):
    """Decompose signed ints into 2-bit cell planes using offset-binary:
    store u = w + 2^(b-1)  (unsigned, fits b bits); then
    x @ w = x @ u - 2^(b-1) * sum(x).
    Returns planes of shape (n_planes, *w.shape), LSB plane first, values in
    [0, 2^cell_bits)."""
    offset = 1 << (weight_bits - 1)
    u = (w_int + offset).astype(np.uint32)
    n_planes = -(-weight_bits // cell_bits)
    mask = (1 << cell_bits) - 1
    planes = np.stack([(u >> (cell_bits * p)) & mask
                       for p in range(n_planes)]).astype(np.int32)
    return planes


def crossbar_matmul(x_int: np.ndarray, planes: np.ndarray,
                    weight_bits: int = 8, cell_bits: int = 2) -> np.ndarray:
    """Integer MVM the way the crossbar + shift-and-add pipeline computes it.
    ``x_int``: (..., n) int32; ``planes``: (P, n, m). Exact."""
    offset = 1 << (weight_bits - 1)
    acc = np.zeros(x_int.shape[:-1] + (planes.shape[-1],), dtype=np.int64)
    for p in range(planes.shape[0]):
        acc += (x_int.astype(np.int64) @ planes[p].astype(np.int64)
                ) << (cell_bits * p)
    acc -= offset * np.sum(x_int, axis=-1, keepdims=True).astype(np.int64)
    return acc


@dataclass(frozen=True)
class CrossbarMapping:
    """Static mapping of one model's MLP stacks onto ReRAM arrays."""

    arrays_per_stage: tuple[int, ...]   # flattened over layers then stages
    total_arrays: int
    budget: int

    @property
    def fits(self) -> bool:
        return self.total_arrays <= self.budget

    @property
    def utilization(self) -> float:
        return self.total_arrays / self.budget


def _arrays_for(n: int, m: int, hw: HWParams) -> int:
    """Arrays to hold an (n x m) weight matrix: rows tile by 128; each 8-bit
    weight takes cells_per_weight adjacent columns."""
    rows = -(-n // hw.array_rows)
    cols = -(-m * hw.cells_per_weight // hw.array_cols)
    return rows * cols


def map_mlp_to_arrays(config: PointNetConfig,
                      hw: HWParams = DEFAULT_HW) -> CrossbarMapping:
    per_stage = []
    for layer in config.layers:
        for (n, m) in layer.mlp_shapes:
            per_stage.append(_arrays_for(n, m, hw))
    return CrossbarMapping(arrays_per_stage=tuple(per_stage),
                           total_arrays=sum(per_stage),
                           budget=hw.n_arrays)
