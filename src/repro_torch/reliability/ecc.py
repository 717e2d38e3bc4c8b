"""ECC-protected crossbar planes: Hamming parity in spare columns, in torch.

The port's counterpart of the JAX package's ``repro.reliability.ecc``, bit
for bit. The plane tensors of a :class:`~repro_torch.kernels.
CrossbarProgram` are padded to a uniform ``d_pad`` edge, so most layers
own spare columns beyond their real width whose outputs ``col_mask``
zeroes anyway. :func:`protect_program` (``build_program(..., ecc=...)``)
splits each row of each cell plane into codewords of ``group`` data cells
and stores a SEC Hamming parity symbol per codeword in the spare columns,
re-padding the whole program one or more crossbar edges wider where a
layer's spare region is too small; :func:`correct_program` decodes the
syndromes and flips single-cell errors back. Codes run per bit lane: lane
``b`` of a codeword collects bit ``b`` of each data cell, and parity cell
``j`` packs one parity bit per lane, so any single faulty cell corrupts at
most one bit per lane and every lane corrects its own error.

Layout per layer (``n_data`` = the layer's real output width)::

    columns [0, n_data)                      data (col_mask = 1)
    columns [n_data, n_data + n_groups * r)  parity cells (col_mask = 0)
    columns beyond                           dead padding, unprotected

Everything here is integer torch arithmetic on the program's tensors, run
once when a model is compiled, on the program's device. On the card the
Hopper kernels compute each layer over its real widths rounded up to their
block edges, so parity cells inside a block edge are read and masked
(``col_mask``), and the wider ``d_pad`` changes only the tensors' strides.
:func:`ecc_overhead` prices the protection from
:class:`~repro_torch.core.energy.HWParams`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.energy import DEFAULT_HW, HWParams
from repro_torch.kernels.program import CROSSBAR, CrossbarProgram

__all__ = [
    "EccConfig", "EccLayerLayout", "EccSpec", "correct_model_program",
    "correct_program", "ecc_overhead", "hamming_r", "protect_program",
]


def hamming_r(k: int) -> int:
    """Parity bits of a SEC Hamming code over ``k`` data bits: the
    smallest ``r`` with ``2**r - r - 1 >= k``."""
    if k < 1:
        raise ValueError(f"codeword needs >= 1 data bit, got {k}")
    r = 2
    while (1 << r) - r - 1 < k:
        r += 1
    return r


def _data_positions(k: int, r: int) -> np.ndarray:
    """Hamming positions (1-based) of the ``k`` data bits: the first
    ``k`` non-power-of-two indices in ``1..k+r``."""
    pos = [i for i in range(1, k + r + 1) if i & (i - 1)]
    return np.asarray(pos[:k], dtype=np.int32)


def _parity_matrix(k: int, r: int) -> np.ndarray:
    """(k, r) 0/1 matrix: ``H[i, j]`` = bit ``j`` of data position ``i``."""
    pos = _data_positions(k, r)
    return ((pos[:, None] >> np.arange(r)[None, :]) & 1).astype(np.int32)


@dataclass(frozen=True)
class EccConfig:
    """``group`` data cells per codeword: smaller groups correct denser
    faults at a higher parity overhead (``hamming_r(group) / group``)."""

    group: int = 16

    def __post_init__(self):
        if self.group < 1:
            raise ValueError(f"group must be >= 1, got {self.group}")


@dataclass(frozen=True)
class EccLayerLayout:
    """Static per-layer codeword geometry."""

    n_data: int        # real output columns (protected data)
    k: int             # data cells per codeword (min(group, n_data))
    r: int             # parity cells per codeword
    n_groups: int      # codewords per (plane, row)
    parity_start: int  # first parity column (== n_data)

    @property
    def parity_cols(self) -> int:
        return self.n_groups * self.r

    @property
    def cols_needed(self) -> int:
        return self.n_data + self.parity_cols


@dataclass(frozen=True)
class EccSpec:
    """The ECC description a protected program carries (``program.ecc``)."""

    group: int
    layouts: tuple[EccLayerLayout, ...]

    @property
    def parity_cols(self) -> int:
        return sum(l.parity_cols for l in self.layouts)


def _layer_layout(n_data: int, group: int) -> EccLayerLayout:
    k = min(group, n_data)
    r = hamming_r(k)
    n_groups = -(-n_data // k)
    return EccLayerLayout(n_data=n_data, k=k, r=r, n_groups=n_groups,
                          parity_start=n_data)


def _lane_bits(cells: torch.Tensor, lane: int) -> torch.Tensor:
    return (cells.to(torch.int32) >> lane) & 1


def _grouped_data(planes_l: torch.Tensor,
                  lay: EccLayerLayout) -> torch.Tensor:
    """(P, d, n_data) data region -> (P, d, n_groups, k), the last group
    zero-padded with virtual (unstored, always-clean) cells."""
    data = planes_l[:, :, :lay.n_data]
    pad = lay.n_groups * lay.k - lay.n_data
    if pad:
        data = torch.nn.functional.pad(data, (0, pad))
    return data.reshape(*data.shape[:-1], lay.n_groups, lay.k)


def _syndrome_bits(bits: torch.Tensor, h: np.ndarray) -> list:
    """``bits @ h (mod 2)`` over the last axis, one ``(…, )`` tensor per
    column of ``h`` (integer matmuls do not run on the card; a masked sum
    per parity bit does, without a ``(…, k, r)`` intermediate)."""
    out = []
    for j in range(h.shape[1]):
        sel = torch.as_tensor(h[:, j], dtype=torch.int32,
                              device=bits.device)
        out.append((bits * sel).sum(dim=-1) % 2)
    return out


def _parity_cells(data_g: torch.Tensor, lay: EccLayerLayout,
                  cell_bits: int) -> torch.Tensor:
    """Encode: (P, d, n_groups, k) data cells -> (P, d, n_groups * r)
    int32 parity cells (one parity bit per lane packed per cell)."""
    h = _parity_matrix(lay.k, lay.r)
    out = torch.zeros(data_g.shape[:-1] + (lay.r,), dtype=torch.int32,
                      device=data_g.device)
    for lane in range(cell_bits):
        par = torch.stack(_syndrome_bits(_lane_bits(data_g, lane), h),
                          dim=-1)
        out = out + (par << lane)
    return out.reshape(*out.shape[:-2], lay.n_groups * lay.r)


def protect_program(program: CrossbarProgram,
                    ecc: EccConfig | bool = True) -> CrossbarProgram:
    """ECC-encode a built program: Hamming parity for every codeword,
    stored in the spare columns, the whole program re-padded one or more
    crossbar edges wider where a layer's spare region is too small (all
    layers share ``d_pad``). Parity sits under ``col_mask = 0``, so a
    protected program computes what its unprotected twin does, bit for
    bit, on every backend."""
    if program.ecc is not None:
        raise ValueError("program is already ECC-protected")
    if ecc is True:
        ecc = EccConfig()
    layouts = tuple(_layer_layout(n, ecc.group)
                    for n in program.widths[1:])
    need = max(max(l.cols_needed for l in layouts), program.d_pad)
    d_new = -(-need // CROSSBAR) * CROSSBAR
    planes = program.planes
    bias, col_mask = program.bias, program.col_mask
    grow = d_new - program.d_pad
    if grow:
        planes = torch.nn.functional.pad(planes, (0, grow, 0, grow))
        bias = torch.nn.functional.pad(bias, (0, grow))
        col_mask = torch.nn.functional.pad(col_mask, (0, grow))
    else:
        planes = planes.clone()
    for l, lay in enumerate(layouts):
        par = _parity_cells(_grouped_data(planes[l], lay), lay,
                            program.cell_bits)
        planes[l, :, :, lay.parity_start:
               lay.parity_start + lay.parity_cols] = par.to(planes.dtype)
    return program.replace(planes=planes.contiguous(), bias=bias,
                           col_mask=col_mask,
                           ecc=EccSpec(group=ecc.group, layouts=layouts))


def correct_program(program: CrossbarProgram) -> CrossbarProgram:
    """The digital scrub in front of the shift-add recombination: decode
    every codeword's syndrome, flip single-cell errors (data or parity
    position) and restore consistent parity. A clean protected program
    round-trips bit for bit; columns beyond the parity region are dead
    padding, left as they are."""
    if program.ecc is None:
        raise ValueError("program has no ECC spec; build it with "
                         "build_program(..., ecc=...) or protect_program")
    planes = program.planes.clone()
    cell_bits = program.cell_bits
    for l, lay in enumerate(program.ecc.layouts):
        h = _parity_matrix(lay.k, lay.r)
        pos = torch.as_tensor(_data_positions(lay.k, lay.r),
                              dtype=torch.int32, device=planes.device)
        weights = torch.as_tensor(1 << np.arange(lay.r), dtype=torch.int32,
                                  device=planes.device)
        data_g = _grouped_data(planes[l], lay)             # (P, d, G, k)
        par = planes[l][:, :, lay.parity_start:
                        lay.parity_start + lay.parity_cols]
        par_g = par.reshape(*par.shape[:-1], lay.n_groups, lay.r)
        fixed = torch.zeros(data_g.shape, dtype=torch.int32,
                            device=planes.device)
        for lane in range(cell_bits):
            bits = _lane_bits(data_g, lane)                # (P, d, G, k)
            pbits = _lane_bits(par_g, lane)                # (P, d, G, r)
            synd = (torch.stack(_syndrome_bits(bits, h), dim=-1)
                    + pbits) % 2                           # (P, d, G, r)
            s = (synd * weights).sum(dim=-1, keepdim=True)  # (P, d, G, 1)
            flip = (s == pos).to(torch.int32)
            fixed = fixed + ((bits ^ flip) << lane)
        data_fixed = fixed.reshape(*fixed.shape[:-2],
                                   lay.n_groups * lay.k)[..., :lay.n_data]
        planes[l, :, :, :lay.n_data] = data_fixed.to(planes.dtype)
        planes[l, :, :, lay.parity_start:
               lay.parity_start + lay.parity_cols] = _parity_cells(
            fixed, lay, cell_bits).to(planes.dtype)
    return program.replace(planes=planes)


def correct_model_program(programs: dict) -> dict:
    """Scrub a whole-model program dict; programs without an ECC spec
    pass through unchanged."""
    def fix(p):
        return correct_program(p) if p.ecc is not None else p
    return {"sa": [fix(p) for p in programs["sa"]],
            "head": fix(programs["head"])}


def ecc_overhead(program: CrossbarProgram,
                 hw: HWParams = DEFAULT_HW) -> dict:
    """The protection bill from :class:`HWParams`: the extra cells,
    columns and crossbar arrays the parity occupies, and the digital
    syndrome-decode energy and cycles of one full scrub. Cell counts use
    the real (unpadded) row heights."""
    if program.ecc is None:
        raise ValueError("program has no ECC spec")
    p = program.n_planes
    data_cells = data_cols = parity_cells = parity_cols = extra_arrays = 0
    for l, lay in enumerate(program.ecc.layouts):
        rows = program.widths[l]
        data_cols += lay.n_data
        parity_cols += lay.parity_cols
        data_cells += p * rows * lay.n_data
        parity_cells += p * rows * lay.parity_cols
        extra_arrays += (-(-rows // hw.array_rows)
                         * -(-lay.parity_cols * hw.cells_per_weight
                             // hw.array_cols))
    cells = data_cells + parity_cells
    return {
        "group": program.ecc.group,
        "data_cols": data_cols,
        "parity_cols": parity_cols,
        "data_cells": data_cells,
        "parity_cells": parity_cells,
        "area_overhead": parity_cols / max(1, data_cols),
        "extra_arrays": extra_arrays,
        "scrub_energy_j": cells * hw.e_ecc_per_cell,
        "scrub_cycles": cells / hw.ecc_cells_per_cycle,
    }
