"""ReRAM non-ideality injection, in torch.

The port's counterpart of the JAX package's ``repro.reliability.faults``.
:class:`FaultModel` describes conductance noise, stuck-at cells and ADC
clipping as a transform on the ``(..., K, N)`` int8 offset-binary cell
planes a :class:`~repro_torch.kernels.CrossbarProgram` stores and every
kernel consumes, so every backend and dataflow inherits the faults
unchanged. Per cell (level domain, ``levels = 2**cell_bits``):

  1. conductance noise — ``g = c + sigma * N(0, 1)`` (the product and the
     sum each rounded to float32, no fused multiply-add);
  2. ADC read-out — ``round`` (half to even) then clip to ``[0,
     min(levels, 2**adc_bits) - 1]``;
  3. stuck-at masks — cells whose uniform draw is below ``p_stuck0`` read
     level 0, then those below ``p_stuck1`` (an independent draw) read
     ``levels - 1``: physical defects override what was programmed.

The transform is split in two. :func:`fault_transform` is a pure function
of the planes and the draws; :meth:`FaultModel.draw` makes the draws. The
draws come from CPU ``torch.Generator`` streams seeded from ``(seed,
*site)`` (a site is the MLP and the layer, as the reference's
``key_for``/``apply_model_program`` fold them in), three independent
streams per site (noise, stuck-at-0, stuck-at-1), and only then move to
the planes' device — so the CPU and the card see the same faults. The port
does not reimplement ``jax.random``: the same seed gives other faults than
the reference's, and the tests feed the reference's own draws to
:func:`fault_transform` to hold the two to each other. A zero-fault model
is the identity and returns the program object itself.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["FaultDraws", "FaultModel", "fault_transform"]


class FaultDraws(NamedTuple):
    """One site's draws, each of the planes' shape (None where the model
    needs none): standard normal ``noise`` and uniform ``[0, 1)``
    ``u_stuck0``/``u_stuck1``, float32."""

    noise: torch.Tensor | None
    u_stuck0: torch.Tensor | None
    u_stuck1: torch.Tensor | None

    def to(self, device) -> "FaultDraws":
        return FaultDraws(*(None if t is None else t.to(device)
                            for t in self))


def fault_transform(planes: torch.Tensor, draws: FaultDraws, *,
                    sigma: float, p_stuck0: float, p_stuck1: float,
                    adc_bits: int | None, cell_bits: int = 2
                    ) -> torch.Tensor:
    """The fault transform as a pure function of ``planes`` and ``draws``
    (the reference's ``transform_planes`` after its draws): noise, round
    half to even, clip to the ADC's top level, stuck-at-0, stuck-at-1.
    Same dtype and shape as ``planes``."""
    levels = 1 << cell_bits
    g = planes.to(torch.float32)
    if sigma > 0.0:
        g = g + draws.noise * sigma
    hi = levels - 1
    if adc_bits is not None:
        hi = min(hi, (1 << adc_bits) - 1)
    out = torch.clamp(torch.round(g), 0, hi).to(planes.dtype)
    if p_stuck0 > 0.0:
        out = torch.where(draws.u_stuck0 < p_stuck0,
                          torch.zeros_like(out), out)
    if p_stuck1 > 0.0:
        out = torch.where(draws.u_stuck1 < p_stuck1,
                          torch.full_like(out, levels - 1), out)
    return out


@dataclass(frozen=True)
class FaultModel:
    """Seeded description of ReRAM cell non-idealities.

    sigma    : Gaussian conductance noise std, in cell-level units.
    p_stuck0 : per-cell probability of stuck-at-0 (lowest level).
    p_stuck1 : per-cell probability of stuck-at-1 (highest level).
    adc_bits : ADC resolution in bits; levels above ``2**adc_bits - 1``
               clip (None = no clipping).
    seed     : base seed; :meth:`draw` derives each site's streams from it.
    """

    sigma: float = 0.0
    p_stuck0: float = 0.0
    p_stuck1: float = 0.0
    adc_bits: int | None = None
    seed: int = 0

    def __post_init__(self):
        if self.sigma < 0:
            raise ValueError(f"sigma must be >= 0, got {self.sigma}")
        for name in ("p_stuck0", "p_stuck1"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if self.adc_bits is not None and self.adc_bits < 1:
            raise ValueError(f"adc_bits must be >= 1, got {self.adc_bits}")

    # -- identity ----------------------------------------------------------

    def is_ideal_for(self, cell_bits: int) -> bool:
        """True when the transform is the identity on ``cell_bits`` cells
        (an ADC at least as wide as the cell clips nothing)."""
        return (self.sigma == 0.0 and self.p_stuck0 == 0.0
                and self.p_stuck1 == 0.0
                and (self.adc_bits is None or self.adc_bits >= cell_bits))

    @property
    def is_ideal(self) -> bool:
        """True when no non-ideality is configured at all."""
        return (self.sigma == 0.0 and self.p_stuck0 == 0.0
                and self.p_stuck1 == 0.0 and self.adc_bits is None)

    # -- draws -------------------------------------------------------------

    def _generator(self, site: tuple, stream: int) -> torch.Generator:
        entropy = [self.seed % 2 ** 64, *(int(i) for i in site), stream]
        state = np.random.SeedSequence(entropy).generate_state(
            1, np.uint64)[0]
        return torch.Generator(device="cpu").manual_seed(int(state) >> 1)

    def draw(self, shape, *site: int, device=None) -> FaultDraws:
        """The draws of site ``site`` (e.g. MLP index, layer index) for
        planes of ``shape``: made on the CPU, one ``torch.Generator`` per
        stream seeded from ``(seed, *site, stream)``, then moved to
        ``device``. Identical arguments give identical draws; only the
        draws the model needs are made."""
        shape = tuple(int(s) for s in shape)
        noise = u0 = u1 = None
        if self.sigma > 0.0:
            noise = torch.randn(shape, generator=self._generator(site, 0),
                                dtype=torch.float32)
        if self.p_stuck0 > 0.0:
            u0 = torch.rand(shape, generator=self._generator(site, 1),
                            dtype=torch.float32)
        if self.p_stuck1 > 0.0:
            u1 = torch.rand(shape, generator=self._generator(site, 2),
                            dtype=torch.float32)
        draws = FaultDraws(noise, u0, u1)
        return draws if device is None else draws.to(device)

    # -- the transform -----------------------------------------------------

    def transform_planes(self, planes: torch.Tensor, key=(), *,
                         cell_bits: int = 2) -> torch.Tensor:
        """Inject faults into an offset-binary cell-plane tensor of any
        shape (each element one cell, values in ``[0, 2**cell_bits)``).
        ``key`` is a site tuple (drawn here, on the CPU) or a
        :class:`FaultDraws` made before — a caller that must not draw
        inside a call, as a captured one, passes draws. The identity
        (the same tensor) when :meth:`is_ideal_for` holds."""
        if self.is_ideal_for(cell_bits):
            return planes
        draws = (key if isinstance(key, FaultDraws)
                 else self.draw(planes.shape, *key))
        return fault_transform(planes, draws.to(planes.device),
                               sigma=self.sigma, p_stuck0=self.p_stuck0,
                               p_stuck1=self.p_stuck1,
                               adc_bits=self.adc_bits, cell_bits=cell_bits)

    def apply(self, program, site: tuple = ()):
        """Faulty twin of a :class:`~repro_torch.kernels.CrossbarProgram`:
        same layout (widths, bit geometry, ECC spec), planes through
        :meth:`transform_planes` at ``site``. The ideal model returns the
        program object unchanged."""
        if self.is_ideal_for(program.cell_bits):
            return program
        return program.replace(planes=self.transform_planes(
            program.planes, tuple(site), cell_bits=program.cell_bits))

    def apply_model_program(self, programs: dict, site: tuple = ()) -> dict:
        """Inject into a whole-model program dict (``{"sa": [...], "head":
        ...}`` of :func:`~repro_torch.models.pointnet2.
        build_model_program`), each MLP at its own site: ``(*site, i + 1)``
        for SA layer i, ``(*site, 0)`` for the head, as the reference folds
        its keys."""
        site = tuple(site)
        sa = [self.apply(p, site + (i + 1,))
              for i, p in enumerate(programs["sa"])]
        head = self.apply(programs["head"], site + (0,))
        return {"sa": sa, "head": head}
