"""Reliability of the crossbars: ReRAM non-idealities, ECC, Pareto sweeps.

The port's counterpart of ``repro.reliability``:

  * :class:`FaultModel` (``faults``) — seeded conductance noise, stuck-at
    cells and ADC clipping as a transform on crossbar cell planes, drawn on
    the CPU and applied on the planes' device; every backend and dataflow
    inherits it through ``compile_model(fault_model=...)``;
  * ECC (``ecc``) — Hamming parity in the planes' spare columns, encoded at
    ``build_program(..., ecc=...)``, scrubbed by :func:`correct_program`,
    priced by :func:`ecc_overhead`;
  * the Pareto harness (``pareto``) — :func:`sweep`, :func:`pareto_front`
    and :func:`classify_archetypes`.
"""
from repro_torch.reliability.ecc import (EccConfig, EccLayerLayout, EccSpec,
                                         correct_model_program,
                                         correct_program, ecc_overhead,
                                         protect_program)
from repro_torch.reliability.faults import FaultModel
from repro_torch.reliability.pareto import (ArchetypeBands, DesignPoint,
                                            classify_archetypes,
                                            pareto_front, sweep)

__all__ = [
    "ArchetypeBands", "DesignPoint", "EccConfig", "EccLayerLayout",
    "EccSpec", "FaultModel", "classify_archetypes", "correct_model_program",
    "correct_program", "ecc_overhead", "pareto_front", "protect_program",
    "sweep",
]
