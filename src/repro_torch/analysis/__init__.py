"""Static and launch-contract analysis of the port: ``trace``, the
counterpart of the JAX package's ``repro.analysis.trace``, reading one
recorded call where the reference reads a jaxpr (:func:`verify_contracts`
is the public API, ``repro_torch.verify_contracts``); and ``lint``, the
counterpart of ``repro.analysis.lint``, its ``host-sync`` rule rooted at
the port's capture sites and kernel entry points (:func:`lint_paths`;
``python -m repro_torch.analysis`` lints ``src/repro_torch`` and
``examples/*_torch.py``)."""
from repro_torch.analysis import lint
from repro_torch.analysis.lint import Finding, lint_paths, lint_source
from repro_torch.analysis.trace import (CONTRACTS, ContractReport,
                                        ContractViolation, LaunchRecord,
                                        TraceInfo, trace_info,
                                        verify_contracts)

__all__ = [
    "CONTRACTS",
    "ContractReport",
    "ContractViolation",
    "Finding",
    "LaunchRecord",
    "TraceInfo",
    "lint",
    "lint_paths",
    "lint_source",
    "trace_info",
    "verify_contracts",
]
