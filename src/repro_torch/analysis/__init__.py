"""Launch-contract verification of compiled models (``trace``): the
counterpart of the JAX package's ``repro.analysis.trace``, reading one
recorded call where the reference reads a jaxpr. :func:`verify_contracts`
is the public API (``repro_torch.verify_contracts``)."""
from repro_torch.analysis.trace import (CONTRACTS, ContractReport,
                                        ContractViolation, LaunchRecord,
                                        TraceInfo, trace_info,
                                        verify_contracts)

__all__ = [
    "CONTRACTS",
    "ContractReport",
    "ContractViolation",
    "LaunchRecord",
    "TraceInfo",
    "trace_info",
    "verify_contracts",
]
