"""Launch-contract verifier: check a :class:`CompiledModel`'s calls
against its declared launch and purity contracts.

The counterpart of the JAX package's ``repro.analysis.trace``. The
reference reads a jaxpr, which it gets by running the code once on
abstract values; the port runs the call once, eagerly, as a CUDA-graph
capture would run it (:func:`~repro_torch.kernels.record.as_captured`: the
host-side checks a capture skips are skipped), under three recorders:

  * the launch recorder (:func:`~repro_torch.kernels.record.recording`):
    every kernel entry point notes ``(name, out_shape, dtype)`` on either
    branch, so "exactly ``n_layers`` gather launches, never the per-cloud
    kernel in a batched call" is a count over records on the CPU as on the
    card;
  * a ``TorchDispatchMode`` over every PyTorch op of the call: an op that
    reads a value back to the host (``aten._local_scalar_dense`` — an
    ``.item()``, ``float`` or ``bool`` of a tensor —, ``aten.nonzero``, …)
    is a host round trip, and an op with a float64 result is f64 creep;
  * on the card, ``torch.cuda.set_sync_debug_mode``: every synchronizing
    CUDA operation of the call is a host round trip too. It warns rather
    than raises, so the call runs to its end and every launch is recorded,
    as the reference's trace records every primitive.

``check_graph=True``, the counterpart of ``check_hlo``, checks the artifact
the card replays: the call captured into a CUDA graph (which fails on a
host sync) and one replay's kernels listed by ``torch.profiler``, each
recorded launch matched by its kernel in the replay.

Violations name the offending kernel or op and the SA layer.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from collections import Counter
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.program import MAX_SMEM_BYTES
from repro_torch.kernels.record import (as_captured, inside_launch,
                                         recording)

__all__ = [
    "CONTRACTS",
    "ContractReport",
    "ContractViolation",
    "LaunchRecord",
    "TraceInfo",
    "trace_info",
    "verify_contracts",
]

#: the contract set, in check order (``smem-budget`` is the port's
#: ``vmem-budget``: the card's shared memory in place of the TPU's VMEM;
#: ``graph-launches`` is read only with ``check_graph=True``)
CONTRACTS = ("traceable", "gather-launches", "mlp-launches",
             "host-callbacks", "f64", "smem-budget", "graph-launches")

#: PyTorch ops that read a tensor's value back to the host
_HOST_OPS = {"_local_scalar_dense", "nonzero", "masked_select", "_unique",
             "_unique2", "unique_dim", "unique_consecutive", "equal",
             "allclose", "repeat_interleave"}

#: kernel-name prefix -> launch kind (the reference's prefixes, then the
#: port's FPS loop and its planning kernels P1 and P2)
_KIND_PREFIXES = (
    ("aggregate_diff_batched", "gather-batched"),
    ("aggregate_diff", "gather"),
    ("reram_mlp_fused", "mlp"),
    ("reram_matmul_int", "linear"),
    ("fps", "geometry"),
    ("plan_", "plan"),
)

#: recorded launches -> the device kernels one of them replays (each MLP
#: call of K1/K2/K3 and each K6 product launches the s8 pre-pass once)
_GRAPH_KERNELS = (
    ("gather-launches", ("aggregate_diff",), ("aggregate_diff_kernel",)),
    ("mlp-launches", ("reram_mlp_fused", "reram_matmul_int"),
     ("combine_weights_kernel",)),
    ("graph-launches", ("fps_batched",),
     ("fps_loop_kernel", "fps_stream_kernel")),
    ("graph-launches", ("fps_update",), ("fps_update_kernel",)),
    ("graph-launches", ("plan_greedy",), ("greedy_kernel",)),
    ("graph-launches", ("plan_coordinate",), ("coordinate_kernel",)),
)


# ---------------------------------------------------------------------------
# report types
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ContractViolation:
    """One broken contract, naming the offending kernel or op
    (``primitive``) and, when the contract is per layer, the SA layer index
    (head = ``n_layers``)."""

    contract: str
    message: str
    primitive: str | None = None
    layer: int | None = None

    def __str__(self) -> str:
        where = "".join([
            f" [primitive={self.primitive}]" if self.primitive else "",
            f" [layer={self.layer}]" if self.layer is not None else "",
        ])
        return f"[{self.contract}]{where} {self.message}"


@dataclasses.dataclass(frozen=True)
class LaunchRecord:
    """One kernel launch of the call, in execution order."""

    name: str           # the kernel entry point's name
    kind: str           # gather / gather-batched / mlp / linear / ...
    out_shape: tuple    # the output's shape (batched gathers lead with
                        # the batch: the proof that the whole batch rode
                        # one launch)
    dtype: str = ""     # the output's dtype


@dataclasses.dataclass(frozen=True)
class TraceInfo:
    """What one recorded call showed."""

    launches: tuple[LaunchRecord, ...]
    host_callbacks: tuple[str, ...]
    f64_primitives: tuple[str, ...]
    primitive_counts: dict[str, int]

    @property
    def gather_launches(self) -> int:
        return sum(l.kind in ("gather", "gather-batched")
                   for l in self.launches)

    @property
    def mlp_launches(self) -> int:
        return sum(l.kind == "mlp" for l in self.launches)

    def launches_of(self, kind: str) -> list[LaunchRecord]:
        return [l for l in self.launches if l.kind == kind]


@dataclasses.dataclass
class ContractReport:
    """Everything :func:`verify_contracts` measured plus the violations.
    ``ok`` is the gate; ``raise_if_violated`` formats a hard failure."""

    backend: str
    schedule: dict
    expected_gather_launches: int
    info: TraceInfo | None
    graph: dict | None
    smem_rows: dict[str, dict]
    violations: list[ContractViolation]

    @property
    def ok(self) -> bool:
        return not self.violations

    def raise_if_violated(self) -> "ContractReport":
        if self.violations:
            lines = "\n  ".join(str(v) for v in self.violations)
            raise AssertionError(
                f"launch contracts violated for backend "
                f"'{self.backend}':\n  {lines}")
        return self

    def summary(self) -> dict:
        return {
            "backend": self.backend,
            "schedule": self.schedule,
            "gather_launches": None if self.info is None
            else self.info.gather_launches,
            "expected_gather_launches": self.expected_gather_launches,
            "mlp_launches": None if self.info is None
            else self.info.mlp_launches,
            "host_callbacks": [] if self.info is None
            else list(self.info.host_callbacks),
            "graph": self.graph,
            "smem_rows": self.smem_rows,
            "violations": [str(v) for v in self.violations],
            "ok": self.ok,
        }


# ---------------------------------------------------------------------------
# recording one call
# ---------------------------------------------------------------------------

def _kind_of(name: str) -> str:
    for prefix, kind in _KIND_PREFIXES:
        if name.startswith(prefix):
            return kind
    return "other"


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


class _OpRecorder(TorchDispatchMode):
    """Every PyTorch op of a call outside the kernel entry points: its
    count, the ops that read a value back to the host, and those with a
    float64 result."""

    def __init__(self):
        super().__init__()
        self.counts: Counter = Counter()
        self.host: list[str] = []
        self.f64: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if inside_launch():          # a launch's interior, not the call's
            return out
        op = func.overloadpacket.__name__
        name = f"aten.{op}"
        self.counts[name] += 1
        if op in _HOST_OPS:
            self.host.append(name)
        for t in _tensors(out):
            if t.dtype == torch.float64:
                self.f64.append(f"{name} -> f64{tuple(t.shape)}")
        return out


@contextlib.contextmanager
def _sync_warnings(on_card: bool):
    """On the card, every synchronizing CUDA operation inside the block
    as a warning in the yielded list (``set_sync_debug_mode("warn")``)."""
    caught: list = []
    if not on_card:
        yield caught
        return
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    caught += [str(w.message).splitlines()[0] for w in seen
               if "called a synchronizing" in str(w.message)]


def trace_info(fn: Callable, *args) -> TraceInfo:
    """Run ``fn(*args)`` once, as a capture would, and read off its kernel
    launches, its host round trips and its float64 results. On the card a
    warm-up call runs first, unrecorded, as a capture's does (it fills the
    wrappers' caches, whose first fill copies to the card)."""
    on_card = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    with as_captured():
        if on_card:
            fn(*args)
            torch.cuda.synchronize()
        ops = _OpRecorder()
        with recording() as log, _sync_warnings(on_card) as syncs:
            with ops:
                fn(*args)
    launches = tuple(LaunchRecord(name, _kind_of(name), shape,
                                  str(dtype).removeprefix("torch."))
                     for name, shape, dtype in log)
    host = tuple(ops.host) + tuple(f"cuda-sync: {s}" for s in syncs)
    return TraceInfo(launches, host, tuple(ops.f64), dict(ops.counts))


# ---------------------------------------------------------------------------
# the contracts
# ---------------------------------------------------------------------------

def _gather_contract(info: TraceInfo, expected: int,
                     n_layers: int) -> list[ContractViolation]:
    out: list[ContractViolation] = []
    gathers = [l for l in info.launches
               if l.kind in ("gather", "gather-batched")]
    if len(gathers) > expected:
        extra = gathers[expected]
        out.append(ContractViolation(
            "gather-launches",
            f"expected exactly {expected} gather launch(es) — one per SA "
            f"layer — but the call made {len(gathers)}; launch "
            f"#{expected + 1} ('{extra.name}') has no SA layer",
            primitive=extra.name, layer=min(expected, n_layers)))
    elif len(gathers) < expected:
        out.append(ContractViolation(
            "gather-launches",
            f"expected exactly {expected} gather launch(es) — one per SA "
            f"layer — but the call made only {len(gathers)}; SA layer "
            f"{len(gathers)} issues no gather",
            primitive="aggregate_diff_batched", layer=len(gathers)))
    return out


def _batched_purity(info: TraceInfo,
                    batch: int | None) -> list[ContractViolation]:
    """In a batched call the per-cloud gather kernel must never appear,
    and every batched gather must carry the whole batch."""
    out: list[ContractViolation] = []
    if batch is None:
        return out
    for i, l in enumerate(info.launches_of("gather")):
        out.append(ContractViolation(
            "gather-launches",
            f"per-cloud gather kernel '{l.name}' in a batched call — the "
            f"batch must ride ONE batched launch per SA layer",
            primitive=l.name, layer=i))
    for i, l in enumerate(info.launches_of("gather-batched")):
        if l.out_shape and l.out_shape[0] != batch:
            out.append(ContractViolation(
                "gather-launches",
                f"batched gather launch #{i + 1} carries batch "
                f"{l.out_shape[0]}, expected the full batch of {batch}",
                primitive=l.name, layer=i))
    return out


def _smem_contract(model, budget: int) -> tuple[dict, list]:
    """Every fused launch geometry the model has chosen (its launch cache:
    per MLP, rows per cloud and batch) against ``budget`` bytes of dynamic
    shared memory a block."""
    rows: dict[str, dict] = {}
    violations: list[ContractViolation] = []
    cache = getattr(model.backend, "_launch_cache", None)
    if not cache:
        return rows, violations
    n_layers = model.config.n_layers
    for (key, m_rows, batch), geom in sorted(cache.items(),
                                             key=lambda kv: str(kv[0])):
        label = "head" if key == "head" else f"sa{key[1]}"
        row = f"{label}@{m_rows}" + (f"x{batch}" if batch != 1 else "")
        smem = max(geom.smem_bytes, default=0)
        rows[row] = {"mode": geom.mode, "smem_bytes": list(geom.smem_bytes),
                     "fits_budget": smem <= budget}
        if smem > budget:
            layer = n_layers if key == "head" else key[1]
            violations.append(ContractViolation(
                "smem-budget",
                f"fused launch for MLP '{label}' at {m_rows} rows x batch "
                f"{batch} (mode={geom.mode}) needs {smem} B of shared "
                f"memory a block, over the {budget} B budget",
                primitive=f"reram_mlp_fused_{geom.mode}", layer=layer))
    return rows, violations


#: seconds the card is left idle at the start of the replay's profiling
#: session, after a synchronize: ``torch.profiler`` drops the device records
#: of launches made in the first milliseconds of a session, now and then
#: (measured on an H100: up to 171 of 586 launches in about 1% of sessions;
#: none of 600 after a 5 ms pause)
PROFILE_SETTLE_S = 0.02


def _graph_contract(fn, x, info: TraceInfo, rules) -> tuple[dict, list]:
    """Capture ``fn(x)`` into a CUDA graph, list one replay's kernels with
    ``torch.profiler`` and match them against the recorded launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.backend import CudaGraphCall
    violations: list[ContractViolation] = []
    try:
        call = CudaGraphCall(fn, (x,))
    except RuntimeError as e:
        if "host-callbacks" in rules:
            violations.append(ContractViolation(
                "host-callbacks",
                f"the call does not capture into a CUDA graph (a host "
                f"round trip inside it?): {str(e).splitlines()[0]}"))
        return {"captured": False}, violations
    call(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
        call(x)
        torch.cuda.synchronize()
    kernels: Counter = Counter()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] += e.count
    graph = {"captured": True, "kernel_launches": sum(kernels.values()),
             "kernels": dict(kernels)}
    for contract, names, device_names in _GRAPH_KERNELS:
        want = sum(l.name.startswith(names) for l in info.launches)
        got = sum(n for k, n in kernels.items()
                  if any(d in k for d in device_names))
        if want != got and contract in rules:
            violations.append(ContractViolation(
                contract,
                f"the captured call replays {got} launch(es) of "
                f"{'/'.join(device_names)}, the eager call recorded {want} "
                f"of {'/'.join(names)}", primitive=device_names[0]))
    return graph, violations


def verify_contracts(model, x, *, rules: tuple = CONTRACTS,
                     expected_gather_launches: int | None = None,
                     smem_budget: int = MAX_SMEM_BYTES,
                     check_graph: bool = False) -> ContractReport:
    """Verify ``model``'s launch contracts on example input ``x`` ((N, 3)
    cloud -> ``forward``; (B, N, 3) -> ``batched_forward``), on the
    model's device.

    Checks (select with ``rules``):

      * ``traceable``      — the call can be captured whole: a model that
        plans on the host per cloud cannot (``jit_*`` refuses it), and
        reports this one violation and nothing else;
      * ``gather-launches``— exactly ``n_layers`` gather launches for a
        planned model (0 for 'baseline'), in a batched call the batched
        kernel with the full batch, never the per-cloud one;
      * ``mlp-launches``   — batch-in-grid backends run each MLP as ONE
        fused call: ``n_layers + 1`` (head included);
      * ``host-callbacks`` — no op reads a value back to the host, and on
        the card no synchronizing CUDA operation;
      * ``f64``            — no op has a float64 result;
      * ``smem-budget``    — every fused launch geometry the model chose
        fits ``smem_budget`` bytes of shared memory a block;
      * ``graph-launches`` — with ``check_graph``: the captured call's FPS,
        P1 and P2 kernels match the eager call's launches.

    ``check_graph=True`` also captures the call into a CUDA graph and
    lists one replay's kernels (``torch.profiler``): every recorded
    gather, MLP, FPS, P1 and P2 launch must be there, and the capture
    fails on a host sync. It needs the card (``ValueError`` on the CPU).
    Returns a :class:`ContractReport`.
    """
    x = torch.as_tensor(x)
    if x.ndim == 3:
        fn, batch = model.batched_forward, int(x.shape[0])
    elif x.ndim == 2:
        fn, batch = model.forward, None
    else:
        raise ValueError(f"x must be a (N, 3) cloud or (B, N, 3) batch; "
                         f"got shape {tuple(x.shape)}")
    device = getattr(model, "device", x.device)
    if check_graph and torch.device(device).type != "cuda":
        raise ValueError("check_graph=True captures the call into a CUDA "
                         "graph; it needs a model on the card")
    x = x.to(device=device, dtype=torch.float32).contiguous()
    n_layers = model.config.n_layers
    if expected_gather_launches is None:
        expected_gather_launches = n_layers if model.planned else 0
    report = ContractReport(
        backend=model.backend_name, schedule=model.schedule,
        expected_gather_launches=expected_gather_launches,
        info=None, graph=None, smem_rows={}, violations=[])

    require = getattr(model, "_require_traceable", None)
    try:
        if require is not None:
            require(fn.__name__)
    except TypeError as e:
        report.violations.append(ContractViolation(
            "traceable", f"{fn.__name__} cannot be captured whole: {e}"))
        return report
    info = trace_info(fn, x)
    report.info = info

    if "gather-launches" in rules:
        report.violations += _gather_contract(
            info, expected_gather_launches, n_layers)
        report.violations += _batched_purity(info, batch)
    if "mlp-launches" in rules and model.backend.batched_in_grid:
        expected_mlp = n_layers + 1            # one per SA MLP + the head
        if info.mlp_launches != expected_mlp:
            report.violations.append(ContractViolation(
                "mlp-launches",
                f"batch-in-grid backend must run each MLP as ONE fused "
                f"call: expected {expected_mlp} fused-MLP launches "
                f"({n_layers} SA + head), got {info.mlp_launches}",
                primitive="reram_mlp_fused",
                layer=min(info.mlp_launches, n_layers)))
    if "host-callbacks" in rules:
        for prim in info.host_callbacks:
            report.violations.append(ContractViolation(
                "host-callbacks",
                f"host round trip '{prim}' inside the call — the captured "
                f"pipeline must not read values back to the host",
                primitive=prim))
    if "f64" in rules:
        for entry in info.f64_primitives:
            report.violations.append(ContractViolation(
                "f64", f"float64 creep in the call: {entry}",
                primitive=entry.split(" ")[0]))
    if "smem-budget" in rules:
        report.smem_rows, v = _smem_contract(model, smem_budget)
        report.violations += v
    if check_graph:
        report.graph, v = _graph_contract(fn, x, info, rules)
        report.violations += v
    return report
