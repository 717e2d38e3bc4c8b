"""Unified backend/compile API: ``compile_model`` + the backend registry.

The counterpart of the JAX package's ``repro.models.backend``, in torch.
Lifecycle — the same three phases as the accelerator:

  program : ``compile_model(params, config, backend=...)`` resolves the
            backend by name and lets it do its one-time work (the
            'reram-fused' backend quantizes + plane-encodes every MLP into
            a :class:`~repro_torch.kernels.CrossbarProgram` here, exactly
            once), then moves the model to its device.
  plan    : ``policy=`` hands the scheduling decisions to a
            :class:`~repro_torch.core.policy.PlanPolicy` cost model (the
            fused dataflow launched on the card, and the intra-layer order
            per workload unless ``schedule=`` pins it; a precommitted
            policy plans on the card like a preset).
            ``schedule=`` pins the execution order (paper Algorithm 1):
            ``"baseline"`` is plain layer-by-layer index order; any other
            preset / ``{"intra": ..., "coordinated": ...}`` spec routes
            execution through a per-cloud plan built from the forward's own
            geometry — on the device by default (``device_planning``: the
            ``device_*`` twins of ``core/schedule.py``, greedy through P1
            and coordination through P2), on the host with
            ``device_planning=False``; a prebuilt ``ExecutionPlan`` is
            lowered here, once, into a :class:`DevicePlan` (also accepted
            directly, possibly batched).
  execute : ``CompiledModel.forward``/``batched_forward``. Under a plan,
            each SA layer runs its centers in plan order through the gather
            kernels (``aggregate_diff`` for one cloud, one
            ``aggregate_diff_batched`` launch per layer for a batch), which
            read the plan order and the index-order geometry themselves,
            the MLP runs through the backend's kernels, and the per-center
            max is scattered back to index order — so logits are bitwise
            invariant to the order. ``jit_forward``/``jit_batched_forward``
            (and ``eval_step``) capture one call per input shape into a CUDA
            graph and replay it.

Devices: a compiled model runs on ``cuda`` unless ``compile_model`` is given
``device="cpu"``, and raises when asked for a card that is not there. On
the card every kernel wrapper launches its CUDA kernel; on the CPU it runs
its plain torch version. Nothing falls back from one to the other.

Under device planning a call makes no host transfer (no ``.cpu()``,
``.item()`` or ``bool`` of a tensor), which is what lets it be captured.
Host planning pulls the geometry with ``.cpu()``, builds the plan with the
NumPy planner and lowers it with ``DevicePlan.lower`` (the JAX package's
``device_planning=False`` path); only it records the plan-ordered neighbor
streams that :meth:`CompiledModel.stats` reports after a call.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.core.energy import TPU_ROOFLINE
from repro_torch.core.policy import DEFAULT_POLICY, PlanPolicy
from repro_torch.core.schedule import (GREEDY_DENSE_LIMIT, DevicePlan,
                                       ExecutionPlan, MODE_PRESETS,
                                       build_plan, complete_order,
                                       device_build_plan)
from repro_torch.core.workload import PointNetConfig, PointNetWorkload
from repro_torch.kernels import (FUSED_MODES, aggregate_diff,
                                 aggregate_diff_batched, count_dma_elisions,
                                 plan_fused_mlp, reram_linear,
                                 reram_mlp_fused, reram_mlp_fused_batched)
from repro_torch.kernels.program import (launch_count, launch_work,
                                         mtiled_on_chip, plan_launch,
                                         require_finite)
from repro_torch.reliability.faults import FaultDraws
from repro_torch.models import pointnet2 as _pn

__all__ = [
    "Backend",
    "CompiledModel",
    "FloatBackend",
    "ReramFusedBackend",
    "ReramFusedMTiledBackend",
    "ReramFusedWStatBackend",
    "ReramPerLayerBackend",
    "available_backends",
    "compile_model",
    "graph_key",
    "register_backend",
    "resolve_device",
]

Params = Any

# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type["Backend"]] = {}


def register_backend(name: str) -> Callable[[type], type]:
    """Class decorator: make ``compile_model(..., backend=name)`` resolve to
    the decorated :class:`Backend` subclass (latest registration wins)."""
    def deco(cls: type) -> type:
        if "name" not in vars(cls):
            cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def available_backends() -> list[str]:
    """Registered backend names, sorted."""
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# backends: how one MLP is applied
# ---------------------------------------------------------------------------

class Backend(nn.Module):
    """One way of running the model's MLPs. ``key`` addresses an MLP:
    ``("sa", i)`` for SA layer i's MLP, ``"head"`` for the classification
    head. ``apply_mlp`` accepts any leading dims on ``x``;
    ``apply_mlp_batched`` treats axis 0 as a batch of independent clouds."""

    name = "?"
    #: True where each MLP is one kernel call for the whole batch (the
    #: fused backends): the verifier's ``mlp-launches`` contract holds
    #: them to one launch per MLP, as the reference does.
    batched_in_grid = False
    #: True where the weights are the caller's tensors and a loss carries
    #: gradients to them ('float'); False where they are buffers of their
    #: own (the crossbar backends).
    trainable = False
    #: :class:`~repro_torch.core.policy.PlanPolicy` stamped by
    #: ``compile_model`` (None without one); the fused backends consult it
    #: for their dataflow choices.
    policy: PlanPolicy | None = None

    def __init__(self, params: Params, config: PointNetConfig):
        super().__init__()
        self.config = config

    def apply_mlp(self, key, x, *, final_relu: bool = True):
        raise NotImplementedError

    def apply_mlp_batched(self, key, x, *, final_relu: bool = True):
        return self.apply_mlp(key, x, final_relu=final_relu)

    def stats(self) -> dict:
        """What the backend programmed: ``program_bytes``, the crossbar
        programs' bytes (none for a backend without programs)."""
        return {"program_bytes": 0}


class _FloatMLP(nn.Module):
    """One float MLP's weights and biases, as buffers. With ``keep``, a
    leaf that requires grad is the caller's tensor itself (float32), so a
    loss carries gradients to it and an in-place update of it is what the
    next call reads; every other leaf is copied."""

    def __init__(self, layers, keep: bool = False):
        super().__init__()
        self.n = len(layers)
        for i, lyr in enumerate(layers):
            for part in ("w", "b"):
                t = lyr[part]
                if keep and isinstance(t, torch.Tensor) and t.requires_grad:
                    if t.dtype != torch.float32:
                        raise TypeError(f"a trained leaf must be float32; "
                                        f"got {t.dtype}")
                else:
                    t = torch.as_tensor(t, dtype=torch.float32).clone()
                self.register_buffer(f"{part}{i}", t)

    def layers(self) -> list[dict]:
        return [{"w": getattr(self, f"w{i}"), "b": getattr(self, f"b{i}")}
                for i in range(self.n)]


@register_backend("float")
class FloatBackend(Backend):
    """Plain float32 ``x @ w + b`` (``torch.matmul``; the JAX package's
    float backend has no Pallas kernel either). The weights that require
    grad are the caller's tensors, not copies (:class:`_FloatMLP`), so
    :meth:`CompiledModel.loss_fn` carries gradients to them."""

    trainable = True

    def __init__(self, params, config):
        super().__init__(params, config)
        keep = type(self).trainable
        self.sa = nn.ModuleList(_FloatMLP(m, keep) for m in params["sa"])
        self.head = _FloatMLP(params["head"], keep)

    def _mlp(self, key) -> _FloatMLP:
        return self.head if key == "head" else self.sa[key[1]]

    def apply_mlp(self, key, x, *, final_relu=True):
        return _pn._apply_mlp(self._mlp(key).layers(), x,
                              final_relu=final_relu)


@register_backend("reram")
class ReramPerLayerBackend(FloatBackend):
    """Per-layer bit-sliced INT8 crossbar matmuls (``reram_linear`` over
    K6): the same arithmetic as the fused path, but every weight is
    quantized and plane-encoded anew on every call, one kernel launch per
    layer. The reference the fused kernels are tested against. A batch
    quantizes each cloud under its own scale, as a per-cloud loop does, and
    runs each layer as one launch over all clouds' rows.

    Every weight is checked for NaN/Inf once, here, with the
    ``ValueError`` the JAX package raises on its first call; the calls then
    quantize the weights without the check's host sync.

    ``fault_model`` (a :class:`~repro_torch.reliability.FaultModel`)
    injects ReRAM non-idealities into each product's freshly encoded
    planes, site ``(mlp, layer)`` (the head MLP 0, SA layer i's MLP i + 1)
    as the reference keys them. The reference draws the same faults on
    every call, so each site's draws are made once, here, and kept as
    buffers: a call draws nothing, and a captured call replays the same
    faults. The zero-fault model takes the ideal path bit for bit. The
    weights are copies, whatever requires grad: the loss carries no
    gradient."""

    trainable = False

    def __init__(self, params, config, *, fault_model=None):
        super().__init__(params, config)
        for mlp in (*self.sa, self.head):
            for lyr in mlp.layers():
                require_finite(lyr["w"])
        self.fault_model = fault_model
        if fault_model is None or fault_model.is_ideal:
            return
        for key in (*(("sa", i) for i in range(len(self.sa))), "head"):
            for l, lyr in enumerate(self._mlp(key).layers()):
                # the four 2-bit cell planes of an 8-bit weight
                draws = fault_model.draw((4, *lyr["w"].shape),
                                         _mlp_index(key), l)
                for part, t in zip(("noise", "u0", "u1"), draws):
                    self.register_buffer(_draw_name(key, l, part), t)

    def fault_draws(self, key, layer: int) -> FaultDraws:
        """The draws of site ``(mlp, layer)`` made when the backend was
        built, on the model's device."""
        return FaultDraws(*(getattr(self, _draw_name(key, layer, part))
                            for part in ("noise", "u0", "u1")))

    def _matmul(self, key, batched: bool):
        fm = self.fault_model
        if fm is None or fm.is_ideal:
            return lambda a, w: reram_linear(a, w, batched=batched,
                                             check_weights=False)
        layer = iter(range(len(self._mlp(key).layers())))

        def mm(a, w):
            return reram_linear(a, w, batched=batched, check_weights=False,
                                fault_model=fm,
                                fault_key=self.fault_draws(key, next(layer)))
        return mm

    def apply_mlp(self, key, x, *, final_relu=True):
        return _pn._apply_mlp(self._mlp(key).layers(), x,
                              final_relu=final_relu,
                              matmul=self._matmul(key, False))

    def apply_mlp_batched(self, key, x, *, final_relu=True):
        return _pn._apply_mlp(self._mlp(key).layers(), x,
                              final_relu=final_relu,
                              matmul=self._matmul(key, True))


def _mlp_index(key) -> int:
    """The MLP's index in a fault site: 0 for the head, i + 1 for SA layer
    i (the reference's fold-in order)."""
    return 0 if key == "head" else key[1] + 1


def _draw_name(key, layer: int, part: str) -> str:
    return f"fault_{_mlp_index(key)}_{layer}_{part}"


def _tpu_policy(policy):
    """``policy`` as the JAX package holds it, for the reference's TPU
    dataflow rows: the TPU's roofline (:data:`~repro_torch.core.energy.
    TPU_ROOFLINE`) and the TPU's VMEM budget, unless ``policy`` set a
    budget apart from its own roofline's on-chip memory. None stays None
    (the reference's first-fit walk)."""
    if policy is None:
        return None
    own = policy.vmem_budget != policy.hw.vmem_bytes
    return dataclasses.replace(policy, hw=TPU_ROOFLINE,
                               vmem_budget=policy.vmem_budget if own else 0)


@register_backend("reram-fused")
class ReramFusedBackend(Backend):
    """Weight-stationary path: every MLP programmed into crossbar planes
    exactly once at compile time (or pass a prebuilt ``program=`` from
    :func:`~repro_torch.models.pointnet2.build_model_program`), then each
    MLP runs through one fused kernel call. ``mode`` pins the dataflow
    ('whole'/'tiled' -> K1, 'mtiled' -> K2, 'wstat' -> K3); by default the
    Hopper choice runs — the compiled policy's
    :meth:`~repro_torch.core.policy.PlanPolicy.select_launch`, else
    :data:`~repro_torch.core.policy.DEFAULT_POLICY`'s — per MLP, row count
    and batch size, made once per shape. The reference's TPU choice
    (:func:`plan_fused_mlp` under the policy's TPU twin,
    :func:`_tpu_policy`) is reported beside it in :meth:`stats`.

    ``ecc`` (an :class:`~repro_torch.reliability.EccConfig`) protects the
    programs with Hamming parity in their spare columns; ``fault_model``
    (a :class:`~repro_torch.reliability.FaultModel`) then injects faults
    into the planes and the ECC scrub corrects them, once, here — the
    kernels run the post-scrub planes."""

    #: the dataflow this registry entry pins (None: chosen per shape)
    mode: str | None = None
    batched_in_grid = True

    def __init__(self, params, config, *, program=None,
                 mode: str | None = None, ecc=None, fault_model=None):
        super().__init__(params, config)
        if mode is not None and mode not in FUSED_MODES:
            raise ValueError(f"mode={mode!r} must be one of {FUSED_MODES}")
        if program is None:
            program = _pn.build_model_program(params, ecc=ecc)
        elif ecc is not None:
            raise ValueError(
                "pass ecc= to build_model_program when prebuilding the "
                "program, not alongside program=")
        if fault_model is not None and not fault_model.is_ideal:
            # protect (at build) -> inject -> correct; without ECC the
            # correction passes the faulted planes through unchanged
            from repro_torch.reliability.ecc import correct_model_program
            program = correct_model_program(
                fault_model.apply_model_program(program))
        self.sa = nn.ModuleList(program["sa"])
        self.head = program["head"]
        self.fault_model = fault_model
        self.mode = mode if mode is not None else type(self).mode
        self._plan_cache: dict = {}
        self._launch_cache: dict = {}

    def _prog(self, key):
        return self.head if key == "head" else self.sa[key[1]]

    @property
    def program(self) -> dict:
        return {"sa": list(self.sa), "head": self.head}

    def fused_plan(self, key, m_rows: int):
        """The reference's TPU dataflow for MLP ``key`` at ``m_rows`` rows
        per cloud (:func:`plan_fused_mlp` under the compiled policy's TPU
        twin, :func:`_tpu_policy`), made once per (MLP, rows) and
        cached."""
        ck = (key, int(m_rows))
        if ck not in self._plan_cache:
            self._plan_cache[ck] = plan_fused_mlp(
                self._prog(key), m_rows, mode=self.mode,
                policy=_tpu_policy(self.policy))
        return self._plan_cache[ck]

    def launch_plan(self, key, m_rows: int, batch: int = 1):
        """The Hopper launch geometry MLP ``key`` runs at ``m_rows`` rows
        per cloud and ``batch`` clouds: the pinned mode's, else the policy's
        choice (:meth:`~repro_torch.core.policy.PlanPolicy.select_launch`),
        made once per shape and cached."""
        ck = (key, int(m_rows), int(batch))
        if ck not in self._launch_cache:
            prog = self._prog(key)
            self._launch_cache[ck] = (
                plan_launch(prog, m_rows, self.mode)
                if self.mode is not None else
                (self.policy or DEFAULT_POLICY).select_launch(
                    prog, m_rows, batch=batch))
        return self._launch_cache[ck]

    def apply_mlp(self, key, x, *, final_relu=True):
        geom = self.launch_plan(key, math.prod(x.shape[:-1]))
        return reram_mlp_fused(x, self._prog(key), final_relu=final_relu,
                               mode=geom.mode)

    def apply_mlp_batched(self, key, x, *, final_relu=True):
        geom = self.launch_plan(key, math.prod(x.shape[1:-1]), x.shape[0])
        return reram_mlp_fused_batched(x, self._prog(key),
                                       final_relu=final_relu, mode=geom.mode)

    def stats(self) -> dict:
        """Program bytes, in all and per MLP (laid out as the JAX
        package's, so the counts agree); per MLP at the rows one cloud
        gives it, the reference's TPU dataflow row (``fused_plan``,
        :meth:`_plan_row`) and beside it the Hopper launch the port runs
        for one cloud (``launch_plan``, :meth:`_launch_row`); and under
        ``reliability`` the fault model and the summed ECC overhead, when
        there are any."""
        progs = {f"sa{i}": p for i, p in enumerate(self.sa)}
        progs["head"] = self.head
        nbytes = {k: sum(b.numel() * b.element_size() for b in p.buffers())
                  for k, p in progs.items()}
        keys = {f"sa{i}": (("sa", i), spec.n_centers * spec.n_neighbors)
                for i, spec in enumerate(self.config.layers)}
        keys["head"] = ("head", 1)
        out = {"program_bytes": sum(nbytes.values()),
               "program_bytes_per_mlp": nbytes,
               "fused_plan": {k: self._plan_row(*v)
                              for k, v in keys.items()},
               "launch_plan": {k: self._launch_row(*v)
                               for k, v in keys.items()}}
        rel = {}
        if self.fault_model is not None:
            rel["fault_model"] = dataclasses.asdict(self.fault_model)
        protected = {k: p for k, p in progs.items() if p.ecc is not None}
        if protected:
            from repro_torch.reliability.ecc import ecc_overhead
            per = {k: ecc_overhead(p) for k, p in protected.items()}
            rel["ecc"] = {
                "per_mlp": per,
                "parity_cells": sum(o["parity_cells"] for o in per.values()),
                "extra_arrays": sum(o["extra_arrays"] for o in per.values()),
                "scrub_energy_j": sum(o["scrub_energy_j"]
                                      for o in per.values()),
                "scrub_cycles": sum(o["scrub_cycles"] for o in per.values()),
            }
        if rel:
            out["reliability"] = rel
        return out

    def _plan_row(self, key, rows) -> dict:
        """The JAX package's ``fused_plan`` row of MLP ``key`` at ``rows``
        rows: the mode, the TPU tile edge and VMEM bytes it rests on, and
        that dataflow's HBM accounting on the TPU."""
        fp = self.fused_plan(key, rows)
        return {"mode": fp.mode, "block_n": fp.block_n,
                "vmem_bytes": fp.vmem_bytes,
                "fits_budget": fp.fits_budget,
                "plane_tile_fetches_per_layer":
                    fp.plane_tile_fetches_per_layer,
                "plane_hbm_bytes_per_layer": fp.plane_hbm_bytes_per_layer,
                "act_hbm_bytes_per_layer": fp.act_hbm_bytes_per_layer}

    def _launch_row(self, key, rows) -> dict:
        """The Hopper launch of MLP ``key`` for one cloud of ``rows`` rows:
        the kernel and mode, each layer launch's dynamic shared memory and
        blocks, the call's launches, and the policy's predicted
        device-memory bytes and cycles."""
        geom = self.launch_plan(key, rows)
        prog, mode = self._prog(key), geom.mode
        policy = self.policy or DEFAULT_POLICY
        kernel = {"whole": "K1", "tiled": "K1", "mtiled": "K2",
                  "wstat": "K3"}[mode]
        if mode == "mtiled" and not mtiled_on_chip(geom):
            kernel = "K1"
        work = launch_work(prog, rows, mode, sms=policy.hw.sms)
        return {"kernel": kernel, "mode": mode,
                "smem_bytes": list(geom.smem_bytes),
                "blocks": [w.blocks for w in work if w.blocks],
                "launches": launch_count(prog, mode),
                "predicted_bytes": policy.predict_device_bytes(prog, rows,
                                                               mode),
                "predicted_cycles": policy.launch_cost(prog, rows, mode)}


@register_backend("reram-fused-mtiled")
class ReramFusedMTiledBackend(ReramFusedBackend):
    """'reram-fused' with the 'mtiled' dataflow pinned: every MLP through
    K2, each block keeping its stripe of rows in shared memory and writing
    its outputs in place."""

    mode = "mtiled"


@register_backend("reram-fused-wstat")
class ReramFusedWStatBackend(ReramFusedBackend):
    """'reram-fused' with the 'wstat' dataflow pinned: every MLP through
    K3, each block keeping one N-tile of combined weights in shared memory
    while its share of the rows streams through."""

    mode = "wstat"


# ---------------------------------------------------------------------------
# schedule canonicalization
# ---------------------------------------------------------------------------

def _canonical_schedule(schedule, config: PointNetConfig):
    """-> (spec_dict, host_plan_or_None, device_plan_or_None, planned).
    ``planned`` is False only for the plain layer-by-layer index-order path
    (the 'baseline' preset). A prebuilt ``ExecutionPlan`` is kept (for
    :meth:`CompiledModel.stats`) and lowered to a (CPU) :class:`DevicePlan`
    here, once; a prebuilt ``DevicePlan`` passes through."""
    sizes = tuple(s.n_centers for s in config.layers)
    if schedule is None:
        schedule = "baseline"
    if isinstance(schedule, DevicePlan):
        if schedule.layer_sizes != sizes:
            raise ValueError(
                f"DevicePlan layer sizes {schedule.layer_sizes} do not "
                f"match config layers {sizes}")
        return ({"intra": schedule.intra,
                 "coordinated": schedule.coordinated}, None, schedule, True)
    if isinstance(schedule, ExecutionPlan):
        return ({"intra": schedule.intra,
                 "coordinated": schedule.coordinated}, schedule,
                DevicePlan.lower(schedule, sizes), True)
    if isinstance(schedule, Mapping):
        spec = dict(schedule)
        unknown = set(spec) - {"intra", "coordinated"}
        if unknown:
            raise ValueError(f"unknown schedule keys {sorted(unknown)}; "
                             f"expected 'intra' and 'coordinated'")
        spec.setdefault("intra", "index")
        spec.setdefault("coordinated", False)
        if spec["intra"] not in ("index", "greedy", "morton"):
            raise ValueError(f"unknown intra mode {spec['intra']!r}; "
                             f"expected 'index', 'greedy' or 'morton'")
        return spec, None, None, True
    if isinstance(schedule, str):
        if schedule not in MODE_PRESETS:
            raise ValueError(
                f"unknown schedule {schedule!r}; expected one of "
                f"{sorted(MODE_PRESETS)}, a {{'intra', 'coordinated'}} "
                f"mapping, an ExecutionPlan, or a DevicePlan")
        return (dict(MODE_PRESETS[schedule]), None, None,
                schedule != "baseline")
    raise TypeError(f"schedule must be a preset name, a mapping, an "
                    f"ExecutionPlan, or a DevicePlan; got "
                    f"{type(schedule).__name__}")


def _device_planning_blocker(spec: dict, config: PointNetConfig,
                             policy: PlanPolicy | None) -> str | None:
    """Why plan construction can NOT run on the device for this (spec,
    config, policy) — or None when device planning is available. The
    host-only cases: a policy whose intra choice is still per workload
    (scored on concrete geometry; ``precommit`` it first), and a greedy
    order whose last layer exceeds the one-block limit."""
    intra = spec["intra"]
    if intra == "auto":
        if policy is None or len(policy.intra_candidates) != 1:
            return ("the policy's intra choice is per-workload (scored on "
                    "concrete geometry); precommit it to one candidate "
                    "first — policy.precommit(representative_workload)")
        intra = policy.intra_candidates[0]
    if intra == "greedy" and config.layers[-1].n_centers > GREEDY_DENSE_LIMIT:
        return (f"device greedy ordering holds a cloud in one block and is "
                f"limited to last-layer sizes <= "
                f"GREEDY_DENSE_LIMIT={GREEDY_DENSE_LIMIT}; this config's "
                f"last layer has {config.layers[-1].n_centers} centers")
    if intra not in ("index", "greedy", "morton"):
        return f"unknown intra mode {intra!r}"
    return None


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``. Asking for a
    card that is not there raises — the port never runs on the CPU unless
    told to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port's plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu'; got {dev}")
    return dev


# ---------------------------------------------------------------------------
# the compiled model
# ---------------------------------------------------------------------------

def _flatten(args) -> tuple[list, tuple]:
    """The tensors of a call's operands and the structure around them: a
    :class:`DevicePlan` gives its orders then its inverses, None gives
    nothing."""
    leaves, spec = [], []
    for a in args:
        if isinstance(a, DevicePlan):
            leaves += [*a.orders, *a.inverses]
            spec.append(("plan", a.n_layers, a.layer_sizes, a.intra,
                         a.coordinated))
        elif a is None:
            spec.append(None)
        else:
            leaves.append(a)
            spec.append("tensor")
    return leaves, tuple(spec)


def _unflatten(leaves, spec) -> tuple:
    """The operands :func:`_flatten` took apart, rebuilt over ``leaves``."""
    it = iter(leaves)
    out = []
    for s in spec:
        if s is None:
            out.append(None)
        elif s == "tensor":
            out.append(next(it))
        else:
            _, n, sizes, intra, coordinated = s
            orders = [next(it) for _ in range(n)]
            inverses = [next(it) for _ in range(n)]
            out.append(DevicePlan(orders, inverses, sizes, intra,
                                  coordinated))
    return tuple(out)


def graph_key(fn, args) -> tuple:
    """The capture a call of ``fn`` on ``args`` replays: its name, the
    operands' structure (a plan or None) and every tensor's shape and
    dtype — for a served step, the batch size, the point count and
    whether there is a plan, batched or shared."""
    leaves, spec = _flatten(args)
    return ((fn.__name__, spec)
            + tuple((tuple(t.shape), t.dtype) for t in leaves))


class CudaGraphCall:
    """One call of ``fn`` on CUDA operands captured into a
    ``torch.cuda.CUDAGraph`` for their shapes: warmed up on a side stream,
    then captured over static input buffers. Operands are tensors, None,
    or a :class:`DevicePlan`, whose orders and inverses become static
    buffers too. Calling it copies the operands' tensors in, replays the
    graph and returns clones of the outputs. A failed capture raises;
    nothing falls back to eager execution."""

    #: eager calls on the side stream before the capture (they build the
    #: kernels and fill the wrappers' shape caches)
    WARMUP = 2

    def __init__(self, fn: Callable, args: tuple):
        leaves, spec = _flatten(args)
        dev = leaves[0].device
        self.inputs = tuple(t.clone() for t in leaves)
        static = _unflatten(self.inputs, spec)
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP):
                    fn(*static)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.outputs = fn(*static)

    def __call__(self, *args):
        for buf, t in zip(self.inputs, _flatten(args)[0]):
            buf.copy_(t)
        self.graph.replay()
        if isinstance(self.outputs, tuple):
            return tuple(o.clone() for o in self.outputs)
        return self.outputs.clone()


class CompiledModel(nn.Module):
    """The executable returned by :func:`compile_model`: a programmed
    backend plus a compiled schedule, on one device."""

    def __init__(self, backend: Backend, config: PointNetConfig,
                 schedule_spec: dict, planned: bool, *,
                 plan: ExecutionPlan | None = None,
                 device_plan: DevicePlan | None = None,
                 policy: PlanPolicy | None = None,
                 device_planning: bool = False):
        super().__init__()
        self.backend = backend
        self.config = config
        self._spec = schedule_spec
        self._plan = plan          # user-supplied host plan (stats only)
        self._dplan = device_plan  # compile-time lowered plan, if any
        self._policy = policy
        self._planned = planned
        self._device_planning = device_planning
        self._last_streams: list | None = None
        self._graphs: dict = {}    # (entry, input shapes) -> CudaGraphCall

    # -- public metadata ----------------------------------------------------

    @property
    def backend_name(self) -> str:
        return self.backend.name

    @property
    def schedule(self) -> dict:
        """The canonical ``{'intra': ..., 'coordinated': ...}`` spec. Under
        a policy that owns the ordering, ``intra`` is ``'auto'``: the cost
        model picks it per workload (or once, if precommitted)."""
        return dict(self._spec)

    @property
    def policy(self) -> PlanPolicy | None:
        """The :class:`~repro_torch.core.policy.PlanPolicy` compiled in, if
        any."""
        return self._policy

    @property
    def planned(self) -> bool:
        """True when execution routes through a gather order (any schedule
        but 'baseline') — when there is a plan to build and reuse."""
        return self._planned

    @property
    def device_planning(self) -> bool:
        """True when each call builds its plan on the device from its own
        geometry (``device_build_plan``: no host transfer, so the call can
        be captured). False for host planning (``device_planning=False``)
        and for schedules with no per-cloud construction at all (baseline,
        prebuilt plans)."""
        return self._device_planning

    @property
    def device_plan(self) -> DevicePlan | None:
        """The compile-time-lowered :class:`DevicePlan` (None when plans
        are built per cloud)."""
        return self._dplan

    @property
    def device(self) -> torch.device:
        return next(self.backend.buffers()).device

    def _input(self, clouds) -> torch.Tensor:
        return torch.as_tensor(clouds, dtype=torch.float32,
                               device=self.device).contiguous()

    def build_device_plan(self, cloud, n_valid=None) -> DevicePlan:
        """The single-cloud :class:`DevicePlan` this model's schedule would
        use for ``cloud``, on the model's device — the hook of a plan
        cache: keep the result and pass it back through
        ``forward(dplan=...)`` (or :meth:`DevicePlan.stack` several into
        ``batched_forward(dplan=...)``) to skip planning on a repeat.
        Planning runs on the device under device planning, on the host
        otherwise; the compile-time plan is returned unchanged when one is
        bound. ``n_valid`` masks pad rows out of the geometry, so the plan
        equals the unpadded cloud's."""
        if not self._planned:
            raise ValueError("this model's schedule is unplanned "
                             "('baseline'); there is no plan to build")
        if self._dplan is not None:
            return self._dplan
        geom = _pn.geometry_pass(self.config, self._input(cloud),
                                 n_valid=n_valid)
        if self._device_planning:
            return self._traced_plan(geom[0], geom[2])
        return self._device_plan_for(*geom)

    # -- execution ----------------------------------------------------------

    @torch.no_grad()
    def forward(self, cloud, *, n_valid=None,
                dplan: DevicePlan | None = None) -> torch.Tensor:
        """Single cloud ``(N, 3)`` -> logits ``(n_classes,)``. ``n_valid``
        marks the real row count of a cloud padded with trailing rows;
        ``dplan`` supplies a prebuilt single-cloud :class:`DevicePlan` for
        this call, in place of the compile-time plan or planning."""
        cloud = self._input(cloud)
        if self._planned:
            return self._forward_planned(cloud, n_valid, dplan)
        _refuse_unplanned(dplan)
        return self._forward_base(cloud, n_valid)

    @torch.no_grad()
    def batched_forward(self, clouds, *, n_valid=None,
                        dplan: DevicePlan | None = None) -> torch.Tensor:
        """Batch ``(B, N, 3)`` -> logits ``(B, n_classes)``: one fused-MLP
        call per MLP for the whole batch and, under a plan, one batched
        gather launch per SA layer. ``n_valid`` is a ``(B,)`` vector of
        real row counts; ``dplan`` a prebuilt :class:`DevicePlan` for this
        call, batched for this batch size or one plan shared batch-wide."""
        clouds = self._input(clouds)
        if self._planned:
            return self._batched_forward_planned(clouds, n_valid, dplan)
        _refuse_unplanned(dplan)
        return self._batched_in_grid(clouds, n_valid)

    def loss_fn(self, clouds, labels):
        """Mean negative log-likelihood and accuracy of
        :meth:`batched_forward` over a batch with int ``labels`` ``(B,)``,
        as 0-d tensors.

        On the 'float' backend under the 'baseline' schedule the loss is
        differentiable with respect to the params tree the model was
        compiled from, where its leaves require grad (they are the model's
        weights, not copies): the batched path runs with autograd, the
        geometry (FPS and kNN indices, the layer-0 features) carrying no
        gradient. Elsewhere it carries none: the crossbar backends hold
        quantized copies of the weights, and a planned schedule's gathers
        run through K4/K5 on the card, which have no backward (the
        reference trains 'float' under 'baseline' too)."""
        if self._planned or not self.backend.trainable:
            logits = self.batched_forward(clouds)
        else:
            logits = self._batched_in_grid(self._input(clouds))
        labels = torch.as_tensor(labels, dtype=torch.int64,
                                 device=logits.device)
        logp = torch.log_softmax(logits, dim=1)
        nll = -logp.gather(1, labels[:, None]).mean()
        acc = (logits.argmax(dim=1) == labels).to(torch.float32).mean()
        return nll, acc

    @torch.no_grad()
    def eval_step(self, clouds, labels):
        """:meth:`loss_fn` under ``torch.no_grad()``, captured into a CUDA
        graph per input shape on the card (replayed on later calls), as the
        reference jits it. A model that plans on the host per cloud runs
        eagerly, as does one on the CPU (there is nothing to capture)."""
        if self._planned and self._dplan is None \
                and not self._device_planning:
            return self.loss_fn(clouds, labels)
        labels = torch.as_tensor(labels, dtype=torch.int64,
                                 device=self.device)
        return self._replay(self.loss_fn, self._input(clouds), labels)

    def _require_traceable(self, what: str) -> None:
        if self._planned and self._dplan is None \
                and not self._device_planning:
            raise TypeError(
                f"{what} needs the whole pipeline captured into one CUDA "
                f"graph, but this model plans on host per cloud "
                f"(device_planning is off); compile with "
                f"device_planning=True, precommit the policy, or pass a "
                f"prebuilt ExecutionPlan/DevicePlan")

    def jit_forward(self, cloud) -> torch.Tensor:
        """:meth:`forward` as one captured CUDA graph, cloud -> logits:
        captured on the first call of each cloud shape, replayed after.
        Under device planning the graph holds the geometry, the plan's
        construction (P1, P2), the gathers and the MLPs: no host work. On
        a CPU model it is :meth:`forward`."""
        self._require_traceable("jit_forward")
        return self._replay(self.forward, self._input(cloud))

    def jit_batched_forward(self, clouds, *, n_valid=None,
                            dplan: DevicePlan | None = None) -> torch.Tensor:
        """:meth:`batched_forward` as one captured CUDA graph per batch
        shape, as :meth:`jit_forward` is for one cloud. ``n_valid`` and
        ``dplan`` are operands of the graph, as the clouds are: ``n_valid``
        goes onto the device before the replay and the plan's orders and
        inverses are copied into the graph's buffers, so one capture per
        batch size, point count and kind of plan (none, batched or shared)
        serves every call. With a ``dplan`` even a host-planned model runs
        captured: the plan is all the planning there is."""
        if dplan is None:
            self._require_traceable("jit_batched_forward")
        else:
            dplan = dplan.to(self.device)
        if n_valid is not None:
            n_valid = torch.as_tensor(n_valid, dtype=torch.int32,
                                      device=self.device)
        return self._replay(self._batched_step, self._input(clouds),
                            n_valid, dplan)

    def _batched_step(self, clouds, n_valid, dplan):
        return self.batched_forward(clouds, n_valid=n_valid, dplan=dplan)

    @property
    def captures(self) -> int:
        """How many CUDA graphs this model has captured (one per key of
        :func:`graph_key`)."""
        return len(self._graphs)

    def _replay(self, fn, *args):
        """``fn(*args)`` through its :class:`CudaGraphCall` for these
        operands' shapes (captured on first use) on the card; eagerly on
        the CPU."""
        if self.device.type != "cuda":
            return fn(*args)
        key = graph_key(fn, args)
        call = self._graphs.get(key)
        if call is None:
            call = self._graphs[key] = CudaGraphCall(fn, args)
        return call(*args)

    # -- introspection ------------------------------------------------------

    def stats(self, cloud=None, *, workload: PointNetWorkload | None = None,
              window: int = 72) -> dict:
        """Compile and execution report: backend name, schedule spec,
        program bytes and the fused dataflow per MLP (``Backend.stats``),
        and — given a ``cloud`` or a prebuilt ``workload`` (geometry by the
        NumPy planner), else from the last call that planned on the host —
        the DMA elisions of the plan-ordered neighbor streams that drive
        the gathers, per layer, through ``count_dma_elisions`` with a
        ``window``-row working set. A call that plans on the device, or
        runs under a compile-time or caller-supplied plan, keeps its
        geometry on the device and records no stream."""
        s = {"backend": self.backend_name, "schedule": self.schedule,
             "planned": self._planned}
        if self._policy is not None:
            s["policy"] = self._policy
        s.update(self.backend.stats())
        streams = None
        if cloud is not None or workload is not None:
            if workload is None:
                pts = (cloud.detach().cpu().numpy()
                       if isinstance(cloud, torch.Tensor) else cloud)
                workload = PointNetWorkload.build(
                    np.asarray(pts, np.float64), self.config)
            if self._plan is not None:
                plan = self._plan
            elif self._dplan is not None:
                plan = self._dplan
            elif self._policy is not None:
                plan = self._policy.build_plan(workload)
            else:
                plan = build_plan(workload, **self._spec)
            streams = _plan_streams(plan, [np.asarray(nb) for nb in
                                           workload.neighbors[1:]])
        elif self._last_streams is not None:
            streams = self._last_streams
        if streams is not None:
            s["dma"] = _dma_report(streams, window)
        return s

    # -- execution internals ------------------------------------------------

    def _forward_base(self, cloud, n_valid=None):
        """Layer-by-layer index-order execution (no plan, no gather
        kernel)."""
        cfg = self.config
        feats = _pn.lift_features(cloud, cfg.layers[0].in_features)
        pts = cloud
        for i, spec in enumerate(cfg.layers):
            pts, diff = _pn._sa_geometry(spec, pts, feats,
                                         n_valid if i == 0 else None)
            h = self.backend.apply_mlp(("sa", i), diff)
            feats = h.amax(dim=1)                        # reduction over K
        g = feats.amax(dim=0)                            # global max pool
        return self.backend.apply_mlp("head", g, final_relu=False)

    def _batched_in_grid(self, clouds, n_valid=None):
        """Baseline order for a batch: batched geometry, one batched MLP
        call per MLP."""
        cfg = self.config
        feats = _pn.lift_features(clouds, cfg.layers[0].in_features)
        pts = clouds
        for i, spec in enumerate(cfg.layers):
            pts, diff = _pn._sa_geometry(spec, pts, feats,
                                         n_valid if i == 0 else None)
            h = self.backend.apply_mlp_batched(("sa", i), diff)
            feats = h.amax(dim=2)                        # reduction over K
        g = feats.amax(dim=1)                            # global max pool
        return self.backend.apply_mlp_batched("head", g, final_relu=False)

    def _bound_plan(self, dplan: DevicePlan | None) -> DevicePlan | None:
        """The plan that drives this call without planning: the caller's,
        else the compile-time one, else None."""
        if dplan is None:
            return self._dplan
        sizes = tuple(s.n_centers for s in self.config.layers)
        if dplan.layer_sizes != sizes:
            raise ValueError(f"DevicePlan layer sizes {dplan.layer_sizes} "
                             f"do not match config layers {sizes}")
        return dplan

    def _resolved_intra(self) -> str:
        """The concrete intra mode device planning builds ('auto' resolves
        to the precommitted policy's single candidate)."""
        intra = self._spec["intra"]
        if intra == "auto":
            return self._policy.intra_candidates[0]
        return intra

    def _traced_plan(self, pts_list, nbr_list) -> DevicePlan:
        """Plan construction on the device from the forward's own geometry
        (one cloud or a batch): Algorithm 1 through
        :func:`~repro_torch.core.schedule.device_build_plan`, no host
        transfer."""
        return device_build_plan(nbr_list[1:], pts_list[-1],
                                 intra=self._resolved_intra(),
                                 coordinated=self._spec["coordinated"])

    def _planned_layers(self, feats, ctr_list, nbr_list, dplan: DevicePlan,
                        batched: bool):
        """The SA layers in plan order: per layer one gather (the kernel
        reads the plan order and the index-order indices), the MLP, the
        max over K, and the scatter back to index order. Returns the last
        layer's features in index order."""
        for k in range(1, self.config.n_layers + 1):
            order = dplan.order_of(k)
            inv = dplan.inverse_of(k).long()
            if batched:
                diff = aggregate_diff_batched(feats, nbr_list[k],
                                              ctr_list[k], order)
                h = self.backend.apply_mlp_batched(("sa", k - 1), diff)
                out = h.amax(dim=2)                      # reduction over K
                if inv.ndim == 1:                 # one plan shared batch-wide
                    inv = inv.expand(out.shape[0], -1)
                feats = torch.take_along_dim(out, inv[:, :, None], dim=1)
            else:
                diff = aggregate_diff(feats, nbr_list[k], ctr_list[k], order)
                h = self.backend.apply_mlp(("sa", k - 1), diff)
                feats = h.amax(dim=1)[inv]       # back to index order
        return feats

    def _forward_planned(self, cloud, n_valid=None, dplan=None):
        """Plan-driven execution of one cloud. The plan: the caller's, else
        the compile-time one, else built on the device from this cloud's
        geometry (device planning), else built on the host."""
        cfg = self.config
        dplan = self._bound_plan(dplan)
        if dplan is not None and dplan.batched:
            raise ValueError("this DevicePlan is batched; use "
                             "batched_forward for it")
        feats = _pn.lift_features(cloud, cfg.layers[0].in_features)
        pts_list, ctr_list, nbr_list = _pn.geometry_pass(cfg, cloud,
                                                         n_valid=n_valid)
        if dplan is None:
            dplan = (self._traced_plan(pts_list, nbr_list)
                     if self._device_planning else
                     self._device_plan_for(pts_list, ctr_list, nbr_list,
                                           record=True))
        feats = self._planned_layers(feats, ctr_list, nbr_list,
                                     dplan.to(cloud.device), batched=False)
        g = feats.amax(dim=0)
        return self.backend.apply_mlp("head", g, final_relu=False)

    def _batched_forward_planned(self, clouds, n_valid=None, dplan=None):
        """Plan-driven execution of a batch. A caller's or compile-time
        :class:`DevicePlan`, or device planning, go through
        :meth:`_batched_forward_device`; here the host plans: batched
        geometry pulled to the host once, per-cloud NumPy plans stacked into
        one batched :class:`DevicePlan`, then one ``aggregate_diff_batched``
        launch and one batched MLP call per SA layer. Logits equal the
        per-cloud ``forward`` row for row."""
        dplan = self._bound_plan(dplan)
        if dplan is not None or self._device_planning:
            return self._batched_forward_device(clouds, n_valid, dplan)
        cfg = self.config
        feats = _pn.lift_features(clouds, cfg.layers[0].in_features)
        pts_list, ctr_list, nbr_list = _pn.geometry_pass(cfg, clouds,
                                                         n_valid=n_valid)
        dplan = self._device_plan_for(pts_list, ctr_list, nbr_list,
                                      record=True)
        feats = self._planned_layers(feats, ctr_list, nbr_list, dplan,
                                     batched=True)
        g = feats.amax(dim=1)                            # global max pool
        return self.backend.apply_mlp_batched("head", g, final_relu=False)

    def _batched_forward_device(self, clouds, n_valid=None, dplan=None):
        """The batched path without host work: batched geometry, the plan
        built on the device for the whole batch (P1 and P2 one launch each
        on the card) unless a prebuilt or caller-supplied
        :class:`DevicePlan` is given, then one ``aggregate_diff_batched``
        launch and one batched MLP call per SA layer. Same arithmetic per
        row as the host-planned path, so the logits equal it bit for bit
        (crossbar backends)."""
        cfg = self.config
        batch = clouds.shape[0]
        if dplan is not None and dplan.batched and dplan.batch_size != batch:
            raise ValueError(f"batched DevicePlan is for batch "
                             f"{dplan.batch_size}, got {batch} clouds")
        feats = _pn.lift_features(clouds, cfg.layers[0].in_features)
        pts_list, ctr_list, nbr_list = _pn.geometry_pass(cfg, clouds,
                                                         n_valid=n_valid)
        dplan = (self._traced_plan(pts_list, nbr_list) if dplan is None
                 else dplan.to(clouds.device))
        feats = self._planned_layers(feats, ctr_list, nbr_list, dplan,
                                     batched=True)
        g = feats.amax(dim=1)                            # global max pool
        return self.backend.apply_mlp_batched("head", g, final_relu=False)

    def _host_plan_for(self, pts, ctrs, nbrs) -> ExecutionPlan:
        """The host ``ExecutionPlan`` for one cloud's geometry: NumPy points
        of layers 0..L, centers and neighbors of layers 1..L."""
        wl = PointNetWorkload(
            config=self.config,
            points=[np.asarray(p, np.float64) for p in pts],
            centers=[None] + list(ctrs), neighbors=[None] + list(nbrs))
        if self._policy is not None and self._spec["intra"] == "auto":
            return self._policy.build_plan(wl)
        return build_plan(wl, **self._spec)

    def _device_plan_for(self, pts_list, ctr_list, nbr_list, *,
                         record: bool = False) -> DevicePlan:
        """Pull the geometry (one cloud or a batch) to the host once, build
        each cloud's plan there and lower the plans onto the device. With
        ``record``, keep the plan-ordered neighbor streams of this call for
        :meth:`stats`, cut from the host copies already made."""
        pts = [p.cpu().numpy() for p in pts_list]
        ctrs = [c.cpu().numpy() for c in ctr_list[1:]]
        nbrs = [nb.cpu().numpy() for nb in nbr_list[1:]]
        sizes = tuple(s.n_centers for s in self.config.layers)
        single = pts[0].ndim == 2
        if single:
            plans = self._host_plan_for(pts, ctrs, nbrs)
        else:
            plans = [self._host_plan_for([p[b] for p in pts],
                                         [c[b] for c in ctrs],
                                         [nb[b] for nb in nbrs])
                     for b in range(pts[0].shape[0])]
        if record:
            clouds = ([(plans, nbrs)] if single else
                      [(pl, [nb[b] for nb in nbrs])
                       for b, pl in enumerate(plans)])
            per = [_plan_streams(pl, nb) for pl, nb in clouds]
            self._last_streams = [[st for p in per for st in p[k]]
                                  for k in range(len(nbrs))]
        return DevicePlan.lower(plans, sizes, device=pts_list[0].device)


def _check_trained_leaves(params, dev: torch.device) -> None:
    """A leaf that requires grad becomes the model's weight itself, so it
    must already sit on the model's device: a copy made there would leave
    the caller's in-place updates unseen."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    for mlp in (*params["sa"], params["head"]):
        for lyr in mlp:
            for t in lyr.values():
                if isinstance(t, torch.Tensor) and t.requires_grad \
                        and t.device != dev:
                    raise ValueError(
                        f"a parameter that requires grad is on {t.device}, "
                        f"the model on {dev}; move the params tree to the "
                        f"model's device before compile_model")


def _refuse_unplanned(dplan) -> None:
    if dplan is not None:
        raise ValueError("dplan= was passed but this model's schedule is "
                         "unplanned ('baseline'); there is no gather order "
                         "for it to drive")


def _plan_streams(plan, neighbors) -> list[list[np.ndarray]]:
    """The plan-ordered neighbor index streams that drive the gathers:
    ``streams[k-1]`` holds one array per cloud (a batched plan gives one
    per batch row) — ``neighbors[k-1]`` ``(n_k, K)`` in the plan's
    completed order of layer k. ``plan`` is an ``ExecutionPlan`` or a
    :class:`DevicePlan`."""
    streams = []
    for k, nb in enumerate(neighbors, start=1):
        order = plan.order_of(k)
        order = (order.cpu().numpy() if isinstance(order, torch.Tensor)
                 else np.asarray(order))
        orders = order[None] if order.ndim == 1 else order
        streams.append([nb[complete_order(o, nb.shape[0], k)]
                        for o in orders])
    return streams


def _dma_report(streams, window: int) -> dict:
    """Per-layer and total elision counts of the plan-ordered streams
    (:func:`_plan_streams`); counts never chain across clouds, and a
    layer's entry sums over its clouds."""
    layers = []
    for per_cloud in streams:
        counts = [count_dma_elisions(st, window=window) for st in per_cloud]
        steps = sum(c["steps"] for c in counts)
        elided = sum(c["elided"] for c in counts)
        layers.append({"steps": steps, "elided": elided,
                       "dma": steps - elided,
                       "elision_rate": elided / max(1, steps)})
    steps = sum(lyr["steps"] for lyr in layers)
    elided = sum(lyr["elided"] for lyr in layers)
    return {"window": window, "layers": layers, "steps": steps,
            "elided": elided, "dma": steps - elided,
            "elision_rate": elided / max(1, steps)}


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def compile_model(params: Params, config: PointNetConfig, *,
                  backend: str = "float", schedule=None,
                  policy: PlanPolicy | None = None,
                  device_planning: bool | None = None,
                  fault_model=None, device=None,
                  **backend_opts) -> CompiledModel:
    """Compile PointNet++ ``params`` for execution on ``device``.

    params   : ``{"sa": [[{"w", "b"}, …], …], "head": […]}`` of tensors —
               :func:`~repro_torch.models.pointnet2.init_params`, or the
               JAX package's weights through
               :func:`repro_torch.convert.params_from_numpy`.
    backend  : registry name — 'float', 'reram', 'reram-fused',
               'reram-fused-mtiled' or 'reram-fused-wstat' (or anything
               added with :func:`register_backend`).
    policy   : a :class:`~repro_torch.core.policy.PlanPolicy` — the cost
               model of the scheduling decisions: the fused backends launch
               its Hopper dataflow choice (and report its TPU one), and
               unless ``schedule`` pins the order the intra-layer order is
               picked per workload by predicted DMA elisions (on the host;
               a precommitted policy plans on the card).
    fault_model : a :class:`~repro_torch.reliability.FaultModel` — ReRAM
               non-idealities injected into the crossbar planes; a backend
               without cell planes ('float') raises ``ValueError``. The
               zero-fault model equals compiling without one, bit for bit.
    schedule : None/'baseline', a ``MODE_PRESETS`` name ('pointer-1',
               'pointer-12', 'pointer', 'pointer-morton'), an
               ``{'intra', 'coordinated'}`` mapping, a prebuilt
               :class:`ExecutionPlan`, or a prebuilt (possibly batched)
               :class:`DevicePlan`.
    device_planning : build each call's plan on the device from its own
               geometry (:func:`~repro_torch.core.schedule.
               device_build_plan`: greedy through P1, coordination through
               P2), so a call makes no host transfer and
               ``jit_forward``/``jit_batched_forward`` can capture it.
               None (the default) turns it on wherever the schedule allows
               (a spec-driven planned schedule whose greedy last layer is
               within ``GREEDY_DENSE_LIMIT``); True demands it
               (``ValueError`` naming the blocker); False keeps host
               planning, which also records the plan-ordered streams
               :meth:`CompiledModel.stats` reports.
    device   : where the model runs; default ``cuda``, which raises when no
               card is present. ``device="cpu"`` runs the plain versions.
    backend_opts : go to the backend's constructor — on 'reram-fused',
               ``mode=`` ('whole', 'tiled', 'mtiled', 'wstat') pins the
               fused dataflow, ``program=`` passes prebuilt programs,
               ``ecc=`` (an :class:`~repro_torch.reliability.EccConfig`)
               protects them.
    """
    dev = resolve_device(device)
    if not isinstance(backend, str):
        raise TypeError(f"backend must be a registry name string; got "
                        f"{type(backend).__name__}")
    try:
        cls = _REGISTRY[backend]
    except KeyError:
        raise ValueError(f"unknown backend {backend!r}; registered backends: "
                         f"{available_backends()}") from None
    if policy is not None and not isinstance(policy, PlanPolicy):
        raise TypeError(f"policy must be a PlanPolicy; got "
                        f"{type(policy).__name__}")
    if fault_model is not None:
        if "fault_model" not in inspect.signature(cls.__init__).parameters:
            raise ValueError(
                f"backend {backend!r} does not support fault injection "
                f"(no fault_model= constructor option — the float path "
                f"has no crossbar cell planes to fault); use a crossbar "
                f"backend such as 'reram' or 'reram-fused'")
        backend_opts["fault_model"] = fault_model
    if schedule is None and policy is not None:
        # the policy owns the ordering decision: per-workload intra choice
        spec = {"intra": "auto", "coordinated": policy.coordinated}
        plan, dplan, planned = None, None, True
    else:
        spec, plan, dplan, planned = _canonical_schedule(schedule, config)
    if planned and dplan is None:
        blocker = _device_planning_blocker(spec, config, policy)
        if device_planning is None:
            device_planning = blocker is None
        elif device_planning and blocker is not None:
            raise ValueError(f"device_planning=True impossible for this "
                             f"schedule: {blocker}")
    else:
        # baseline, or a prebuilt ExecutionPlan/DevicePlan: construction
        # already happened, there is nothing to run on the device
        if device_planning:
            raise ValueError(
                "device_planning=True needs a spec-driven planned schedule "
                "(preset name, {'intra', 'coordinated'} mapping, or "
                "policy=); baseline and prebuilt plans have no plan "
                "construction left to lower")
        device_planning = False
    if cls.trainable:
        _check_trained_leaves(params, dev)
    be = cls(params, config, **backend_opts)
    be.policy = policy           # dataflow decisions consult the cost model
    model = CompiledModel(be, config, spec, planned, plan=plan,
                          device_plan=None if dplan is None else dplan.to(dev),
                          policy=policy,
                          device_planning=bool(device_planning))
    return model.to(dev)
