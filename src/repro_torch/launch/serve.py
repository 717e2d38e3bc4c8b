"""The serving tier: one engine over a ``CompiledModel`` or an LM.

The port's copy of ``repro.launch.serve``, with the same classes, rules and
counters:

  ``ServingEngine``       — a request queue and continuous batching behind
                            a pluggable :class:`Scheduler`: each step asks
                            the scheduler for one same-bucket batch and
                            runs it. :class:`FIFOScheduler` (the default)
                            lets the oldest request fix the bucket;
                            :class:`EDFScheduler` serves by priority tier,
                            feasible deadlines first, earliest deadline
                            first, with deadline-aware batch admission and
                            an aging bound.
  ``PointCloudServable``  — pads requests into point-count and batch-size
                            shape buckets, reuses plans through a
                            content-keyed :class:`PlanCache` and an optional
                            :class:`FrameTracker`, and runs each batch as
                            one ``jit_batched_forward(clouds, n_valid=...,
                            dplan=...)``: on the card one CUDA graph per
                            bucket shape, captured on its first batch and
                            replayed after, on the CPU an eager call. Each
                            served row is bitwise equal to ``forward`` on
                            the bare request (crossbar backends).
  ``LMServable``          — the LM adapter (``models/lm.py``): prompts
                            bucketed on their length, one prefill and a
                            decode step a token. On the card the prefill is
                            captured once per (config, batch, prompt length,
                            capacity) and the decode step once per (config,
                            batch, capacity) as CUDA graphs over one decode
                            cache (KV rows, SSM and RWKV states) written in
                            place, every family; on the CPU both run
                            eagerly. ``generate`` is its thin client, with
                            the reference's signature and stats keys.
  ``make_prefill`` and    — the LM's sharded prefill over ``mesh=`` (a
  ``make_serve_step``       ``DeviceMesh``) and its decode step, sharded
                            with ``mesh=``, as functions, every rank
                            calling with the same global batch as the
                            sharded train step's ranks do
                            (``launch/train.py``): the weights a tree of
                            ``DTensor`` s (``param_pspecs``), each rank on
                            its part of the batch, the weights gathered per
                            layer and the blocks computed on 'model' shards
                            as the sharded train step does
                            (``launch.tp.ParamShards``, forward only), the
                            decode cache a tree of ``DTensor`` s by
                            ``cache_pspecs`` written in place on the rank's
                            shards, the logits a ``DTensor`` of the rank's
                            rows. Under GSPMD the reference's sharded
                            prefill and decode step are its unsharded
                            functions; so are these, up to the order of the
                            sums over the 'model' ranks and, for a cache
                            whose rows are cut, over the rows' ranks. They
                            run eagerly.

Results stay on the model's device, one logits row per request. The
service time ``serve_stream`` measures ends after the card has finished
the batch: the engine synchronizes the results' device before it reads
its clock again.
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.schedule import (DevicePlan, FrameTracker, PlanCache,
                                       cloud_content_key, host_array)
from repro_torch.models import lm
from repro_torch.models.backend import CudaGraphCall, resolve_device
from repro_torch.optim.optimizer import tree_leaves

__all__ = [
    "ShapeBuckets",
    "Request",
    "Servable",
    "PointCloudServable",
    "LMServable",
    "Scheduler",
    "FIFOScheduler",
    "EDFScheduler",
    "SCHEDULERS",
    "VirtualClock",
    "ServingEngine",
    "make_serve_step",
    "make_prefill",
    "generate",
    "lm_capture_counts",
    "clear_lm_captures",
]


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------

class VirtualClock:
    """Deterministic injectable clock: each ``monotonic()`` call advances
    it by exactly ``tick_s``, so each served batch costs one virtual tick
    and every latency percentile and deadline decision is a function of
    the arrival stream and the scheduler alone."""

    def __init__(self, tick_s: float = 0.0, *, start: float = 0.0):
        if tick_s < 0.0:
            raise ValueError(f"tick_s must be >= 0; got {tick_s}")
        self.tick_s = float(tick_s)
        self.t = float(start)

    def monotonic(self) -> float:
        self.t += self.tick_s
        return self.t

    def advance(self, dt: float) -> None:
        """Manually advance the clock by ``dt`` seconds."""
        if dt < 0.0:
            raise ValueError(f"dt must be >= 0; got {dt}")
        self.t += float(dt)


# ---------------------------------------------------------------------------
# shape buckets
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeBuckets:
    """The discrete shapes the serving tier runs. A request of n points is
    padded up to the smallest point bucket >= n, a batch up to the smallest
    batch bucket (short batches replicate row 0), so the served step sees at
    most ``len(points) * len(batch)`` shapes: on the card, as many CUDA
    graphs."""

    points: tuple[int, ...] = (1024,)
    batch: tuple[int, ...] = (1, 2, 4, 8)

    def __post_init__(self):
        if (not self.points or not self.batch
                or tuple(sorted(self.points)) != tuple(self.points)
                or tuple(sorted(self.batch)) != tuple(self.batch)):
            raise ValueError("ShapeBuckets needs non-empty ascending "
                             "'points' and 'batch' tuples")

    @property
    def max_batch(self) -> int:
        return self.batch[-1]

    def point_bucket(self, n: int) -> int:
        """Smallest point bucket >= n (ValueError past the largest: the
        engine never truncates a cloud)."""
        for b in self.points:
            if n <= b:
                return b
        raise ValueError(f"cloud with {n} points exceeds the largest "
                         f"point bucket {self.points[-1]}")

    def batch_bucket(self, b: int) -> int:
        for bb in self.batch:
            if b <= bb:
                return bb
        raise ValueError(f"batch of {b} exceeds the largest batch bucket "
                         f"{self.batch[-1]}")


# ---------------------------------------------------------------------------
# requests + the servable protocol
# ---------------------------------------------------------------------------

@dataclass
class Request:
    """One queued unit of work. ``payload`` is a cloud for
    :class:`PointCloudServable`; ``result`` and ``t_done`` are filled by
    the engine. ``deadline_us`` is a latency budget relative to arrival
    (None: no deadline), ``priority`` an integer tier, higher more urgent;
    both drive :class:`EDFScheduler` and are inert under FIFO."""

    id: int
    payload: Any
    t_arrival: float = 0.0
    deadline_us: float | None = None
    priority: int = 0
    result: Any = None
    t_done: float | None = None

    @property
    def latency(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.t_arrival

    @property
    def deadline(self) -> float | None:
        """Absolute deadline on the arrival clock (seconds), or None."""
        return (None if self.deadline_us is None
                else self.t_arrival + self.deadline_us * 1e-6)

    @property
    def missed(self) -> bool:
        """True iff the request had a deadline and completed past it."""
        return (self.t_done is not None and self.deadline is not None
                and self.t_done > self.deadline)


class Servable:
    """What the engine needs from a model adapter: ``bucket_of`` maps a
    payload to a hashable bucket key (requests batch together iff their
    keys are equal), ``run_batch`` runs one same-bucket batch and returns
    one result per payload, in order, ``max_batch`` bounds a batch and
    ``stats`` reports the adapter's counters."""

    max_batch: int = 8

    def bucket_of(self, payload) -> Any:
        raise NotImplementedError

    def run_batch(self, payloads: list) -> list:
        raise NotImplementedError

    def stats(self) -> dict:
        return {}


# ---------------------------------------------------------------------------
# schedulers: the pluggable queue discipline
# ---------------------------------------------------------------------------

class Scheduler:
    """The engine's queue discipline. :meth:`push` enqueues,
    :meth:`select` removes and returns one same-bucket batch,
    :meth:`pending` snapshots the queue in arrival order. Every pushed
    request is selected exactly once."""

    name = "scheduler"

    def __init__(self):
        self._pending: deque[Request] = deque()

    def push(self, req: Request) -> None:
        self._pending.append(req)

    def __len__(self) -> int:
        return len(self._pending)

    def pending(self) -> tuple[Request, ...]:
        """Still-queued requests, in arrival order."""
        return tuple(self._pending)

    def select(self, *, bucket_of: Callable[[Any], Any], max_batch: int,
               now: float = 0.0,
               est_service: Callable[[Any, int], float] | None = None,
               ) -> list[Request]:
        raise NotImplementedError


class FIFOScheduler(Scheduler):
    """The oldest request fixes the bucket; queued same-bucket requests
    join in FIFO order up to ``max_batch``; other buckets keep their place.
    Deadlines and priorities are carried but ignored."""

    name = "fifo"

    def select(self, *, bucket_of, max_batch, now=0.0, est_service=None):
        if not self._pending:
            return []
        bucket = bucket_of(self._pending[0].payload)
        batch: list[Request] = []
        rest: deque[Request] = deque()
        while self._pending:
            req = self._pending.popleft()
            if (len(batch) < max_batch
                    and bucket_of(req.payload) == bucket):
                batch.append(req)
            else:
                rest.append(req)
        self._pending = rest
        return batch


class EDFScheduler(Scheduler):
    """Deadline and priority discipline for streaming LiDAR. Selection
    order: requests waiting ``aging_s`` or longer first (FIFO among them,
    the starvation bound), then higher ``priority``, then feasible
    deadlines (``now + est <= deadline``; none counts as feasible) before
    infeasible ones, then earliest deadline, then arrival id. The head
    fixes the bucket; a candidate joins only while the batch stays
    deadline-safe for itself and every admitted request, and aged requests
    bypass that admission."""

    name = "edf"

    def __init__(self, *, aging_s: float | None = 1.0):
        super().__init__()
        if aging_s is not None and aging_s <= 0.0:
            raise ValueError(f"aging_s must be > 0 or None; got {aging_s}")
        self.aging_s = aging_s

    def _aged(self, req: Request, now: float) -> bool:
        return (self.aging_s is not None
                and now - req.t_arrival >= self.aging_s)

    def _key(self, req: Request, now: float, est0: float):
        if self._aged(req, now):
            return (0, 0, 0, 0.0, req.id)          # FIFO among the aged
        dl = req.deadline
        infeasible = dl is not None and now + est0 > dl
        return (1, -req.priority, 1 if infeasible else 0,
                math.inf if dl is None else dl, req.id)

    def select(self, *, bucket_of, max_batch, now=0.0, est_service=None):
        if not self._pending:
            return []
        est = est_service if est_service is not None else lambda b, n: 0.0
        order = sorted(
            self._pending,
            key=lambda r: self._key(r, now, est(bucket_of(r.payload), 1)))
        head = order[0]
        bucket = bucket_of(head.payload)
        batch = [head]
        for cand in order[1:]:
            if len(batch) >= max_batch:
                break
            if bucket_of(cand.payload) != bucket:
                continue
            t_done = now + est(bucket, len(batch) + 1)
            if not self._aged(cand, now):
                dl = cand.deadline
                if (dl is not None and t_done > dl
                        and now + est(bucket, 1) <= dl):
                    # this batch would blow a still-meetable deadline:
                    # keep the candidate queued for a batch it can make
                    continue
                if any(r.deadline is not None and t_done > r.deadline
                       and not self._aged(r, now) for r in batch):
                    # growing the batch blows an admitted deadline; any
                    # further growth completes no earlier — stop here
                    break
            batch.append(cand)
        selected = {id(r) for r in batch}
        self._pending = deque(r for r in self._pending
                              if id(r) not in selected)
        return batch


#: registry for ``ServingEngine(scheduler="fifo" | "edf")``
SCHEDULERS: dict[str, type[Scheduler]] = {
    "fifo": FIFOScheduler,
    "edf": EDFScheduler,
}


# ---------------------------------------------------------------------------
# point clouds: the CompiledModel adapter
# ---------------------------------------------------------------------------

class PointCloudServable(Servable):
    """Serve a :class:`~repro_torch.models.backend.CompiledModel` (any
    backend, any schedule).

    A batch: each cloud padded with zero rows to its point bucket, the
    batch padded to its batch bucket by replicating row 0, one
    ``model.jit_batched_forward(clouds, n_valid=..., dplan=...)``, the
    replicated rows dropped. On the card that call replays one CUDA graph
    per (batch bucket, point bucket, plan or none), with the clouds,
    ``n_valid`` and the stacked plan copied into its buffers. A model that
    plans on the host with the plan cache off runs eagerly, as the
    reference does outside ``jit``.

    The plan cache (on by default for a schedule planned per cloud) keys
    each request's real rows by content: a repeated cloud skips planning,
    and its :class:`DevicePlan` is stacked straight into the batch. A miss
    builds through ``model.build_device_plan`` eagerly, on the model's
    device (under device planning FPS, kNN, P1 and P2: a few launches).
    ``frame_reuse`` adds a :class:`FrameTracker` in front of the cache.

    ``jit_traces`` and ``trace_shapes`` count the step keys this servable
    has seen, as the reference counts its traces; on the card each is at
    most one capture, shared by every servable of the model.

    ``mesh`` (a 1-D replica mesh from
    :func:`repro_torch.launch.mesh.make_replica_mesh`) fans the batch out
    over ranks: every rank of the mesh runs the same engine on the same
    requests, each runs its slice of the batch
    (:func:`repro_torch.launch.sharding.shard_batch` on the clouds,
    ``n_valid`` and the stacked plan), and the rows are all-gathered over
    the replica group, so every rank returns whole results. A batch that
    does not divide the replica count runs replicated (correct, not
    faster), as the reference's. The counters count the whole batch's
    step, as the reference's traces do.
    """

    def __init__(self, model, *, buckets: ShapeBuckets | None = None,
                 plan_cache: PlanCache | bool | None = True,
                 mesh=None,
                 frame_reuse: FrameTracker | bool = False):
        if mesh is not None and "replica" not in (
                getattr(mesh, "mesh_dim_names", None) or ()):
            raise ValueError("mesh= takes a DeviceMesh with a 'replica' "
                             "axis (launch/mesh.py::make_replica_mesh)")
        self.model = model
        self.mesh = mesh
        self.buckets = buckets if buckets is not None else ShapeBuckets()
        self.max_batch = self.buckets.max_batch
        # compile-time plans need no per-request planning; 'baseline' has
        # no plan at all — the cache only earns its keep for per-cloud
        # planned schedules
        cacheable = model.planned and model.device_plan is None
        if plan_cache is True:
            self.plan_cache = PlanCache() if cacheable else None
        elif plan_cache in (False, None):
            self.plan_cache = None
        else:
            if not cacheable:
                raise ValueError(
                    "plan_cache= was given but this model has no "
                    "per-cloud plan to cache (baseline schedule or "
                    "compile-time DevicePlan)")
            self.plan_cache = plan_cache
        if isinstance(frame_reuse, FrameTracker):
            self.frame_tracker = frame_reuse
        else:
            self.frame_tracker = FrameTracker() if frame_reuse else None
        if self.frame_tracker is not None and self.plan_cache is None:
            raise ValueError(
                "frame_reuse= needs the per-cloud plan path (a planned "
                "schedule with plan_cache enabled); this servable has "
                "no plan to reuse across frames")
        self.requests = 0
        self.batches = 0
        self.jit_traces = 0
        self.trace_shapes: list[tuple[int, int]] = []
        self._step_keys: set[tuple[int, int, bool]] = set()

    def bucket_of(self, payload) -> int:
        n = (payload.shape[0] if isinstance(payload, torch.Tensor)
             else np.asarray(payload).shape[0])
        return self.buckets.point_bucket(n)

    def _plan_for(self, padded, n: int) -> DevicePlan:
        if self.frame_tracker is not None:
            plan = self.frame_tracker.lookup(padded, n_valid=n)
            if plan is not None:
                return plan
        key = cloud_content_key(padded, n_valid=n)
        plan = self.plan_cache.get_or_build(
            key, lambda: self.model.build_device_plan(padded, n_valid=n))
        if self.frame_tracker is not None:
            self.frame_tracker.update(padded, plan, n_valid=n)
        return plan

    def _count_step(self, b: int, n: int, planned: bool) -> None:
        key = (b, n, planned)
        if key not in self._step_keys:
            self._step_keys.add(key)
            self.jit_traces += 1
            self.trace_shapes.append((b, n))

    def run_batch(self, payloads: list) -> list:
        # a payload on the card is pulled to the host here, once: padding,
        # keys and fingerprints are host work
        clouds = [host_array(p).astype(np.float32, copy=False)
                  for p in payloads]
        n_bucket = self.buckets.point_bucket(clouds[0].shape[0])
        b_real = len(clouds)
        b_bucket = self.buckets.batch_bucket(b_real)
        if b_bucket == 1:
            # never run a true singleton batch, as the reference does not
            # (for XLA, which collapses a unit batch axis and re-fuses the
            # float matmuls): the port's batch-1 step would be exact too,
            # but padding to 2 keeps ``batches`` and ``trace_shapes`` equal
            # to the reference's on the same stream
            b_bucket = 2
        padded = np.zeros((b_bucket, n_bucket, 3), np.float32)
        n_valid = np.empty((b_bucket,), np.int32)
        for i, c in enumerate(clouds):
            padded[i, :c.shape[0]] = c
            n_valid[i] = c.shape[0]
        padded[b_real:] = padded[0]          # batch pads: replicate row 0
        n_valid[b_real:] = n_valid[0]

        dplan = None
        if self.plan_cache is not None:
            plans = [self._plan_for(padded[i], int(n_valid[i]))
                     for i in range(b_real)]
            plans += [plans[0]] * (b_bucket - b_real)   # pads reuse row 0's
            dplan = DevicePlan.stack(plans)

        # a planned model that plans on the host, with the cache off, has
        # no plan to hand the captured step: it runs eagerly, as the
        # reference runs it outside jit
        capturable = (dplan is not None or not self.model.planned
                      or self.model.device_planning
                      or self.model.device_plan is not None)
        if capturable:
            self._count_step(b_bucket, n_bucket, dplan is not None)
            step = self.model.jit_batched_forward
        else:
            step = self.model.batched_forward
        if self.mesh is None:
            logits = step(padded, n_valid=n_valid, dplan=dplan)
        else:
            logits = self._fan_out(step, padded, n_valid, dplan)
        self.requests += b_real
        self.batches += 1
        return list(logits[:b_real])

    def _fan_out(self, step, padded, n_valid, dplan) -> torch.Tensor:
        """The step on this rank's slice of the batch, the replicas' rows
        all-gathered in rank order."""
        import torch.distributed as dist
        from repro_torch.launch.sharding import shard_batch
        clouds, nv, plan = shard_batch((padded, n_valid, dplan), self.mesh)
        logits = step(clouds, n_valid=nv, dplan=plan)
        if clouds.shape[0] == padded.shape[0]:      # run replicated
            return logits
        group = self.mesh.get_group("replica")
        parts = [torch.empty_like(logits)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, logits.contiguous(), group=group)
        return torch.cat(parts)

    def stats(self) -> dict:
        s = {"requests": self.requests, "batches": self.batches,
             "jit_traces": self.jit_traces,
             "trace_shapes": list(self.trace_shapes)}
        if self.plan_cache is not None:
            s["plan_cache"] = self.plan_cache.stats()
        if self.frame_tracker is not None:
            s["frame_tracker"] = self.frame_tracker.stats()
        return s


# ---------------------------------------------------------------------------
# LMs: prefill + sampled decode as a servable
# ---------------------------------------------------------------------------

class _LMSession:
    """The captured serving calls of one (config, batch, capacity) over one
    set of weights, on the card: a decode cache allocated at capacity (KV
    rows, and the SSM, conv and RWKV states), one prefill graph per prompt
    length writing into it, and one decode-step graph reading and writing
    it in place. The cache is both graphs' ``state``: what their warm-ups
    write to any of its leaves is undone. ``pos`` enters the step as a
    device int32 scalar copied into the graph's buffer, so no replay reads
    anything on the host. A session holds its weights (the graphs read them
    where they lie). Its calls run under ``torch.inference_mode()``,
    whoever calls them.

    The hybrid's KV cache holds ``lm.kv_rows(cfg, capacity)`` rows (the
    capacity rounded up to the Mamba chunk): a prompt of any length up to
    the capacity keeps its padded keys, as the reference's ``prefill``
    does. Decode masks the rows past ``pos``, so the extra rows are never
    read."""

    @torch.inference_mode()
    def __init__(self, params, cfg, batch: int, max_seq: int, device):
        self.params = params
        self.cfg = cfg
        self.max_seq = lm.kv_rows(cfg, max_seq)
        self.serve_step = make_serve_step(cfg)
        self.cache = lm.init_cache(cfg, batch, self.max_seq, device=device)
        self.prefills: dict[int, CudaGraphCall] = {}
        self.step: CudaGraphCall | None = None

    def _prefill_fn(self, ids, image_embeds):
        logits, _ = lm.prefill(self.params, self.cfg, ids,
                               image_embeds=image_embeds,
                               max_seq=self.max_seq, cache=self.cache)
        return logits

    def _step_fn(self, ids1, pos):
        logits, _ = self.serve_step(self.params, self.cache, ids1, pos)
        return logits

    @torch.inference_mode()
    def prefill(self, ids, image_embeds=None):
        s = ids.shape[1]
        if s not in self.prefills:
            self.prefills[s] = CudaGraphCall(
                self._prefill_fn, (ids, image_embeds),
                state=tree_leaves(self.cache))
        return self.prefills[s](ids, image_embeds), self.cache

    @torch.inference_mode()
    def decode(self, cache, ids1, pos):
        if cache is not self.cache:
            for dst, src in zip(tree_leaves(self.cache), tree_leaves(cache)):
                dst.copy_(src)
        if self.step is None:
            self.step = CudaGraphCall(self._step_fn, (ids1, pos),
                                      state=tree_leaves(self.cache))
        return self.step(ids1, pos), self.cache


#: captured LM sessions: (config, batch, capacity, the weights' addresses)
#: -> :class:`_LMSession`. Module-level, as the reference's jit caches are,
#: so that repeated ``generate`` calls replay instead of capturing again.
_SESSIONS: dict = {}


def _session(params, cfg, batch: int, max_seq: int) -> _LMSession:
    leaves = tree_leaves(params)
    key = (cfg, int(batch), int(max_seq),
           tuple(t.data_ptr() for t in leaves))
    if key not in _SESSIONS:
        _SESSIONS[key] = _LMSession(params, cfg, batch, max_seq,
                                    leaves[0].device)
    return _SESSIONS[key]


def lm_capture_counts() -> dict:
    """How many LM graphs this process has captured: ``{"prefill": n,
    "step": n, "sessions": n}``."""
    return {"prefill": sum(len(s.prefills) for s in _SESSIONS.values()),
            "step": sum(s.step is not None for s in _SESSIONS.values()),
            "sessions": len(_SESSIONS)}


def clear_lm_captures() -> None:
    """Drop every captured LM session (its graphs, cache and weights)."""
    _SESSIONS.clear()


def _jit_prefill(params, cfg: ArchConfig, batch: int, max_seq: int):
    """``(ids, image_embeds) -> (last logits, cache)``: on the card the
    session's captured prefill for the prompt length, on the CPU
    ``lm.prefill``."""
    if _device_of(params).type == "cuda":
        return _session(params, cfg, batch, max_seq).prefill
    return lambda ids, image_embeds=None: lm.prefill(
        params, cfg, ids, image_embeds=image_embeds, max_seq=max_seq)


def _jit_step(params, cfg: ArchConfig, batch: int, max_seq: int):
    """``(cache, ids1, pos) -> (logits, cache)``: on the card the session's
    captured decode step, on the CPU ``lm.decode_step``."""
    if _device_of(params).type == "cuda":
        return _session(params, cfg, batch, max_seq).decode
    step = make_serve_step(cfg)
    return lambda cache, ids1, pos: step(params, cache, ids1, pos)


def _device_of(params) -> torch.device:
    return tree_leaves(params)[0].device


def make_serve_step(cfg: ArchConfig, *, mesh=None):
    """``serve_step(params, cache, ids1, pos, *, image_embeds=None,
    embeds1=None) -> (logits, cache)``: ``lm.decode_step``; with ``mesh``
    the sharded decode step (module docstring), ``cache`` a tree of
    ``DTensor`` s (``make_prefill(..., mesh=)``'s, or any cache sharded by
    ``cache_pspecs``) and ``serve_step.gather_stats`` the last step's
    gathered bytes."""
    if mesh is not None:
        from repro_torch.launch.sharding import check_head_layout
        from repro_torch.launch.tp import GatherStats
        check_head_layout(cfg, mesh)
        stats = GatherStats()

        def sharded(params, cache, ids1=None, pos=None, *, image_embeds=None,
                    embeds1=None):
            return _sharded_decode(cfg, mesh, stats, params, cache, ids1,
                                   pos, embeds1)
        sharded.gather_stats = stats
        return sharded

    def serve_step(params, cache, ids1, pos, *, image_embeds=None,
                   embeds1=None):
        return lm.decode_step(params, cfg, cache, ids1=ids1, pos=pos,
                              embeds1=embeds1, image_embeds=image_embeds)
    return serve_step


def make_prefill(cfg: ArchConfig, *, mesh):
    """``prefill(params, ids=None, *, embeds=None, image_embeds=None,
    max_seq=None) -> (last logits, cache)``: the sharded prefill over
    ``mesh`` (module docstring; unsharded, ``lm.prefill``): a new cache of
    the rank's zeroed shards, filled, and ``prefill.gather_stats`` the last
    call's gathered bytes."""
    from repro_torch.launch.sharding import check_head_layout
    from repro_torch.launch.tp import GatherStats
    check_head_layout(cfg, mesh)
    stats = GatherStats()

    def sharded(params, ids=None, *, embeds=None, image_embeds=None,
                max_seq=None):
        return _sharded_prefill(cfg, mesh, stats, params, ids, embeds,
                                image_embeds, max_seq)
    sharded.gather_stats = stats
    return sharded


def _local_tree(tree):
    """A tree of ``DTensor`` s' local shards."""
    from repro_torch.optim import tree_map
    return tree_map(lambda d: d.to_local(), tree)


def _sharded_inputs(mesh, inputs: dict, dev) -> tuple:
    """The global batch's entries on ``dev`` cut to this rank's part
    (``input_pspecs``): ``(local entries, whether the batch is cut)``."""
    from repro_torch.launch.sharding import NamedSharding, input_pspecs
    inputs = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()
              if v is not None}
    specs = input_pspecs(inputs, mesh)
    local = {k: NamedSharding(mesh, specs[k]).shard(v)
             for k, v in inputs.items()}
    return local, next(iter(specs.values()))[0] is not None


def _shards(cfg, mesh, params, split: bool, stats, cache_specs: dict,
            cache_shapes: dict):
    """``(lcfg, ParamShards)``: the rank's config and its forward-only
    gathers of ``params`` (DTensors) for a batch cut (``split``) or not,
    over a cache of ``cache_shapes`` (global, by key) sharded by
    ``cache_specs``."""
    from repro_torch.launch.sharding import gather_plan
    from repro_torch.launch.tp import ParamShards, batch_parts, model_axis
    lcfg, span, batch_dims, _ = batch_parts(cfg, mesh, split)
    names = mesh.mesh_dim_names
    plans, blocks = gather_plan(cfg, params, mesh,
                                {names[i] for i in batch_dims})
    stats.reset()
    tp = model_axis(mesh)
    return lcfg, ParamShards(lcfg, mesh, plans, blocks, tp=tp, span=span,
                             stats=stats,
                             cache=_cache_shards(cache_specs, cache_shapes,
                                                 mesh, tp))


def _cache_shards(specs: dict, shapes: dict, mesh, tp):
    """The ``CacheShards`` of a cache of ``shapes`` sharded by ``specs``
    (``cache_pspecs``): per key the dim 'model' cuts, and the KV rows this
    rank holds where the batch's mesh dims cut them."""
    from repro_torch.launch.sharding import NamedSharding
    from repro_torch.launch.tp import CacheShards, SeqShards
    dims, seq = {}, None
    for key, spec in specs.items():
        n = len(spec)
        for d, entry in enumerate(spec):
            if entry == "model":
                dims[key] = d - n
        if key.startswith(("k", "v")) and spec[n - 3] is not None:
            ns = NamedSharding(mesh, spec)
            lo, rows = ns.bounds(shapes[key])[n - 3]
            seq = SeqShards(tuple(mesh.get_group(i) for i, d in
                                  enumerate(ns.shard_dims) if d == n - 3),
                            lo, rows)
    return CacheShards(dims, tp, seq)


def _logits_out(logits, mesh, split: bool):
    """The rank's logits rows as a ``DTensor`` of the global logits."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.launch.sharding import NamedSharding, PartitionSpec
    spec = PartitionSpec(batch_axes(mesh) if split else None, None)
    return DTensor.from_local(logits, mesh,
                              NamedSharding(mesh, spec).placements,
                              run_check=False)


def _sharded_prefill(cfg, mesh, stats, params, ids, embeds, image_embeds,
                     max_seq):
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.sharding import NamedSharding, cache_pspecs
    dev = tree_leaves(params)[0].to_local().device
    local, split = _sharded_inputs(mesh, {"ids": ids, "embeds": embeds,
                                          "image_embeds": image_embeds}, dev)
    b, s = (ids if ids is not None else embeds).shape[:2]
    cap = max(max_seq or s, lm.kv_rows(cfg, s))
    # the global cache's shapes, allocating nothing (no tensor: a dry run
    # on meta tensors would count it)
    shapes = lm.cache_shapes(cfg, b, cap)
    specs = cache_pspecs({k: SimpleNamespace(shape=shape)
                          for k, (shape, _) in shapes.items()}, mesh)
    cache = {}
    for key, (shape, dtype) in shapes.items():
        ns = NamedSharding(mesh, specs[key])
        part = tuple(size for _, size in ns.bounds(shape))
        cache[key] = DTensor.from_local(
            torch.zeros(part, dtype=dtype, device=dev), mesh, ns.placements,
            run_check=False)
    lcfg, shards = _shards(cfg, mesh, params, split, stats, specs,
                           {k: shape for k, (shape, _) in shapes.items()})
    with torch.no_grad():
        logits, _ = lm.prefill(_local_tree(params), lcfg, local.get("ids"),
                               embeds=local.get("embeds"),
                               image_embeds=local.get("image_embeds"),
                               max_seq=cap, cache=_local_tree(cache),
                               par=shards)
    return _logits_out(logits, mesh, split), cache


def _sharded_decode(cfg, mesh, stats, params, cache, ids1, pos, embeds1):
    from repro_torch.launch.sharding import cache_pspecs
    dev = tree_leaves(params)[0].to_local().device
    local, split = _sharded_inputs(mesh, {"ids1": ids1, "embeds1": embeds1},
                                   dev)
    lcfg, shards = _shards(cfg, mesh, params, split, stats,
                           cache_pspecs(cache, mesh),
                           {k: tuple(t.shape) for k, t in cache.items()})
    pos = None if pos is None else torch.as_tensor(pos, device=dev)
    with torch.no_grad():
        logits, _ = lm.decode_step(_local_tree(params), lcfg,
                                   _local_tree(cache), ids1=local.get("ids1"),
                                   pos=pos, embeds1=local.get("embeds1"),
                                   par=shards)
    return _logits_out(logits, mesh, split), cache


def _generator(key, device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    gen = torch.Generator(device=device)
    gen.manual_seed(0 if key is None else int(key))
    return gen


class LMServable(Servable):
    """The LM ``generate`` path as a servable: payloads are 1-D int32
    prompts, bucketed on exact length (same-length prompts batch; decode
    state is per batch, so there is no cross-length padding). ``run_batch``
    stacks the batch, runs one prefill and ``max_new_tokens - 1`` decode
    steps — on the card replays of the captured graphs — and returns the
    full (prompt + generated) row per request, on the weights' device.
    Timing accumulates on the instance, on the injectable ``clock``, each
    phase ending after the card has finished it.

    Greedy sampling (``temperature <= 0``) is ``argmax``, ties to the lower
    index, as the reference's. Above 0 the port samples from ``key``, a
    ``torch.Generator`` on the weights' device or an int seed (0 when
    None): other draws than the reference's ``jax.random.categorical``.
    The weights must lie on ``device`` (the card unless ``device="cpu"``).
    The serving path runs under ``torch.inference_mode()``."""

    def __init__(self, params, cfg: ArchConfig, *, max_new_tokens: int = 32,
                 temperature: float = 0.0, key=None, image_embeds=None,
                 max_batch: int = 8, clock=None, device=None):
        dev = resolve_device(device)
        if _device_of(params).type != dev.type:
            raise ValueError(f"the weights lie on {_device_of(params)}, "
                             f"not on {dev}")
        self.params = params
        self.cfg = cfg
        self.clock = clock if clock is not None else time
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.generator = _generator(key, _device_of(params))
        self.image_embeds = image_embeds
        self.max_batch = int(max_batch)
        self.requests = 0
        self.batches = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.tokens = 0

    def bucket_of(self, payload) -> tuple:
        shape = (payload.shape if isinstance(payload, torch.Tensor)
                 else np.asarray(payload).shape)
        return ("lm", int(shape[-1]))

    def _sample(self, logits):
        if self.temperature <= 0.0:
            return logits.argmax(dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator
                                 )[:, 0].to(torch.int32)

    @torch.inference_mode()
    def run_batch(self, payloads: list) -> list:
        dev = _device_of(self.params)
        prompts = torch.stack([torch.as_tensor(p, dtype=torch.int32,
                                               device=dev)
                               for p in payloads])
        b, s = prompts.shape
        max_seq = s + self.max_new_tokens
        # decode positions on the device, made once: each step copies one
        # into the captured step's buffer without a host round trip
        positions = torch.arange(s, max_seq, dtype=torch.int32, device=dev)
        t0 = self.clock.monotonic()
        logits, cache = _jit_prefill(self.params, self.cfg, b, max_seq)(
            prompts, self.image_embeds)
        _synchronize([logits])
        t1 = self.clock.monotonic()
        step = _jit_step(self.params, self.cfg, b, max_seq)
        toks = [self._sample(logits)]
        for i in range(self.max_new_tokens - 1):
            lg, cache = step(cache, toks[-1][:, None], positions[i])
            toks.append(self._sample(lg))
        _synchronize(toks[-1:])
        t2 = self.clock.monotonic()
        self.prefill_s += t1 - t0
        self.decode_s += t2 - t1
        self.tokens += b * self.max_new_tokens
        self.requests += b
        self.batches += 1
        return list(torch.cat([prompts, torch.stack(toks, dim=1)], dim=1))

    def stats(self) -> dict:
        return {"requests": self.requests, "batches": self.batches,
                "prefill_s": self.prefill_s, "decode_s": self.decode_s,
                "decode_tok_per_s":
                    self.tokens / max(self.decode_s, 1e-9)}


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _synchronize(results) -> None:
    """Wait until the device of the results has finished them (a no-op
    for results on the CPU)."""
    for r in results:
        if isinstance(r, torch.Tensor) and r.device.type == "cuda":
            torch.cuda.synchronize(r.device)
            return


class ServingEngine:
    """Scheduled queue and continuous batching over one :class:`Servable`.

    :meth:`step` asks the :class:`Scheduler` (default FIFO; pass
    ``scheduler="edf"`` or an instance) for one same-bucket batch and runs
    it as one ``run_batch``; served results are bitwise the same under
    every scheduler, only order and latency change. :meth:`drain` steps
    until the queue is empty; :meth:`serve_stream` replays a timed arrival
    stream, measuring each batch's service time on the injectable
    ``clock`` (the ``time`` module by default; a :class:`VirtualClock`
    makes it deterministic), and reports p50/p99 latency, throughput and
    the deadline-miss rate. A per-(bucket, batch size) EMA of measured
    service times (:meth:`service_estimate`) feeds deadline-aware
    schedulers."""

    def __init__(self, servable: Servable, *, max_batch: int | None = None,
                 scheduler: Scheduler | str | None = None, clock=None):
        self.servable = servable
        self.max_batch = (servable.max_batch if max_batch is None
                          else min(int(max_batch), servable.max_batch))
        if scheduler is None:
            scheduler = FIFOScheduler()
        elif isinstance(scheduler, str):
            if scheduler not in SCHEDULERS:
                raise ValueError(
                    f"unknown scheduler {scheduler!r}; available: "
                    f"{sorted(SCHEDULERS)}")
            scheduler = SCHEDULERS[scheduler]()
        self.scheduler = scheduler
        self.clock = clock if clock is not None else time
        self._next_id = 0
        self.completed: list[Request] = []
        #: measured EMA of batch service seconds: bucket -> {batch_size:
        #: seconds}; `service_estimate` answers from it
        self._svc: dict[Any, dict[int, float]] = {}
        self.default_service_s = 0.0

    @property
    def queue(self) -> tuple[Request, ...]:
        """Still-queued requests in arrival order (scheduler-owned)."""
        return self.scheduler.pending()

    # -- service-time model -------------------------------------------------

    def service_estimate(self, bucket, batch_size: int = 1) -> float:
        """Estimated seconds to serve a ``batch_size`` batch of
        ``bucket``: the EMA at the smallest measured batch size >=
        ``batch_size``, else the largest measured, else
        ``default_service_s``."""
        sizes = self._svc.get(bucket)
        if not sizes:
            return self.default_service_s
        for s in sorted(sizes):
            if s >= batch_size:
                return sizes[s]
        return sizes[max(sizes)]

    def seed_service_estimate(self, bucket, seconds: float, *,
                              batch_size: int = 1) -> None:
        """Pin the estimate for (bucket, batch_size)."""
        self._svc.setdefault(bucket, {})[int(batch_size)] = float(seconds)

    def _record_service(self, bucket, batch_size: int, dt: float) -> None:
        sizes = self._svc.setdefault(bucket, {})
        prev = sizes.get(int(batch_size))
        sizes[int(batch_size)] = (dt if prev is None
                                  else 0.7 * prev + 0.3 * dt)

    # -- the request path ---------------------------------------------------

    def submit(self, payload, *, t: float = 0.0,
               deadline_us: float | None = None,
               priority: int = 0) -> Request:
        """Enqueue one request arriving at ``t`` and return its
        :class:`Request`; ``result`` is filled when a :meth:`step` serves
        it."""
        req = Request(id=self._next_id, payload=payload, t_arrival=t,
                      deadline_us=deadline_us, priority=int(priority))
        self._next_id += 1
        self.scheduler.push(req)
        return req

    def step(self, *, now: float = 0.0) -> list[Request]:
        """Serve one scheduler-selected batch and return its requests; []
        when the queue is empty."""
        batch = self.scheduler.select(
            bucket_of=self.servable.bucket_of, max_batch=self.max_batch,
            now=now, est_service=self.service_estimate)
        if not batch:
            return []
        results = self.servable.run_batch([r.payload for r in batch])
        for req, res in zip(batch, results):
            req.result = res
            req.t_done = now
        self.completed.extend(batch)
        return batch

    def drain(self, *, now: float = 0.0) -> list[Request]:
        """Step until the queue is empty; returns everything completed by
        this call, in completion order."""
        done: list[Request] = []
        while self.queue:
            done.extend(self.step(now=now))
        return done

    def serve_stream(self, stream: Iterable, *,
                     payload_of: Callable = None,
                     deadline_us: float | Callable | None = None,
                     priority_of: Callable = None) -> dict:
        """Replay ``stream``, an iterable of ``(t_arrival, payload, ...)``:
        requests are admitted when the stream's clock passes their arrival,
        each batch advances it by its service time on the engine's
        ``clock`` (ending after the card has finished the batch), and an
        empty queue fast-forwards to the next arrival. ``deadline_us`` (a
        scalar or ``item -> budget_us | None``) and ``priority_of`` (``item
        -> int``) attach scheduling metadata. Returns latency, throughput
        and deadline stats (p50/p99 in ms) merged with the servable's
        counters."""
        arrivals = deque(stream)
        clock = 0.0
        latencies: list[float] = []
        submitted: list[Request] = []
        n_served = 0
        while arrivals or self.queue:
            if not self.queue and arrivals:
                clock = max(clock, float(arrivals[0][0]))
            while arrivals and float(arrivals[0][0]) <= clock:
                item = arrivals.popleft()
                payload = item[1] if payload_of is None else payload_of(item)
                d_us = (deadline_us(item) if callable(deadline_us)
                        else deadline_us)
                prio = 0 if priority_of is None else int(priority_of(item))
                submitted.append(self.submit(
                    payload, t=float(item[0]), deadline_us=d_us,
                    priority=prio))
            t0 = self.clock.monotonic()
            served = self.step(now=clock)
            # kernel launches return before the card is done: a latency
            # must wait for the logits, not for their launch
            _synchronize([r.result for r in served])
            dt = self.clock.monotonic() - t0
            clock += dt
            for req in served:
                req.t_done = clock
                latencies.append(req.latency)
            if served:
                self._record_service(
                    self.servable.bucket_of(served[0].payload),
                    len(served), dt)
            n_served += len(served)
        lat = (np.asarray(latencies, np.float64) if latencies
               else np.zeros(1))
        deadlined = [r for r in submitted if r.deadline_us is not None]
        misses = sum(r.missed for r in deadlined)
        stats = {"n_requests": n_served, "wall_s": clock,
                 "throughput_rps": n_served / max(clock, 1e-9),
                 "p50_ms": float(np.percentile(lat, 50)) * 1e3,
                 "p99_ms": float(np.percentile(lat, 99)) * 1e3,
                 "mean_ms": float(lat.mean()) * 1e3,
                 "scheduler": self.scheduler.name,
                 "n_deadlined": len(deadlined),
                 "n_deadline_misses": int(misses),
                 "deadline_miss_rate":
                     misses / len(deadlined) if deadlined else 0.0}
        stats.update(self.servable.stats())
        return stats

    def stats(self) -> dict:
        """Engine-side queue counters merged with the servable's."""
        s = {"queued": len(self.queue), "completed": len(self.completed),
             "scheduler": self.scheduler.name}
        s.update(self.servable.stats())
        return s


# ---------------------------------------------------------------------------
# the LM entry point, a thin engine client
# ---------------------------------------------------------------------------

def generate(params, cfg: ArchConfig, prompts, *, max_new_tokens: int = 32,
             temperature: float = 0.0, key=None, image_embeds=None,
             verbose: bool = False, device=None):
    """prompts (B, S) int32 -> ((B, S + max_new_tokens) on the weights'
    device, timing stats).

    The reference's signature and stats keys (``device`` added: the card
    unless ``device="cpu"``); the work flows through :class:`ServingEngine`
    and :class:`LMServable`, so on the card a second call with the same
    config, batch, lengths and weights replays the graphs the first
    captured."""
    prompts = (prompts if isinstance(prompts, torch.Tensor)
               else torch.as_tensor(np.asarray(prompts)))
    b, s = prompts.shape
    servable = LMServable(params, cfg, max_new_tokens=max_new_tokens,
                          temperature=temperature, key=key,
                          image_embeds=image_embeds, max_batch=b,
                          device=device)
    engine = ServingEngine(servable)
    reqs = [engine.submit(prompts[i]) for i in range(b)]
    engine.drain()
    out = torch.stack([r.result for r in reqs])
    st = servable.stats()
    stats = {"prefill_s": st["prefill_s"],
             "decode_tok_per_s": st["decode_tok_per_s"],
             "decode_s": st["decode_s"]}
    if verbose:
        print(f"[serve] prefill {stats['prefill_s']*1e3:.1f} ms, "
              f"{stats['decode_tok_per_s']:.1f} tok/s")
    return out, stats
