"""The point-cloud serving tier: one engine over a ``CompiledModel``.

The port's copy of the point-cloud half of ``repro.launch.serve``, with the
same classes, rules and counters:

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
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.core.schedule import (DevicePlan, FrameTracker, PlanCache,
                                       cloud_content_key, host_array)

__all__ = [
    "ShapeBuckets",
    "Request",
    "Servable",
    "PointCloudServable",
    "Scheduler",
    "FIFOScheduler",
    "EDFScheduler",
    "SCHEDULERS",
    "VirtualClock",
    "ServingEngine",
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
    most one capture, shared by every servable of the model. ``mesh=``
    (replica fan-out) is not ported: anything but None raises.
    """

    def __init__(self, model, *, buckets: ShapeBuckets | None = None,
                 plan_cache: PlanCache | bool | None = True,
                 mesh=None,
                 frame_reuse: FrameTracker | bool = False):
        if mesh is not None:
            raise ValueError(
                "mesh= is not supported by the port: replica fan-out needs "
                "the launch mesh and batch sharding (launch/mesh.py, "
                "sharding.py), which are not ported yet; pass mesh=None")
        self.model = model
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
            logits = self.model.jit_batched_forward(padded, n_valid=n_valid,
                                                    dplan=dplan)
        else:
            logits = self.model.batched_forward(padded, n_valid=n_valid)
        self.requests += b_real
        self.batches += 1
        return list(logits[:b_real])

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
