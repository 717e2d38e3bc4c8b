"""Traffic kind ``fleet``: a perception service for a fleet of LiDAR
sensors, an open loop on the host clock.

Parameters (the traffic file): ``sensors``, unsynchronised: each has a
phase drawn uniformly, and a frame rate drawn uniformly within
``rate_spread`` (a fraction) of ``frame_hz``, so that frames of different
sensors collide, and their alignments drift through each other over the
window. Every frame brings a Poisson number of object clouds of mean
``objects_mean`` (at least one), of the configuration's point count, all
due at the frame's time. Phases, rates and counts are drawn from the
file's ``arrivals_seed``, so that every run's seed offers the same
arrivals and the same set of frame sizes; the run's seed deals the sizes
to the frames in another order and draws each request's cloud from a pool
of ``pool_clouds`` distinct clouds made from the seed, handed to the
service as host arrays. The requests go to the program's
``ServingEngine`` (``scheduler``) over ``PointCloudServable`` with the
file's ``buckets`` and ``plan_cache``; ``sample_requests`` served rows are
compared with the reference.

A request's latency runs from its due time to the time its logits are on
the host after a synchronize. The window is the requests due in the first
``seconds``; after it the service runs on until the last of them is
served or ``drain_s`` has passed, and a request not served by then is
missing.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from . import inputs, program
from .trace import WINDOW, profiled, sync

#: the host sleeps until this long before a frame is due, then spins
SPIN_S = 0.001


def schedule(tr: dict, seconds: float, seed: int):
    """The frames due in the window, by due time: ``(due, counts, order)``,
    each frame's due time and object count, and the pool index of each
    request in due order."""
    arrivals = np.random.default_rng(tr["arrivals_seed"])
    n = tr["sensors"]
    phase = arrivals.random(n)
    rate = tr["frame_hz"] * (1.0 + tr["rate_spread"]
                             * (2.0 * arrivals.random(n) - 1.0))
    due = np.sort(np.concatenate([
        (np.arange(int(math.ceil(seconds * r)) + 1) + p) / r
        for p, r in zip(phase, rate)]))
    due = due[due < seconds]
    sizes = np.maximum(arrivals.poisson(tr["objects_mean"], len(due)), 1)
    rng = np.random.default_rng(seed)
    counts = rng.permutation(sizes)
    order = rng.integers(0, tr["pool_clouds"], int(counts.sum()))
    return due, counts, order


def _wait_until(t: float) -> None:
    left = t - time.perf_counter()
    if left > SPIN_S:
        time.sleep(left - SPIN_S)
    while time.perf_counter() < t:
        pass


def run(env):
    cfg, tr = env.config, env.traffic
    pool = inputs.surface_clouds(tr["pool_clouds"], cfg["n_points"],
                                 env.seed, env.device)[0].cpu().numpy()
    env.mark("inputs")
    model = program.build_model(cfg, env.weights, env.device)
    serv, eng = program.servable(model, tr)
    env.mark("compile_model")
    # warm up and capture every batch bucket: a Poisson number of objects
    # a frame reaches each of them
    for b in tr["buckets"]["batch"]:
        for _ in range(3):
            for i in range(b):
                eng.submit(pool[i])
            eng.step()
            sync(env.device)
    env.mark("warm-up and capture")

    due, counts, order = schedule(tr, env.seconds, env.seed)
    first = np.concatenate([[0], np.cumsum(counts)])
    n_req = int(first[-1])
    start = np.full(n_req, np.nan)
    done = np.full(n_req, np.nan)
    rows = np.full((n_req, cfg["head"][-1]), np.nan, np.float32)
    rid_of: dict[int, int] = {}
    spans = env.spans
    stats0 = serv.stats()
    with profiled(env.trace) as prof:
        t0 = time.perf_counter() + 0.01
        _wait_until(t0)
        with spans.span(WINDOW):
            env.window_start = t0
            f = 0
            while True:
                now = time.perf_counter() - t0
                while f < len(due) and due[f] <= now:
                    for rid in range(first[f], first[f + 1]):
                        req = eng.submit(pool[order[rid]], t=float(due[f]))
                        rid_of[req.id] = rid
                    f += 1
                if eng.queue:
                    t_step = time.perf_counter() - t0
                    with spans.span("bench.step"):
                        served = eng.step(now=now)
                    with spans.span("bench.fetch"):
                        host = (torch.stack([r.result for r in served]).cpu()
                                if served else torch.empty(0))
                    t_done = time.perf_counter() - t0
                    for r, row in zip(served, host.numpy()):
                        rid = rid_of.pop(r.id)
                        start[rid], done[rid], rows[rid] = t_step, t_done, row
                elif f >= len(due):
                    break
                else:
                    with spans.span("bench.idle"):
                        _wait_until(t0 + due[f])
                if now > env.seconds + tr["drain_s"]:
                    break
    stats1 = serv.stats()
    env.model = model
    env.prof = prof
    env.window_s = env.seconds
    env.attempted = n_req
    served = ~np.isnan(done)
    env.failed = int(n_req - served.sum())
    env.clouds = int(served.sum())
    due_r = np.repeat(due, counts)
    env.latency_s = np.where(served, done - due_r, np.inf)
    env.queue_wait_s = (start - due_r)[served]
    env.counters = {k: stats1[k] - stats0[k] for k in ("requests", "batches")}

    rng = np.random.default_rng(env.seed)
    ok = np.flatnonzero(served)
    picks = np.sort(rng.choice(ok, size=min(tr["sample_requests"], len(ok)),
                               replace=False))
    clouds = torch.from_numpy(pool[order[picks]]).to(env.device)
    env.judged = [(clouds, torch.from_numpy(rows[picks]).to(env.device))]
