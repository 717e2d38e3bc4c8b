"""Traffic kind ``offline``: offline classification of recorded
object sets, a closed loop of whole batches.

Parameters (the traffic file): ``batch`` clouds a call, a pool of
``pool_batches`` distinct batches made on the device from the seed and
cycled, ``in_flight`` calls queued before the host waits for the oldest,
``sample_batches`` batches compared with the reference.

Each call is the program's ``jit_batched_forward``; every call's logits
are kept. The rate is every cloud completed over the whole window, from
the first call to the end of the last.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import inputs, program
from .trace import WINDOW, profiled, sync


def run(env):
    cfg, tr = env.config, env.traffic
    batch, n_pool = tr["batch"], tr["pool_batches"]
    pool = inputs.surface_clouds(batch * n_pool, cfg["n_points"], env.seed,
                                 env.device)[0]
    pool = pool.view(n_pool, batch, cfg["n_points"], 3)
    env.mark("inputs")
    model = program.build_model(cfg, env.weights, env.device)
    env.mark("compile_model")
    # the cell's one shape: captured on the first call, then replayed
    for _ in range(3):
        model.jit_batched_forward(pool[0])
    sync(env.device)
    env.mark("warm-up and capture")

    spans, outs, events = env.spans, [], []
    lag = tr["in_flight"] - 1
    with profiled(env.trace) as prof:
        with spans.span(WINDOW):
            t0 = time.perf_counter()
            env.window_start = t0
            while time.perf_counter() - t0 < env.seconds:
                i = len(outs)
                with spans.span("bench.enqueue"):
                    outs.append(model.jit_batched_forward(pool[i % n_pool]))
                if env.device.type == "cuda":
                    events.append(torch.cuda.Event())
                    events[-1].record()
                    if i >= lag:
                        with spans.span("bench.wait"):
                            events[i - lag].synchronize()
            with spans.span("bench.wait"):
                sync(env.device)
            window_s = time.perf_counter() - t0
    env.model = model
    env.prof = prof
    env.window_s = window_s
    env.batches = len(outs)
    env.clouds = env.attempted = batch * len(outs)
    env.failed = 0

    rng = np.random.default_rng(env.seed)
    picks = rng.choice(len(outs), size=min(tr["sample_batches"], len(outs)),
                       replace=False)
    env.judged = [(pool[int(p) % n_pool], outs[int(p)]) for p in picks]

