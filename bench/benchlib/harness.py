"""One run of one cell: set up, measure the window, read the metrics,
judge the outputs, print the result line."""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import pathlib
import sys
import time
from types import SimpleNamespace

from . import judge, manifest
from .trace import DeviceTrace, Spans

#: top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list[str]:
    """The top-level names among ``names`` (by default the loaded modules)
    that are one of :data:`FORBIDDEN`, compared whole: ``repro_torch`` is
    not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def _runner(kind: str):
    """The ``run(env)`` of traffic kind ``kind``: ``benchlib/<kind>.py``."""
    return importlib.import_module(f"{__package__}.{kind}").run


def measure(cell: dict, config: dict, traffic: dict, *, seed: int,
            seconds: float, trace: bool, device, t_start: float):
    """Set up and run the cell's window once on ``device``: the run's
    record, its program freed (the reference runs after it), with the
    device's peak memory and, where traced, the trace read."""
    import torch
    from . import inputs
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    marks = [("start", t_start), ("imports", time.perf_counter())]
    env = SimpleNamespace(cell=cell, config=config, traffic=traffic,
                          seed=int(seed), seconds=float(seconds),
                          trace=bool(trace), device=dev,
                          spans=Spans(bool(trace)), counters={},
                          mark=lambda name: marks.append(
                              (name, time.perf_counter())))
    env.weights = inputs.he_weights(config, env.seed, dev)
    env.mark("weights")
    _runner(traffic["kind"])(env)
    env.setup_s = env.window_start - t_start
    marks.append(("until the window", env.window_start))
    env.setup_split = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    env.peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
    env.trace_reading = DeviceTrace(env.prof) if env.prof is not None \
        else None
    env.prof = None
    del env.model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return env


def run_cell(cell: dict, config: dict, traffic: dict, metrics: list[dict],
             *, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Run the cell once on ``device`` and return the result line's
    object. ``metrics`` are the manifest's entries the run reports."""
    import torch
    env = measure(cell, config, traffic, seed=seed, seconds=seconds,
                  trace=trace, device=device, t_start=t_start)
    dev, peak = env.device, env.peak
    values = {}
    for m in metrics:
        v = manifest.reader(m["name"])(env)
        if v is not None and math.isfinite(v):
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = judge.compare(config, env.weights, env.judged, env.failed)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": judge.correct(checks), "attempted": int(env.attempted),
           "failed": int(env.failed), "metrics": values,
           "device": device_info}
    if env.trace_reading is not None:
        device_info["busy_s"] = env.trace_reading.busy_s
        device_info["window_s"] = env.trace_reading.window_s
        out["breakdown"] = env.trace_reading.breakdown()
    if dev.type == "cuda":
        from .work import power_limit
        device_info["power_limit"] = power_limit()
    out["setup_split"] = env.setup_split
    out["checks"] = checks
    return out


def main(argv, *, t_start: float, root: pathlib.Path) -> int:
    p = argparse.ArgumentParser(prog="bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    man = manifest.load(root)
    cell = manifest.cell(man, args.workload)
    config = manifest.config(root, man, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    metrics = (manifest.per_layer(man, cell["name"]) if args.trace
               else manifest.end_to_end(man, cell["name"]))

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"bench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 3
    out = run_cell(cell, config, traffic, metrics, seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace),
                   device="cuda", t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"bench: forbidden modules were loaded: {bad}",
              file=sys.stderr)
        return 4
    print("setup split (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in out.pop("setup_split").items()),
        file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
