"""The knee of a served cell: the highest offered rate at which the
backlog does not grow (not part of a run).

    python3 bench/sweep.py --workload <served cell> --seed <n> \
        --seconds <s> --sensors <n>

Runs the cell's traffic once with ``--sensors`` sensors, the rest of its
traffic file unchanged, and prints one JSON line: offered and completed
clouds a second, p50 and p95 latency, the requests a batch, and the mean
latency of the first and last quarter of the requests by due time. The
backlog grows where the last quarter waits more than twice as long as the
first, or a request is never served. Give each rate a process of its own,
as a run has: the program's heap then grows from the same start.
"""
import json
import pathlib
import sys
import time

import numpy as np

from benchlib import harness, manifest, stats


def main(argv) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="bench/sweep.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--sensors", type=int, required=True)
    args = p.parse_args(argv)
    root = pathlib.Path(__file__).resolve().parent.parent
    man = manifest.load(root)
    cell = manifest.cell(man, args.workload)
    config = manifest.config(root, man, cell["config"])
    traffic = dict(manifest.traffic(cell["traffic"]), sensors=args.sensors)
    env = harness.measure(cell, config, traffic, seed=args.seed,
                          seconds=args.seconds, trace=False, device="cuda",
                          t_start=time.perf_counter())
    lat = env.latency_s
    q = max(1, len(lat) // 4)
    first, last = float(np.mean(lat[:q])), float(np.mean(lat[-q:]))
    print(json.dumps({
        "workload": cell["name"], "sensors": args.sensors,
        "offered_per_s": env.attempted / args.seconds,
        "completed_per_s": env.clouds / args.seconds,
        "failed": env.failed,
        "p50_ms": 1e3 * stats.nearest_rank(lat, 50),
        "p95_ms": 1e3 * stats.nearest_rank(lat, 95),
        "p99_ms": 1e3 * stats.nearest_rank(lat, 99),
        "first_quarter_ms": 1e3 * first, "last_quarter_ms": 1e3 * last,
        "batch_fill": env.counters["requests"]
        / max(env.counters["batches"], 1),
        "grows": bool(env.failed or last > 2 * first
                      or not np.isfinite(lat).all())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
