"""Readings that the limits of ``correct`` are set from (not part of a run).

    python3 bench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n,n,...> [--control-seeds <n,n,...>]

Runs the cell in one process once per seed, each time a short window at
the cell's own load and sizes, and prints one JSON line per run with the
numbers ``correct`` compares: first the program's, then the control's
(the reference one precision below the configuration's in the program's
place), then the program's with each fault planted under its timed path
(both in ``benchlib/control.py``).
"""
import contextlib
import json
import pathlib
import sys
import time

from benchlib import control, harness, judge, manifest


def main(argv) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="bench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="",
                   help="faults of benchlib/control.py to plant, each run "
                        "on every --fault-seeds seed")
    p.add_argument("--fault-seeds", default="")
    args = p.parse_args(argv)
    root = pathlib.Path(__file__).resolve().parent.parent
    man = manifest.load(root)
    cell = manifest.cell(man, args.workload)
    config = manifest.config(root, man, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    runs = ([("program", int(s)) for s in args.seeds.split(",") if s]
            + [("control", int(s)) for s in args.control_seeds.split(",")
               if s]
            + [(f, int(s)) for f in args.faults.split(",") if f
               for s in args.fault_seeds.split(",") if s])
    for kind, seed in runs:
        ctx = (control.in_place_of_the_program() if kind == "control"
               else control.planted(kind) if kind in control.FAULTS
               else contextlib.nullcontext())
        t = time.perf_counter()
        with ctx:
            env = harness.measure(cell, config, traffic, seed=seed,
                                  seconds=args.seconds, trace=False,
                                  device="cuda", t_start=t)
        checks = judge.compare(config, env.weights, env.judged, env.failed)
        print(json.dumps({"workload": cell["name"], "kind": kind,
                          "seed": seed, "attempted": env.attempted,
                          "failed": env.failed,
                          "judged": sum(len(c) for c, _ in env.judged),
                          "checks": checks,
                          "correct": judge.correct(checks)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
