"""The dry run's JSON records (``launch/dryrun.py``) as the roofline
tables: the port's counterpart of the JAX package's ``launch/report.py``.
The fits column reads ``fits_hbm`` (the step's resident bytes within one
H100's device memory, ``hlo_analysis.HBM_PER_CHIP``), where the
reference's reads ``fits_16gb``.

Usage: PYTHONPATH=src python -m repro_torch.launch.report
       [--dir experiments/dryrun_torch] [--baseline DIR] [--mesh single]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

__all__ = ["load", "table", "failures", "main"]


def load(dirname: str) -> dict:
    out = {}
    for f in glob.glob(os.path.join(dirname, "*.json")):
        with open(f) as fh:
            r = json.load(fh)
        out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def table(records: dict, baseline: dict | None = None, mesh="single"):
    hdr = ("| arch | shape | fits | resident GiB | args GiB | compute s | "
           "memory s | collective s | bound | bound s | useful | frac |")
    sep = "|" + "---|" * 12
    lines = [hdr, sep]
    for (arch, shape, m), r in sorted(records.items()):
        if m != mesh or not r.get("ok"):
            continue
        ro, me = r["roofline"], r["memory"]
        base = ""
        if baseline:
            b = baseline.get((arch, shape, m))
            if b and b.get("ok"):
                base = f" (was {b['roofline']['bound_step_time_s']:.2f})"
        lines.append(
            f"| {arch} | {shape} | {'Y' if me.get('fits_hbm') else 'N'} | "
            f"{fmt_bytes(me.get('resident_bytes', 0))} | "
            f"{fmt_bytes(me.get('argument_size_in_bytes', 0))} | "
            f"{ro['compute_s']:.3f} | {ro['memory_s']:.3f} | "
            f"{ro['collective_s']:.3f} | {ro['bottleneck']} | "
            f"{ro['bound_step_time_s']:.3f}{base} | "
            f"{ro['useful_ratio']:.2f} | {ro['roofline_fraction']:.3f} |")
    return "\n".join(lines)


def failures(records: dict):
    return [(k, r.get("error")) for k, r in sorted(records.items())
            if not r.get("ok")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    rec = load(args.dir)
    base = load(args.baseline) if args.baseline else None
    print(table(rec, base, mesh=args.mesh))
    bad = failures(rec)
    if bad:
        print(f"\nFAILURES ({len(bad)}):")
        for k, e in bad:
            print(" ", k, e)


if __name__ == "__main__":
    main()
