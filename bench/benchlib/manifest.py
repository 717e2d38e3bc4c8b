"""``BENCHMARK.json`` and the data files it names.

Everything that belongs to one configuration, traffic mix, metric or
layer lives in a file of its own, found by name:

- ``bench/configs/<config>.json`` (the file the manifest names);
- ``bench/traffic/<traffic>.json``;
- ``bench/metrics/<metric>.py``, a reader with ``read(ctx)`` (or
  ``<name>.py`` for every ``<name>.<split>`` read alike);
- ``bench/kernels/<table>.json``, a layer's kernel names.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re

BENCH = pathlib.Path(__file__).resolve().parent.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: pathlib.Path) -> dict:
    path = pathlib.Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in manifest['workloads']]}")


def config(root: pathlib.Path, manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((pathlib.Path(root) / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def kernel_table(name: str) -> dict:
    """``{"layer": ..., "patterns": [...]}``: a kernel is the layer's when
    one of the patterns is a substring of its name."""
    return json.loads((BENCH / "kernels" / f"{name}.json").read_text())


def reader(metric: str):
    """The ``read(ctx)`` of ``bench/metrics/<metric>.py``, or, where there
    is none, of the file named by the part before the first dot: one
    reader serves every split ``<name>.<split>`` that is read alike."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = BENCH / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def end_to_end(manifest: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in manifest["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(manifest: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics a traced run of the cell reads: those that
    list it, and those without a list whose ``moves`` the cell reports."""
    moved = {m["name"] for m in end_to_end(manifest, cell_name)}
    return [m for m in manifest["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def problems(manifest: dict) -> list[str]:
    """What in the manifest breaks the naming rules or leaves a metric's
    ``moves`` unreported in a cell that lists it."""
    out = []
    names = ([c["name"] for c in manifest["configs"]]
             + [w["name"] for w in manifest["workloads"]]
             + [m["name"] for m in manifest["end_to_end"]]
             + [m["name"] for m in manifest["per_layer"]]
             + [w["config"] for w in manifest["workloads"]]
             + [w["traffic"] for w in manifest["workloads"]]
             + [k for c in manifest["configs"] for k in c["reduced"]])
    out += [f"bad name {n!r}" for n in names if not NAME.match(n)]
    units = [m["unit"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    out += [f"bad unit {u!r}" for u in units if not UNIT.match(u)]
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        for c in m.get("workloads", []):
            if c not in cells:
                out.append(f"{m['name']} lists unknown cell {c}")
            elif m["moves"] not in {e["name"] for e in end_to_end(manifest,
                                                                  c)}:
                out.append(f"{m['name']} moves {m['moves']}, which {c} "
                           f"does not report")
    return out
