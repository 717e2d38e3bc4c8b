"""Multi-pod dry run: every (architecture x input shape x mesh) cell of the
production meshes, run once as rank 0 of a fake process group on ``meta``
tensors and counted, for the roofline tables (``launch/report.py``): the
port's counterpart of the JAX package's ``launch/dryrun.py``.

Run it as its own process (``python -m repro_torch.launch.dryrun``): each
cell (:func:`count_cell`) starts a ``"fake"`` default process group of the
mesh's size (256 ranks for 'single', 512 for 'multi'; ``torch.testing``'s
``FakeStore``), in which this process is rank 0 and every collective
returns at once, and destroys it when the cell ends; nothing is started at
import.

Per cell (:func:`run_cell`, which :func:`count_cell` does the work of):

    mesh   = DeviceMesh("meta", arange(chips).reshape(sizes))
    state  = shard_tree(init_train_state(device="meta"), state_pspecs)
             (prefill, decode: lm.init(device="meta") by param_pspecs, the
             decode cache by cache_pspecs)
    with StepCounter():                       # launch/hlo_analysis.py
        make_train_step(cfg, mesh=mesh)(state, input_specs(cfg, shape))
        (make_prefill / make_serve_step(cfg, mesh=mesh) for the others)

The step is the port's own sharded step, so the counts are what this rank
would run: its operations, its eager ops' bytes, its collectives' bytes by
op and the most bytes it holds at once. The rank holds its shard of the
batch, a copy as ``NamedSharding.put`` makes it, as the reference's
``in_shardings`` give each device its shard: the argument bytes and the
peak both count that shard, and neither counts the global batch that the
step is called with (every rank calls it with the same global batch and
cuts its part). A meta tensor has no storage, so a
cell at full width and depth costs host time only (the ops' dispatch),
never memory. The reference compiles each cell under ``in_shardings`` and
reads XLA's analyses; the port has no compiler, so ``xla_*``,
``hlo_bytes``, ``scan_trip_counts`` and ``--include-text`` have no
counterpart, and ``lower_s``/``compile_s`` are ``build_s`` (the state's
init and sharding) and ``count_s`` (the counted step).

Results are cached as JSON under ``--out`` (default
``experiments/dryrun_torch``, which ``.gitignore`` lists); ``--force``
runs a cell again. A cell that
runs past ``--limit`` seconds is written with ``ok: false`` and that as its
error, as is any cell that fails.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import signal
import sys
import threading
import time
import traceback

from repro_torch.configs import ARCHS, SHAPES, Shape, get_config, input_specs
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch.mesh import MESH_AXES, MESH_SHAPES

__all__ = ["MESHES", "prod_cfg", "planned_cells", "run_cell", "count_cell",
           "fake_world", "main"]

MESHES = {"single": dict(multi_pod=False), "multi": dict(multi_pod=True)}
#: seconds a cell may run before it is written as failed
DEFAULT_LIMIT_S = 1800.0


def prod_cfg(name: str, *, extra: dict | None = None):
    cfg = get_config(name)
    over = dict(tp=16, dtype="bfloat16", remat=True)
    over.update(extra or {})
    return dataclasses.replace(cfg, **over)


def planned_cells(include_quadratic_long: bool = False):
    cells = []
    for arch in sorted(ARCHS):
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if (shape.name == "long_500k" and not cfg.sub_quadratic
                    and not include_quadratic_long):
                cells.append((arch, shape.name, "SKIP-quadratic"))
                continue
            cells.append((arch, shape.name, "run"))
    return cells


@contextlib.contextmanager
def fake_world(size: int):
    """A ``"fake"`` default process group of ``size`` ranks, this process
    rank 0 (every collective a no-op on any device, ``meta`` included),
    destroyed on exit; a default group already running is an error."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


class CellTimeLimit(Exception):
    """A cell ran past its time limit."""


@contextlib.contextmanager
def _time_limit(seconds):
    """Raise :class:`CellTimeLimit` in the block after ``seconds`` (a
    SIGALRM timer: the main thread only; elsewhere, or with no limit, no
    timer)."""
    if not seconds or threading.current_thread() is not \
            threading.main_thread():
        yield
        return

    def on_alarm(signum, frame):
        raise CellTimeLimit(f"the cell ran past its limit of {seconds} s")
    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, float(seconds))
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _batch_shard(specs: dict, mesh) -> dict:
    """A copy of the rank's part of a batch of meta tensors
    (``input_pspecs``), as ``NamedSharding.put`` makes it: the batch the
    rank holds (module docstring)."""
    from repro_torch.launch.sharding import NamedSharding, input_pspecs
    batch = {k: v for k, v in specs.items() if k != "cache"}
    ps = input_pspecs(batch, mesh)
    return {k: NamedSharding(mesh, ps[k]).put(v) for k, v in batch.items()}


def _steps_for(cfg, shape, mesh):
    """-> ``(run, arguments, stats)``: ``run()`` the cell's step once on
    ``mesh`` (its outputs), ``arguments`` what the rank holds when it
    starts (its state or parameter shards, the decode cache's shards and
    its batch shard), ``stats`` the step's ``GatherStats``."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.serve import make_prefill, make_serve_step
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig
    specs = input_specs(cfg, shape)
    batch = _batch_shard(specs, mesh)

    if shape.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
        state = init_train_state(0, cfg, opt_cfg, device="meta")
        state = shd.shard_tree(state, shd.named_shardings(
            shd.state_pspecs(state, mesh), mesh))
        step = make_train_step(cfg, opt_cfg, mesh=mesh)
        return (lambda: step(state, specs)[1], (state, batch),
                step.gather_stats)

    params = lm.init(0, cfg, device="meta")
    params = shd.shard_tree(params, shd.named_shardings(
        shd.param_pspecs(params, mesh), mesh))
    if shape.kind == "prefill":
        prefill = make_prefill(cfg, mesh=mesh)
        return (lambda: prefill(params, specs.get("ids"),
                                embeds=specs.get("embeds"),
                                image_embeds=specs.get("image_embeds")),
                (params, batch), prefill.gather_stats)

    cache = shd.shard_tree(specs["cache"], shd.named_shardings(
        shd.cache_pspecs(specs["cache"], mesh), mesh))
    step = make_serve_step(cfg, mesh=mesh)
    return (lambda: step(params, cache, specs.get("ids1"), specs["pos"],
                         embeds1=specs.get("embeds1")),
            (params, cache, batch), step.gather_stats)


def _memory_dict(res: dict) -> dict:
    """The counter's bytes in the reference's keys: every argument and
    output is alive at the end, so the peak is what the step holds
    (``resident_bytes``)."""
    args, peak = res["argument_bytes"], res["peak_bytes"]
    return {"argument_size_in_bytes": args,
            "output_size_in_bytes": res["output_bytes"],
            "temp_size_in_bytes": peak - args,
            "peak_memory_in_bytes": peak, "resident_bytes": peak,
            "fits_hbm": peak <= ha.HBM_PER_CHIP}


def _dp_pinned(cfg, shape, sizes: dict, cfg_extra):
    """The reference's pin: the activations' batch over the mesh's
    data-parallel axes where the global batch divides them (``long_500k``'s
    batch of 1 stays unpinned: its cache is cut by sequence)."""
    dp_axes = tuple(a for a in sizes if a != "model")
    n_dp = math.prod(sizes[a] for a in dp_axes)
    if shape.global_batch % n_dp == 0 and "batch_axes" not in (
            cfg_extra or {}):
        cfg = dataclasses.replace(cfg, batch_axes=dp_axes, dp_shards=n_dp)
    return cfg


def count_cell(arch: str, shape, sizes: tuple, *,
               cfg_extra: dict | None = None,
               limit_s: float | None = DEFAULT_LIMIT_S) -> dict:
    """One cell (``shape`` a name of ``SHAPES`` or a ``Shape``) on a mesh
    of ``sizes`` (2 or 3 dims, named as the production meshes of as many
    dims), as rank 0 of a fake world of ``prod(sizes)`` ranks on ``meta``
    tensors: the record :func:`run_cell` writes, but its ``mesh``."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    axes = MESH_AXES["multi" if len(sizes) == 3 else "single"]
    shape = shape if isinstance(shape, Shape) else SHAPES[shape]
    chips = math.prod(sizes)
    cfg = _dp_pinned(prod_cfg(arch, extra=cfg_extra), shape,
                     dict(zip(axes, sizes)), cfg_extra)
    rec = {"arch": arch, "shape": shape.name, "sizes": list(sizes),
           "chips": chips, "ok": False}
    # this harness measures its own run time: the real clock is the point
    t0 = time.monotonic()  # lint: allow-wall-clock
    try:
        with fake_world(chips), _time_limit(limit_s):
            mesh = DeviceMesh("meta", torch.arange(chips).reshape(sizes),
                              mesh_dim_names=axes)
            run, arguments, stats = _steps_for(cfg, shape, mesh)
            t_build = time.monotonic() - t0  # lint: allow-wall-clock
            with ha.StepCounter() as counter:
                counter.arguments(*arguments)
                counter.outputs(run())
            t_count = (time.monotonic() - t0  # lint: allow-wall-clock
                       - t_build)
        res = counter.result()
        mf = ha.model_flops(cfg, shape)
        roof = ha.roofline(
            flops_per_device=res["flops"], bytes_per_device=res["bytes"],
            collective_bytes_per_device=float(
                res["collectives"]["total_bytes"]),
            chips=chips, model_flops_global=mf)
        rec.update(ok=True, build_s=t_build, count_s=t_count,
                   memory=_memory_dict(res),
                   cost={"flops_per_device": res["flops"],
                         "bytes_per_device": res["bytes"],
                         "ops_per_device": res["ops"]},
                   collectives=res["collectives"], roofline=roof,
                   gathers=stats.as_dict())
    except Exception as e:
        elapsed = time.monotonic() - t0  # lint: allow-wall-clock
        if limit_s and (isinstance(e, CellTimeLimit) or elapsed >= limit_s):
            err = f"CellTimeLimit: the cell ran past its limit of {limit_s} s"
        else:
            err = f"{type(e).__name__}: {e}"
        rec.update(error=err, traceback=traceback.format_exc()[-4000:])
    rec["total_s"] = time.monotonic() - t0  # lint: allow-wall-clock
    return rec


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str,
             *, force: bool = False, cfg_extra: dict | None = None,
             tag: str = "", limit_s: float | None = DEFAULT_LIMIT_S) -> dict:
    """One production cell's record (:func:`count_cell` on the mesh
    ``launch.mesh.MESH_SHAPES[mesh_name]``), cached as JSON in
    ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}"
                        + (f"__{tag}" if tag else "") + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    rec = count_cell(arch, shape_name, MESH_SHAPES[mesh_name],
                     cfg_extra=cfg_extra, limit_s=limit_s)
    rec.update(mesh=mesh_name, tag=tag, limit_s=limit_s)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--include-quadratic-long", action="store_true",
                    help="also run long_500k decode for full-attention "
                         "archs (decode is O(S))")
    ap.add_argument("--limit", type=float, default=DEFAULT_LIMIT_S,
                    help="seconds a cell may run before it is written as "
                         "failed")
    args = ap.parse_args(argv)

    cells = planned_cells(args.include_quadratic_long)
    if args.list:
        for c in cells:
            print(*c)
        return 0
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = 0
    for mesh_name in meshes:
        for arch, shape_name, status in cells:
            if args.arch not in ("all", arch):
                continue
            if args.shape not in ("all", shape_name):
                continue
            if status.startswith("SKIP"):
                print(f"[dryrun] {arch} x {shape_name}: {status} "
                      "(see DESIGN.md §5)")
                continue
            rec = run_cell(arch, shape_name, mesh_name, args.out,
                           force=args.force, limit_s=args.limit)
            if rec["ok"]:
                r = rec["roofline"]
                m = rec["memory"]
                print(f"[dryrun] OK {arch} x {shape_name} x {mesh_name}: "
                      f"count={rec.get('count_s', 0):.0f}s "
                      f"resident={m['resident_bytes'] / 2**30:.2f}GiB "
                      f"bottleneck={r['bottleneck']} "
                      f"terms(c/m/x)={r['compute_s']:.2e}/"
                      f"{r['memory_s']:.2e}/{r['collective_s']:.2e}s",
                      flush=True)
            else:
                failures += 1
                print(f"[dryrun] FAIL {arch} x {shape_name} x "
                      f"{mesh_name}: {rec['error']}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
