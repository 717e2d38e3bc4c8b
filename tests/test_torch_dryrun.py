"""The port's dry run and roofline tools (``repro_torch.launch.dryrun``,
``hlo_analysis``, ``report``) against the JAX package's, on the CPU.

- ``model_flops`` equals the reference's for every config and shape, at
  the configs' own TP degree and at the dry run's (``prod_cfg``);
  ``roofline`` given the reference's hardware equals the reference's;
- ``planned_cells``, ``prod_cfg`` and ``MESHES`` equal the reference's
  (``repro.launch.dryrun`` forces 512 host devices at import, so it is
  read in a subprocess), and ``python -m repro_torch.launch.dryrun
  --list`` prints the reference's cells;
- ``report.table`` and ``report.failures`` print the reference's lines on
  the same records (``fits_hbm`` where the reference reads
  ``fits_16gb``);
- P4 on ``meta`` tensors: the plain version's shape and dtype, no launch;
- cells counted on ``meta`` as rank 0 of a fake world of 8 on a (4, 2)
  mesh (``count_cell``, which starts and destroys the group): a
  ``reduced()`` cell of each step kind for a dense, an ssm and a hybrid
  config, its operations per data-parallel rank (``flops`` x chips /
  'model' ranks: each 'model' rank computes every replicated leaf's block)
  over ``model_flops`` within 5% of the ratio measured for its family and
  step kind (:data:`FLOPS_RATIO`); the same step with one layer fewer
  falls outside that band; its argument bytes the sum of the ``state_pspecs`` (``param_pspecs``,
  ``cache_pspecs``) shards' bytes and the batch's shard; and, for a config
  whose attention and MLP shard over 'data' and 'model', the all-gather
  and reduce-scatter bytes the hand count from ``gather_plan`` (each
  gathered leaf all-gathered over 'data' in each layer's forward and again
  for its backward, its gradient reduce-scattered once) and
  ``step.gather_stats``'s gathered bytes, plus the block-boundary
  activations' all-gathers over 'model' (:func:`_boundary_bytes`); no
  default group left behind;
- the boundary cut over 'model' (the reference's ``_shard_batch``): a
  train cell with its batch pinned against the same cell unpinned, the
  peak lower by each checkpointed layer's half of its input, the
  all-gathers higher by three whole boundaries a layer, the operations
  equal;
- the meta count's operations equal ``FlopCounterMode``'s on the CPU for
  the same sharded step (the card's equality is ``chip_smoke.py``'s);
- ``run_cell`` writes the reference's record (``fits_hbm`` for
  ``fits_16gb``) and reads it back until ``force``; a cell past its time
  limit is written as failed, the limit its error.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: (4, 2): 'data' 4, 'model' 2; the cells' small shapes (batch divides 4)
MESH = (4, 2)
TINY = {"train": ("tiny_train", "train", 64, 16),
        "prefill": ("tiny_prefill", "prefill", 64, 16),
        "decode": ("tiny_decode", "decode", 64, 16)}
#: per-rank operations over ``model_flops``, as counted on this tree for
#: :func:`test_reduced_cell_counts`' configs, by (family, step kind).
#: Above 1: the products that the analytic count leaves out (the masked
#: halves of the attention chunks, which it counts causal, the flash
#: backward's recomputed scores, and a train step's recomputed forward of
#: each checkpointed layer: ``prod_cfg`` sets ``cfg.remat``). Below 1: the prefill's head at the last
#: position only (``model_flops`` counts it at every token); RWKV's untied
#: embedding table, which ``model_flops`` counts in N and the port reads by
#: a gather; the state-space scans' state math, which ``model_flops`` adds
#: and ``FlopCounterMode`` does not count (no matrix product). The counts
#: are exact; the band leaves room for a change of chunking, and a step
#: that skips one of its layers (2 in dense and ssm, 5 in hybrid: 11-50%
#: fewer) or half its backward falls outside it.
FLOPS_RATIO = {("dense", "train"): 1.356, ("dense", "prefill"): 0.832,
               ("dense", "decode"): 1.000, ("ssm", "train"): 0.933,
               ("ssm", "prefill"): 0.575, ("ssm", "decode"): 0.740,
               ("hybrid", "train"): 1.176, ("hybrid", "prefill"): 0.924,
               ("hybrid", "decode"): 0.881}
#: how far, relatively, a cell's ratio may lie from :data:`FLOPS_RATIO`'s
FLOPS_BAND = 0.05
#: the configs of :func:`test_reduced_cell_counts`, one a family
REDUCED = ["qwen1.5-0.5b-reduced", "rwkv6-3b-reduced", "zamba2-7b-reduced"]
#: widths at which q/k/v/o and the MLP shard over 'data' and 'model' (every
#: such leaf at least 1M elements) and compute on 'model' shards
SHARDED = {"d_model": 1024, "n_heads": 8, "n_kv_heads": 8, "d_head": 128,
           "d_ff": 2048, "vocab_size": 2048, "tp": 2}

_REF_DRYRUN = """
import dataclasses, json
from repro.launch import dryrun
from repro.configs import ARCHS
print(json.dumps({
    "cells": dryrun.planned_cells(),
    "cells_long": dryrun.planned_cells(True),
    "meshes": dryrun.MESHES,
    "prod": {a: dataclasses.asdict(dryrun.prod_cfg(a)) for a in ARCHS},
    "extra": dataclasses.asdict(dryrun.prod_cfg("qwen1.5-0.5b",
                                                extra={"tp": 4}))}))
"""


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from repro.configs import SHAPES, get_config
    from repro.launch import hlo_analysis, report
    return {"ha": hlo_analysis, "report": report,
            "get_config": get_config, "SHAPES": SHAPES}


@pytest.fixture(scope="module")
def ref_dryrun():
    pytest.importorskip("jax")
    out = subprocess.run([sys.executable, "-c", _REF_DRYRUN], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _shape(kind: str):
    from repro_torch.configs import Shape
    return Shape(*TINY[kind])


# ---------------------------------------------------------------------------
# the reference's arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [None, 16])
def test_model_flops_is_the_references(ref, tp):
    from repro_torch.configs import ARCHS, SHAPES, get_config
    from repro_torch.launch import hlo_analysis as ha
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), ref["get_config"](arch)
        if tp:
            cfg = dataclasses.replace(cfg, tp=tp)
            rcfg = dataclasses.replace(rcfg, tp=tp)
        for name, shape in SHAPES.items():
            assert ha.model_flops(cfg, shape) == \
                ref["ha"].model_flops(rcfg, ref["SHAPES"][name]), (arch, name)


def test_roofline_on_the_references_hardware_is_the_references(ref):
    from repro_torch.launch import hlo_analysis as ha
    for flops, nbytes, coll in ((1e15, 1e9, 1e6), (1e9, 1e12, 1e6),
                                (1e9, 1e6, 1e12), (0.0, 0.0, 0.0)):
        kw = dict(flops_per_device=flops, bytes_per_device=nbytes,
                  collective_bytes_per_device=coll, chips=256,
                  model_flops_global=3e17)
        got = ha.roofline(**kw, hw=ref["ha"].HW)
        want = ref["ha"].roofline(**kw)
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, float) and math.isnan(v):
                assert math.isnan(got[k]), k
            else:
                assert got[k] == v, k


def test_roofline_defaults_to_the_h100():
    from repro_torch.launch import hlo_analysis as ha
    got = ha.roofline(flops_per_device=989e12, bytes_per_device=3.35e12,
                      collective_bytes_per_device=25e9, chips=1,
                      model_flops_global=989e12)
    assert got["compute_s"] == got["memory_s"] == 1.0
    assert got["collective_s"] == 0.5 and got["useful_ratio"] == 1.0


def test_planned_cells_and_prod_cfg_are_the_references(ref_dryrun):
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    assert [list(c) for c in dryrun.planned_cells()] == ref_dryrun["cells"]
    assert [list(c) for c in dryrun.planned_cells(True)] == \
        ref_dryrun["cells_long"]
    assert dryrun.MESHES == ref_dryrun["meshes"]
    for arch in ARCHS:
        got = json.loads(json.dumps(dataclasses.asdict(dryrun.prod_cfg(arch))))
        assert got == ref_dryrun["prod"][arch], arch
    got = dataclasses.asdict(dryrun.prod_cfg("qwen1.5-0.5b",
                                             extra={"tp": 4}))
    assert json.loads(json.dumps(got)) == ref_dryrun["extra"]


def test_list_prints_the_references_cells(ref_dryrun):
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--list"], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines() == [" ".join(c)
                                       for c in ref_dryrun["cells"]]


def _records(fits_key: str) -> dict:
    def rec(arch, shape, mesh, ok, fits=True, bound=0.5):
        r = {"arch": arch, "shape": shape, "mesh": mesh, "ok": ok}
        if not ok:
            r["error"] = "RuntimeError: boom"
            return r
        r["memory"] = {fits_key: fits, "resident_bytes": 3 * 2**30,
                       "argument_size_in_bytes": 2**29}
        r["roofline"] = {"compute_s": 0.1, "memory_s": bound,
                         "collective_s": 0.2, "bottleneck": "memory",
                         "bound_step_time_s": bound, "useful_ratio": 0.75,
                         "roofline_fraction": 0.1 / bound}
        return r
    rows = [rec("qwen1.5-0.5b", "train_4k", "single", True),
            rec("grok-1-314b", "train_4k", "single", True, fits=False,
                bound=7.25),
            rec("rwkv6-3b", "long_500k", "multi", True),
            rec("zamba2-7b", "prefill_32k", "single", False)]
    return {(r["arch"], r["shape"], r["mesh"]): r for r in rows}


def test_report_prints_the_references_lines(ref, tmp_path):
    from repro_torch.launch import report
    port, theirs = _records("fits_hbm"), _records("fits_16gb")
    base_port = {k: dict(v) for k, v in port.items()}
    base_ref = {k: dict(v) for k, v in theirs.items()}
    for mesh in ("single", "multi"):
        assert report.table(port, mesh=mesh) == \
            ref["report"].table(theirs, mesh=mesh)
        assert report.table(port, base_port, mesh=mesh) == \
            ref["report"].table(theirs, base_ref, mesh=mesh)
    assert report.failures(port) == ref["report"].failures(theirs)
    # load reads the dry run's files
    for r in port.values():
        (tmp_path / f"{r['arch']}__{r['shape']}__{r['mesh']}.json").write_text(
            json.dumps(r))
    assert report.load(str(tmp_path)) == port


# ---------------------------------------------------------------------------
# P4 on meta tensors
# ---------------------------------------------------------------------------

def test_p4_on_meta_gives_the_plain_shape_and_launches_nothing():
    from repro_torch.kernels import gather_backward as gb
    g = torch.randn(2, 5, 3)
    idx = torch.tensor([[0, 2, 2, 1, 0], [3, 3, 0, 1, 2]])
    want = gb.gather_rows_backward(g, idx, 4)
    before = dict(gb.LAUNCHES)
    got = gb.gather_rows_backward(g.to("meta"), idx.to("meta"), 4)
    assert got.device.type == "meta"
    assert got.shape == want.shape and got.dtype == want.dtype
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(4, 3, device="meta", dtype=dtype, requires_grad=True)
        y = gb.gather_rows(x, idx.to("meta"))
        (gx,) = torch.autograd.grad(y.sum(), x)
        assert gx.shape == x.shape and gx.dtype == dtype
    assert gb.LAUNCHES == before


def test_a_kernel_wrapper_without_a_meta_rule_still_refuses_meta():
    from repro_torch.kernels import _build
    with pytest.raises(ValueError, match="no kernel for device meta"):
        _build.runs_plain(torch.empty(2, device="meta"))


# ---------------------------------------------------------------------------
# cells counted on meta in a fake world
# ---------------------------------------------------------------------------

def _cell(arch: str, kind: str, extra=None) -> dict:
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    rec = dryrun.count_cell(arch, _shape(kind), MESH,
                            cfg_extra=dict({"tp": 2}, **(extra or {})),
                            limit_s=600)
    assert not dist.is_initialized()
    assert rec["ok"], rec.get("traceback", rec.get("error"))
    return rec


def _local_bytes(tree, specs, sizes: dict) -> int:
    """The rank's shard bytes of a tree of meta tensors cut by ``specs``,
    by hand: each dim over the product of its entry's axis sizes."""
    from repro_torch.optim import tree_leaves
    total = 0
    for leaf, spec in zip(tree_leaves(tree), _spec_leaves(specs)):
        n = leaf.numel()
        for entry in spec:
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            n //= math.prod(sizes[a] for a in axes)
        total += n * leaf.element_size()
    return total


def _spec_leaves(specs) -> list:
    from repro_torch.launch.sharding import PartitionSpec
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    assert isinstance(specs, PartitionSpec)
    return [specs]


def _cfg(arch: str, kind: str, extra=None):
    from repro_torch.launch import dryrun
    extra = dict({"tp": 2}, **(extra or {}))
    return dryrun._dp_pinned(dryrun.prod_cfg(arch, extra=extra),
                             _shape(kind), {"data": 4, "model": 2}, extra)


def _hand_argument_bytes(cfg, kind: str) -> int:
    from repro_torch.configs import input_specs
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.train import init_train_state
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig
    mesh = MeshShape(MESH, ("data", "model"))
    sizes = mesh.shape
    specs = input_specs(cfg, _shape(kind))
    batch = {k: v for k, v in specs.items() if k != "cache"}
    total = _local_bytes(batch, shd.input_pspecs(batch, mesh), sizes)
    if kind == "train":
        state = init_train_state(0, cfg, AdamWConfig(
            moment_dtype=cfg.opt_moment_dtype), device="meta")
        return total + _local_bytes(state, shd.state_pspecs(state, mesh),
                                    sizes)
    params = lm.init(0, cfg, device="meta")
    total += _local_bytes(params, shd.param_pspecs(params, mesh), sizes)
    if kind == "decode":
        total += _local_bytes(specs["cache"],
                              shd.cache_pspecs(specs["cache"], mesh), sizes)
    return total


def _flops_ratio(rec: dict, cfg, kind: str) -> float:
    """A cell's operations per data-parallel rank over ``cfg``'s
    ``model_flops`` (module docstring)."""
    from repro_torch.launch import hlo_analysis as ha
    per_part = rec["cost"]["flops_per_device"] * rec["chips"] / MESH[1]
    return per_part / ha.model_flops(cfg, _shape(kind))


def _in_band(ratio: float, cfg, kind: str) -> bool:
    return abs(ratio / FLOPS_RATIO[cfg.family, kind] - 1) <= FLOPS_BAND


@pytest.mark.parametrize("arch", REDUCED)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_reduced_cell_counts(arch, kind):
    from repro_torch.launch import hlo_analysis as ha
    rec = _cell(arch, kind)
    cfg = _cfg(arch, kind)
    ratio = _flops_ratio(rec, cfg, kind)
    assert _in_band(ratio, cfg, kind), ratio
    assert rec["memory"]["argument_size_in_bytes"] == \
        _hand_argument_bytes(cfg, kind)
    assert rec["memory"]["peak_memory_in_bytes"] >= \
        rec["memory"]["argument_size_in_bytes"]
    roof = rec["roofline"]
    assert roof["compute_s"] == rec["cost"]["flops_per_device"] / ha.PEAK_FLOPS


@pytest.mark.parametrize("arch", REDUCED)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_a_step_with_a_layer_fewer_falls_outside_the_band(arch, kind):
    """The cell's step at one layer fewer, held against the whole config's
    ``model_flops``: what a step that skipped a layer would count."""
    cfg = _cfg(arch, kind)
    rec = _cell(arch, kind, {"n_layers": cfg.n_layers - 1})
    assert not _in_band(_flops_ratio(rec, cfg, kind), cfg, kind)


def test_gathers_are_the_hand_count_from_gather_plan():
    """At :data:`SHARDED` widths every block's weights shard over 'data'
    and 'model': the step all-gathers each over 'data' (4 ranks) in its
    layer's forward and again for its backward, and reduce-scatters its
    gradient once; the embedding and head compute on their 'model' shards
    and gather nothing."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.train import init_train_state
    from repro_torch.optim import AdamWConfig
    arch = "qwen1.5-0.5b-reduced"
    rec = _cell(arch, "train", SHARDED)
    cfg = _cfg(arch, "train", SHARDED)
    mesh = MeshShape(MESH, ("data", "model"))
    params = init_train_state(0, cfg, AdamWConfig(), device="meta")["params"]
    specs = shd.param_pspecs(params, mesh)
    from repro_torch.launch.train import _leaf_paths
    from repro_torch.optim import tree_leaves
    gathered = scattered = 0
    for key, leaf, spec in zip(_leaf_paths(params), tree_leaves(params),
                               _spec_leaves(specs)):
        if "data" not in spec:
            continue
        assert key.startswith("blocks/"), key
        local = leaf.numel() * leaf.element_size() // math.prod(MESH)
        gathered += 2 * 4 * local                 # forward + backward
        scattered += local
    assert gathered > 0
    by_op = rec["collectives"]["bytes_by_op"]
    assert gathered == rec["gathers"]["gathered_bytes"]
    assert by_op["all-gather"] == gathered + 3 * _boundary_bytes(cfg)
    assert by_op["reduce-scatter"] == scattered


def _boundary_bytes(cfg) -> int:
    """A train cell's block-boundary activations, whole, over its layers:
    ``n_layers`` x the rank's batch x the sequence x d_model."""
    _, _, seq, batch = TINY["train"]
    item = torch.empty((), dtype=cfg.jdtype).element_size()
    return cfg.n_layers * batch // MESH[0] * seq * cfg.d_model * item


def test_the_boundary_cut_lowers_the_peak_by_the_boundaries_bytes():
    """The reference's ``_shard_batch`` cut over 'model' holds where the
    launch layer pins the batch (``batch_axes``): each checkpointed layer
    then keeps the rank's half of its input (peak lower by half the
    boundaries' bytes), and the step all-gathers each boundary three times
    (the join in the forward and in the recompute, the cut's backward);
    the operations are the unpinned cell's."""
    arch = "qwen1.5-0.5b-reduced"
    cut, whole = _cell(arch, "train"), _cell(arch, "train",
                                             {"batch_axes": ()})
    cfg = _cfg(arch, "train")
    assert cfg.batch_axes and cfg.remat
    assert not _cfg(arch, "train", {"batch_axes": ()}).batch_axes
    assert cut["cost"]["flops_per_device"] == \
        whole["cost"]["flops_per_device"]
    assert whole["memory"]["peak_memory_in_bytes"] - \
        cut["memory"]["peak_memory_in_bytes"] == _boundary_bytes(cfg) // 2
    gathers = cut["collectives"]["bytes_by_op"]["all-gather"]
    assert gathers - whole["collectives"]["bytes_by_op"]["all-gather"] == \
        3 * _boundary_bytes(cfg)


def test_meta_count_is_the_cpu_count():
    """The same sharded step (a fake world of 1, the (1, 1) mesh), counted
    on meta by ``count_cell`` and run on the CPU under ``FlopCounterMode``:
    the same operations."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import dummy_inputs
    from repro_torch.launch import dryrun, sharding as shd
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.optim import AdamWConfig
    arch, (name, kind, seq, batch) = "qwen1.5-0.5b-reduced", TINY["train"]
    rec = dryrun.count_cell(arch, _shape("train"), (1, 1),
                            cfg_extra={"tp": 1}, limit_s=600)
    assert rec["ok"], rec.get("error")
    cfg = dryrun._dp_pinned(dryrun.prod_cfg(arch, extra={"tp": 1}),
                            _shape("train"), {"data": 1, "model": 1},
                            {"tp": 1})
    opt = AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
    with dryrun.fake_world(1):
        mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("data", "model"))
        state = init_train_state(0, cfg, opt, device="cpu")
        state = shd.shard_tree(state, shd.named_shardings(
            shd.state_pspecs(state, mesh), mesh))
        step = make_train_step(cfg, opt, mesh=mesh)
        data = dummy_inputs(cfg, "train", batch, seq, device="cpu")
        with FlopCounterMode(display=False) as counter:
            step(state, data)
    assert rec["cost"]["flops_per_device"] == counter.get_total_flops()


def test_step_counter_counts_arguments_and_peak_by_storage():
    """An argument that views part of a storage counts that whole storage,
    once, in the argument bytes and in the peak alike; a tensor the step
    allocates counts in the peak only; an argument updated in place is no
    output."""
    from repro_torch.launch import hlo_analysis as ha
    whole = torch.empty(64, 32, dtype=torch.bfloat16, device="meta")
    state = torch.empty(8, dtype=torch.float32, device="meta")
    with ha.StepCounter() as counter:
        counter.arguments({"batch": whole[:16], "again": whole[16:]}, state)
        out = whole[:16].float().sum(0)
        state.add_(1.0)
        counter.outputs(out, state)
    res = counter.result()
    held = whole.numel() * 2 + state.numel() * 4
    assert res["argument_bytes"] == held
    assert res["peak_bytes"] >= held + 16 * 32 * 4
    assert res["output_bytes"] == out.numel() * 4


def test_run_cell_writes_the_references_record_and_caches_it(tmp_path):
    """A production cell through ``run_cell``: the reference's record
    (``fits_hbm`` for ``fits_16gb``; no ``xla_*``, ``hlo_bytes`` or
    ``scan_trip_counts``), written once and read back until ``force``."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    arch = "qwen1.5-0.5b-reduced"
    rec = dryrun.run_cell(arch, "decode_32k", "single", str(tmp_path))
    assert not dist.is_initialized()
    assert rec["ok"], rec.get("traceback")
    for key in ("arch", "shape", "mesh", "chips", "ok", "tag", "total_s",
                "memory", "cost", "collectives", "roofline"):
        assert key in rec, key
    assert rec["chips"] == 256 and rec["mesh"] == "single"
    for key in ("argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "peak_memory_in_bytes",
                "resident_bytes", "fits_hbm"):
        assert key in rec["memory"], key
    assert set(rec["collectives"]) == {"bytes_by_op", "counts",
                                       "total_bytes"}
    path = tmp_path / f"{arch}__decode_32k__single.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    again = dryrun.run_cell(arch, "decode_32k", "single", str(tmp_path))
    assert again["total_s"] == rec["total_s"]
    forced = dryrun.run_cell(arch, "decode_32k", "single", str(tmp_path),
                             force=True)
    assert forced["total_s"] != rec["total_s"]


def test_a_cell_past_its_time_limit_is_written_as_failed():
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    rec = dryrun.count_cell("qwen1.5-0.5b-reduced", _shape("train"), MESH,
                            cfg_extra={"tp": 2}, limit_s=0.01)
    assert not dist.is_initialized()
    assert not rec["ok"]
    assert rec["error"].startswith("CellTimeLimit"), rec["error"]
