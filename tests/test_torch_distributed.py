"""The port's distributed layer (``repro_torch.launch``: ``mesh``,
``sharding``, ``collectives``, ``pipeline``, ``tp``, the sharded train
step with its per-layer gathers and tensor-parallel compute,
``restore_checkpoint(shardings=)``, ``PointCloudServable(mesh=)``, MoE
local routing and routing groups that span ranks) against the JAX
package, on the CPU.

Multi-rank parity runs on gloo: the module fixture :func:`ranks` starts 8
processes of this file (``python tests/test_torch_distributed.py RANK
WORLD DIR``, a ``file://`` store in ``DIR``); each runs :func:`_worker` and
saves its results. The reference's collectives run meanwhile in a
subprocess with 8 forced host devices, under ``jax.set_mesh`` and
``jax.shard_map`` (the reference's own tests call ``shard_map`` without a
mesh context, which JAX 0.9 refuses). The reference's sharded train step
is, under GSPMD, its unsharded function: it runs jitted here on one
device. JAX is imported inside the fixtures and subprocesses only, so the
``cuda`` cases collect where there is no JAX.

Bounds, and why:
- ``compressed_psum`` on 8 ranks: bit for bit the reference's (the scale
  divides by a float32 127 in both; measured equal), and within the
  reference's own test bound (8 quantization steps) of the exact sum;
- ``pipeline_forward``, 8 stages and 4 microbatches: bit for bit the
  port's sequential composition (the same stage calls on the same
  microbatches), within 2e-5 of the reference's (its tolerance against
  its own sequential composition);
- ``overlapped_tp_matmul`` on 8 ranks: every rank within 1e-5 of the
  reference's (8 partial products summed in each rank's ring order, the
  products' own order the BLAS's) and within the reference test's 1e-4 of
  ``x @ w``;
- MoE local routing at 4 groups: token order, slots and drops equal to
  the reference's, outputs within 1e-5 (the expert GEMMs' order);
- the sharded step on a (4, 2) mesh (the :data:`CASES`: deepseek-7b
  ``reduced()``, ``batch_axes=("data",)``, ``tp=2``, as it is, widened,
  with compression and widened until attention shards on 'model' too; and
  grok-1 ``reduced()`` with 4 MoE routing groups and with 1, which spans
  the 4 data parts; and, on ranks of their own in
  ``tests/test_torch_distributed_tp.py`` and ``_ssm.py``
  (:data:`RANK_SETS`), the ``tp`` case with ``remat``, the MoE experts,
  vlm's cross-attention, the hybrid's Mamba2 layers and shared block and
  RWKV6 widened until they compute on 'model' shards, their float32 bounds
  :data:`F32_BOUNDS`), at full learning rate from the first step
  (``warmup_steps=0``, so that the parameters move): the losses within
  1e-6 relative of the reference's step (the global mean taken as the
  mean of 4 parts' means) and the gradient norms within 1e-5 relative
  (the norm reads the gradient's scale, which AdamW does not: a sum over
  the parts in place of their mean, or a replicated shard counted once per
  copy, shows here and in the moments); on every rank, every local shard
  of the parameters after 2 steps within 1e-4 x max|p| (the ``tp``
  case: ``TP_P_BOUND``) of the port's unsharded step's and within
  ``DP_BOUND`` x max|p - p0| (``tp``: ``TP_DP_BOUND``) of it; where
  blocks compute tensor-parallel (``wide``, ``compressed``, ``tp``), also
  within that bound of the unsharded step in the sharded step's
  tensor-parallel arithmetic (``launch.tp.EmulatedTP``: the 'model' ranks
  emulated in one process), and, with both steps run again in float64,
  within ``DP_BOUND`` and 1e-4 x max|p| of the unsharded step (the split
  sums' rounding, which AdamW's eps regime amplifies in float32, falls
  far below it there); the moments m and v within 1e-4 x their leaf's
  max of the port's unsharded step's (in float64 too where blocks compute
  tensor-parallel); every local shard's shape the reference's specs' cut;
  the routing of a MoE group that spans ranks equal to the unsharded
  step's (which ``tests/test_torch_lm_families.py`` holds equal to the
  reference's); the gathered parameter bytes alive at once at most two
  layers' slices and the unstacked leaves, and no weight's copy kept for
  the backward;
- ``restore_checkpoint(shardings=)`` of a state saved on 8 ranks onto a
  (2, 2) mesh of 4: every shard equal to its slice of the global array;
- ``PointCloudServable(mesh=make_replica_mesh(2))``: every row bit for
  bit the ``mesh=None`` servable's, at batch 4 (sharded) and 3 (run
  replicated);
- the sharded prefill and decode step (``make_prefill`` /
  ``make_serve_step(..., mesh=)``) on the (4, 2) mesh (:data:`SERVE_CASES`:
  the dense, moe, ssm, hybrid and vlm families at ``reduced()``, the
  ``tp`` widths, whose attention and MLP compute on 'model' shards, and a
  batch of 1 whose KV rows are cut over 'data'): on every rank the logits
  of its rows and every leaf of its cache shards after the prefill and
  after each of 2 decode steps within ``SERVE_BOUND`` x the largest |value|
  of the port's unsharded ``lm.prefill`` / ``lm.decode_step``: their
  float32 GEMMs round a rank's rows otherwise than the batch's, sums split
  over 'model' and the rows' log-sum-exp merge round otherwise than whole
  ones, and RWKV6's decays amplify such roundings through its scan
  (measured: at most 1.3e-6 in the attention families, 2.0e-5 in rwkv6's
  token-shift rows); each shard's shape the ``cache_pspecs`` cut.
"""
import contextlib
import dataclasses
import math
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.optim import (AdamWConfig, int8_dequantize,       # noqa: E402
                               int8_quantize, tree_leaves, tree_map)

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 8
ARCH, MOE_ARCH = "deepseek-7b", "grok-1-314b"
#: the sharded step's cases, (config, overrides of ``reduced()``, int8
#: gradient compression): as the reference's test runs it (every leaf
#: under the rules' 1M-element floor, so replicated); widened so that the
#: embedding, head and MLP weights shard (vocab over 'model'; d_model over
#: 'data' and d_ff over 'model'), which then compute tensor-parallel;
#: widened with compression (each leaf's scale the largest |value| over
#: its shards); widened until q/k/v/o shard too, with 5 MHA heads that the
#: TP layout pads to 6 at tp 2, so that a rank's 'model' shard (320 of 640
#: columns) falls inside a head and attention gathers, arranges and takes
#: the rank's 3 heads, and 3 layers, so that two layers' slices are less
#: than the whole stack; a MoE config routing in 4 groups, one per
#: data-parallel part, as the reference's launch layer sets ``dp_shards``;
#: and in 1 group, which spans the 4 parts
WIDE = {"vocab_size": 16384, "d_ff": 8192}
TP_WIDE = {"d_model": 1024, "d_head": 128, "n_heads": 5, "n_kv_heads": 5,
           "vocab_size": 2048, "d_ff": 512, "n_layers": 3}
#: widened until the MoE experts (E, d, f) shard: gate and up on f over
#: 'model', down on d (re-cut to f by an all-to-all)
MOE_TP = {"dp_shards": 4, "d_model": 256, "d_ff": 1024}
#: widened until vlm's attention and cross-attention shard, 5 MHA heads
#: padded to 6 (a rank's shard, 400 of 800 columns, inside a head)
VLM_TP = {"d_model": 768, "d_head": 160, "n_heads": 5, "n_kv_heads": 5,
          "d_ff": 256, "vocab_size": 2048, "d_image": 768}
#: widened until the grouped Mamba2 layers (12 heads, 6 a rank) and the
#: shared block shard (the trailing layer, under the floor, stays whole;
#: the shared attention's 5 heads padded to 6, a rank's shard inside a
#: head), with the published ``remat``
HYBRID_TP = {"d_model": 384, "d_ff": 2816, "n_heads": 5, "n_kv_heads": 5,
             "d_head": 640, "remat": True}
#: widened until RWKV6's block shards: 17 heads of 64 padded to 18, so a
#: rank's shard (544 of 1088 columns) falls inside a head; the channel
#: mix's v re-cut from d to d_ff; with the published ``remat``
SSM_TP = {"d_model": 1088, "n_heads": 17, "n_kv_heads": 17,
          "head_size": 64, "d_ff": 1024, "n_layers": 1, "remat": True}
CASES = {"reduced": (ARCH, {}, False), "wide": (ARCH, WIDE, False),
         "compressed": (ARCH, WIDE, True),
         "moe": (MOE_ARCH, {"dp_shards": 4}, False),
         "tp": (ARCH, TP_WIDE, False),
         "moe_span": (MOE_ARCH, {"dp_shards": 1}, False),
         "tp_remat": (ARCH, dict(TP_WIDE, remat=True), False),
         "moe_tp": (MOE_ARCH, MOE_TP, False),
         "vlm_tp": ("llama-3.2-vision-11b", VLM_TP, False),
         "hybrid_tp": ("zamba2-7b", HYBRID_TP, False),
         "ssm_tp": ("rwkv6-3b", SSM_TP, False)}
BATCH, SEQ, STEPS = 8, 32, 2
#: no warmup, so that each step moves every parameter by about the
#: learning rate (AdamWConfig's warmup would move them by 3e-6 and 6e-6)
OPT = dict(warmup_steps=0, lr=1e-4)
#: the sharded step's parameters against the unsharded step's, relative to
#: how far the two steps moved them: AdamW's first update g / (|g| + eps)
#: is ill-conditioned where |g| is near eps, and there the order of the
#: sum over the batch's parts shows (in one process, the mean of 4 parts'
#: gradients in place of the whole batch's moved one element of the widened
#: config's down/w 1.2e-2 of the step away); 1e-4 is the learning rate at
#: which that error stays within 1e-4 x max|p| too. Tensor parallelism's
#: split sums add float32 rounding of their own: on the 8 ranks the
#: widened config's worst element (down/w) is 2.6e-2 of the step off; in
#: float64 2.1e-4 (attention computes in float32 whatever its inputs)
DP_BOUND = 3e-2
#: :data:`DP_BOUND` for the float32 ``tp`` case: at d_model 1024 the CPU's
#: GEMMs round a row differently at a rank's 64 rows than at the batch's
#: 256 (measured: not so at d_model 64), so every activation of a data
#: part carries float32 noise that AdamW's eps regime amplifies, tensor
#: parallelism or not (measured worst: 7.6% of the step, an element of
#: embed/w, against the unsharded step; 3.6% against the one in the same
#: tensor-parallel arithmetic; in float64, 5.1e-4 within ``DP_BOUND``)
TP_DP_BOUND = 0.1
#: the parameters' bound against the unsharded step, as a fraction of the
#: leaf's largest value (1e-4), for the ``tp`` case: its embedding's
#: largest value is 0.1 (std 0.02), so the element that the same noise
#: moves 7.6% of the step away (measured) is 1.5e-4 of it
TP_P_BOUND = 3e-4
#: with int8 compression, the share of elements that the sharded and
#: unsharded gradients' last-bit differences may flip across a rounding
#: boundary of the quantization (each such element's update then differs
#: by up to a learning rate)
FLIP_SHARE = 1e-4
PSUM_SHAPE = (8, 64)
PIPE = dict(S=8, M=4, MB=2, D=16)
MATMUL = dict(m=16, k=64, n=24)
RANK_TIMEOUT = 240
#: the sharded prefill and decode step's cases: (config, overrides of
#: ``reduced()``, batch)
SERVE_CASES = {"dense": (ARCH, {}, 4), "moe": (MOE_ARCH, {"dp_shards": 4}, 4),
               "ssm": ("rwkv6-3b", {}, 4), "hybrid": ("zamba2-7b", {}, 4),
               "vlm": ("llama-3.2-vision-11b", {}, 4),
               "tp": (ARCH, TP_WIDE, 4), "seq": (ARCH, {}, 1),
               "moe_tp": (MOE_ARCH, MOE_TP, 4),
               "vlm_tp": ("llama-3.2-vision-11b", VLM_TP, 4),
               "hybrid_tp": ("zamba2-7b", HYBRID_TP, 4),
               "ssm_tp": ("rwkv6-3b", SSM_TP, 4)}
#: the train and serve cases whose gloo ranks another file runs, by the
#: name :func:`_worker` takes: ``tests/test_torch_distributed_tp.py``
#: ("tp": remat, the MoE experts, vlm's cross-attention) and
#: ``tests/test_torch_distributed_ssm.py`` ("ssm": the hybrid's Mamba2
#: layers and shared block, RWKV6), so that each file's ranks stay well
#: inside :data:`RANK_TIMEOUT`; this file's ranks ("base") run the others
RANK_SETS = {"tp": (("tp_remat", "moe_tp", "vlm_tp"), ("moe_tp", "vlm_tp")),
             "ssm": (("hybrid_tp", "ssm_tp"), ("hybrid_tp", "ssm_tp"))}
BASE_CASES = tuple(c for c in CASES if all(
    c not in cases for cases, _ in RANK_SETS.values()))
BASE_SERVE_CASES = tuple(c for c in SERVE_CASES if all(
    c not in serve for _, serve in RANK_SETS.values()))
RANK_SETS["base"] = (BASE_CASES, BASE_SERVE_CASES)
#: the float32 bounds of a case where they are not (1e-4, :data:`DP_BOUND`,
#: 1e-4): the parameters' (x max|p|, x how far the steps moved the leaf)
#: and the moments' (x their leaf's max). The widened cases that compute
#: attention or RWKV6 or Mamba2 tensor-parallel carry the ``tp`` case's
#: float32 noise at their widths (measured worst: ``tp_remat`` 7.6% of the
#: step, ``vlm_tp`` 6.5%, ``hybrid_tp`` 7.7%; 1.6e-4 x max|p|). RWKV6's
#: decays amplify it (its float32 gradient is at its conditioning's limit:
#: ``tests/test_torch_lm_train.py``): ``ssm_tp`` measured 27.7% of the
#: step (an embedding element), 5.6e-4 x max|p|, moments 2.1e-4 x their
#: max; in float64 6e-9 and 2e-8, within the defaults
F32_BOUNDS = {"tp": (TP_P_BOUND, TP_DP_BOUND, 1e-4),
              "tp_remat": (TP_P_BOUND, TP_DP_BOUND, 1e-4),
              "vlm_tp": (TP_P_BOUND, TP_DP_BOUND, 1e-4),
              "hybrid_tp": (TP_P_BOUND, TP_DP_BOUND, 1e-4),
              "ssm_tp": (1.2e-3, 0.6, 5e-4)}
SERVE_PROMPT, SERVE_CAPACITY, SERVE_STEPS = 20, 40, 2
SERVE_BOUND = 1e-4


def _sharded_cfg(get_config, case: str):
    arch, over, _ = CASES[case]
    return dataclasses.replace(get_config(arch).reduced(),
                               batch_axes=("data",), tp=2, **over)


def _f32_bounds(case: str) -> tuple:
    """``case``'s float32 bounds (:data:`F32_BOUNDS`)."""
    return F32_BOUNDS.get(case, (1e-4, DP_BOUND, 1e-4))


def _cuts(case: str) -> bool:
    """Whether ``case``'s widths put some leaf above the rules' floor."""
    return bool(set(CASES[case][1]) - {"dp_shards", "remat"})


# ---------------------------------------------------------------------------
# the ranks' program (gloo, one process each)
# ---------------------------------------------------------------------------

def _pipe_inputs():
    rng = np.random.default_rng(0)
    s, m, mb, d = PIPE["S"], PIPE["M"], PIPE["MB"], PIPE["D"]
    ws = (rng.normal(size=(s, d, d)) / np.sqrt(d)).astype(np.float32)
    return ws, rng.normal(size=(m, mb, d)).astype(np.float32)


def _matmul_inputs():
    rng = np.random.default_rng(2)
    return (rng.normal(size=(MATMUL["m"], MATMUL["k"])).astype(np.float32),
            rng.normal(size=(MATMUL["k"], MATMUL["n"])).astype(np.float32))


def _psum_input():
    return np.random.default_rng(1).normal(size=PSUM_SHAPE).astype(
        np.float32)


def _stage(w, h):
    return torch.tanh(h @ w)


def _serve_case():
    """A tiny PointNet++ (the serving tests' shape) and 4 clouds."""
    from repro_torch.core.workload import PointNetConfig, SALayerSpec
    from repro_torch.models.pointnet2 import init_params
    cfg = PointNetConfig(name="tiny-replicas", n_points=64, layers=(
        SALayerSpec(n_centers=24, n_neighbors=4, in_features=4,
                    mlp=(4, 8, 8, 16)),
        SALayerSpec(n_centers=8, n_neighbors=4, in_features=16,
                    mlp=(16, 16, 16, 32))))
    params = init_params(cfg, seed=0, n_classes=10)
    rng = np.random.default_rng(5)
    clouds = [rng.normal(size=(n, 3)).astype(np.float32)
              for n in (64, 50, 64, 40)]
    return cfg, params, clouds


def _served_rows(model, clouds, mesh):
    from repro_torch.launch import PointCloudServable, ShapeBuckets
    servable = PointCloudServable(model, buckets=ShapeBuckets(
        points=(64,), batch=(1, 2, 3, 4)), mesh=mesh)
    return [torch.stack(servable.run_batch(clouds)),
            torch.stack(servable.run_batch(clouds[:3]))], servable


def _worker(rank: int, world: int, out_dir: str, which: str = "base") -> None:
    """Rank ``rank``'s program: ``which``'s cases (:data:`RANK_SETS`), and
    for "base" the collectives."""
    import torch.distributed as dist
    import repro_torch
    from repro_torch.launch import make_replica_mesh, make_test_mesh
    from repro_torch.launch.collectives import (compressed_psum,
                                                overlapped_tp_matmul)
    from repro_torch.launch.pipeline import pipeline_forward
    out = pathlib.Path(out_dir)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}",
                            rank=rank, world_size=world)
    res = {}
    try:
        if which != "base":
            mesh = make_test_mesh((4, 2), device_type="cpu")
            mesh4 = make_test_mesh((2, 2), device_type="cpu")
            cases, serve = RANK_SETS[which]
            for case in cases:
                res[case] = _sharded_run(case, mesh, mesh4, rank, out)
            for case in serve:
                res[f"serve_{case}"] = _serve_run(case, mesh)
            dist.barrier()
            return
        x = torch.from_numpy(_psum_input())
        res["psum"] = compressed_psum(x[rank:rank + 1])
        ws, xm = map(torch.from_numpy, _pipe_inputs())
        res["pipe"] = pipeline_forward(_stage, ws[rank], xm)
        if rank == 0:
            seq = []
            for j in range(xm.shape[0]):
                h = xm[j]
                for s in range(ws.shape[0]):
                    h = _stage(ws[s], h)
                seq.append(h)
            res["pipe_sequential"] = torch.stack(seq)
        xw, w = map(torch.from_numpy, _matmul_inputs())
        k = xw.shape[1] // world
        res["matmul"] = overlapped_tp_matmul(xw[:, rank * k:(rank + 1) * k],
                                             w)

        # the storage-sharded step on a (4, 2) mesh
        mesh = make_test_mesh((4, 2), device_type="cpu")
        mesh4 = make_test_mesh((2, 2), device_type="cpu")
        for case in BASE_CASES:
            res[case] = _sharded_run(case, mesh, mesh4, rank, out)

        for case in BASE_SERVE_CASES:
            res[f"serve_{case}"] = _serve_run(case, mesh)

        # a (1, 1) mesh of rank 0: every collective an identity
        one = make_test_mesh((1, 1), device_type="cpu")
        if rank == 0:
            res["one_rank"] = _one_rank(one)
            res["padded_one_rank"] = _padded_one_rank(one)

        # replica fan-out over the first 2 ranks
        replicas = make_replica_mesh(2, device_type="cpu")
        if rank < 2:
            pcfg, params, clouds = _serve_case()
            model = repro_torch.compile_model(
                params, pcfg, backend="reram-fused", schedule="pointer",
                device="cpu")
            rows, servable = _served_rows(model, clouds, replicas)
            plain, base = _served_rows(model, clouds, None)
            res["served"] = {"rows": rows, "plain": plain,
                             "trace_shapes": servable.trace_shapes,
                             "plain_trace_shapes": base.trace_shapes}
        dist.barrier()
    finally:
        torch.save(res, out / f"rank{rank}.pt")
        dist.destroy_process_group()


def _serve_run(case: str, mesh) -> dict:
    """The sharded prefill and :data:`SERVE_STEPS` decode steps of
    ``case`` against the port's unsharded ones on this rank: per output
    (the logits, each cache leaf) the largest difference over the calls
    as a fraction of the largest |value|, the shards' shapes against the
    specs' cut, and the KV leaves' specs."""
    from repro_torch.configs import dummy_inputs, get_config
    from repro_torch.launch.serve import make_prefill, make_serve_step
    from repro_torch.launch.sharding import (NamedSharding, cache_pspecs,
                                             input_pspecs, named_shardings,
                                             param_pspecs, shard_tree)
    from repro_torch.models import lm
    arch, over, b = SERVE_CASES[case]
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              batch_axes=("data",), tp=2, **over)
    params = lm.init(0, cfg, device="cpu")
    sharded = shard_tree(params, named_shardings(param_pspecs(params, mesh),
                                                 mesh))
    ins = dummy_inputs(cfg, "prefill", b, SERVE_PROMPT, device="cpu")
    ids, embeds = ins.get("ids"), ins.get("embeds")
    prefill, step = make_prefill(cfg, mesh=mesh), make_serve_step(cfg,
                                                                  mesh=mesh)
    want, cache = lm.prefill(params, cfg, ids, embeds=embeds,
                             image_embeds=ins.get("image_embeds"),
                             max_seq=SERVE_CAPACITY)
    got, shards = prefill(sharded, ids, embeds=embeds,
                          image_embeds=ins.get("image_embeds"),
                          max_seq=SERVE_CAPACITY)
    specs = cache_pspecs(cache, mesh)
    rows = NamedSharding(mesh, input_pspecs({"ids": ids if ids is not None
                                             else embeds}, mesh)["ids"])
    errs, shapes = {}, True

    def compare(want, got):
        nonlocal shapes
        pairs = [("logits", rows.shard(want), got.to_local())] + [
            (k, NamedSharding(mesh, specs[k]).shard(cache[k]),
             shards[k].to_local()) for k in cache]
        for k, a, g in pairs:
            shapes = shapes and a.shape == g.shape
            err = float((a - g).abs().max() / (
                (cache[k] if k in cache else want).abs().max()
                .clamp_min(1e-30)))
            errs[k] = max(errs.get(k, 0.0), err)
    compare(want, got)
    s = lm.kv_rows(cfg, SERVE_PROMPT)
    for t in range(SERVE_STEPS):
        pos = torch.tensor(s + t, dtype=torch.int32)
        ids1 = None if ids is None else ids[:, t:t + 1]
        e1 = None if embeds is None else embeds[:, t:t + 1]
        want, _ = lm.decode_step(params, cfg, cache, ids1=ids1, pos=pos,
                                 embeds1=e1)
        got, _ = step(sharded, shards, ids1, pos, embeds1=e1)
        compare(want, got)
    return {"errs": errs, "shapes": shapes,
            "kv_specs": {k: tuple(v) for k, v in specs.items()
                         if k.startswith(("k", "v"))}}


def _routes(fn) -> list:
    """``fn()``'s MoE routing: per call of ``moe._route_local``, the token
    count, the capacity, the top-k experts and the keep mask."""
    from repro_torch.models import moe
    routes, route = [], moe._route_local

    def record(x, router_w, top_k, cap, e):
        xe, meta, top_idx, logits = route(x, router_w, top_k, cap, e)
        routes.append((x.shape[0], cap, top_idx.clone(), meta[3].clone()))
        return xe, meta, top_idx, logits
    moe._route_local = record
    try:
        fn()
    finally:
        moe._route_local = route
    return routes


@contextlib.contextmanager
def _kept_inputs(into: list):
    """Appends to ``into``, per layer that ``cfg.remat`` checkpoints
    (``lm.checkpoint``'s calls), the activation it keeps as its input: its
    shape and the bytes of its storage (a view would count the whole it
    views)."""
    from repro_torch.models import lm
    real = lm.checkpoint

    def kept(fn, blk, x, **kw):
        into.append((tuple(x.shape), x.untyped_storage().nbytes()))
        return real(fn, blk, x, **kw)
    lm.checkpoint = kept
    try:
        yield
    finally:
        lm.checkpoint = real


def _gathered_bytes(cfg, params, plans: dict, mesh) -> tuple:
    """``(one layer's, the unstacked leaves')`` bytes that the gathers hand
    the model: each gathered leaf's local slice times the sizes of the mesh
    dims it is gathered over, a heads-arranged one cut to the rank's heads
    of the TP head layout."""
    from repro_torch.models.lm import STACK_DIMS
    eff, eff_kv, _, _ = cfg.head_layout()
    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    layer = unstacked = 0
    for key, d in _flatten(params).items():
        plan = plans[key]
        if not plan.gather:
            continue
        stack = STACK_DIMS.get(key.split("/")[0], 0)
        n = d.to_local()[(0,) * stack].numel()
        n *= math.prod(mesh.size(i) for i, _, _ in plan.gather)
        if isinstance(plan.use, tuple):
            q = plan.use[1] in ("q", "o")
            n = n // (cfg.n_heads if q else cfg.n_kv_heads) * (
                eff if q else eff_kv)
            n //= tp if plan.use[0] == "heads" else 1
        if stack:
            layer += n * d.element_size()
        else:
            unstacked += n * d.element_size()
    return layer, unstacked


def _emulated_steps(cfg, opt, comp: bool, blocks: dict, state, batch):
    """:data:`STEPS` unsharded steps of ``state`` in the sharded step's
    tensor-parallel arithmetic (``blocks`` of ``gather_plan``, 2 'model'
    ranks in this process)."""
    from repro_torch.launch import train
    from repro_torch.launch.tp import EmulatedTP
    par = EmulatedTP(cfg, blocks, 2)
    args = [None if batch.get(k) is None else torch.as_tensor(batch[k])
            for k in train.BATCH_KEYS]
    for _ in range(STEPS):
        train._step(cfg, opt, comp, state, *args, par=par)
    return state


def _float64(state: dict) -> dict:
    """``state`` with its floating leaves in float64 (the parameters still
    requiring grad)."""
    return tree_map(lambda t: t.detach().double().requires_grad_(
        t.requires_grad) if t.is_floating_point() else t, state)


def _compare(state, shardings, plain, p0, bound: float, same=None,
             m_bound: float = 1e-4) -> dict:
    """Every local shard of ``state`` (after the steps) against its slice
    of the unsharded ``plain``'s leaf: the largest error, the leaf's largest
    value, how far the steps moved it from ``p0``, and the elements
    ``off``: a parameter's beyond ``bound`` x that distance, a moment's
    beyond ``m_bound`` x its leaf's largest value; with ``same`` (another
    unsharded step), a parameter's ``off_same`` beyond ``bound`` x that
    distance from ``same``'s."""
    shardings, plain, p0 = map(_flatten, (shardings, plain, p0))
    same = None if same is None else _flatten(same)
    res = {}
    for key, got in _flatten(state).items():
        s, want = shardings[key], plain[key].detach()
        diff = (got.to_local() - s.shard(want)).abs()
        scale = float(want.abs().max())
        moved = float((want - p0[key].detach()).abs().max())
        e = {"err": float(diff.max()), "scale": scale, "moved": moved,
             "numel": diff.numel()}
        if key.startswith("params/"):
            e["off"] = int((diff > bound * moved).sum())
            if same is not None:
                gap = (got.to_local() - s.shard(same[key].detach())).abs()
                e["off_same"] = int((gap > bound * moved).sum())
        else:
            e["off"] = int((diff > m_bound * scale).sum())
        res[key] = e
    return res


def _float64_run(case: str, init: dict, mesh, batch: dict) -> dict:
    """:data:`STEPS` sharded and unsharded steps of ``case`` in float64
    from the reference's state, compared by :func:`_compare` at
    :data:`DP_BOUND`."""
    from repro_torch.configs import get_config
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.launch import make_train_step
    from repro_torch.launch.sharding import (named_shardings, shard_tree,
                                             state_pspecs)
    # the inputs' dtype too (vlm's image embeddings)
    cfg = dataclasses.replace(_sharded_cfg(get_config, case),
                              dtype="float64")
    comp = CASES[case][2]
    opt = AdamWConfig(**OPT)

    def start():
        return _float64(train_state_from_numpy(init, cfg, device="cpu"))
    state, plain = start(), start()
    shardings = named_shardings(state_pspecs(state, mesh), mesh)
    state = shard_tree(state, shardings)
    step = make_train_step(cfg, opt, mesh=mesh, grad_compression=comp)
    plain_step = make_train_step(cfg, opt, grad_compression=comp)
    for _ in range(STEPS):
        step(state, batch)
        plain_step(plain, batch)
    return _compare(state, shardings, plain, start(), DP_BOUND)


def _sharded_run(case: str, mesh, mesh4, rank: int,
                 out: pathlib.Path) -> dict:
    """:data:`STEPS` sharded steps of ``case`` from the reference's state,
    then the state saved on every rank and restored onto ``mesh4``."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import dummy_inputs, get_config
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.launch import make_train_step
    from repro_torch.launch.sharding import (gather_plan, named_shardings,
                                             shard_tree, state_pspecs)
    cfg = _sharded_cfg(get_config, case)
    comp = CASES[case][2]
    with np.load(out / f"init_{case}.npz") as npz:
        init = _unflatten({key: npz[key] for key in npz.files})
    state = train_state_from_numpy(init, cfg, device="cpu")
    shardings = named_shardings(state_pspecs(state, mesh), mesh)
    state = shard_tree(state, shardings)
    res = {"shard_shapes": {key: tuple(d.to_local().shape)
                            for key, d in _flatten(state).items()}}
    batch = dummy_inputs(cfg, "train", batch=BATCH, seq=SEQ, device="cpu")
    step = make_train_step(cfg, AdamWConfig(**OPT), mesh=mesh,
                           grad_compression=comp)
    step.gather_stats.track_copies = True
    plans, blocks = gather_plan(cfg, state["params"], mesh, {"data"})
    res["tp_blocks"] = blocks
    res["gathered_layer"], res["gathered_unstacked"] = _gathered_bytes(
        cfg, state["params"], plans, mesh)
    res["layers"] = cfg.n_layers
    res["losses"], res["grad_norms"], res["gathers"] = [], [], []
    routes, res["kept_inputs"] = [], []
    for i in range(STEPS):
        got = []
        with _kept_inputs(res["kept_inputs"] if i == 0 else []):
            seen = _routes(lambda: got.append(step(state, batch)[1]))
        routes = routes or seen
        metrics = got[0]
        res["losses"].append(float(metrics["loss"]))
        res["grad_norms"].append(float(metrics["grad_norm"]))
        res["gathers"].append(step.gather_stats.as_dict())
    # the port's unsharded step from the same state: every local shard
    # against its slice of the unsharded leaf; where blocks compute
    # tensor-parallel, both steps again in float64, and the parameters'
    # float32 DP bound also against the unsharded step in the sharded
    # step's tensor-parallel arithmetic
    opt = AdamWConfig(**OPT)
    plain = train_state_from_numpy(init, cfg, device="cpu")
    plain_step = make_train_step(cfg, opt, grad_compression=comp)
    plain_routes = _routes(lambda: plain_step(plain, batch))
    for _ in range(STEPS - 1):
        plain, _ = plain_step(plain, batch)
    if cfg.family == "moe":
        res["routes"], res["plain_routes"] = routes, plain_routes
    same = None
    if blocks:
        same = _emulated_steps(cfg, opt, comp, blocks, train_state_from_numpy(
            init, cfg, device="cpu"), batch)
        res["vs_unsharded_f64"] = _float64_run(case, init, mesh, batch)
    _, dp_bound, m_bound = _f32_bounds(case)
    res["vs_unsharded"] = _compare(
        state, shardings, plain,
        train_state_from_numpy(init, cfg, device="cpu"), dp_bound, same,
        m_bound)
    full = tree_map(lambda d: d.full_tensor(), state)
    # saved on 8 ranks, restored onto a (2, 2) mesh of the first 4
    ckpt = str(out / f"ckpt_{case}")
    save_checkpoint(ckpt, STEPS, state)
    if rank < 4:
        want = named_shardings(state_pspecs(state, mesh4), mesh4)
        got, at, _ = restore_checkpoint(ckpt, state, shardings=want)
        res["restore"] = {
            "step": at, "leaves": len(tree_leaves(got)),
            "equal": sum(torch.equal(g.to_local(), s.shard(f))
                         for g, s, f in zip(tree_leaves(got),
                                            tree_leaves(want),
                                            tree_leaves(full))),
            "sharded": sum(g.to_local().numel() < f.numel()
                           for g, f in zip(tree_leaves(got),
                                           tree_leaves(full)))}
    return res


def _padded_one_rank(mesh) -> dict:
    """On a one-rank mesh: 2 sharded steps of the ``tp`` case's config
    (5 heads padded to 6 at ``tp=2``; q/k/v/o above the floor, so gathered
    over mesh dims of 1 and arranged in the gather, attention computing
    whole) against 2 unsharded ones, and the weights' copies kept."""
    from repro_torch.configs import dummy_inputs, get_config
    from repro_torch.launch import init_train_state, make_train_step
    from repro_torch.launch.sharding import (gather_plan, named_shardings,
                                             shard_tree, state_pspecs)
    cfg = _sharded_cfg(get_config, "tp")
    opt = AdamWConfig(**OPT)
    batch = dummy_inputs(cfg, "train", batch=2, seq=SEQ, device="cpu")
    plain = init_train_state(0, cfg, opt, device="cpu")
    sharded = init_train_state(0, cfg, opt, device="cpu")
    sharded = shard_tree(sharded, named_shardings(
        state_pspecs(sharded, mesh), mesh))
    plans, _ = gather_plan(cfg, sharded["params"], mesh, {"data"})
    step = make_train_step(cfg, opt)
    sstep = make_train_step(cfg, opt, mesh=mesh)
    sstep.gather_stats.track_copies = True
    losses, gathers = [], []
    for _ in range(2):
        losses.append((step(plain, batch)[1]["loss"],
                       sstep(sharded, batch)[1]["loss"]))
        gathers.append(sstep.gather_stats.as_dict())
    return {"arranged": sorted(k for k, p in plans.items()
                               if p.gather and p.use[0] == "arranged"),
            "losses": all(torch.equal(a, b) for a, b in losses),
            "leaves": all(torch.equal(a.detach(), b.to_local())
                          for a, b in zip(tree_leaves(plain),
                                          tree_leaves(sharded))),
            "gathers": gathers}


def _one_rank(mesh) -> dict:
    """On a one-rank mesh: 3 sharded steps of qwen1.5-0.5b ``reduced()``
    against 3 unsharded ones from the same seed, with and without int8
    compression, and the collectives against their one-rank meaning."""
    from repro_torch.configs import dummy_inputs, get_config
    from repro_torch.launch import init_train_state, make_train_step
    from repro_torch.launch.collectives import (compressed_psum,
                                                overlapped_tp_matmul)
    from repro_torch.launch.pipeline import pipeline_forward
    from repro_torch.launch.sharding import (named_shardings, shard_tree,
                                             state_pspecs)
    cfg = get_config("qwen1.5-0.5b").reduced()
    opt = AdamWConfig()
    batch = dummy_inputs(cfg, "train", batch=2, seq=36, device="cpu")
    losses, leaves = [], []
    for comp in (False, True):
        plain = init_train_state(0, cfg, opt, grad_compression=comp,
                                 device="cpu")
        sharded = init_train_state(0, cfg, opt, grad_compression=comp,
                                   device="cpu")
        sharded = shard_tree(sharded, named_shardings(
            state_pspecs(sharded, mesh), mesh))
        step = make_train_step(cfg, opt, grad_compression=comp)
        sstep = make_train_step(cfg, opt, grad_compression=comp, mesh=mesh)
        for _ in range(3):
            losses.append((step(plain, batch)[1]["loss"],
                           sstep(sharded, batch)[1]["loss"]))
        leaves += list(zip(tree_leaves(plain), tree_leaves(sharded)))
    group = mesh.get_group("data")
    x = torch.from_numpy(_psum_input())
    ws, xm = map(torch.from_numpy, _pipe_inputs())
    xw, w = map(torch.from_numpy, _matmul_inputs())
    return {
        "losses": all(torch.equal(a, b) for a, b in losses),
        "leaves": all(torch.equal(a.detach(), b.to_local())
                      for a, b in leaves),
        "psum": torch.equal(compressed_psum(x, group),
                            int8_dequantize(*int8_quantize(x))),
        "pipe": torch.equal(pipeline_forward(_stage, ws[0], xm, group),
                            torch.stack([_stage(ws[0], h) for h in xm])),
        "matmul": torch.equal(overlapped_tp_matmul(xw, w, group), xw @ w)}


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


def _unflatten(flat: dict) -> dict:
    tree = {}
    for key, v in flat.items():
        *path, last = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

_REF_COLLECTIVES = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, "src")
sys.path.insert(0, "tests")
from repro.launch.collectives import compressed_psum, overlapped_tp_matmul
from repro.launch.pipeline import pipeline_forward
from test_torch_distributed import _matmul_inputs, _pipe_inputs, _psum_input

out = {}
pod = jax.make_mesh((8,), ("pod",))
with jax.set_mesh(pod):
    x = jnp.asarray(_psum_input())
    out["psum"] = jax.shard_map(lambda a: compressed_psum(a, "pod"),
                                mesh=pod, in_specs=P("pod"),
                                out_specs=P())(x)
    out["psum_exact"] = jax.shard_map(lambda a: jax.lax.psum(a, "pod"),
                                      mesh=pod, in_specs=P("pod"),
                                      out_specs=P())(x)
    ws, xm = map(jnp.asarray, _pipe_inputs())
    out["pipe"] = jax.shard_map(
        lambda w, h: pipeline_forward(lambda a, b: jnp.tanh(b @ a), w[0], h,
                                      axis_name="pod"),
        mesh=pod, in_specs=(P("pod"), P()), out_specs=P())(ws, xm)
model = jax.make_mesh((8,), ("model",))
with jax.set_mesh(model):
    xw, w = map(jnp.asarray, _matmul_inputs())
    out["matmul"] = jax.shard_map(
        lambda a, b: overlapped_tp_matmul(a, b, "model"), mesh=model,
        in_specs=(P(None, "model"), P()), out_specs=P(),
        check_vma=False)(xw, w)
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
"""


def _free_env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.configs import dummy_inputs, get_config
    from repro.launch import train as ref_train
    from repro.models import moe as ref_moe
    from repro.optim import AdamWConfig as RefAdamW
    return {"jax": jax, "jnp": jax.numpy, "get_config": get_config,
            "dummy_inputs": dummy_inputs, "train": ref_train,
            "moe": ref_moe, "AdamWConfig": RefAdamW}


@pytest.fixture(scope="module")
def ranks(jx, tmp_path_factory):
    """Every rank's results (``rank{r}.pt``), the reference's collectives
    (``ref.npz``) and the reference's train state and 2 steps."""
    return run_ranks(jx, tmp_path_factory.mktemp("gloo"), "base")


def run_ranks(jx, out: pathlib.Path, which: str) -> dict:
    """The ``ranks`` fixtures' body: the 8 gloo ranks of ``which``'s cases
    (:func:`_worker`) and meanwhile, for "base", the reference's
    collectives; the reference's train state and 2 steps per case."""
    jax = jx["jax"]
    cases = RANK_SETS[which][0]
    ref_proc = None
    if which == "base":
        ref_proc = subprocess.Popen(
            [sys.executable, "-c", _REF_COLLECTIVES, str(out / "ref.npz")],
            cwd=ROOT, env=dict(_free_env(), XLA_FLAGS=(
                "--xla_force_host_platform_device_count=8")),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    opt = jx["AdamWConfig"](**OPT)
    init = {}
    for case in cases:
        rcfg = _sharded_cfg(jx["get_config"], case)
        init[case] = jax.device_get(jax.jit(
            lambda k: jx["train"].init_train_state(
                k, rcfg, opt, grad_compression=CASES[case][2]))(
                    jax.random.PRNGKey(0)))
        np.savez(out / f"init_{case}.npz", **{
            k: np.asarray(v) for k, v in _flatten(init[case]).items()})
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), str(out), which],
        cwd=ROOT,
        env=_free_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    # the reference's steps meanwhile: its sharded step is, under GSPMD,
    # the unsharded function, here on a one-device mesh so that
    # ``batch_axes`` (the MoE routing groups) takes effect
    ref_losses, ref_norms = {}, {}
    one = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    for case in cases:
        rcfg = _sharded_cfg(jx["get_config"], case)
        batch = jx["dummy_inputs"](rcfg, "train", batch=BATCH, seq=SEQ)
        ref_step = jax.jit(jx["train"].make_train_step(
            rcfg, opt, grad_compression=CASES[case][2]))
        st = jax.tree.map(jax.numpy.asarray, init[case])
        ref_losses[case], ref_norms[case] = [], []
        with jax.set_mesh(one):
            for _ in range(STEPS):
                st, m = ref_step(st, batch)
                ref_losses[case].append(float(m["loss"]))
                ref_norms[case].append(float(m["grad_norm"]))
    logs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    res = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    got = {"rank": res, "init": init, "ref_losses": ref_losses,
           "ref_norms": ref_norms}
    if ref_proc is not None:
        _, err = ref_proc.communicate(timeout=RANK_TIMEOUT)
        assert ref_proc.returncode == 0, err[-4000:]
        got["ref"] = dict(np.load(out / "ref.npz"))
    return got


# ---------------------------------------------------------------------------
# collectives and the pipeline
# ---------------------------------------------------------------------------

def test_compressed_psum_is_the_references(ranks):
    got = [r["psum"] for r in ranks["rank"]]
    assert all(torch.equal(g, got[0]) for g in got)
    np.testing.assert_array_equal(got[0].numpy(), ranks["ref"]["psum"])
    x = _psum_input()
    err = float(np.abs(got[0].numpy() - ranks["ref"]["psum_exact"]).max())
    assert err <= 8 * float(np.abs(x).max()) / 127 + 1e-6


def test_pipeline_forward_is_the_sequential_composition(ranks):
    got = [r["pipe"] for r in ranks["rank"]]
    assert all(torch.equal(g, got[0]) for g in got)
    assert torch.equal(got[0], ranks["rank"][0]["pipe_sequential"])
    np.testing.assert_allclose(got[0].numpy(), ranks["ref"]["pipe"],
                               rtol=0, atol=2e-5)


def test_overlapped_tp_matmul_matches_the_reference(ranks):
    """Each rank sums its 8 partial products in its own ring order, so the
    ranks' results differ in the last bits, as the reference's devices'
    do: each within the bounds."""
    xw, w = _matmul_inputs()
    for r in ranks["rank"]:
        np.testing.assert_allclose(r["matmul"].numpy(),
                                   ranks["ref"]["matmul"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["matmul"].numpy(), xw @ w, rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the storage-sharded train step
# ---------------------------------------------------------------------------

def check_kept_inputs(ranks, case: str) -> None:
    """``case``'s checkpointed layers (``cfg.remat``), in the first sharded
    step on every rank: each keeps as its input the rank's slice of the
    block-boundary activation over 'model' (the reference's
    ``_shard_batch`` cut), ``(1, B_local, S, D/2)`` in a storage of its
    own, ``B_local·S·(D/2)·itemsize`` bytes: half the whole that the step
    kept before the cut. S is the sequence padded to the state-space
    families' chunk."""
    from repro_torch.configs import get_config
    from repro_torch.launch.tp import EmulatedTP
    from repro_torch.models import lm, rwkv, ssm
    cfg = _sharded_cfg(get_config, case)
    assert cfg.remat
    chunk = {"hybrid": ssm.CHUNK, "ssm": rwkv.CHUNK}.get(cfg.family, 1)
    b, s, d = BATCH // 4, -(-SEQ // chunk) * chunk, cfg.d_model
    whole = b * s * d * torch.empty((), dtype=cfg.jdtype).element_size()
    assert lm._boundary_tp(cfg, EmulatedTP(cfg, {}, 2)) is not None
    for r in ranks["rank"]:
        kept = r[case]["kept_inputs"]
        assert len(kept) == cfg.n_layers
        for shape, nbytes in kept:
            assert shape == (1, b, s, d // 2)
            assert 2 * nbytes == whole


@pytest.mark.parametrize("case", BASE_CASES)
def test_sharded_step_losses_match_the_references(ranks, case):
    ref = np.asarray(ranks["ref_losses"][case])
    for r in ranks["rank"]:
        np.testing.assert_allclose(np.asarray(r[case]["losses"]), ref,
                                   rtol=1e-6)


@pytest.mark.parametrize("case", BASE_CASES)
def test_sharded_step_grad_norms_match_the_references(ranks, case):
    ref = np.asarray(ranks["ref_norms"][case])
    for r in ranks["rank"]:
        np.testing.assert_allclose(np.asarray(r[case]["grad_norms"]), ref,
                                   rtol=1e-5)


def _vs_unsharded(ranks, case: str, prefixes: tuple,
                  field: str = "vs_unsharded"):
    """Every rank's comparison of its local shards with the unsharded
    step's (:func:`_sharded_run`; ``field`` "vs_unsharded_f64": both in
    float64), for the leaves under ``prefixes``."""
    out = [(key, e) for r in ranks["rank"]
           for key, e in r[case][field].items()
           if key.startswith(prefixes)]
    assert out
    return out


def _computes_tp(ranks, case: str) -> bool:
    """Whether some block of ``case`` computes on 'model' shards."""
    return bool(ranks["rank"][0][case]["tp_blocks"])


def _within(ranks, case: str, prefixes: tuple, flip_err=None,
            bound: float = 1e-4, field: str = "vs_unsharded",
            off: str = "off") -> None:
    """Every leaf's largest error within ``bound`` of its largest value and
    no element beyond its bound (``off``, or ``off_same``); with int8
    compression, at most :data:`FLIP_SHARE` of the elements beyond it and
    each leaf's largest error within ``flip_err`` of its largest value,
    where given."""
    leaves = _vs_unsharded(ranks, case, prefixes, field)
    if CASES[case][2]:
        n = sum(e[off] for _, e in leaves)
        assert n <= FLIP_SHARE * sum(e["numel"] for _, e in leaves), n
        for key, e in leaves:
            assert flip_err is None or e["err"] <= flip_err * e["scale"], (
                key, e)
        return
    for key, e in leaves:
        assert e[off] == 0, (key, e)
        assert e["err"] <= bound * e["scale"], (key, e)


@pytest.mark.parametrize("case", BASE_CASES)
def test_sharded_step_parameters_match_the_unsharded_step(ranks, case):
    """Every rank's shard of every parameter after the steps, against its
    slice of the port's unsharded step's: within 1e-4 x max|p| and within
    :data:`DP_BOUND` of how far the steps moved the leaf (the widened cases:
    :data:`F32_BOUNDS`) (a flipped
    element under compression moves by up to a step more or less). Where
    blocks compute tensor-parallel, also within that bound of the
    unsharded step in the sharded step's tensor-parallel arithmetic, and,
    with both steps run in float64 (where the split sums' rounding falls
    far below it), within :data:`DP_BOUND` and 1e-4 x max|p| of the
    unsharded step."""
    for key, e in _vs_unsharded(ranks, case, ("params/",)):
        assert e["moved"] > 0, key
    bound = _f32_bounds(case)[0]
    _within(ranks, case, ("params/",), bound=bound)
    if _computes_tp(ranks, case):
        _within(ranks, case, ("params/",), bound=bound, off="off_same")
        for key, e in _vs_unsharded(ranks, case, ("params/",),
                                    "vs_unsharded_f64"):
            assert e["moved"] > 0, key
        _within(ranks, case, ("params/",), field="vs_unsharded_f64")


@pytest.mark.parametrize("case", BASE_CASES)
def test_sharded_step_moments_match_the_unsharded_step(ranks, case):
    """Every rank's shard of AdamW's m and v, which carry the gradient's
    scale, within 1e-4 of their leaf's largest value, in float32
    (:data:`F32_BOUNDS`) and, where blocks compute tensor-parallel, in
    float64; under compression a flipped element is off by at most 2 int8
    steps of the gradient."""
    _within(ranks, case, ("opt/m/", "opt/v/"), flip_err=2 / 127,
            bound=_f32_bounds(case)[2])
    if _computes_tp(ranks, case):
        _within(ranks, case, ("opt/m/", "opt/v/"), flip_err=2 / 127,
                field="vs_unsharded_f64")


def test_moe_routing_groups_must_split_over_the_parts(ranks):
    """Routing groups that split over the 4 data parts (``moe``) are routed
    by the rank that holds them: each routes its 64 tokens as one group;
    one group that spans the parts (``moe_span``) is routed on every rank
    over the batch's 256 gathered tokens, the routing (top-k experts and
    kept slots, each layer) equal to the unsharded step's, whose routing
    ``tests/test_torch_lm_families.py`` holds equal to the reference's."""
    for r in ranks["rank"]:
        local = r["moe"]["routes"]
        assert local and all(t == BATCH * SEQ // 4 for t, *_ in local)
        got, want = r["moe_span"]["routes"], r["moe_span"]["plain_routes"]
        assert len(got) == len(want) > 0
        for (t, cap, idx, keep), (t0, cap0, idx0, keep0) in zip(got, want):
            assert (t, cap) == (t0, cap0) == (BATCH * SEQ, cap0)
            assert torch.equal(idx, idx0) and torch.equal(keep, keep0)


def test_sharded_step_gathers_at_most_two_layers(ranks):
    """Per-layer gathers: in every step, on every rank, the most gathered
    parameter bytes alive at once (forward and backward) at most two
    layers' worth of what the gathers hand the model and the unstacked
    leaves' (``_gathered_bytes``), where the ``tp`` case's 3 layers gather
    more; every layer gathered again for the backward (a weight that
    autograd kept would be neither); and, in every case, no copy of a
    weight (arranged, cast or sliced) kept by autograd for the backward.
    Where nothing is sharded (``reduced``) nothing is gathered. On one
    rank, a layout that pads heads arranges q/k/v/o in their gathers: the
    steps bit for bit the unsharded step's, no copy kept."""
    for r in ranks["rank"]:
        for case in ("wide", "tp"):
            layer, unstacked = r[case]["gathered_layer"], r[case][
                "gathered_unstacked"]
            assert layer > 0
            for g in r[case]["gathers"]:
                assert 0 < g["peak_alive_bytes"] <= 2 * layer + unstacked
                assert g["gathered_bytes"] >= 2 * r[case]["layers"] * layer
        assert 2 < r["tp"]["layers"]
        for case in BASE_CASES:
            assert all(g["kept_copy_bytes"] == 0 for g in r[case]["gathers"])
        assert all(g == {"gathered_bytes": 0, "peak_alive_bytes": 0,
                         "kept_copy_bytes": 0}
                   for g in r["reduced"]["gathers"])
    padded = ranks["rank"][0]["padded_one_rank"]
    assert padded["arranged"] == [f"blocks/attn/{n}/w" for n in "koqv"]
    assert padded["losses"] and padded["leaves"]
    assert all(g["gathered_bytes"] > 0 and g["kept_copy_bytes"] == 0
               for g in padded["gathers"])


def test_tp_blocks_compute_on_model_shards(ranks):
    """Which blocks compute tensor-parallel: none at ``reduced()`` (every
    leaf under the rules' floor) or in the MoE cases; the embedding, head
    and MLP when widened; attention too in ``tp``."""
    for r in ranks["rank"]:
        for case in ("reduced", "moe", "moe_span"):
            assert r[case]["tp_blocks"] == {}
        assert r["wide"]["tp_blocks"] == {"blocks": ("mlp",),
                                          "embed": ("",), "lm_head": ("",)}
        assert r["tp"]["tp_blocks"] == {"blocks": ("attn", "mlp"),
                                        "embed": ("",), "lm_head": ("",)}


@pytest.mark.parametrize("case", BASE_CASES)
def test_sharded_state_shards_are_the_reference_specs_cut(ranks, jx, case):
    """Each rank's local shard of every state leaf has the shape the
    reference's ``state_pspecs`` on a (4, 2) mesh cut; at ``reduced()``
    every leaf is below the rules' floor and whole, widened some shard."""
    from jax.sharding import AbstractMesh, PartitionSpec
    from repro.launch import sharding as ref_shd
    mesh = AbstractMesh((4, 2), ("data", "model"))
    init = _flatten(ranks["init"][case])
    specs = jx["jax"].tree.leaves(
        ref_shd.state_pspecs(ranks["init"][case], mesh),
        is_leaf=lambda x: isinstance(x, PartitionSpec))
    sizes = dict(mesh.shape)
    want = {}
    for (key, leaf), spec in zip(init.items(), specs):
        shape = list(np.shape(leaf))
        for d, entry in enumerate(spec):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            for a in axes:
                shape[d] //= sizes[a]
        want[key] = tuple(shape)
    cut = sum(w != np.shape(leaf) for w, leaf in zip(want.values(),
                                                      init.values()))
    assert (cut > 0) == _cuts(case)
    for r in ranks["rank"]:
        assert r[case]["shard_shapes"] == want


def test_one_rank_mesh_is_the_unsharded_program(ranks):
    """At one rank every collective is an identity: the sharded step's
    losses and state bit for bit the unsharded step's, ``compressed_psum``
    bit for bit ``int8_dequantize(int8_quantize(x))``, ``pipeline_forward``
    the stage, ``overlapped_tp_matmul`` the product (what phase
    ``distributed`` of ``chip_smoke.py`` holds on the card)."""
    assert ranks["rank"][0]["one_rank"] == {
        "losses": True, "leaves": True, "psum": True, "pipe": True,
        "matmul": True}


# ---------------------------------------------------------------------------
# elastic restore and replica fan-out
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", BASE_CASES)
def test_restore_recuts_an_8_rank_checkpoint_for_4(ranks, case):
    for r in ranks["rank"][:4]:
        got = r[case]["restore"]
        assert got["step"] == STEPS
        assert got["equal"] == got["leaves"] > 0
        assert (got["sharded"] > 0) == _cuts(case)
    assert all("restore" not in r[case] for r in ranks["rank"][4:])


def test_replica_fan_out_serves_the_plain_rows(ranks):
    for r in ranks["rank"][:2]:
        served = r["served"]
        for rows, plain in zip(served["rows"], served["plain"]):
            assert torch.equal(rows, plain)
        assert served["trace_shapes"] == served["plain_trace_shapes"]
    assert torch.equal(ranks["rank"][0]["served"]["rows"][0],
                       ranks["rank"][1]["served"]["rows"][0])


# ---------------------------------------------------------------------------
# MoE local routing (one process)
# ---------------------------------------------------------------------------

def test_moe_local_routing_matches_the_reference(jx):
    """4 routing groups of 16 tokens, top-2 of 4 experts at capacity
    factor 1 (8 slots per expert and group, so some choices drop): each
    group's routing
    (tokens in expert order, slots, drops) equal to the reference's
    ``_route_local`` on the same group, and ``moe_apply`` under a mesh
    within 1e-5 of the reference's."""
    from repro_torch.models import moe
    jax, jnp, ref = jx["jax"], jx["jnp"], jx["moe"]
    groups, t, d, f, e, k, cf = 4, 64, 16, 32, 4, 2, 1.0
    p = jax.device_get(ref.moe_init(jax.random.PRNGKey(3), d, f, e,
                                    jnp.float32))
    x = np.random.default_rng(4).normal(size=(t, d)).astype(np.float32)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    with jax.set_mesh(mesh):
        want = jax.jit(lambda p, x: ref.moe_apply(
            p, x, top_k=k, capacity_factor=cf, shard_axes=("data",),
            groups=groups))(p, x)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), p)
    got = moe.moe_apply(tp, torch.from_numpy(x), top_k=k,
                        capacity_factor=cf, shard_axes=("data",),
                        groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    cap = moe.capacity(cf, t // groups, k, e)
    assert cap == 8
    drops = 0
    for xg in np.split(x, groups):
        _, (st, _, slot, keep) = ref._route_local(
            jnp.asarray(xg), p["router"]["w"], k, cap, e)
        _, meta, _, _ = moe._route_local(torch.from_numpy(xg),
                                         tp["router"]["w"], k, cap, e)
        for a, b in zip(meta[:1] + meta[2:], (st, slot, keep)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        drops += int((~meta[3]).sum())
    assert drops > 0


# ---------------------------------------------------------------------------
# the sharded prefill and decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", BASE_SERVE_CASES)
def test_sharded_prefill_and_decode_match_the_unsharded_port(ranks, case):
    for r, res in enumerate(ranks["rank"]):
        got = res[f"serve_{case}"]
        assert got["shapes"], (r, case)
        worst = max(got["errs"], key=got["errs"].get)
        assert got["errs"][worst] <= SERVE_BOUND, (r, case, worst, got)


def test_batch_one_decode_cuts_the_kv_rows_over_data(ranks):
    """``seq``'s batch of 1 does not split over 'data': its KV rows do,
    and each rank attends over its own (the log-sum-exp merge)."""
    for res in ranks["rank"]:
        specs = res["serve_seq"]["kv_specs"]
        assert specs["k"] == (None, None, ("data",), "model", None), specs
    dense = ranks["rank"][0]["serve_dense"]["kv_specs"]
    assert dense["k"] == (None, ("data",), None, "model", None), dense


# ---------------------------------------------------------------------------
# the card: world-size-1 identities over NCCL
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    yield dist
    dist.destroy_process_group()


@pytest.mark.cuda
def test_compressed_psum_on_one_rank_is_quantize_dequantize(nccl):
    from repro_torch.launch.collectives import compressed_psum
    x = torch.from_numpy(_psum_input()).cuda()
    assert torch.equal(compressed_psum(x),
                       int8_dequantize(*int8_quantize(x)))


@pytest.mark.cuda
def test_pipeline_on_one_stage_is_the_stage(nccl):
    from repro_torch.launch.pipeline import pipeline_forward
    ws, xm = (torch.from_numpy(a).cuda() for a in _pipe_inputs())
    got = pipeline_forward(_stage, ws[0], xm)
    assert torch.equal(got, torch.stack([_stage(ws[0], h) for h in xm]))


@pytest.mark.cuda
def test_sharded_step_on_one_rank_is_the_unsharded_step(nccl):
    from repro_torch.configs import dummy_inputs, get_config
    from repro_torch.launch import (init_train_state, make_test_mesh,
                                    make_train_step)
    from repro_torch.launch.sharding import (named_shardings, shard_tree,
                                             state_pspecs)
    cfg = get_config("qwen1.5-0.5b").reduced()
    opt = AdamWConfig()
    mesh = make_test_mesh((1, 1))
    plain = init_train_state(0, cfg, opt)
    sharded = shard_tree(init_train_state(0, cfg, opt), named_shardings(
        state_pspecs(plain, mesh), mesh))
    batch = dummy_inputs(cfg, "train", batch=2, seq=36)
    step, sstep = make_train_step(cfg, opt), make_train_step(cfg, opt,
                                                             mesh=mesh)
    for _ in range(3):
        _, m = step(plain, batch)
        _, sm = sstep(sharded, batch)
        assert torch.equal(m["loss"], sm["loss"])
    for a, b in zip(tree_leaves(plain), tree_leaves(sharded)):
        assert torch.equal(a.detach(), b.to_local())


@pytest.mark.cuda
def test_sharded_prefill_and_decode_on_one_rank_are_the_unsharded_ones(nccl):
    from repro_torch.configs import dummy_inputs, get_config
    from repro_torch.launch import make_test_mesh
    from repro_torch.launch.serve import make_prefill, make_serve_step
    from repro_torch.launch.sharding import (named_shardings, param_pspecs,
                                             shard_tree)
    from repro_torch.models import lm
    mesh = make_test_mesh((1, 1))
    for arch in ("qwen1.5-0.5b", "rwkv6-3b", "zamba2-7b",
                 "llama-3.2-vision-11b"):
        cfg = get_config(arch).reduced()
        params = lm.init(0, cfg)
        sharded = shard_tree(params, named_shardings(
            param_pspecs(params, mesh), mesh))
        ins = dummy_inputs(cfg, "prefill", 2, SERVE_PROMPT)
        img = ins.get("image_embeds")
        want, cache = lm.prefill(params, cfg, ins["ids"], image_embeds=img,
                                 max_seq=SERVE_CAPACITY)
        got, shards = make_prefill(cfg, mesh=mesh)(
            sharded, ins["ids"], image_embeds=img, max_seq=SERVE_CAPACITY)
        assert torch.equal(want, got.to_local()), arch
        step = make_serve_step(cfg, mesh=mesh)
        pos = torch.tensor(lm.kv_rows(cfg, SERVE_PROMPT), dtype=torch.int32,
                           device="cuda")
        want, _ = lm.decode_step(params, cfg, cache, ids1=ins["ids"][:, :1],
                                 pos=pos)
        got, _ = step(sharded, shards, ins["ids"][:, :1], pos)
        assert torch.equal(want, got.to_local()), arch
        for k in cache:
            assert torch.equal(cache[k], shards[k].to_local()), (arch, k)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], *sys.argv[4:])
