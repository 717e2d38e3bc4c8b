"""Serve a PointNet++ CompiledModel on the PyTorch/CUDA port:
shape-bucketed continuous batching over a Poisson request stream, with the
content-keyed plan cache; the twin of ``examples/serve_pointcloud.py``.

The stream mixes point counts (the engine pads them into two shape
buckets) and repeats clouds (the plan cache skips FPS/kNN + Algorithm 1
on repeats). Every served result equals the unpadded per-request
``forward``, bit for bit on the crossbar backends ('float' sums a batch in
another order than one cloud: within 1e-5 of the largest logit there),
asserted below for the whole stream. On the card each bucket shape replays
one captured CUDA graph.

Run:  PYTHONPATH=src python examples/serve_pointcloud_torch.py
          [--backend reram-fused --requests 24 --device cpu]
"""
import argparse

import torch

import repro_torch
from repro_torch.core.workload import PointNetConfig, SALayerSpec
from repro_torch.data import request_stream
from repro_torch.launch import PointCloudServable, ServingEngine, ShapeBuckets
from repro_torch.models.pointnet2 import init_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="reram-fused")
    ap.add_argument("--schedule", default="pointer")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = PointNetConfig(name="serve-demo", n_points=64, layers=(
        SALayerSpec(n_centers=24, n_neighbors=4, in_features=4,
                    mlp=(4, 8, 8, 16)),
        SALayerSpec(n_centers=8, n_neighbors=4, in_features=16,
                    mlp=(16, 16, 16, 32)),
    ))
    params = init_params(cfg, seed=0, n_classes=10)
    model = repro_torch.compile_model(params, cfg, backend=args.backend,
                                      schedule=args.schedule,
                                      device=args.device)

    servable = PointCloudServable(
        model, buckets=ShapeBuckets(points=(48, 64), batch=(1, 2, 4)))
    engine = ServingEngine(servable)
    stream = list(request_stream(args.requests, rate_hz=500.0,
                                 n_points=(40, 48, 56, 64), pool=6,
                                 repeat_p=0.7, seed=0))
    stats = engine.serve_stream(stream, payload_of=lambda item: item[1])

    print(f"served {stats['n_requests']} requests in "
          f"{stats['wall_s']*1e3:.0f} ms  "
          f"(p50 {stats['p50_ms']:.1f} ms, p99 {stats['p99_ms']:.1f} ms, "
          f"{stats['throughput_rps']:.1f} req/s) on {model.device}")
    print(f"batches: {stats['batches']}  traces: {stats['jit_traces']} "
          f"(bucketed: at most |points| x |batch| ever)")
    pc = stats["plan_cache"]
    print(f"plan cache: {pc['hits']} hits / {pc['misses']} misses "
          f"(hit rate {pc['hit_rate']:.0%})")

    # the bucketing contract, end to end: padded+batched serving returns
    # the per-request forward's logits (completion order differs from
    # arrival order, so match on request ids)
    by_id = {r.id: r for r in engine.completed}
    for rid, (_, cloud, _) in enumerate(stream):
        ref = model.forward(cloud)
        got = by_id[rid].result
        if args.backend == "float":
            tol = 1e-5 * float(ref.abs().max())
            assert float((got - ref).abs().max()) <= tol, rid
        else:
            assert torch.equal(got, ref), rid
    print("check vs per-request forward: OK")
    return stats


if __name__ == "__main__":
    main()
