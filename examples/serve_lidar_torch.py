"""Streaming-LiDAR serving on the PyTorch/CUDA port: deadline scheduling
and frame-coherent plan reuse, the twin of ``examples/serve_lidar.py``.

One periodic sensor emits temporally coherent frames (drifting object
clusters and per-frame jitter: never bitwise equal, so the exact-key plan
cache misses every frame, but within the FrameTracker tolerance, so the
anchor's DevicePlan is reused). The same stream replays under FIFO and
under EDF on a deterministic virtual clock, every 3rd frame urgent. Under
overload FIFO serves in arrival order and urgent frames miss; EDF serves
the earliest feasible deadline first and meets them. The served logits
are the same either way, and equal ``forward`` on each bare frame, bit for
bit on the crossbar backends. On the card each batch replays a captured
CUDA graph.

Run:  PYTHONPATH=src python examples/serve_lidar_torch.py
          [--backend reram-fused --frames 18 --device cpu]
"""
import argparse

import torch

import repro_torch
from repro_torch.core.workload import PointNetConfig, SALayerSpec
from repro_torch.data import request_stream
from repro_torch.launch import (PointCloudServable, ServingEngine,
                                ShapeBuckets, VirtualClock)
from repro_torch.models.pointnet2 import init_params

SERVICE_S = 2e-3          # virtual seconds per batch (one clock tick)
URGENT_US, RELAXED_US = 4_000, 100_000


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="reram-fused")
    ap.add_argument("--frames", type=int, default=18)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()

    cfg = PointNetConfig(name="lidar-demo", n_points=64, layers=(
        SALayerSpec(n_centers=24, n_neighbors=4, in_features=4,
                    mlp=(4, 8, 8, 16)),
        SALayerSpec(n_centers=8, n_neighbors=4, in_features=16,
                    mlp=(16, 16, 16, 32)),
    ))
    params = init_params(cfg, seed=0, n_classes=10)
    model = repro_torch.compile_model(params, cfg, backend=args.backend,
                                      schedule="pointer", device=args.device)
    # 800 frames/s against 2 ms service at batch 1 = overload: the queue
    # grows and the scheduling policy decides who eats the delay
    stream = list(request_stream(args.frames, rate_hz=800.0,
                                 n_points=(64,), pool=4, seed=0,
                                 mode="lidar"))

    def replay(scheduler):
        servable = PointCloudServable(
            model, buckets=ShapeBuckets(points=(64,), batch=(1,)),
            frame_reuse=repro_torch.FrameTracker(tol=1e-3))
        engine = ServingEngine(servable, scheduler=scheduler, max_batch=1,
                               clock=VirtualClock(tick_s=SERVICE_S))
        engine.seed_service_estimate(64, SERVICE_S)
        stats = engine.serve_stream(
            stream, payload_of=lambda it: it[1],
            deadline_us=lambda it: URGENT_US if it[2] % 3 == 0
            else RELAXED_US)
        return engine, stats

    results = {}
    for name in ("fifo", "edf"):
        engine, stats = replay(name)
        results[name] = (engine, stats)
        ft = stats["frame_tracker"]
        print(f"{name:4s}: deadline misses "
              f"{stats['n_deadline_misses']}/{stats['n_deadlined']} "
              f"(rate {stats['deadline_miss_rate']:.0%})  "
              f"p50 {stats['p50_ms']:.1f} ms  p99 {stats['p99_ms']:.1f} ms  "
              f"frame hits {ft['frame_hits']}/{args.frames} "
              f"(rate {ft['hit_rate']:.0%})  on {model.device}")

    f_stats, e_stats = results["fifo"][1], results["edf"][1]
    assert e_stats["deadline_miss_rate"] < f_stats["deadline_miss_rate"], \
        "EDF must beat FIFO under binding deadlines"
    assert e_stats["frame_tracker"]["hit_rate"] > 0.5

    # scheduling is a policy: both replays, frame reuse and all, return
    # the per-request forward's logits ('float' sums a batch in another
    # order than one cloud: within 1e-5 of the largest logit there)
    for name, (engine, _) in results.items():
        by_id = {r.id: r for r in engine.completed}
        for rid, (_, cloud, _) in enumerate(stream):
            ref = model.forward(cloud)
            got = by_id[rid].result
            if args.backend == "float":
                tol = 1e-5 * float(ref.abs().max())
                assert float((got - ref).abs().max()) <= tol, (name, rid)
            else:
                assert torch.equal(got, ref), (name, rid)
    print("check vs per-request forward (both schedulers): OK")


if __name__ == "__main__":
    main()
