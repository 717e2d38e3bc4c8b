"""Pipeline parallelism across ranks (GPipe schedule): the port's
counterpart of the JAX package's ``launch/pipeline.py``.

Layers are split into ``n_stages`` contiguous stages, one per rank of a
process group; a microbatched forward hands activations stage to stage
with point-to-point sends. The bubble fraction is (S-1)/(M+S-1) for S
stages and M microbatches.

``pipeline_forward`` is model-agnostic: it pipelines any per-stage
function ``stage_fn(stage_params, x) -> x``, so tests hold it against the
sequential composition exactly.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.collectives import _peer

__all__ = ["pipeline_forward"]


def pipeline_forward(stage_fn, stage_params, x_mb: torch.Tensor,
                     group=None) -> torch.Tensor:
    """Run on every rank of ``group``, one stage per rank, stage ``s`` the
    rank of group rank ``s``.

    stage_params : this rank's stage parameters
    x_mb         : (M, mb, ...) microbatched input, the same on every rank
                   (only stage 0 reads it)
    returns      : (M, mb, ...) the last stage's outputs, on every rank.

    ``M + S - 1`` ticks: at tick t stage 0 takes microbatch t (the last
    one again past M, as the reference does), every other stage what its
    predecessor sent at tick t - 1; each stage but the last sends its
    output on (no wrap-around), and the last stage retires microbatch
    t - (S - 1). The reference's ``psum`` of the last stage's masked value
    is a broadcast from it here."""
    s = dist.get_world_size(group)
    sid = dist.get_rank(group)
    m = x_mb.shape[0]
    buf = torch.zeros_like(x_mb[0])
    out = torch.zeros_like(x_mb)
    for t in range(m + s - 1):
        h_in = x_mb[min(t, m - 1)] if sid == 0 else buf
        h_out = stage_fn(stage_params, h_in)
        mb_done = t - (s - 1)
        if sid == s - 1 and mb_done >= 0:
            out[mb_done] = h_out
        ops = []
        if sid < s - 1:
            ops.append(dist.P2POp(dist.isend, h_out.contiguous(),
                                  _peer(group, sid + 1), group))
        if sid > 0:
            buf = torch.empty_like(h_out)
            ops.append(dist.P2POp(dist.irecv, buf, _peer(group, sid - 1),
                                  group))
        if ops:
            for r in dist.batch_isend_irecv(ops):
                r.wait()
    dist.broadcast(out, src=_peer(group, s - 1), group=group)
    return out
