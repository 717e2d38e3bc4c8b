"""Collective helpers over ``torch.distributed``: the compressed cross-pod
all-reduce and the overlap-friendly TP matmul — the port's counterpart of
the JAX package's ``launch/collectives.py``.

Each takes a process group (``mesh.get_group(axis)``) where the reference
takes a ``shard_map`` axis name, and is called by every rank of it. The
reference's version shims (``launch/_compat.py``: ``axis_size``,
``pvary``) exist for JAX's versions and have no counterpart: the port
reads the group's size and this rank's place in it
(``dist.get_world_size(group)``, ``dist.get_rank(group)``), and a tensor
is simply local to its rank.

``compressed_psum``: int8-quantized all-reduce for the cross-pod gradient
reduction. All participants agree on a scale through one scalar MAX
all-reduce, quantize to int8, reduce, dequantize. It carries int32 (the
reference's ``psum`` does too): the semantics are the deployment's, the
4x fewer bytes of an int8 wire format are not.

``overlapped_tp_matmul``: all-gather-free tensor-parallel matmul that
rotates activation shards around the group's ring while multiplying: each
rank's send of the shard it holds and receive of the next
(``batch_isend_irecv``) are in flight while it multiplies the shard it
already holds.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.optim.optimizer import _f32

__all__ = ["compressed_psum", "overlapped_tp_matmul"]


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-quantized sum of ``x`` over the ranks of ``group`` (every rank
    calls it with its own ``x`` and gets the sum). The reference's
    arithmetic: float32, the scale the largest |x| of any rank over 127
    (a division by a float32 tensor, as ``optim/compression.py`` divides)
    and at least 1e-12, ``x / scale`` rounded half to even and clipped to
    [-127, 127], the int32 sum times the scale, in ``x``'s dtype."""
    x32 = x.to(torch.float32)
    amax = x32.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(amax / _f32(127.0, amax), 1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return (total.to(torch.float32) * scale).to(x.dtype)


def _peer(group, group_rank: int) -> int:
    """The global rank of ``group_rank`` in ``group`` (p2p ops take
    global ranks)."""
    if group is None:
        return group_rank
    return dist.get_global_rank(group, group_rank)


def overlapped_tp_matmul(x_shard: torch.Tensor, w_shard: torch.Tensor,
                         group=None) -> torch.Tensor:
    """``allgather(x, group) @ w_shard`` without materializing the
    all-gather: ring-rotate x shards, accumulating partial products.

    Over a group of N ranks:
      x_shard (m, k/N) — activation sharded on the contraction dim, rank i
                         holding shard i;
      w_shard (k, n)   — the weight's rows, of which step t multiplies the
                         k/N that match the shard held then.

    At step t rank i holds shard (i - t) mod N; it sends it to rank i + 1
    and receives the next from rank i - 1 while it multiplies. The
    partial products are summed in the reference's order, step 0 first,
    into a zero accumulator."""
    n_dev = dist.get_world_size(group)
    idx = dist.get_rank(group)
    k_shard = x_shard.shape[-1]
    acc = torch.zeros((x_shard.shape[0], w_shard.shape[-1]),
                      dtype=torch.promote_types(x_shard.dtype,
                                                w_shard.dtype),
                      device=x_shard.device)
    blk = x_shard.contiguous()
    for i in range(n_dev):
        reqs, nxt = [], None
        if i < n_dev - 1:       # the last step's rotation is never read
            nxt = torch.empty_like(blk)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, blk, _peer(group, (idx + 1) % n_dev),
                           group),
                dist.P2POp(dist.irecv, nxt, _peer(group, (idx - 1) % n_dev),
                           group)])
        shard_id = (idx - i) % n_dev
        acc = acc + blk @ w_shard[shard_id * k_shard:
                                  (shard_id + 1) * k_shard]
        for r in reqs:
            r.wait()
        blk = nxt
    return acc
