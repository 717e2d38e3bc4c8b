"""Mixture-of-Experts with sort-based dispatch in PyTorch (llama4-scout
16e top-1, grok-1 8e top-2): the port's counterpart of the JAX package's
``models/moe.py``, one routing group (``groups`` = 1).

Tokens are argsorted by expert id so that consecutive work items hit the
same stationary expert weights; a fixed per-expert capacity ``cap =
max(1, int(capacity_factor · T · k / E))`` keeps every shape static, and
tokens past it fall back to the residual path (token dropping). The
routing is the reference's exactly and capturable:

  * top-k ties go to the lower index, as ``lax.top_k`` breaks them:
    ``argmax`` for k = 1, a stable descending sort otherwise (never
    ``torch.topk``, whose tie order on CUDA is not fixed);
  * the sort by expert is ``argsort(stable=True)``;
  * per-expert counts are a ``scatter_add_`` into ``zeros(E)`` (no
    ``bincount``, which reads its maximum on the host);
  * dispatch writes every (token, choice) row, the dropped ones into the
    extra row ``E·cap``, which is discarded: no data-dependent shape.

The three expert products are batched GEMMs in the model's dtype, as the
reference's einsums. The local routing of a sharded batch (``shard_axes``,
``groups`` > 1) waits for the distributed slice (ROADMAP item 17).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

__all__ = ["moe_init", "moe_apply", "capacity"]


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype: torch.dtype) -> dict:
    """The reference's layout: a float32 router, experts stacked (E, ...)."""
    def stack(d_in, d_out):
        return torch.stack([dense_init(gen, d_in, d_out, dtype)["w"]
                            for _ in range(n_experts)])

    return {
        "router": dense_init(gen, d_model, n_experts, torch.float32),
        "gate": stack(d_model, d_ff),     # (E, d, f)
        "up": stack(d_model, d_ff),
        "down": stack(d_ff, d_model),     # (E, f, d)
    }


def capacity(capacity_factor: float, tokens: int, top_k: int,
             n_experts: int) -> int:
    """Slots per expert for one call of ``tokens`` tokens (the reference's
    Python arithmetic)."""
    return max(1, int(capacity_factor * tokens * top_k / n_experts))


def _top_k(logits: torch.Tensor, k: int):
    """``lax.top_k``: the k largest per row, ties to the lower index."""
    if k == 1:
        idx = logits.argmax(dim=-1, keepdim=True)
        return logits.gather(-1, idx), idx
    val, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def _route_local(x: torch.Tensor, router_w: torch.Tensor, top_k: int,
                 cap: int, e: int):
    """x (t, d) -> (xe (E, cap, d), (token, gate, slot, keep) in expert
    order, top_idx (t, k), router logits (t, E))."""
    t, d = x.shape
    logits = x.float() @ router_w
    top_val, top_idx = _top_k(logits, top_k)
    gates = torch.softmax(top_val, dim=-1)

    expert_of = top_idx.reshape(-1)                            # (t*k,)
    token_of = torch.arange(t, device=x.device).repeat_interleave(top_k)
    gate_of = gates.reshape(-1)
    order = torch.argsort(expert_of, stable=True)              # reordering
    se, st, sg = expert_of[order], token_of[order], gate_of[order]
    counts = torch.zeros((e,), dtype=torch.int64, device=x.device
                         ).scatter_add_(0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(t * top_k, device=x.device) - starts[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)         # drop row
    xd = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    # the drop row takes duplicate writes and is discarded
    xd.index_copy_(0, slot, x[st])
    return (xd[:-1].reshape(e, cap, d), (st, sg, slot, keep), top_idx,
            logits)


def _combine_local(y: torch.Tensor, meta, t: int, d: int) -> torch.Tensor:
    st, sg, slot, keep = meta
    e_cap = y.shape[0] * y.shape[1]
    yf = y.reshape(e_cap, -1)
    contrib = torch.where(keep[:, None],
                          yf[torch.clamp_max(slot, e_cap - 1)]
                          * sg[:, None].to(yf.dtype), 0)
    # each token gets at most k <= 2 contributions into a zero row: the
    # rounded sum (0 + a) + b equals (0 + b) + a, so the result does not
    # depend on the order index_add_ adds in
    return torch.zeros((t, d), dtype=yf.dtype, device=y.device
                       ).index_add_(0, st, contrib)


def moe_apply(p, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, shard_axes: tuple = (),
              groups: int = 1) -> torch.Tensor:
    """x (T, d) flattened tokens -> (T, d), routed as one group."""
    if shard_axes:
        raise ValueError(
            f"moe_apply: shard_axes={tuple(shard_axes)} (local routing over "
            f"{groups} data-parallel groups) waits for the distributed slice "
            f"(ROADMAP item 17); the port routes one group")
    t, d = x.shape
    e = p["gate"].shape[0]
    cap = capacity(capacity_factor, t, top_k, e)
    xe, meta, _, _ = _route_local(x, p["router"]["w"], top_k, cap, e)
    h = torch.bmm(xe, p["gate"])
    u = torch.bmm(xe, p["up"])
    y = torch.bmm(F.silu(h) * u, p["down"])
    return _combine_local(y, meta, t, d).to(x.dtype)
