"""Mixture-of-Experts with sort-based dispatch in PyTorch (llama4-scout
16e top-1, grok-1 8e top-2): the port's counterpart of the JAX package's
``models/moe.py``.

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
reference's einsums. In TP form (the sharded step's, ``launch/tp.py``)
they run on the rank's part of ``f``, as the reference pins the experts
over 'model': ``gate`` and ``up`` column-parallel, ``down`` row-parallel,
the routing replicated and the dispatched tokens copied in, the partial
outputs summed over 'model' before the combine.

The backward sums in a fixed order on the card: the dispatch's row
gathers (the tokens into expert order, the gates into expert order, the
expert outputs back per choice) take their rows through
``kernels.gather_rows``, whose gradient is P4's fixed-order segment sum,
where autograd's backward of an indexing would scatter with atomics; the
top-k values are selected by a compare-and-sum over the experts (one
non-zero term: the value exactly), whose backward is elementwise; the
slot write (``index_copy_``) has a gather for its backward and the
combine's ``index_add_`` an ``index_select``.

Routing is LOCAL under data parallelism, as the reference's: with
``shard_axes`` set and ``groups`` = g > 1 the T tokens are cut into g
contiguous groups of T/g (batch-major, so group r is data-parallel rank
r's part of the batch) and each group is routed, dispatched and combined
on its own, with a capacity of ``max(1, int(cf · (T/g) · k / E))`` per
expert. Dispatch and combine then never cross ranks; a rank that holds one
group's tokens routes them as one group. A group that spans ranks (fewer
groups than data-parallel parts: every config's ``dp_shards=1``) is routed
by the sharded step on every rank over the batch's gathered tokens, each
rank keeping its own rows (``launch/tp.py::TokenSpan``, ``models/lm.py``'s
``_ffn``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.gather_backward import gather_rows
from repro_torch.models.layers import dense_init, upcast

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
    """``lax.top_k``: the k largest per row, ties to the lower index. The
    values are read by a compare with the expert index and a sum (each a
    row's one logit plus zeros, so the value exactly), whose backward,
    unlike a ``gather``'s or a ``sort``'s, scatters nothing."""
    if k == 1:
        idx = logits.argmax(dim=-1, keepdim=True)
    else:
        idx = torch.sort(logits, dim=-1, descending=True,
                         stable=True).indices[..., :k]
    experts = torch.arange(logits.shape[-1], device=logits.device)
    chosen = idx[..., None] == experts                     # (t, k, E)
    val = torch.where(chosen, logits[..., None, :], 0.0).sum(dim=-1)
    return val, idx


def _route_local(x: torch.Tensor, router_w: torch.Tensor, top_k: int,
                 cap: int, e: int):
    """x (t, d) -> (xe (E, cap, d), (token, gate, slot, keep) in expert
    order, top_idx (t, k), router logits (t, E))."""
    t, d = x.shape
    logits = upcast(x) @ router_w
    top_val, top_idx = _top_k(logits, top_k)
    gates = torch.softmax(top_val, dim=-1)

    expert_of = top_idx.reshape(-1)                            # (t*k,)
    token_of = torch.arange(t, device=x.device).repeat_interleave(top_k)
    gate_of = gates.reshape(-1)
    order = torch.argsort(expert_of, stable=True)              # reordering
    se, st = expert_of[order], token_of[order]
    sg = gather_rows(gate_of[:, None], order)[:, 0]
    counts = torch.zeros((e,), dtype=torch.int64, device=x.device
                         ).scatter_add_(0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(t * top_k, device=x.device) - starts[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)         # drop row
    xd = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    # the drop row takes duplicate writes and is discarded
    xd.index_copy_(0, slot, gather_rows(x, st))
    return (xd[:-1].reshape(e, cap, d), (st, sg, slot, keep), top_idx,
            logits)


def _combine_local(y: torch.Tensor, meta, t: int, d: int) -> torch.Tensor:
    st, sg, slot, keep = meta
    e_cap = y.shape[0] * y.shape[1]
    yf = y.reshape(e_cap, -1)
    contrib = torch.where(keep[:, None],
                          gather_rows(yf, torch.clamp_max(slot, e_cap - 1))
                          * sg[:, None].to(yf.dtype), 0)
    # each token gets at most k <= 2 contributions into a zero row: the
    # rounded sum (0 + a) + b equals (0 + b) + a, so the result does not
    # depend on the order index_add_ adds in
    return torch.zeros((t, d), dtype=yf.dtype, device=y.device
                       ).index_add_(0, st, contrib)


def _experts_tp(p, xe: torch.Tensor) -> torch.Tensor:
    """The experts in TP form (``p`` marked ``"tp"``): the dispatched ``xe``
    (E, cap, d), replicated, copied in; ``gate`` and ``up`` the rank's
    columns of ``f`` ``(n, E, d, f/tp)``, ``down`` its rows ``(n, E, f/tp,
    d)``; the ranks' partial outputs summed over 'model'."""
    tp = p["tp"]
    n, e = tp.n, xe.shape[0]

    def bmm(a, w):
        return torch.bmm(a.flatten(0, 1), w.flatten(0, 1)).unflatten(0,
                                                                     (n, e))
    xr = tp.copy_in(xe)
    h = bmm(xr, p["gate"])
    u = bmm(xr, p["up"])
    return tp.reduce_out(bmm(F.silu(h) * u, p["down"]))


def _moe_group(p, x: torch.Tensor, top_k: int, cap: int) -> torch.Tensor:
    """One routing group: x (t, d) routed, the experts applied, combined."""
    t, d = x.shape
    xe, meta, _, _ = _route_local(x, p["router"]["w"], top_k, cap,
                                  p["router"]["w"].shape[1])
    if "tp" in p:
        y = _experts_tp(p, xe)
    else:
        h = torch.bmm(xe, p["gate"])
        u = torch.bmm(xe, p["up"])
        y = torch.bmm(F.silu(h) * u, p["down"])
    return _combine_local(y, meta, t, d)


def moe_apply(p, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, shard_axes: tuple = (),
              groups: int = 1) -> torch.Tensor:
    """x (T, d) flattened tokens -> (T, d). ``groups`` = the data-parallel
    shard count (local routing, with ``shard_axes`` set); 1 = one group."""
    t, d = x.shape
    e = p["router"]["w"].shape[1]
    g = max(1, groups) if shard_axes else 1
    if t % g:
        raise ValueError(f"moe_apply: {t} tokens do not split into {g} "
                         f"routing groups")
    cap = capacity(capacity_factor, t // g, top_k, e)
    outs = [_moe_group(p, xg, top_k, cap) for xg in x.split(t // g)]
    return (torch.cat(outs) if g > 1 else outs[0]).to(x.dtype)
