"""RWKV6 ("Finch") time-mix and channel-mix in PyTorch: the port's
counterpart of the JAX package's ``models/rwkv.py``.

Per head (K = V = head_size), state S in R^{K x V}:

    o_t = r_t @ (S_{t-1} + (u ⊙ k_t) (x) v_t)
    S_t = diag(w_t) S_{t-1} + k_t (x) v_t            w_t in (0,1)^K, per token

with a data-dependent decay ``log w = -(W_MIN + W_SPAN·sigmoid(·))``.
Prefill runs the reference's chunk-parallel form (chunks of ``CHUNK``
tokens) as a Python loop over the static chunks, carrying the float32
(B, H, K, V) state: no host read, so a CUDA graph captures it whole.
Decode is the O(1) recurrence. The token shift's trailing token is carried
in the decode cache. The arithmetic is the reference's, op for op: float32
decays, cumulative sums and products, the group norm's population
variance, the output cast to the model's dtype before the gate (float32
is :func:`~repro_torch.models.layers.upcast`'s: float64 weights compute
in float64). The decays' cumulative sums run in the reference's float32
order, forward and backward (:class:`_CumSum`), for every chunk at once
before the loop; the rest differentiates through autograd (no op here
writes in place into a tensor autograd saved).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.models.layers import (dense_init, linear, linear_col,
                                       linear_row, upcast)

__all__ = ["rwkv_init", "rwkv_time_mix", "rwkv_time_mix_step",
           "rwkv_channel_mix", "rwkv_channel_mix_step", "CHUNK"]

CHUNK = 16
W_MIN, W_SPAN = 0.01, 4.0


def rwkv_init(gen: torch.Generator, d_model: int, head_size: int, d_ff: int,
              dtype: torch.dtype) -> dict:
    """One block's time-mix and channel-mix weights in the reference's
    layout, shapes and dtypes (``u`` float32), drawn from ``gen``."""
    h = d_model // head_size
    dev = gen.device

    def half(n):
        return (0.5 * torch.ones((n, d_model), dtype=torch.float32,
                                 device=dev)).to(dtype)
    return {
        "time": {
            "mix": half(5),
            "r": dense_init(gen, d_model, d_model, dtype),
            "k": dense_init(gen, d_model, d_model, dtype),
            "v": dense_init(gen, d_model, d_model, dtype),
            "g": dense_init(gen, d_model, d_model, dtype),
            "w": dense_init(gen, d_model, d_model, dtype),
            "u": torch.zeros((h, head_size), dtype=torch.float32, device=dev),
            "ln_g": torch.ones((d_model,), dtype=dtype, device=dev),
            "out": dense_init(gen, d_model, d_model, dtype),
        },
        "channel": {
            "mix": half(2),
            "k": dense_init(gen, d_model, d_ff, dtype),
            "v": dense_init(gen, d_ff, d_model, dtype),
        },
    }


def _shift(x: torch.Tensor, last: torch.Tensor | None = None) -> torch.Tensor:
    """x (B,S,D) -> the previous token's row; ``last`` (B,1,D) for decode."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


def _mix(x, xx, mu):
    return x + (xx - x) * mu.to(x.dtype)


def _log_w(wr: torch.Tensor) -> torch.Tensor:
    return -(W_MIN + W_SPAN * torch.sigmoid(upcast(wr)))


def _group_norm(o: torch.Tensor, gamma: torch.Tensor, head_size: int,
                eps: float = 1e-5) -> torch.Tensor:
    """o (..., d) normed per head of ``head_size``; ``gamma`` broadcast to
    it. A zero head gives zero (its variance 0, ``rsqrt(eps)`` finite)."""
    oh = upcast(o.unflatten(-1, (-1, head_size)))
    mu = oh.mean(dim=-1, keepdim=True)
    # jnp.var is the population variance
    var = oh.var(dim=-1, keepdim=True, correction=0)
    oh = (oh - mu) * torch.rsqrt(var + eps)
    return oh.flatten(-2) * upcast(gamma)


def _projections(pt, x, xx, head_size: int):
    """r, k, v (float32), the gate g and the log decays; in TP form (``pt``
    marked ``"tp"``) column-parallel, each the rank's heads ``(n·B, S,
    heads, K)`` (g ``(n, B, S, heads·K)``)."""
    b, s, d = x.shape
    tp = pt.get("tp")
    if tp is None:
        proj = [linear(pt[name], _mix(x, xx, pt["mix"][i]))
                for i, name in enumerate("rkvgw")]
        shape = (b, s, d // head_size, head_size)
    else:
        proj = [linear_col(pt[name], tp.copy_in(_mix(x, xx, pt["mix"][i])))
                for i, name in enumerate("rkvgw")]
        shape = (tp.n * b, s, -1, head_size)
    r, k, v, g, wr = proj
    return (upcast(r.reshape(shape)), upcast(k.reshape(shape)),
            upcast(v.reshape(shape)), g, _log_w(wr.reshape(shape)))


def _u(pt, b: int) -> torch.Tensor:
    """The bonus ``u`` broadcast to a chunk's (B, q, H, K) rows: (1, 1, H,
    K); in TP form each rank's heads over its batch rows (n·B, 1, heads,
    K)."""
    u = pt["u"]
    if "tp" not in pt:
        return u[None, None]
    n = u.shape[0]
    return u[:, None, None].expand(n, b, 1, *u.shape[1:]).flatten(0, 1)


def _finish(pt, o, g, x, head_size: int):
    b, s, d = x.shape
    tp = pt.get("tp")
    if tp is None:
        o = _group_norm(o.reshape(b, s, d), pt["ln_g"], head_size)
        return linear(pt["out"], o.to(x.dtype) * F.silu(g))
    # the rank's heads: its gains (n, heads·K), out's rows, summed over
    # 'model'; a padded head's r, k, v and g are zero, so its output is
    o = _group_norm(o.reshape(g.shape), pt["ln_g"][:, None, None],
                    head_size)
    return linear_row(pt["out"], o.to(x.dtype) * F.silu(g), tp)


class _CumSum(torch.autograd.Function):
    """The inclusive sum along dim 1 in the reference's float32 order (what
    XLA's CPU backend computes for a chunk of at most 16): output ``i`` is
    ``((x_0 + x_1) + ...) + x_i``, its gradient ``((g_i + g_{i+1}) + ...)
    + g_{q-1}``. ``torch.cumsum`` accumulates float32 in float64 on the
    CPU and in a parallel order on the card; the decays' sums reach -60 in
    a chunk, so their rounding moves ``exp(±lcum)`` by about 60 ulp, and
    the group norm's rows that are nearly constant carry that into the
    gradients. Each addition is one launch over every chunk of a layer
    (dim 0 runs over batch rows and chunks)."""

    @staticmethod
    def forward(ctx, x):
        sums = [x[:, :1]]
        for i in range(1, x.shape[1]):
            sums.append(sums[-1] + x[:, i:i + 1])
        return torch.cat(sums, dim=1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q = g.shape[1]
        tail = F.pad(g, (0,) * (2 * (g.ndim - 2)) + (0, q - 1))
        acc = g
        for d in range(1, q):       # zeros past the end add exactly
            acc = acc + tail[:, d:d + q]
        return acc


def _chunk(s0, ub, rb, kb, vb, lwb, lcum):
    """One chunk of the reference's ``chunk_body`` (``lcum`` the decays'
    inclusive sum within it, ``ub`` the bonus as :func:`_u` broadcasts
    it): the state after it and the chunk's outputs (B, q, H, V)."""
    q = rb.shape[1]
    p_prev = torch.exp(lcum - lwb)                    # P_{t-1} = P_t / w_t
    rt = rb * p_prev
    # inter-chunk: r_t ⊙ P_{t-1} @ S0
    o_inter = torch.einsum("bqhk,bhkv->bqhv", rt, s0)
    # intra-chunk: A[t,j] = (r_t ⊙ P_{t-1}/P_j)·k_j, j <= t-1
    kt = kb * torch.exp(-lcum)
    a = torch.einsum("bqhk,bjhk->bhqj", rt, kt)
    idx = torch.arange(q, device=rb.device)
    mask = idx[:, None] > idx[None, :]
    a = a * mask
    diag = torch.einsum("bqhk,bqhk->bqh", rb, ub * kb)
    o_intra = torch.einsum("bhqj,bjhv->bqhv", a, vb) + diag[..., None] * vb
    # state handoff
    decay_rest = torch.exp(lcum[:, -1:] - lcum)       # Π_{m>j} w_m
    s_new = s0 * torch.exp(lcum[:, -1])[..., None] \
        + torch.einsum("bqhk,bqhv->bhkv", kb * decay_rest, vb)
    return s_new, o_inter + o_intra


def rwkv_time_mix(pt, x: torch.Tensor, *, head_size: int, state=None,
                  last_x=None):
    """x (B,S,D), S % CHUNK == 0 (or S < CHUNK). Returns (out, state
    (B,H,K,V) float32, last_x (B,1,D)). In TP form (``pt`` marked ``"tp"``,
    ``launch/tp.py``) the rank's heads: r, k, v, g and w column-parallel,
    the state ``(n·B, heads, K, V)``, out row-parallel."""
    b, s, d = x.shape
    xx = _shift(x, last_x)
    r, k, v, g, lw = _projections(pt, x, xx, head_size)
    bh, h = r.shape[0], r.shape[2]
    q = min(CHUNK, s)
    # each chunk's inclusive decay sums, every chunk at once
    lcum = _CumSum.apply(lw.reshape(bh * (s // q), q, h, head_size))
    lcum = lcum.reshape(lw.shape)
    if state is None:
        state = torch.zeros((bh, h, head_size, head_size), dtype=lw.dtype,
                            device=x.device)
    ub = _u(pt, b)
    outs = []
    for c in range(s // q):
        sl = slice(c * q, (c + 1) * q)
        state, o = _chunk(state, ub, r[:, sl], k[:, sl], v[:, sl],
                          lw[:, sl], lcum[:, sl])
        outs.append(o)
    o = torch.cat(outs, dim=1)
    return _finish(pt, o, g, x, head_size), state, x[:, -1:]


def rwkv_time_mix_step(pt, x1: torch.Tensor, state: torch.Tensor,
                       last_x: torch.Tensor, *, head_size: int):
    """Single-token decode. x1 (B,1,D) -> (out, new state, x1). The state
    is not written: the caller stores the returned one. In TP form the
    state is the rank's heads ``(n·B, heads, K, V)``."""
    xx = _shift(x1, last_x)
    r, k, v, g, lw = _projections(pt, x1, xx, head_size)
    r1, k1, v1, lw1 = r[:, 0], k[:, 0], v[:, 0], lw[:, 0]   # (B,H,K)
    u = _u(pt, x1.shape[0])[:, 0]
    o = torch.einsum("bhk,bhkv->bhv", r1,
                     state + (u * k1)[..., None] * v1[:, :, None, :])
    state = state * torch.exp(lw1)[..., None] \
        + k1[..., None] * v1[:, :, None, :]
    return _finish(pt, o, g, x1, head_size), state, x1


def rwkv_channel_mix(pc, x: torch.Tensor, *, last_x=None):
    """``v(relu(k(mix(x)))²)``; in TP form (``pc`` marked ``"tp"``) k
    column-parallel and v row-parallel on the rank's part of ``d_ff``."""
    xx = _shift(x, last_x)
    if "tp" in pc:
        tp = pc["tp"]
        k = linear_col(pc["k"], tp.copy_in(_mix(x, xx, pc["mix"][0])))
        return linear_row(pc["v"], torch.square(F.relu(k)), tp), x[:, -1:]
    k = linear(pc["k"], _mix(x, xx, pc["mix"][0]))
    kv = linear(pc["v"], torch.square(F.relu(k)))
    return kv, x[:, -1:]


def rwkv_channel_mix_step(pc, x1: torch.Tensor, last_x: torch.Tensor):
    return rwkv_channel_mix(pc, x1, last_x=last_x)
