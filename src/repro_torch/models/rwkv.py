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
variance, the output cast to the model's dtype before the gate.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, linear

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
    return -(W_MIN + W_SPAN * torch.sigmoid(wr.float()))


def _group_norm(o: torch.Tensor, gamma: torch.Tensor, head_size: int,
                eps: float = 1e-5) -> torch.Tensor:
    b, s, d = o.shape
    oh = o.reshape(b, s, d // head_size, head_size).float()
    mu = oh.mean(dim=-1, keepdim=True)
    # jnp.var is the population variance
    var = oh.var(dim=-1, keepdim=True, correction=0)
    oh = (oh - mu) * torch.rsqrt(var + eps)
    return oh.reshape(b, s, d) * gamma.float()


def _projections(pt, x, xx, head_size: int):
    b, s, d = x.shape
    h = d // head_size
    r = linear(pt["r"], _mix(x, xx, pt["mix"][0]))
    k = linear(pt["k"], _mix(x, xx, pt["mix"][1]))
    v = linear(pt["v"], _mix(x, xx, pt["mix"][2]))
    g = linear(pt["g"], _mix(x, xx, pt["mix"][3]))
    wr = linear(pt["w"], _mix(x, xx, pt["mix"][4]))
    shape = (b, s, h, head_size)
    return (r.reshape(shape).float(), k.reshape(shape).float(),
            v.reshape(shape).float(), g, _log_w(wr.reshape(shape)))


def _finish(pt, o, g, x, head_size: int):
    b, s, d = x.shape
    o = _group_norm(o.reshape(b, s, d), pt["ln_g"], head_size).to(x.dtype)
    return linear(pt["out"], o * F.silu(g))


def _chunk(s0, u, rb, kb, vb, lwb):
    """One chunk of the reference's ``chunk_body``: the state after it and
    the chunk's outputs (B, q, H, V)."""
    q = rb.shape[1]
    lcum = torch.cumsum(lwb, dim=1)                   # inclusive
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
    diag = torch.einsum("bqhk,bqhk->bqh", rb, u[None, None] * kb)
    o_intra = torch.einsum("bhqj,bjhv->bqhv", a, vb) + diag[..., None] * vb
    # state handoff
    decay_rest = torch.exp(lcum[:, -1:] - lcum)       # Π_{m>j} w_m
    s_new = s0 * torch.exp(lcum[:, -1])[..., None] \
        + torch.einsum("bqhk,bqhv->bhkv", kb * decay_rest, vb)
    return s_new, o_inter + o_intra


def rwkv_time_mix(pt, x: torch.Tensor, *, head_size: int, state=None,
                  last_x=None):
    """x (B,S,D), S % CHUNK == 0 (or S < CHUNK). Returns (out, state
    (B,H,K,V) float32, last_x (B,1,D))."""
    b, s, d = x.shape
    h = d // head_size
    xx = _shift(x, last_x)
    r, k, v, g, lw = _projections(pt, x, xx, head_size)
    q = min(CHUNK, s)
    if state is None:
        state = torch.zeros((b, h, head_size, head_size),
                            dtype=torch.float32, device=x.device)
    outs = []
    for c in range(s // q):
        sl = slice(c * q, (c + 1) * q)
        state, o = _chunk(state, pt["u"], r[:, sl], k[:, sl], v[:, sl],
                          lw[:, sl])
        outs.append(o)
    o = torch.cat(outs, dim=1)
    return _finish(pt, o, g, x, head_size), state, x[:, -1:]


def rwkv_time_mix_step(pt, x1: torch.Tensor, state: torch.Tensor,
                       last_x: torch.Tensor, *, head_size: int):
    """Single-token decode. x1 (B,1,D) -> (out, new state, x1). The state
    is not written: the caller stores the returned one."""
    xx = _shift(x1, last_x)
    r, k, v, g, lw = _projections(pt, x1, xx, head_size)
    r1, k1, v1, lw1 = r[:, 0], k[:, 0], v[:, 0], lw[:, 0]   # (B,H,K)
    u = pt["u"][None]
    o = torch.einsum("bhk,bhkv->bhv", r1,
                     state + (u * k1)[..., None] * v1[:, :, None, :])
    state = state * torch.exp(lw1)[..., None] \
        + k1[..., None] * v1[:, :, None, :]
    return _finish(pt, o, g, x1, head_size), state, x1


def rwkv_channel_mix(pc, x: torch.Tensor, *, last_x=None):
    xx = _shift(x, last_x)
    k = linear(pc["k"], _mix(x, xx, pc["mix"][0]))
    kv = linear(pc["v"], torch.square(F.relu(k)))
    return kv, x[:, -1:]


def rwkv_channel_mix_step(pc, x1: torch.Tensor, last_x: torch.Tensor):
    return rwkv_channel_mix(pc, x1, last_x=last_x)
