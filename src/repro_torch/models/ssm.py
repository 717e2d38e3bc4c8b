"""Mamba2-style selective SSM (SSD) in PyTorch, for zamba2-7b: the port's
counterpart of the JAX package's ``models/ssm.py``.

State-space recurrence per head h (P = head dim, N = state dim):

    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * x_t (x) B_t        S: (P, N)
    y_t = S_t @ C_t + D_h * x_t

Prefill runs the reference's chunk-parallel algorithm (chunks of ``CHUNK``
tokens) as a Python loop over the static chunks, carrying the float32
(B, H, P, N) state: no host read, so a CUDA graph captures it whole.
Decode is the O(1) recurrence. Decays are bounded (``dt <= DT_MAX``,
``|A| <= A_MAX``) so every float32 ``exp`` is finite, as in the reference.

The causal depthwise convolution is the reference's Python ``sum`` of
``CONV_K`` shifted products in the model's dtype, each product and each
sum rounded to that dtype as its own op (``F.conv1d`` would accumulate in
float32 and round once). The scan computes in float32 where the reference
does (``layers.upcast``: float64 weights compute in float64).

In TP form (the sharded step's, ``launch/tp.py``; ``p`` marked ``"tp"``)
a rank computes its heads: ``in_proj`` column-parallel on its heads' z, x
and dt columns and the whole B and C (one group, computed on every rank),
the conv on its channels, the scan on its heads, the gated RMSNorm's sum
of squares summed over 'model', ``out_proj`` row-parallel. Heads that do
not divide the 'model' size are padded at the end with zero heads
(``models/lm.py``'s ``pad_perm``), whose output is exactly zero.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense_init, linear, linear_col,
                                       linear_row, rms_norm, upcast)

__all__ = ["mamba_init", "mamba_forward", "mamba_decode_step", "CHUNK",
           "CONV_K"]

CHUNK = 32
DT_MAX = 0.5
A_MAX = 4.0
CONV_K = 4


def mamba_init(gen: torch.Generator, d_model: int, ssm_state: int,
               dtype: torch.dtype, *, expand: int = 2,
               head_dim: int = 64) -> dict:
    """One Mamba2 layer's weights in the reference's layout, shapes and
    dtypes (``A_log``, ``D``, ``dt_bias`` float32), drawn from ``gen``."""
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    dev = gen.device
    f32 = lambda fill: torch.full((n_heads,), fill, dtype=torch.float32,
                                  device=dev)
    conv = torch.randn((CONV_K, d_inner + 2 * ssm_state), generator=gen,
                       device=dev, dtype=torch.float32)
    return {
        # order: [z, x, B, C, dt]
        "in_proj": dense_init(gen, d_model,
                              2 * d_inner + 2 * ssm_state + n_heads, dtype),
        "conv_w": (conv * 0.2).to(dtype),
        "A_log": f32(0.0),
        "D": f32(1.0),
        "dt_bias": f32(0.0),
        "norm": torch.ones((d_inner,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, d_inner, d_model, dtype),
    }


def _split(p, x, ssm_state: int, head_dim: int):
    """``in_proj`` of ``x`` cut into (z, x, B, C, dt, d_inner, heads):
    whole (B, S, ...); in TP form (``p`` marked ``"tp"``) column-parallel,
    the rank's heads of z, x and dt and the whole B and C ``(n, B, S,
    ...)``."""
    tp = p.get("tp")
    if tp is None:
        zxbcdt = linear(p["in_proj"], x)
    else:
        zxbcdt = linear_col(p["in_proj"], tp.copy_in(x))
    n_heads = p["A_log"].shape[-1]
    d_inner = n_heads * head_dim
    z, xin, b, c, dt = torch.split(
        zxbcdt, [d_inner, d_inner, ssm_state, ssm_state, n_heads], dim=-1)
    return z, xin, b, c, dt, d_inner, n_heads


def _conv(p, u: torch.Tensor, state: torch.Tensor | None = None):
    """Causal depthwise conv, window CONV_K. u (..., S, C): (B, S, C), or
    in TP form the rank's channels (n, B, S, C) under its taps. ``state``
    (..., CONV_K-1, C) holds the trailing context for decode."""
    if state is None:
        pad = torch.zeros(u.shape[:-2] + (CONV_K - 1,) + u.shape[-1:],
                          dtype=u.dtype, device=u.device)
    else:
        pad = state.to(u.dtype)
    up = torch.cat([pad, u], dim=-2)
    s = u.shape[-2]
    w = p["conv_w"]
    taps = ([w[i] for i in range(CONV_K)] if "tp" not in p
            else [w[:, i, None, None] for i in range(CONV_K)])
    # the reference's sum(...): 0 + t0, then one rounded add per tap
    y = sum(up[..., i:i + s, :] * taps[i] for i in range(CONV_K))
    new_state = up[..., -(CONV_K - 1):, :]
    return F.silu(y), new_state


def _decays(p, dt_raw: torch.Tensor, lead: int = 0):
    """-> (dt, log_a) both (..., H) float32, bounded. In TP form
    ``dt_raw`` is (n, ...) and the rank's ``dt_bias`` and ``A_log`` (n, H)
    broadcast over its ``lead`` dims after the rank's."""
    bias, a_log = p["dt_bias"], p["A_log"]
    if "tp" in p:
        bias, a_log = (t.reshape(t.shape[0], *([1] * lead), t.shape[1])
                       for t in (bias, a_log))
    dt = DT_MAX * torch.sigmoid(upcast(dt_raw) + bias) + 1e-4
    a = -A_MAX * torch.sigmoid(a_log) - 1e-4
    return dt, dt * a


def _rank_rows(p, t: torch.Tensor, b: int) -> torch.Tensor:
    """A per-head vector ``p``-leaf ``t`` as the rows of the (n·B, H)
    flattened batch: (1, H) whole; the rank's (n, H) repeated over its
    ``b`` rows in TP form."""
    if "tp" not in p:
        return t[None]
    return t[:, None].expand(t.shape[0], b, t.shape[1]).flatten(0, 1)


def _gate_out(p, y, z, x_dtype, d_inner: int):
    """The gated RMSNorm of ``y * silu(z)`` over the whole ``d_inner`` and
    ``out_proj``. In TP form the rank's channels: their sum of squares
    summed over 'model' (``TensorParallel.reduce_all``; a padded head's are
    zero), the rank's gains, ``out_proj`` row-parallel."""
    y = y.to(x_dtype)
    if "tp" not in p:
        return linear(p["out_proj"], rms_norm(y * F.silu(z), p["norm"]))
    tp = p["tp"]
    g = upcast(y * F.silu(z))
    ss = tp.reduce_all((g * g).sum(dim=-1, keepdim=True))
    g = g * torch.rsqrt(ss / d_inner + 1e-5)
    g = (g * upcast(p["norm"])[:, None, None]).to(x_dtype)
    return linear_row(p["out_proj"], g, tp)


def _chunk(s0, xc, bc, cc, dtc, lac):
    """One chunk of the reference's ``chunk_body``: the state after it and
    the chunk's outputs (B, q, H, P)."""
    q = xc.shape[1]
    lcum = torch.cumsum(lac, dim=1)                    # (B,q,H) inclusive
    # inter: y_t^inter = exp(Lcum_t) * C_t @ S0
    y_inter = torch.einsum("bqn,bhpn->bqhp", cc, s0) \
        * torch.exp(lcum)[..., None]
    # intra: M[t,j] = exp(Lcum_t - Lcum_j) (C_t.B_j) dt_j  for j<=t
    ldiff = lcum[:, :, None, :] - lcum[:, None, :, :]  # (B,q,q,H)
    idx = torch.arange(q, device=xc.device)
    keep = (idx[:, None] >= idx[None, :])[None, :, :, None]
    m = torch.exp(ldiff) * torch.where(keep, 1.0, 0.0)
    cb = torch.einsum("bqn,bjn->bqj", cc, bc)
    mm = m * (cb[..., None] * dtc[:, None, :, :])      # (B,q,j,H)
    y_intra = torch.einsum("bqjh,bjhp->bqhp", mm, xc)
    # state handoff
    l_end = lcum[:, -1][:, None]                       # (B,1,H)
    w = torch.exp(l_end - lcum) * dtc                  # (B,q,H)
    s_new = s0 * torch.exp(lcum[:, -1])[..., None, None] \
        + torch.einsum("bqh,bqhp,bqn->bhpn", w, xc, bc)
    return s_new, y_inter + y_intra


def mamba_forward(p, x: torch.Tensor, *, ssm_state: int, expand: int = 2,
                  head_dim: int = 64, state=None, conv_state=None):
    """x (B, S, D) with S % CHUNK == 0 (pad upstream) or S < CHUNK.
    Returns (y (B,S,D), final_state (B,H,P,N) float32, conv_state). In TP
    form (``p`` marked ``"tp"``, ``launch/tp.py``) the rank's heads: the
    state ``(n·B, heads, P, N)``, the conv state its channels ``(n, B,
    CONV_K-1, C)``."""
    bsz, s, d_model = x.shape
    z, xin, b, c, dt_raw, d_inner, h = _split(p, x, ssm_state, head_dim)
    u, conv_state = _conv(p, torch.cat([xin, b, c], dim=-1), conv_state)
    xin, b, c = torch.split(u, [d_inner, ssm_state, ssm_state], dim=-1)
    q = min(CHUNK, s)
    xh = upcast(xin.reshape(-1, s, h, head_dim))
    bh = upcast(b.reshape(-1, s, ssm_state))
    ch = upcast(c.reshape(-1, s, ssm_state))
    dt, log_a = _decays(p, dt_raw, 2)                  # (B,S,H)
    dt, log_a = dt.reshape(-1, s, h), log_a.reshape(-1, s, h)
    if state is None:
        state = torch.zeros((xh.shape[0], h, head_dim, ssm_state),
                            dtype=xh.dtype, device=x.device)
    ys = []
    for i in range(s // q):
        sl = slice(i * q, (i + 1) * q)
        state, y = _chunk(state, xh[:, sl], bh[:, sl], ch[:, sl], dt[:, sl],
                          log_a[:, sl])
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + _rank_rows(p, p["D"], bsz)[:, None, :, None] * xh
    y = y.reshape(z.shape)
    return (_gate_out(p, y, z, x.dtype, expand * d_model), state,
            conv_state)


def mamba_decode_step(p, x1: torch.Tensor, state: torch.Tensor,
                      conv_state: torch.Tensor, *, ssm_state: int,
                      expand: int = 2, head_dim: int = 64):
    """Single-token recurrent step. x1 (B, 1, D) -> (y, new state, new conv
    state). Nothing is written: the caller stores the returned states. In
    TP form the states are the rank's, as :func:`mamba_forward` gives
    them."""
    bsz, _, d_model = x1.shape
    z, xin, b, c, dt_raw, d_inner, h = _split(p, x1, ssm_state, head_dim)
    u, conv_state = _conv(p, torch.cat([xin, b, c], dim=-1), conv_state)
    xin, b, c = torch.split(u, [d_inner, ssm_state, ssm_state], dim=-1)
    xh = upcast(xin[..., 0, :].reshape(-1, h, head_dim))
    bv = upcast(b[..., 0, :].reshape(-1, ssm_state))   # (B,N)
    cv = upcast(c[..., 0, :].reshape(-1, ssm_state))
    dt, log_a = _decays(p, dt_raw[..., 0, :], 1)       # (B,H)
    dt, log_a = dt.reshape(-1, h), log_a.reshape(-1, h)
    state = state * torch.exp(log_a)[..., None, None] \
        + torch.einsum("bh,bhp,bn->bhpn", dt, xh, bv)
    y = torch.einsum("bhpn,bn->bhp", state, cv) \
        + _rank_rows(p, p["D"], bsz)[:, :, None] * xh
    y = y.reshape(z.shape)
    return (_gate_out(p, y, z, x1.dtype, expand * d_model), state,
            conv_state)
