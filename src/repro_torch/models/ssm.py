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
float32 and round once).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, linear, rms_norm

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


def _split(p, x, d_model: int, ssm_state: int, expand: int, head_dim: int):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    zxbcdt = linear(p["in_proj"], x)
    z, xin, b, c, dt = torch.split(
        zxbcdt, [d_inner, d_inner, ssm_state, ssm_state, n_heads], dim=-1)
    return z, xin, b, c, dt, d_inner, n_heads


def _conv(p, u: torch.Tensor, state: torch.Tensor | None = None):
    """Causal depthwise conv, window CONV_K. u (B,S,C). ``state`` (B,
    CONV_K-1, C) holds the trailing context for decode."""
    if state is None:
        pad = torch.zeros(u.shape[:1] + (CONV_K - 1,) + u.shape[2:],
                          dtype=u.dtype, device=u.device)
    else:
        pad = state.to(u.dtype)
    up = torch.cat([pad, u], dim=1)
    s = u.shape[1]
    # the reference's sum(...): 0 + t0, then one rounded add per tap
    y = sum(up[:, i:i + s] * p["conv_w"][i] for i in range(CONV_K))
    new_state = up[:, -(CONV_K - 1):]
    return F.silu(y), new_state


def _decays(p, dt_raw: torch.Tensor):
    """-> (dt, log_a) both (..., H) float32, bounded."""
    dt = DT_MAX * torch.sigmoid(dt_raw.float() + p["dt_bias"]) + 1e-4
    a = -A_MAX * torch.sigmoid(p["A_log"]) - 1e-4
    return dt, dt * a


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
    Returns (y (B,S,D), final_state (B,H,P,N) float32, conv_state)."""
    bsz, s, d_model = x.shape
    z, xin, b, c, dt_raw, d_inner, h = _split(p, x, d_model, ssm_state,
                                              expand, head_dim)
    u, conv_state = _conv(p, torch.cat([xin, b, c], dim=-1), conv_state)
    xin, b, c = torch.split(u, [d_inner, ssm_state, ssm_state], dim=-1)
    q = min(CHUNK, s)
    xh = xin.reshape(bsz, s, h, head_dim).float()
    bh = b.float()
    ch = c.float()
    dt, log_a = _decays(p, dt_raw)                     # (B,S,H)
    if state is None:
        state = torch.zeros((bsz, h, head_dim, ssm_state),
                            dtype=torch.float32, device=x.device)
    ys = []
    for i in range(s // q):
        sl = slice(i * q, (i + 1) * q)
        state, y = _chunk(state, xh[:, sl], bh[:, sl], ch[:, sl], dt[:, sl],
                          log_a[:, sl])
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    return linear(p["out_proj"], y), state, conv_state


def mamba_decode_step(p, x1: torch.Tensor, state: torch.Tensor,
                      conv_state: torch.Tensor, *, ssm_state: int,
                      expand: int = 2, head_dim: int = 64):
    """Single-token recurrent step. x1 (B, 1, D) -> (y, new state, new conv
    state). Nothing is written: the caller stores the returned states."""
    bsz, _, d_model = x1.shape
    z, xin, b, c, dt_raw, d_inner, h = _split(p, x1, d_model, ssm_state,
                                              expand, head_dim)
    u, conv_state = _conv(p, torch.cat([xin, b, c], dim=-1), conv_state)
    xin, b, c = torch.split(u, [d_inner, ssm_state, ssm_state], dim=-1)
    xh = xin[:, 0].reshape(bsz, h, head_dim).float()
    bv = b[:, 0].float()                               # (B,N)
    cv = c[:, 0].float()
    dt, log_a = _decays(p, dt_raw[:, 0])               # (B,H)
    state = state * torch.exp(log_a)[..., None, None] \
        + torch.einsum("bh,bhp,bn->bhpn", dt, xh, bv)
    y = torch.einsum("bhpn,bn->bhp", state, cv) + p["D"][None, :, None] * xh
    y = y.reshape(bsz, 1, d_inner).to(x1.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    return linear(p["out_proj"], y), state, conv_state
