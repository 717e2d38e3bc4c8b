"""Attention of the LM stack, in PyTorch: RoPE, chunked (flash-style)
attention for prefill, and cache-based decode attention — the port's
counterpart of the JAX package's ``models/attention.py``, forward only.

Chunked attention follows the reference's algorithm step for step: the
same chunking and padding (padded queries at position 0, padded keys at
``int32`` max), an online softmax over KV chunks nested in a loop over Q
chunks with the same ``m_safe``/``corr``/``l`` updates, probabilities cast
to ``v``'s dtype before the PV product, and the same ``1e-30`` floor and
``lse``. GQA maps query head ``i`` to kv head ``i // groups``; KV is
repeated per chunk, never the whole tensor.

Where the reference asks for float32 products of low-precision operands
(``preferred_element_type=jnp.float32``), the operands are upcast: bf16
values are exact in float32, so the product sums exact terms in float32.
The custom VJP of the reference's ``_flash`` belongs to the LM training
slice; until then these functions run under ``torch.inference_mode()``
on the serving path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["apply_rope", "chunked_attention", "decode_attention",
           "rope_tables", "rotate"]

_INT32_MAX = 2 ** 31 - 1
_NEG_INF = float("-inf")


def rope_tables(positions: torch.Tensor, d: int, theta: float,
                dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE's cos and sin for ``positions`` (S,) or (B, S) at head width
    ``d``: (B, S, 1, d/2) each, computed in float32 and cast to ``dtype``.
    One pair serves every layer of a call (the reference recomputes them
    per layer; the values are the same)."""
    half = d // 2
    dev = positions.device
    idx = torch.arange(0, half, dtype=torch.float32, device=dev)
    # divide by a tensor: CUDA divides by a Python scalar as a multiply
    # by its reciprocal
    freqs = torch.pow(theta, -idx / torch.full(
        (), float(half), dtype=torch.float32, device=dev))
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs              # (B, S, half)
    return (torch.cos(ang)[:, :, None, :].to(dtype),
            torch.sin(ang)[:, :, None, :].to(dtype))


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) rotated by :func:`rope_tables`' cos and sin."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x (B, S, H, D); positions (S,) or (B, S). cos/sin are computed in
    float32 and cast to ``x.dtype`` before the multiply."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta, x.dtype))


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv * groups, D): query head i reads kv
    head i // groups."""
    if groups == 1:
        return k
    return k.repeat_interleave(groups, dim=2)


def _heads_f32(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> contiguous float32 (B, H, S, D)."""
    return x.transpose(1, 2).to(torch.float32,
                                memory_format=torch.contiguous_format)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor, kv_positions: torch.Tensor,
                      causal: bool = True, q_chunk: int = 512,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """q (B,Sq,H,D); k,v (B,Skv,Hkv,D); positions (Sq,)/(Skv,) int32.
    Returns (B, Sq, H, D) in ``q``'s dtype (float32 softmax state)."""
    sq, skv = q.shape[1], k.shape[1]
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, skv)
    pad_q = (-sq) % qc
    pad_k = (-skv) % kc
    q_positions = q_positions.to(torch.int32)
    kv_positions = kv_positions.to(torch.int32)
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_positions = F.pad(q_positions, (0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        kv_positions = F.pad(kv_positions, (0, pad_k), value=_INT32_MAX)
    kv_valid = torch.arange(skv + pad_k, device=k.device) < skv
    out, _ = _flash_fwd(q, k, v, q_positions, kv_positions, kv_valid,
                        causal, qc, kc)
    return out[:, :sq]


def _mask_for(qp_blk, kp_blk, kv_blk, causal: bool, qc: int, kc: int):
    if causal:
        return qp_blk[:, None] >= kp_blk[None, :]
    return kv_blk[None, :].expand(qc, kc)


def _flash_fwd(q, k, v, qp, kp, kvld, causal: bool, qc: int, kc: int):
    """The reference's ``_flash_fwd_scan`` over padded operands: the output
    (B, Sq, H, D) and the log-sum-exp (B, H, Sq)."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    groups = h // hkv
    nq, nk = sq // qc, skv // kc
    scale = d ** -0.5
    qh = _heads_f32(q)                                     # (B, H, Sq, D)
    outs, lses = [], []
    for i in range(nq):
        q_blk = qh[:, :, i * qc:(i + 1) * qc]
        qp_blk = qp[i * qc:(i + 1) * qc]
        m = torch.full((b, h, qc), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, qc, d), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            sl = slice(j * kc, (j + 1) * kc)
            k_rep = _heads_f32(_repeat_kv(k[:, sl], groups))
            v_rep = _repeat_kv(v[:, sl], groups).transpose(1, 2)
            s = (q_blk @ k_rep.transpose(-1, -2)) * scale  # (B, H, qc, kc)
            mask = _mask_for(qp_blk, kp[sl], kvld[sl], causal, qc, kc)
            s = torch.where(mask, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.where(torch.isneginf(s), 0.0,
                            torch.exp(s - m_safe[..., None]))
            corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
            l = l * corr + p.sum(dim=-1)
            pv = p.to(v.dtype).float() @ v_rep.float()
            acc = acc * corr[..., None] + pv
            m = m_new
        denom = torch.clamp_min(l, 1e-30)
        outs.append((acc / denom[..., None]).to(q.dtype))
        lses.append(torch.where(l > 0, m + torch.log(denom), _NEG_INF))
    out = torch.cat(outs, dim=2).transpose(1, 2)           # (B, Sq, H, D)
    return out, torch.cat(lses, dim=2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos) -> torch.Tensor:
    """q (B,1,H,D); caches (B,S,Hkv,D); ``pos`` a scalar (an int or a 0-d
    int32 tensor, on the device inside a captured step): the index of the
    current token, which attends to cache positions <= pos."""
    b, _, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    groups = h // hkv
    scale = d ** -0.5
    qh = q[:, 0].reshape(b, hkv, groups, d).float()
    kt = k_cache.permute(0, 2, 3, 1).to(
        torch.float32, memory_format=torch.contiguous_format)  # (B,Hkv,D,S)
    logits = (qh @ kt) * scale                             # (B,Hkv,g,S)
    mask = torch.arange(s, device=q.device) <= pos
    logits = torch.where(mask, logits, _NEG_INF)
    w = torch.softmax(logits, dim=-1)
    vt = v_cache.transpose(1, 2).to(
        torch.float32, memory_format=torch.contiguous_format)  # (B,Hkv,S,D)
    out = w.to(v_cache.dtype).float() @ vt                 # (B,Hkv,g,D)
    return out.reshape(b, 1, h, d).to(q.dtype)
