"""Shared transformer building blocks of the LM stack, in PyTorch: the
port's counterpart of the JAX package's ``models/layers.py``.

Conventions, as the reference's:
  * params are plain dicts of tensors, stacked along a leading layer axis;
  * activations (B, S, D); attention heads (B, S, H, Dh);
  * computation dtype follows the input; params stored in ``cfg.dtype``;
  * both norms compute in float32 and cast back (:func:`upcast`: float64
    inputs stay float64, so float64 weights run the same algorithm
    without float32's rounding).

Initializers draw from an explicit ``torch.Generator`` (the port does not
reimplement ``jax.random``): the same layout, shapes, dtypes and
distributions as the reference's, other numbers.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "layer_norm", "dense_init", "linear", "mlp_init",
           "mlp_apply", "embed_init", "upcast"]


def upcast(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, where the reference computes in float32 (norms,
    decays, logits); a float64 ``t`` stays float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = upcast(x)
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (y * upcast(gamma)).to(dt)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = upcast(x)
    mu = x32.mean(dim=-1, keepdim=True)
    # jnp.var is the population variance (ddof=0); torch's default is not
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * upcast(gamma) + upcast(beta)).to(dt)


def _normal(gen: torch.Generator, shape, std: float,
            dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, *, bias: bool = False,
               scale: float | None = None) -> dict:
    s = (1.0 / d_in) ** 0.5 if scale is None else scale
    p = {"w": _normal(gen, (d_in, d_out), s, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    # the bias is added after the product's rounding, as the reference's
    # `x @ w + b` does (no fused addmm epilogue)
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype, *, kind: str = "swiglu") -> dict:
    """``kind`` is config state, not a leaf — pass it to mlp_apply."""
    if kind == "swiglu":
        return {"gate": dense_init(gen, d_model, d_ff, dtype),
                "up": dense_init(gen, d_model, d_ff, dtype),
                "down": dense_init(gen, d_ff, d_model, dtype)}
    if kind == "gelu":
        return {"up": dense_init(gen, d_model, d_ff, dtype),
                "down": dense_init(gen, d_ff, d_model, dtype)}
    raise ValueError(kind)


def mlp_apply(p: dict, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(linear(p["gate"], x)) * linear(p["up"], x)
    else:
        # jax.nn.gelu defaults to approximate=True: the tanh form
        h = F.gelu(linear(p["up"], x), approximate="tanh")
    return linear(p["down"], h)


def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype: torch.dtype) -> dict:
    return {"w": _normal(gen, (vocab, d_model), 0.02, dtype)}
