"""Inputs and weights, made from the seed on the device in a few calls.

The clouds follow the surface generator of the program's synthetic data
set (``src/repro_torch/data/pointcloud.py``, NumPy, one cloud a call):
the same eight primitives and five deformation levels, 40 classes, each
cloud centred and scaled to the unit ball; drawn here for a whole pool at
once with a ``torch.Generator`` on the device.
"""
from __future__ import annotations

import math

import torch

N_CLASSES = 40
_PRIMITIVES = 8


def _uniform(g, shape, lo, hi, dev):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)


def _sphere(g, shape, dev):
    p = torch.randn((*shape, 3), generator=g, device=dev)
    return p / torch.clamp_min(p.norm(dim=-1, keepdim=True), 1e-9)


def _primitive(prim: int, m: int, n: int, g, dev) -> torch.Tensor:
    """``m`` clouds of ``n`` points of primitive ``prim``: ``(m, n, 3)``."""
    u = _uniform(g, (m, n), 0.0, 2 * math.pi, dev)
    v = _uniform(g, (m, n), -1.0, 1.0, dev)
    if prim == 0:                                        # sphere
        return _sphere(g, (m, n), dev)
    if prim == 1:                                        # ellipsoid
        return _sphere(g, (m, n), dev) * torch.tensor([1.0, 0.6, 0.35],
                                                      device=dev)
    if prim == 2:                                        # cylinder + caps
        out = torch.stack([torch.cos(u), torch.sin(u), v], dim=-1)
        ncap = n // 5
        r = torch.sqrt(_uniform(g, (m, ncap), 0.0, 1.0, dev))
        a = _uniform(g, (m, ncap), 0.0, 2 * math.pi, dev)
        z = torch.sign(_uniform(g, (m, ncap), -1.0, 1.0, dev))
        out[:, :ncap] = torch.stack([r * torch.cos(a), r * torch.sin(a), z],
                                    dim=-1)
        return out
    if prim == 3:                                        # cone
        h = _uniform(g, (m, n), 0.0, 1.0, dev)
        return torch.stack([(1 - h) * torch.cos(u), (1 - h) * torch.sin(u),
                            2 * h - 1], dim=-1)
    if prim == 4:                                        # torus
        w = _uniform(g, (m, n), 0.0, 2 * math.pi, dev)
        ring = 1 + 0.35 * torch.cos(w)
        return torch.stack([ring * torch.cos(u), ring * torch.sin(u),
                            0.35 * torch.sin(w)], dim=-1) / 1.35
    if prim == 5:                                        # box surface
        face = torch.randint(0, 6, (m, n), generator=g, device=dev)
        a = _uniform(g, (m, n), -1.0, 1.0, dev)
        b = _uniform(g, (m, n), -1.0, 1.0, dev)
        s = torch.where(face % 2 == 0, 1.0, -1.0)
        ax = face // 2
        cols = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
        out = torch.empty((m, n, 3), device=dev)
        for d in range(3):
            sel = ax == d
            out[..., d] = torch.where(sel, s, out[..., d])
            c0, c1 = cols[d]
            out[..., c0] = torch.where(sel, a, out[..., c0])
            out[..., c1] = torch.where(sel, b, out[..., c1])
        return out
    if prim == 6:                                        # helix tube
        t = _uniform(g, (m, n), -2.0, 2.0, dev)
        jitter = 0.15 * _sphere(g, (m, n), dev)
        return (torch.stack([torch.cos(3 * t), torch.sin(3 * t), t / 2],
                            dim=-1) + jitter) / 1.4
    p = _sphere(g, (m, n), dev) * 0.55                   # dumbbell
    side = torch.sign(_uniform(g, (m, n), -1.0, 1.0, dev))
    return p + torch.stack([0.55 * side, torch.zeros_like(side),
                            torch.zeros_like(side)], dim=-1)


def surface_clouds(n_clouds: int, n_points: int, seed: int,
                   device) -> tuple[torch.Tensor, torch.Tensor]:
    """``n_clouds`` clouds ``(n_clouds, n_points, 3)`` float32 and their
    class labels, from ``seed``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    labels = torch.randint(0, N_CLASSES, (n_clouds,), generator=g,
                           device=dev)
    p = torch.empty((n_clouds, n_points, 3), device=dev)
    prims = (labels % _PRIMITIVES).tolist()
    for prim in range(_PRIMITIVES):
        sel = [i for i, q in enumerate(prims) if q == prim]
        if sel:
            p[sel] = _primitive(prim, len(sel), n_points, g, dev)
    deform = (labels // _PRIMITIVES).to(torch.float32)[:, None, None]
    amp = 0.05 + 0.06 * deform
    p = p + amp * torch.sin((2 + deform) * p[..., [1, 2, 0]])
    theta = 0.15 * deform[..., 0] * p[..., 2]
    c, s = torch.cos(theta), torch.sin(theta)
    x = p[..., 0] * c - p[..., 1] * s
    y = p[..., 0] * s + p[..., 1] * c
    p = torch.stack([x, y, p[..., 2]], dim=-1)
    p = p - p.mean(dim=1, keepdim=True)
    p = p / p.norm(dim=-1).amax(dim=1)[:, None, None]
    return p.contiguous(), labels


def he_weights(config: dict, seed: int, device) -> dict:
    """He-scaled float32 weights and zero biases for every MLP of
    ``config``, in one draw on the device: ``{"sa": [[(w, b), ...], ...],
    "head": [(w, b), ...]}``."""
    dev = torch.device(device)
    mlps = [spec["mlp"] for spec in config["layers"]] + [config["head"]]
    shapes = [(k, n) for w in mlps for k, n in zip(w[:-1], w[1:])]
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) + 1)
    flat = torch.randn(sum(k * n for k, n in shapes), generator=g,
                       device=dev)
    layers, at = [], 0
    for k, n in shapes:
        w = flat[at:at + k * n].view(k, n) * math.sqrt(2.0 / k)
        layers.append((w, torch.zeros(n, device=dev)))
        at += k * n
    out, at = {"sa": []}, 0
    for w in mlps[:-1]:
        out["sa"].append(layers[at:at + len(w) - 1])
        at += len(w) - 1
    out["head"] = layers[at:]
    return out
