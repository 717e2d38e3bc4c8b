"""Plain reference of PointNet++ SSG classification on the INT8 crossbar.

What the benchmark holds the program's logits to. It is written from the
model's description (Qi et al., arXiv:1706.02413; the Pointer paper's
Table 1 and its bit-sliced crossbar), in plain torch, and imports nothing
of the program: it takes the float weights and the clouds that the
benchmark made, and works everything else out again.

Per cloud, in index order (the program's execution order is a permutation
of the centers that it scatters back, so the logits do not depend on it):

1. layer-0 features: ``[xyz, 1, sin 3p, cos 3p, sin 7p, cos 7p]``, cut to
   the first SA layer's input width;
2. per SA layer: farthest point sampling from row 0 (the first maximum;
   squared distances summed x, y, z left to right), the k nearest points
   of each center by a stable sort (ties to the lower index), the
   neighbour-minus-center feature differences;
3. the MLP on the crossbar: the input quantized with one scale per cloud,
   ``s = max(max|x| / qmax, 1e-12)``, ``q = clip(round(x / s), +-qmax)``
   (half to even); each layer the exact integer product with the weights
   quantized per tensor the same way, dequantized as
   ``float(y) * (s * s_w) + b``, ReLU, the next layer's scale from the max
   over the cloud's rows; the max over the K neighbours;
4. a global max over the last layer's points and the head MLP, its last
   layer without ReLU.

``bits`` is the crossbar's precision: 8 as the configuration states; the
benchmark's control runs the same function at 4.
"""
from __future__ import annotations

import torch

#: clouds per block of the MLPs: bounds the reference's memory
BLOCK = 16


def lift(points: torch.Tensor, width: int) -> torch.Tensor:
    ones = torch.ones_like(points[..., :1])
    f = torch.cat([points, ones, torch.sin(3.0 * points),
                   torch.cos(3.0 * points), torch.sin(7.0 * points),
                   torch.cos(7.0 * points)], dim=-1)
    return f[..., :width]


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances of ``a (B, Q, 3)`` to ``b (B, N, 3)``, summed
    x, y, z left to right: ``(B, Q, N)``."""
    dx = a[:, :, None, 0] - b[:, None, :, 0]
    dy = a[:, :, None, 1] - b[:, None, :, 1]
    dz = a[:, :, None, 2] - b[:, None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def fps(points: torch.Tensor, n: int) -> torch.Tensor:
    """Farthest point sampling from row 0: ``(B, N, 3)`` -> ``(B, n)``."""
    batch, n_pts, _ = points.shape
    rows = torch.arange(batch, device=points.device)
    dist = torch.full((batch, n_pts), float("inf"), device=points.device)
    cur = torch.zeros(batch, dtype=torch.long, device=points.device)
    out = []
    for _ in range(n):
        out.append(cur)
        d = sq_dist(points[rows, cur][:, None, :], points)[:, 0]
        dist = torch.minimum(dist, d)
        cur = torch.argmax(dist, dim=1)
    return torch.stack(out, dim=1)


def knn(queries: torch.Tensor, points: torch.Tensor, k: int):
    d = sq_dist(queries, points)
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``x (B, N, C)`` at ``idx (B, ...)``."""
    b = torch.arange(x.shape[0], device=x.device)
    return x[b.view(-1, *([1] * (idx.ndim - 1))), idx]


def geometry(config: dict, clouds: torch.Tensor):
    """Per SA layer the centers' and the neighbours' indices into the
    layer before."""
    out, pts = [], clouds
    for spec in config["layers"]:
        ctr = fps(pts, spec["n_centers"])
        c_pts = take(pts, ctr)
        out.append((ctr, knn(c_pts, pts, spec["n_neighbors"])))
        pts = c_pts
    return out


def _scale(mx: torch.Tensor, qmax: float) -> torch.Tensor:
    return torch.clamp_min(mx / torch.full_like(mx, qmax), 1e-12)


def _quant(x: torch.Tensor, s: torch.Tensor, qmax: float) -> torch.Tensor:
    return torch.clamp(torch.round(x / s), -qmax, qmax)


def quantize_weights(mlp, bits: int):
    """Per layer the integer weights (float64, exact) and their scale."""
    qmax = float(2 ** (bits - 1) - 1)
    out = []
    for w, b in mlp:
        s = _scale(w.abs().amax(), qmax)
        out.append((_quant(w, s, qmax).to(torch.float64), s, b))
    return out


def crossbar_mlp(x: torch.Tensor, layers, bits: int,
                 final_relu: bool = True) -> torch.Tensor:
    """``x (B, R, d0)`` float32, one input scale per cloud -> ``(B, R, dL)``
    float32."""
    qmax = float(2 ** (bits - 1) - 1)
    s = _scale(x.abs().amax(dim=(1, 2)), qmax)[:, None, None]
    for i, (w_int, s_w, b) in enumerate(layers):
        y_int = torch.matmul(_quant(x, s, qmax).to(torch.float64), w_int)
        y = y_int.to(torch.float32) * (s * s_w) + b
        if final_relu or i < len(layers) - 1:
            y = torch.clamp_min(y, 0.0)
        x = y
        if i < len(layers) - 1:
            s = _scale(x.abs().amax(dim=(1, 2)), qmax)[:, None, None]
    return x


def logits(config: dict, weights: dict, clouds: torch.Tensor, *,
           bits: int = 8) -> torch.Tensor:
    """Logits ``(B, n_classes)`` of ``clouds (B, N, 3)`` under float
    ``weights`` ``{"sa": [[(w, b), ...], ...], "head": [(w, b), ...]}``."""
    sa = [quantize_weights(m, bits) for m in weights["sa"]]
    head = quantize_weights(weights["head"], bits)
    geom = geometry(config, clouds)
    rows = []
    for lo in range(0, clouds.shape[0], BLOCK):
        feats = lift(clouds[lo:lo + BLOCK], config["layers"][0]["mlp"][0])
        for (ctr, nbr), layers in zip(geom, sa):
            ctr, nbr = ctr[lo:lo + BLOCK], nbr[lo:lo + BLOCK]
            diff = take(feats, nbr) - take(feats, ctr)[:, :, None, :]
            m, k, c = diff.shape[1:]
            h = crossbar_mlp(diff.reshape(diff.shape[0], m * k, c), layers,
                             bits)
            feats = h.reshape(h.shape[0], m, k, -1).amax(dim=2)
        g = feats.amax(dim=1)[:, None, :]
        rows.append(crossbar_mlp(g, head, bits, final_relu=False)[:, 0])
    return torch.cat(rows)
