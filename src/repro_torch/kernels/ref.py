"""Plain torch helpers shared by the kernels' plain versions."""
from __future__ import annotations

import torch

__all__ = ["combine_planes", "ref_fps_update", "ref_reram_matmul_int"]


def combine_planes(planes: torch.Tensor, cell_bits: int = 2,
                   weight_bits: int = 8) -> torch.Tensor:
    """Recombine offset-binary cell planes ``(P, K, N)`` into signed int32
    weights ``(K, N)``."""
    u = torch.zeros(planes.shape[1:], dtype=torch.int32,
                    device=planes.device)
    for p in range(planes.shape[0]):
        u += planes[p].to(torch.int32) << (cell_bits * p)
    return u - (1 << (weight_bits - 1))


def ref_reram_matmul_int(x_int: torch.Tensor, planes: torch.Tensor,
                         cell_bits: int = 2,
                         weight_bits: int = 8) -> torch.Tensor:
    """``x_int @ combine_planes(planes)`` as int32: ``(…, K)`` integer
    activations times ``(P, K, N)`` planes -> ``(…, N)``. The product runs
    in float64, which is exact while every partial sum stays below 2^53 —
    for int8 activations and 8-bit weights, any K below 2^38."""
    w = combine_planes(planes, cell_bits, weight_bits).to(torch.float64)
    return torch.matmul(x_int.to(torch.float64), w).to(torch.int32)


def ref_fps_update(points_t: torch.Tensor, centroid: torch.Tensor,
                   dist: torch.Tensor) -> torch.Tensor:
    """One FPS relaxation step, the JAX package's oracle formula:
    ``min(dist, sum((points_t - centroid) ** 2, axis=0))`` over
    ``(3, N)``, ``(3, 1)``, ``(1, N)``."""
    d = ((points_t - centroid) ** 2).sum(dim=0, keepdim=True)
    return torch.minimum(dist, d)
