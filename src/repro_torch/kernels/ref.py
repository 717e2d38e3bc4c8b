"""Plain torch helpers shared by the kernels' plain versions."""
from __future__ import annotations

import torch

__all__ = ["combine_planes"]


def combine_planes(planes: torch.Tensor, cell_bits: int = 2,
                   weight_bits: int = 8) -> torch.Tensor:
    """Recombine offset-binary cell planes ``(P, K, N)`` into signed int32
    weights ``(K, N)``."""
    u = torch.zeros(planes.shape[1:], dtype=torch.int32,
                    device=planes.device)
    for p in range(planes.shape[0]):
        u += planes[p].to(torch.int32) << (cell_bits * p)
    return u - (1 << (weight_bits - 1))
