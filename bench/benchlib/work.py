"""Work counted from a configuration's shapes, and the card's peaks.

The yardstick of ``mfu`` and ``mlp_roofline_pct``: counted here from the
configuration file, whatever kernel the program runs.
"""
from __future__ import annotations

import subprocess

#: NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12


def mlps(config: dict) -> list[tuple[int, list[int], int, int]]:
    """Each MLP of one cloud as ``(rows, widths, inputs, outputs)``: an SA
    layer's MLP runs on every center's neighbours, reads the features of
    the points it groups (the cloud's points, or the layer before's
    centers) and leaves one pooled row a center; the head runs on one
    row."""
    out, points = [], config["n_points"]
    for spec in config["layers"]:
        out.append((spec["n_centers"] * spec["n_neighbors"], list(spec["mlp"]),
                    points, spec["n_centers"]))
        points = spec["n_centers"]
    return out + [(1, list(config["head"]), 1, 1)]


def _macs(rows: int, widths: list[int]) -> int:
    return rows * sum(k * n for k, n in zip(widths[:-1], widths[1:]))


def macs_per_cloud(config: dict) -> int:
    """Multiply-adds of one cloud's MLPs."""
    return sum(_macs(rows, w) for rows, w, _, _ in mlps(config))


def mlp_least_seconds(config: dict, batch: int) -> float:
    """The least time of one batch's MLPs on the card: per MLP the larger
    of its operations (2 a multiply-add) over the int8 peak and its bytes
    over the HBM bandwidth. The bytes are those of the function the layer
    computes, whatever kernels split it: each grouped point's int8
    features and the int8 weights read once, and the float32 pooled row
    of each center (the head: its logits) written once. Rows gathered per
    neighbour, or written before the max, belong to a design, not to the
    function."""
    total = 0.0
    for rows, w, n_in, n_out in mlps(config):
        nbytes = (batch * n_in * w[0] + _macs(1, w)
                  + 4 * batch * n_out * w[-1])
        total += max(2 * batch * _macs(rows, w) / INT8_OPS_PER_S,
                     nbytes / HBM_BYTES_PER_S)
    return total


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it (empty where it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else ""
