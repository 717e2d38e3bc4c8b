"""PointNet++ in torch — the geometry, parameters and float MLP of the port.

The counterpart of the JAX package's ``repro.models.pointnet2``: farthest
point sampling and kNN (the "point mapping" stage), the layer-0 feature
lift, the per-layer geometry pass that planned execution builds its plans
from, parameter init, and crossbar programming of every MLP; and the
module-level delegates ``sa_layer``, ``forward``, ``batched_forward``,
``loss_fn`` and ``eval_step``, thin wrappers over
:func:`repro_torch.models.backend.compile_model` (the card by default).

Every geometry function takes one cloud ``(N, 3)`` or a batch
``(B, N, 3)``; a batch gives, row for row, what the single-cloud call
gives. Indices equal the JAX package's bit for bit on the same float32
coordinates: FPS (K7, ``kernels/fps_update.py``: one launch per call on
the card) takes the first maximum and sums the three squared coordinate
differences left to right, as XLA reduces them; kNN sorts distances with
a stable ascending sort, so ties go to the lower index as ``lax.top_k``
breaks them (``torch.topk`` documents no tie order).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.workload import PointNetConfig, SALayerSpec
from repro_torch.kernels import build_program, fps_batched, gather_rows
from repro_torch.kernels.fps_update import sq_dist, valid_rows

Params = Any


# ---------------------------------------------------------------------------
# geometry: the "point mapping" stage
# ---------------------------------------------------------------------------

def farthest_point_sample(points: torch.Tensor, n_samples: int,
                          start: int = 0, *, n_valid=None) -> torch.Tensor:
    """FPS over ``points`` ``(…, N, 3)`` -> int64 ``(…, n_samples)``,
    through :func:`~repro_torch.kernels.fps_batched`: on the card one
    kernel launch for the whole batch.

    ``n_valid`` masks trailing pad rows: they start at ``-inf`` distance,
    so the running argmax never selects them and the result equals FPS on
    ``points[:n_valid]``."""
    single = points.ndim == 2
    idx = fps_batched(points[None] if single else points, n_samples, start,
                      n_valid)
    return idx[0] if single else idx


def knn(queries: torch.Tensor, points: torch.Tensor, k: int, *,
        n_valid=None) -> torch.Tensor:
    """int64 ``(…, Q, k)`` indices of the k nearest ``points`` per query
    (self included when the query is a member of ``points``). ``n_valid``
    forces pad-row distances to ``+inf``."""
    d = sq_dist(queries[..., :, None, :], points[..., None, :, :])
    if n_valid is not None:
        valid = valid_rows(points.shape[-2], n_valid, points.device)
        if points.ndim == 2:
            valid = valid[0]
        d = torch.where(valid[..., None, :], d, float("inf"))
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _init_mlp(rng: np.random.Generator, widths: tuple[int, ...]):
    params = []
    for n, m in zip(widths[:-1], widths[1:]):
        w = rng.standard_normal((n, m)) * np.sqrt(2.0 / n)
        params.append({"w": torch.from_numpy(w.astype(np.float32)),
                       "b": torch.zeros((m,), dtype=torch.float32)})
    return params


def init_params(config: PointNetConfig, seed: int = 0,
                n_classes: int = 40) -> Params:
    """Random He-scaled weights and zero biases from
    ``np.random.default_rng(seed)``, as CPU float32 tensors in the layout
    ``{"sa": [[{"w", "b"}, …], …], "head": […]}``."""
    rng = np.random.default_rng(seed)
    sa = [_init_mlp(rng, spec.mlp) for spec in config.layers]
    d_last = config.layers[-1].out_features
    head = _init_mlp(rng, (d_last, 256, n_classes))
    return {"sa": sa, "head": head}


def build_model_program(params: Params, *, ecc=None) -> dict:
    """Program every MLP of the model into crossbars: one
    :class:`~repro_torch.kernels.CrossbarProgram` per SA layer plus one for
    the head, quantized and plane-encoded here, exactly once. ``ecc`` (an
    :class:`~repro_torch.reliability.EccConfig`, or True) protects every
    program with Hamming parity in its spare columns."""
    return {"sa": [build_program(mlp, ecc=ecc) for mlp in params["sa"]],
            "head": build_program(params["head"], ecc=ecc)}


# ---------------------------------------------------------------------------
# feature processing
# ---------------------------------------------------------------------------

def _apply_mlp(mlp_params, x, *, final_relu=True, matmul=torch.matmul):
    for i, lyr in enumerate(mlp_params):
        x = matmul(x, lyr["w"]) + lyr["b"]
        if final_relu or i < len(mlp_params) - 1:
            x = torch.relu(x)
    return x


def lift_features(points: torch.Tensor, n_features: int) -> torch.Tensor:
    """Deterministic layer-0 features of width ``n_features`` from raw
    coordinates (xyz, bias, and sin/cos liftings)."""
    ones = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                      device=points.device)
    feats = [points, ones,
             torch.sin(3.0 * points), torch.cos(3.0 * points),
             torch.sin(7.0 * points), torch.cos(7.0 * points)]
    return torch.cat(feats, dim=-1)[..., :n_features].contiguous()


def geometry_pass(config: PointNetConfig, cloud: torch.Tensor, *,
                  n_valid=None):
    """The FPS/kNN geometry of every SA layer: per layer k = 1..L the
    FPS-selected coordinates ``pts[k]`` ``(…, n_k, 3)``, center indices
    ``ctr[k]`` ``(…, n_k)`` into layer k-1, and receptive fields
    ``nbr[k]`` ``(…, n_k, K)`` into layer k-1 (index 0 holds the input
    cloud / None / None). ``n_valid`` masks the first layer's pad rows."""
    pts_list, ctr_list, nbr_list = [cloud], [None], [None]
    pts = cloud
    for li, spec in enumerate(config.layers):
        nv = n_valid if li == 0 else None
        centers = farthest_point_sample(pts, spec.n_centers, n_valid=nv)
        c_pts = gather_rows(pts, centers)
        nbr = knn(c_pts, pts, spec.n_neighbors, n_valid=nv)
        pts_list.append(c_pts)
        ctr_list.append(centers)
        nbr_list.append(nbr)
        pts = c_pts
    return pts_list, ctr_list, nbr_list


def _sa_geometry(spec: SALayerSpec, points, features, n_valid=None):
    """The point-mapping + aggregation half of one SA layer: FPS centers,
    kNN gather, neighbor-minus-center differences. points ``(…, N, 3)``,
    features ``(…, N, C)`` -> ``(…, M, 3)``, ``(…, M, K, C)``."""
    centers = farthest_point_sample(points, spec.n_centers, n_valid=n_valid)
    c_pts = gather_rows(points, centers)
    nbr = knn(c_pts, points, spec.n_neighbors, n_valid=n_valid)
    f_nbr = gather_rows(features, nbr)
    f_ctr = gather_rows(features, centers)[..., None, :]
    return c_pts, f_nbr - f_ctr


def sa_layer(mlp_params, spec: SALayerSpec, points, features):
    """One set-abstraction layer, float MLP: points ``(…, N, 3)``, features
    ``(…, N, C_in)`` -> ``(…, M, 3)``, ``(…, M, C_out)``. For any other
    backend, compose :func:`_sa_geometry` with a registered backend's
    ``apply_mlp`` (:mod:`repro_torch.models.backend`)."""
    c_pts, diff = _sa_geometry(spec, points, features)
    h = _apply_mlp(mlp_params, diff)                    # feature comp. M(.)
    return c_pts, h.amax(dim=-2)                        # reduction over K


def _compiled(params, config, schedule, policy, device):
    from repro_torch.models.backend import compile_model
    return compile_model(params, config, schedule=schedule, policy=policy,
                         device=device)


def forward(params: Params, config: PointNetConfig, cloud, *,
            schedule=None, policy=None, device=None) -> torch.Tensor:
    """Single-cloud float forward: ``(N, 3)`` -> logits ``(n_classes,)``,
    a thin delegate to :func:`~repro_torch.models.backend.compile_model`
    (the entry point, and the place to pick any other backend);
    ``schedule``/``policy`` pass straight through, ``device`` too (the card
    by default)."""
    return _compiled(params, config, schedule, policy,
                     device).forward(cloud)


def batched_forward(params: Params, config: PointNetConfig, clouds, *,
                    schedule=None, policy=None, device=None) -> torch.Tensor:
    """Batch ``(B, N, 3)`` -> logits ``(B, n_classes)``, float backend,
    through :func:`~repro_torch.models.backend.compile_model`."""
    return _compiled(params, config, schedule, policy,
                     device).batched_forward(clouds)


def loss_fn(params: Params, config: PointNetConfig, clouds, labels, *,
            schedule=None, policy=None, device=None):
    """Mean negative log-likelihood and accuracy of the float
    :func:`batched_forward` over ``labels``. Under the 'baseline' schedule
    it carries gradients to the leaves of ``params`` that require grad
    (:meth:`~repro_torch.models.backend.CompiledModel.loss_fn`), which
    must then sit on ``device``."""
    return _compiled(params, config, schedule, policy,
                     device).loss_fn(clouds, labels)


@torch.no_grad()
def eval_step(params: Params, config: PointNetConfig, clouds, labels, *,
              schedule=None, policy=None, device=None):
    """:func:`loss_fn` without autograd, run eagerly: each call compiles
    the model anew, so a captured graph would never be replayed. To reuse
    one, compile once and call the compiled model's captured
    :meth:`~repro_torch.models.backend.CompiledModel.eval_step`."""
    return loss_fn(params, config, clouds, labels, schedule=schedule,
                   policy=policy, device=device)
