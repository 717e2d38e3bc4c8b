"""K7's plain versions against the JAX package: one FPS relaxation step
(``fps_update``), whole FPS (``ops.fps``, ``fps_batched``) and the model's
``farthest_point_sample``, and the NumPy ``count_dma_elisions``.

Inputs come from numpy with a seed. Comparisons are bit for bit, with one
stated exception: XLA on the CPU contracts the multiply-adds of the JAX
Pallas step's body (interpret mode) into FMAs, so its distances may lie a
few ulp from the port's, which rounds every product as the JAX oracle
``ref_fps_update`` and the JAX model's FPS do (bound in the test)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import count_dma_elisions as j_count_dma      # noqa: E402
from repro.kernels import fps as j_fps                            # noqa: E402
from repro.kernels import fps_update as j_fps_update              # noqa: E402
from repro.kernels.ref import ref_fps_update as j_ref             # noqa: E402
from repro.models.pointnet2 import farthest_point_sample as j_model_fps  # noqa: E402
from repro_torch.kernels import (count_dma_elisions, fps,         # noqa: E402
                                 fps_batched, fps_update, launch_counts,
                                 ref_fps_update, reset_launch_counts)
from repro_torch.models.pointnet2 import farthest_point_sample    # noqa: E402


def _cloud(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * 2.3
    if kind == "duplicated":
        pts[n // 2:] = pts[:n - n // 2]
    elif kind == "grid":                       # many exactly tied distances
        pts = np.stack(np.meshgrid(*[np.arange(6.0)] * 3),
                       -1).reshape(-1, 3)[:n]
    return pts.astype(np.float32)


@pytest.mark.parametrize("n,block_n", [(128, 128), (200, 200), (1000, 200)])
def test_fps_update_vs_jax_ref_and_kernel(n, block_n):
    rng = np.random.default_rng(n)
    pts = rng.normal(size=(3, n)).astype(np.float32)
    cen = pts[:, 7:8].copy()
    dist = rng.uniform(0, 4, (1, n)).astype(np.float32)
    dist[0, :3] = np.inf                       # not yet relaxed
    dist[0, -2:] = -np.inf                     # pad rows stay at -inf
    want = np.asarray(j_fps_update(jnp.asarray(pts), jnp.asarray(cen),
                                   jnp.asarray(dist), block_n=block_n,
                                   interpret=True))
    want_ref = np.asarray(j_ref(jnp.asarray(pts), jnp.asarray(cen),
                                jnp.asarray(dist)))
    t = [torch.from_numpy(a) for a in (pts, cen, dist)]
    got = fps_update(*t).numpy()
    assert got.shape == (1, n) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want_ref)
    # The Pallas body as XLA on the CPU runs it: fma(dz, dz, fma(dy, dy,
    # dx*dx)), 3 roundings against the port's 5. The three terms are not
    # negative, so nothing cancels and each rounding moves the sum by at
    # most half an ulp of the result: within 4 ulp where finite (2 seen),
    # and the same infinities.
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    np.testing.assert_array_max_ulp(got[finite], want[finite], maxulp=4)
    np.testing.assert_array_equal(ref_fps_update(*t).numpy(), want_ref)
    assert got[0, 7] == 0.0 and np.all(got[0, -2:] == -np.inf)


@pytest.mark.parametrize("kind,n", [("random", 200), ("duplicated", 256),
                                    ("grid", 216)])
@pytest.mark.parametrize("start", [0, 5])
def test_ops_fps_bitwise_vs_jax_ops_fps_and_model_fps(kind, n, start):
    pts = _cloud(kind, n, seed=n)
    got = fps(torch.from_numpy(pts), 48, start=start).numpy()
    want = np.asarray(j_fps(jnp.asarray(pts), 48, start=start,
                            interpret=True))
    want_model = np.asarray(j_model_fps(jnp.asarray(pts), 48, start))
    assert got.dtype == np.int64 and got.shape == (48,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_model)
    np.testing.assert_array_equal(
        farthest_point_sample(torch.from_numpy(pts), 48, start).numpy(),
        want_model)
    assert got[0] == start and len(set(got.tolist())) == 48


def test_fps_batched_n_valid_equals_per_cloud_unpadded():
    n = 96
    clouds = np.stack([_cloud(kind, n, seed=s) for s, kind in
                       enumerate(("random", "duplicated", "grid"))])
    n_valid = np.array([96, 70, 41])
    got = fps_batched(torch.from_numpy(clouds), 40, 3,
                      torch.from_numpy(n_valid))
    for b in range(3):
        real = torch.from_numpy(clouds[b, :n_valid[b]].copy())
        want = fps_batched(real[None], 40, 3)[0]
        assert torch.equal(got[b], want)
        np.testing.assert_array_equal(
            want.numpy(), np.asarray(j_model_fps(jnp.asarray(real.numpy()),
                                                 40, 3)))
    # an int n_valid masks every cloud alike
    assert torch.equal(fps_batched(torch.from_numpy(clouds), 40, 3, 41)[2],
                       got[2])


@pytest.mark.parametrize("window", [1, 8, 72])
def test_count_dma_elisions_equals_jax(window):
    rng = np.random.default_rng(window)
    for nbr in (rng.integers(0, 16, (64, 8)), rng.integers(0, 300, (96, 16)),
                np.sort(rng.integers(0, 40, 512)).reshape(64, 8)):
        assert count_dma_elisions(nbr, window=window) == j_count_dma(
            nbr, window=window)


def test_launch_counters_carry_fps_and_cpu_runs_launch_none():
    reset_launch_counts()
    counts = launch_counts()
    assert counts["fps_update"] == 0 and counts["fps"] == 0
    pts = torch.from_numpy(_cloud("random", 64))
    fps(pts, 8)
    fps_batched(pts[None].expand(2, -1, -1), 8)
    farthest_point_sample(pts, 8)
    fps_update(pts.T.contiguous(), pts[:1].T.contiguous(),
               torch.zeros((1, 64)))
    assert set(launch_counts().values()) == {0}


def test_fps_checks_its_arguments_from_shapes():
    pts = torch.from_numpy(_cloud("random", 32))[None]
    with pytest.raises(ValueError, match="n_samples"):
        fps_batched(pts, 33)
    with pytest.raises(ValueError, match="start"):
        fps_batched(pts, 4, start=32)
    with pytest.raises(ValueError, match="start"):
        fps_batched(pts, 4, start=-1)
    with pytest.raises(ValueError, match=r"\(B, N, 3\)"):
        fps_batched(pts[..., :2], 4)
    with pytest.raises(ValueError, match=r"\(3, N\)"):
        fps_update(pts[0], pts[0, :1].T, torch.zeros((1, 32)))
    assert fps_batched(pts, 0).shape == (1, 0)
