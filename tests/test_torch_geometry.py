"""The port's geometry against the JAX package's on the same float32
coordinates: FPS and kNN indices equal bit for bit, padded clouds
(``n_valid``) and duplicated points included; ``lift_features`` within an
ulp (sin/cos are each framework's own)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.workload import PointNetConfig as JConfig          # noqa: E402
from repro.core.workload import SALayerSpec as JSpec               # noqa: E402
from repro.models import pointnet2 as jpn                          # noqa: E402
from repro_torch.core.workload import PointNetConfig, SALayerSpec  # noqa: E402
from repro_torch.models import pointnet2 as tpn                    # noqa: E402


def _tiny(cfg_cls, spec_cls):
    return cfg_cls(name="tiny", n_points=64, layers=(
        spec_cls(n_centers=24, n_neighbors=4, in_features=4,
                 mlp=(4, 8, 8, 16)),
        spec_cls(n_centers=8, n_neighbors=4, in_features=16,
                 mlp=(16, 16, 16, 32))))


def _cloud(kind, n=64, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * 2.3
    if kind == "duplicated":
        pts[n // 2:] = pts[:n - n // 2]
    elif kind == "grid":                       # many exactly tied distances
        pts = np.stack(np.meshgrid(*[np.arange(4.0)] * 3),
                       -1).reshape(-1, 3)[:n]
    return pts.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "duplicated", "grid"])
def test_fps_and_knn_bitwise(kind):
    pts = _cloud(kind)
    ji = np.asarray(jpn.farthest_point_sample(jnp.asarray(pts), 24))
    ti = tpn.farthest_point_sample(torch.from_numpy(pts), 24).numpy()
    np.testing.assert_array_equal(ti, ji)
    jn = np.asarray(jpn.knn(jnp.asarray(pts[ji]), jnp.asarray(pts), 6))
    tn = tpn.knn(torch.from_numpy(pts[ti]), torch.from_numpy(pts), 6).numpy()
    np.testing.assert_array_equal(tn, jn)


def test_fps_knn_at_paper_size_bitwise():
    pts = _cloud("random", n=1024, seed=3)
    ji = np.asarray(jpn.farthest_point_sample(jnp.asarray(pts), 512))
    ti = tpn.farthest_point_sample(torch.from_numpy(pts), 512).numpy()
    np.testing.assert_array_equal(ti, ji)
    jn = np.asarray(jpn.knn(jnp.asarray(pts[ji]), jnp.asarray(pts), 16))
    tn = tpn.knn(torch.from_numpy(pts[ti]), torch.from_numpy(pts),
                 16).numpy()
    np.testing.assert_array_equal(tn, jn)


@pytest.mark.parametrize("kind", ["random", "duplicated"])
def test_geometry_pass_bitwise_with_padding(kind):
    cfg_j, cfg_t = _tiny(JConfig, JSpec), _tiny(PointNetConfig, SALayerSpec)
    real = _cloud(kind, n=50, seed=5)
    padded = np.concatenate([real, np.zeros((14, 3), np.float32)])
    gj = jpn.geometry_pass(cfg_j, jnp.asarray(padded), n_valid=50)
    gt = tpn.geometry_pass(cfg_t, torch.from_numpy(padded), n_valid=50)
    gt_unpadded = tpn.geometry_pass(cfg_t, torch.from_numpy(real))
    for k in (1, 2):
        for part in (1, 2):
            np.testing.assert_array_equal(gt[part][k].numpy(),
                                          np.asarray(gj[part][k]))
            np.testing.assert_array_equal(gt[part][k].numpy(),
                                          gt_unpadded[part][k].numpy())
        np.testing.assert_array_equal(gt[0][k].numpy(), np.asarray(gj[0][k]))


def test_batched_geometry_equals_per_cloud():
    cfg = _tiny(PointNetConfig, SALayerSpec)
    clouds = np.stack([_cloud("random", seed=s) for s in range(3)])
    nv = np.array([64, 40, 52])
    gb = tpn.geometry_pass(cfg, torch.from_numpy(clouds),
                           n_valid=torch.from_numpy(nv))
    for b in range(3):
        g1 = tpn.geometry_pass(cfg, torch.from_numpy(clouds[b]),
                               n_valid=int(nv[b]))
        for part in range(3):
            for k in (1, 2):
                assert torch.equal(gb[part][k][b], g1[part][k])


def test_lift_features_within_an_ulp():
    pts = _cloud("random", n=256, seed=7)
    for width in (4, 8, 16):
        ref = np.asarray(jpn.lift_features(jnp.asarray(pts), width))
        got = tpn.lift_features(torch.from_numpy(pts), width).numpy()
        assert got.shape == ref.shape
        np.testing.assert_array_max_ulp(got, ref, maxulp=2)
