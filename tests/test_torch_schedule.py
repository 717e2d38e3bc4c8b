"""The port's workload and host planner against the JAX package's.

Both are NumPy code; the port keeps its own copy so that it imports
nothing of the JAX package. Same inputs, made from a seed, must give the
same configs, geometry and plans, bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import schedule as jsched                       # noqa: E402
from repro.core import workload as jwl                          # noqa: E402
from repro_torch.core import schedule as tsched                 # noqa: E402
from repro_torch.core import workload as twl                    # noqa: E402


def _tiny(mod):
    return mod.PointNetConfig(name="tiny", n_points=64, layers=(
        mod.SALayerSpec(n_centers=24, n_neighbors=4, in_features=4,
                        mlp=(4, 8, 8, 16)),
        mod.SALayerSpec(n_centers=8, n_neighbors=4, in_features=16,
                        mlp=(16, 16, 16, 32))))


def _cloud(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.normal(size=(64, 3))
    ctrs = rng.normal(size=(4, 3)) * 4.0
    return np.concatenate([c + 0.25 * rng.normal(size=(16, 3))
                           for c in ctrs])


def _workloads(kind):
    cloud = _cloud(kind)
    return (jwl.PointNetWorkload.build(cloud, _tiny(jwl)),
            twl.PointNetWorkload.build(cloud, _tiny(twl)))


@pytest.mark.parametrize("name", ["model0", "model1", "model2"])
def test_paper_models_equal_field_by_field(name):
    j, t = jwl.PAPER_MODELS[name], twl.PAPER_MODELS[name]
    assert (j.name, j.n_points, j.n_layers) == (t.name, t.n_points,
                                                t.n_layers)
    for lj, lt in zip(j.layers, t.layers):
        assert dataclasses.asdict(lj) == dataclasses.asdict(lt)
        assert (lj.out_features, lj.mlp_shapes, lj.weights) == (
            lt.out_features, lt.mlp_shapes, lt.weights)
    assert sorted(jwl.PAPER_MODELS) == sorted(twl.PAPER_MODELS)


@pytest.mark.parametrize("kind", ["random", "clustered"])
def test_workload_geometry_equal(kind):
    wj, wt = _workloads(kind)
    for k in range(1, wj.n_layers + 1):
        np.testing.assert_array_equal(wj.points[k], wt.points[k])
        np.testing.assert_array_equal(wj.centers[k], wt.centers[k])
        np.testing.assert_array_equal(wj.neighbors[k], wt.neighbors[k])
    assert [f.tolist() for f in wj.pyramid_receptive_field(2, 3)] == [
        f.tolist() for f in wt.pyramid_receptive_field(2, 3)]


@pytest.mark.parametrize("kind", ["random", "clustered"])
@pytest.mark.parametrize("coordinated", [False, True])
@pytest.mark.parametrize("intra", ["index", "greedy", "morton"])
def test_build_plan_equal(intra, coordinated, kind):
    wj, wt = _workloads(kind)
    pj = jsched.build_plan(wj, intra=intra, coordinated=coordinated)
    pt = tsched.build_plan(wt, intra=intra, coordinated=coordinated)
    assert (pj.intra, pj.coordinated, pj.trace) == (pt.intra,
                                                    pt.coordinated, pt.trace)
    for k in range(1, pj.n_layers + 1):
        np.testing.assert_array_equal(pj.order_of(k), pt.order_of(k))


def test_device_plan_lower_equal_single_and_batched():
    wj, wt = _workloads("clustered")
    wj2, wt2 = (jwl.PointNetWorkload.build(_cloud("random", 3), _tiny(jwl)),
                twl.PointNetWorkload.build(_cloud("random", 3), _tiny(twl)))
    sizes = (24, 8)
    mk = dict(intra="greedy", coordinated=True)
    pj = [jsched.build_plan(w, **mk) for w in (wj, wj2)]
    pt = [tsched.build_plan(w, **mk) for w in (wt, wt2)]
    for j_in, t_in in ((pj[0], pt[0]), (pj, pt)):
        dj = jsched.DevicePlan.lower(j_in, sizes)
        dt = tsched.DevicePlan.lower(t_in, sizes)
        assert dj.batched == dt.batched and dj.batch_size == dt.batch_size
        for k in (1, 2):
            assert dt.order_of(k).dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(dj.order_of(k)),
                                          dt.order_of(k).numpy())
            np.testing.assert_array_equal(np.asarray(dj.inverse_of(k)),
                                          dt.inverse_of(k).numpy())
    stacked = tsched.DevicePlan.stack(
        [tsched.DevicePlan.lower(p, sizes) for p in pt])
    batched = tsched.DevicePlan.lower(pt, sizes)
    for k in (1, 2):
        assert torch.equal(stacked.order_of(k), batched.order_of(k))
    with pytest.raises(ValueError):
        batched.order_of(0)


def test_complete_order_and_inverse_equal():
    order = np.array([5, 2, 7], dtype=np.int64)
    np.testing.assert_array_equal(jsched.complete_order(order, 9),
                                  tsched.complete_order(order, 9))
    full = tsched.complete_order(order, 9)
    np.testing.assert_array_equal(jsched.inverse_permutation(full),
                                  tsched.inverse_permutation(full))
    with pytest.raises(ValueError, match="duplicate"):
        tsched.complete_order(np.array([1, 1]), 4)


def test_morton_degenerate_axis_and_greedy_sparse_path_equal():
    rng = np.random.default_rng(4)
    flat = rng.normal(size=(50, 3))
    flat[:, 2] = 1.5
    np.testing.assert_array_equal(jsched.morton_order(flat),
                                  tsched.morton_order(flat))
    pts = rng.normal(size=(40, 3))
    np.testing.assert_array_equal(jsched.greedy_nn_order(pts, start=3),
                                  tsched.greedy_nn_order(pts, start=3))
    assert jsched.MODE_PRESETS == tsched.MODE_PRESETS


def test_fps_and_knn_numpy_equal():
    pts = np.random.default_rng(5).normal(size=(200, 3))
    np.testing.assert_array_equal(jwl.farthest_point_sample_np(pts, 50, 7),
                                  twl.farthest_point_sample_np(pts, 50, 7))
    np.testing.assert_array_equal(jwl.knn_np(pts[:30], pts, 9),
                                  twl.knn_np(pts[:30], pts, 9))
