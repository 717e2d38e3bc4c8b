"""``CompiledModel.stats()``, ``loss_fn``/``eval_step`` and caller-supplied
plans (``build_device_plan``, ``dplan=``) against the JAX package, on the
same weights (``params_from_numpy``) and the same clouds.

Program bytes, fused-plan rows, DMA-elision reports and plan orders are
integers and equal exactly; the loss is within 1e-5 relative (the float
logits differ in the last bits between the frameworks), the accuracy
equal. Both sides plan on the host (``device_planning=False``): only host
planning records the streams ``stats()`` reports after a call."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro                                                       # noqa: E402
import repro_torch                                                 # noqa: E402
from repro.core.schedule import build_plan as j_build_plan         # noqa: E402
from repro.core.workload import PointNetConfig as JConfig          # noqa: E402
from repro.core.workload import PointNetWorkload as JWorkload      # noqa: E402
from repro.core.workload import SALayerSpec as JSpec               # noqa: E402
from repro.models import pointnet2 as jpn                          # noqa: E402
from repro_torch.convert import params_from_numpy                  # noqa: E402
from repro_torch.core.schedule import DevicePlan, build_plan       # noqa: E402
from repro_torch.core.workload import (PointNetConfig,             # noqa: E402
                                       PointNetWorkload, SALayerSpec)


def tiny_config(cfg_cls, spec_cls, n=64, c1=24, c2=8, k=4):
    return cfg_cls(name="tiny", n_points=n, layers=(
        spec_cls(n_centers=c1, n_neighbors=k, in_features=4,
                 mlp=(4, 8, 8, 16)),
        spec_cls(n_centers=c2, n_neighbors=k, in_features=16,
                 mlp=(16, 16, 16, 32))))


@pytest.fixture(scope="module")
def setup():
    cfg_j = tiny_config(JConfig, JSpec)
    cfg_t = tiny_config(PointNetConfig, SALayerSpec)
    jparams = jpn.init_params(jax.random.PRNGKey(0), cfg_j, n_classes=10)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    clouds = np.random.default_rng(1).normal(size=(3, 64, 3)).astype(
        np.float32)
    return cfg_j, cfg_t, jparams, tparams, clouds


def _pair(setup, backend, schedule):
    cfg_j, cfg_t, jparams, tparams, _ = setup
    kw = {} if schedule == "baseline" else {"device_planning": False}
    jm = repro.compile_model(jparams, cfg_j, backend=backend,
                             schedule=schedule, **kw)
    tm = repro_torch.compile_model(tparams, cfg_t, backend=backend,
                                   schedule=schedule, device="cpu", **kw)
    return jm, tm


@pytest.mark.parametrize("schedule", ["baseline", "pointer-1", "pointer"])
@pytest.mark.parametrize("backend", ["float", "reram-fused"])
def test_stats_equal_jax(setup, backend, schedule):
    jm, tm = _pair(setup, backend, schedule)
    cloud = setup[4][0]
    want, got = jm.stats(cloud), tm.stats(cloud)
    for key in ("backend", "schedule", "planned", "program_bytes"):
        assert got[key] == want[key], key
    if backend == "float":
        assert got["program_bytes"] == 0 and "fused_plan" not in got
    else:
        assert got["program_bytes"] > 0
        assert got["program_bytes_per_mlp"] == want["program_bytes_per_mlp"]
        assert got["fused_plan"] == want["fused_plan"]
    assert got["dma"] == want["dma"]
    assert got["dma"]["window"] == 72
    assert tm.stats(cloud, window=1)["dma"] == jm.stats(cloud,
                                                        window=1)["dma"]


def test_stats_of_a_prebuilt_execution_plan_equal_jax(setup):
    cfg_j, cfg_t, jparams, tparams, clouds = setup
    c64 = clouds[1].astype(np.float64)
    jplan = j_build_plan(JWorkload.build(c64, cfg_j), intra="greedy",
                         coordinated=True)
    tplan = build_plan(PointNetWorkload.build(c64, cfg_t), intra="greedy",
                       coordinated=True)
    jm = repro.compile_model(jparams, cfg_j, backend="reram-fused",
                             schedule=jplan)
    tm = repro_torch.compile_model(tparams, cfg_t, backend="reram-fused",
                                   schedule=tplan, device="cpu")
    assert tm.stats(clouds[0])["dma"] == jm.stats(clouds[0])["dma"]


def test_stats_after_planned_forward_and_batched_forward(setup):
    jm, tm = _pair(setup, "reram-fused", "pointer")
    clouds = setup[4]
    assert "dma" not in tm.stats()
    jm.forward(jnp.asarray(clouds[0]))
    tm.forward(clouds[0])
    got = tm.stats()
    assert got["dma"] == jm.stats()["dma"]
    assert got["dma"]["steps"] == sum(s.n_centers * s.n_neighbors
                                      for s in setup[1].layers)
    assert tm.stats(window=8)["dma"] == jm.stats(window=8)["dma"]
    jm.batched_forward(jnp.asarray(clouds))
    tm.batched_forward(clouds)
    got = tm.stats()["dma"]
    assert got == jm.stats()["dma"]
    assert got["steps"] == 3 * sum(s.n_centers * s.n_neighbors
                                   for s in setup[1].layers)
    assert len(got["layers"]) == 2
    # the streams are those of the last call: one cloud again
    tm.forward(clouds[2])
    assert tm.stats()["dma"]["steps"] == got["steps"] // 3


@pytest.mark.parametrize("backend", ["float", "reram-fused"])
def test_loss_fn_and_eval_step_match_jax(setup, backend):
    jm, tm = _pair(setup, backend, "pointer")
    clouds = setup[4]
    labels = np.array([1, 7, 3])
    j_nll, j_acc = jm.loss_fn(jnp.asarray(clouds), jnp.asarray(labels))
    nll, acc = tm.loss_fn(clouds, labels)
    assert nll.shape == acc.shape == ()
    np.testing.assert_allclose(float(nll), float(j_nll), rtol=1e-5)
    assert float(acc) == float(j_acc)
    e_nll, e_acc = tm.eval_step(clouds, torch.from_numpy(labels))
    assert float(e_nll) == float(nll) and float(e_acc) == float(acc)
    assert not e_nll.requires_grad
    # labels equal to the argmax: accuracy one
    best = tm.batched_forward(clouds).argmax(1)
    assert float(tm.eval_step(clouds, best)[1]) == 1.0


@pytest.mark.parametrize("schedule", ["pointer", "pointer-morton"])
def test_build_device_plan_orders_equal_jax(setup, schedule):
    jm, tm = _pair(setup, "reram-fused", schedule)
    for cloud in setup[4][:2]:
        jp = jm.build_device_plan(jnp.asarray(cloud))
        tp = tm.build_device_plan(cloud)
        assert not tp.batched and tp.layer_sizes == (24, 8)
        for k in (1, 2):
            np.testing.assert_array_equal(tp.order_of(k).numpy(),
                                          np.asarray(jp.order_of(k)))
            np.testing.assert_array_equal(tp.inverse_of(k).numpy(),
                                          np.asarray(jp.inverse_of(k)))


def test_dplan_round_trip_bitwise(setup):
    _, tm = _pair(setup, "reram-fused", "pointer")
    clouds = setup[4]
    plans = [tm.build_device_plan(c) for c in clouds]
    for c, p in zip(clouds, plans):
        assert torch.equal(tm.forward(c, dplan=p), tm.forward(c))
    stacked = DevicePlan.stack(plans)
    assert torch.equal(tm.batched_forward(clouds, dplan=stacked),
                       tm.batched_forward(clouds))
    # one single-cloud plan shared batch-wide drives every row alike
    shared = tm.batched_forward(np.stack([clouds[0]] * 2), dplan=plans[0])
    assert torch.equal(shared[1], tm.forward(clouds[0]))
    # padded rows masked out of the geometry: the plan of the real cloud
    padded = np.concatenate([clouds[0], np.zeros((8, 3), np.float32)])
    p_pad = tm.build_device_plan(padded, n_valid=64)
    for k in (1, 2):
        assert torch.equal(p_pad.order_of(k), plans[0].order_of(k))
    # a compile-time plan is returned as it is
    fixed = repro_torch.compile_model(setup[3], setup[1],
                                      backend="reram-fused",
                                      schedule=plans[0], device="cpu")
    assert fixed.build_device_plan(clouds[1]) is fixed.device_plan


def test_dplan_errors(setup):
    _, tm = _pair(setup, "reram-fused", "pointer")
    _, base = _pair(setup, "reram-fused", "baseline")
    clouds = setup[4]
    plan = tm.build_device_plan(clouds[0])
    with pytest.raises(ValueError, match="unplanned"):
        base.forward(clouds[0], dplan=plan)
    with pytest.raises(ValueError, match="unplanned"):
        base.batched_forward(clouds, dplan=plan)
    with pytest.raises(ValueError, match="unplanned"):
        base.build_device_plan(clouds[0])
    with pytest.raises(ValueError, match="batched"):
        tm.forward(clouds[0], dplan=DevicePlan.stack([plan, plan]))
    with pytest.raises(ValueError, match="batch 2, got 3"):
        tm.batched_forward(clouds, dplan=DevicePlan.stack([plan, plan]))
    with pytest.raises(ValueError, match="do not match"):
        tm.forward(clouds[0], dplan=DevicePlan(plan.orders[:1],
                                               plan.inverses[:1], (24,)))
