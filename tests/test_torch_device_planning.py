"""Planning on the device, the port's default as the JAX package's: the
``compile_model(device_planning=)`` switch and its errors against the
reference's, device-planned logits against host-planned ones (bit for bit)
and against the JAX package's device-planned ``forward``/``batched_forward``
(within the tolerance of ``test_torch_backend.py``: 1e-4 relative for
'float', one requantization step, 1e-2 of the largest logit, for the
crossbar backends; equal argmax), and ``jit_forward``/
``jit_batched_forward``/``eval_step`` on the CPU, where there is nothing to
capture and they run eagerly. On the card they replay CUDA graphs
(``tests/test_torch_cuda.py``)."""
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
from repro_torch.core.schedule import (DevicePlan,                 # noqa: E402
                                       GREEDY_DENSE_LIMIT, build_plan)
from repro_torch.core.workload import (PointNetConfig,             # noqa: E402
                                       PointNetWorkload, SALayerSpec)
from repro_torch.kernels import (launch_counts,               # noqa: E402
                                 reset_launch_counts)

SCHEDULES = ["pointer-1", "pointer-12", "pointer", "pointer-morton"]
BACKENDS = ["float", "reram", "reram-fused"]


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


def _port(setup, backend, schedule, **kw):
    return repro_torch.compile_model(setup[3], setup[1], backend=backend,
                                     schedule=schedule, device="cpu", **kw)


def _jax(setup, backend, schedule, **kw):
    return repro.compile_model(setup[2], setup[0], backend=backend,
                               schedule=schedule, **kw)


def _close(got, ref, backend):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    if backend == "float":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * scale)
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(ref, -1))


# ---------------------------------------------------------------------------
# compile_model(device_planning=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["baseline"] + SCHEDULES + [
    {"intra": "morton"}, {"intra": "greedy", "coordinated": True}])
@pytest.mark.parametrize("device_planning", [None, False])
def test_device_planning_default_equals_jax(setup, schedule,
                                            device_planning):
    jm = _jax(setup, "float", schedule, device_planning=device_planning)
    tm = _port(setup, "float", schedule, device_planning=device_planning)
    assert tm.device_planning == jm.device_planning
    assert tm.device_planning == (device_planning is None
                                  and schedule != "baseline")


def test_device_planning_errors_equal_jax(setup):
    cfg_j, cfg_t, jparams, tparams, clouds = setup
    plan_t = build_plan(PointNetWorkload.build(
        clouds[0].astype(np.float64), cfg_t), intra="greedy",
        coordinated=True)
    plan_j = j_build_plan(JWorkload.build(clouds[0].astype(np.float64),
                                          cfg_j), intra="greedy",
                          coordinated=True)
    for t_sched, j_sched in (("baseline", "baseline"), (plan_t, plan_j),
                             (DevicePlan.lower(plan_t, (24, 8)), None)):
        with pytest.raises(ValueError, match="spec-driven planned"):
            _port(setup, "float", t_sched, device_planning=True)
        if j_sched is not None:
            with pytest.raises(ValueError, match="spec-driven planned"):
                _jax(setup, "float", j_sched, device_planning=True)
        assert not _port(setup, "float", t_sched).device_planning
    assert _port(setup, "float", "pointer",
                 device_planning=True).device_planning
    # a greedy last layer past the one-block limit: host planning by
    # default, an error when demanded
    big_t = tiny_config(PointNetConfig, SALayerSpec, n=4200, c1=4100,
                        c2=GREEDY_DENSE_LIMIT + 1)
    big_j = tiny_config(JConfig, JSpec, n=4200, c1=4100,
                        c2=GREEDY_DENSE_LIMIT + 1)
    tm = repro_torch.compile_model(tparams, big_t, schedule="pointer",
                                   device="cpu")
    jm = repro.compile_model(jparams, big_j, schedule="pointer")
    assert tm.device_planning is jm.device_planning is False
    assert repro_torch.compile_model(tparams, big_t,
                                     schedule="pointer-morton",
                                     device="cpu").device_planning
    for compile_fn, params, cfg in (
            (lambda *a, **k: repro_torch.compile_model(*a, device="cpu", **k),
             tparams, big_t),
            (repro.compile_model, jparams, big_j)):
        with pytest.raises(ValueError, match="GREEDY_DENSE_LIMIT=2048"):
            compile_fn(params, cfg, schedule="pointer",
                       device_planning=True)


# ---------------------------------------------------------------------------
# logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_device_planned_equals_host_planned_bitwise(setup, backend,
                                                    schedule):
    clouds = setup[4]
    dev = _port(setup, backend, schedule)
    host = _port(setup, backend, schedule, device_planning=False)
    assert dev.device_planning and not host.device_planning
    assert torch.equal(dev.batched_forward(clouds),
                       host.batched_forward(clouds))
    for c in clouds[:2]:
        assert torch.equal(dev.forward(c), host.forward(c))
    # the plans themselves, one cloud at a time
    for k in (1, 2):
        p_dev = dev.build_device_plan(clouds[1])
        p_host = host.build_device_plan(clouds[1])
        assert torch.equal(p_dev.order_of(k), p_host.order_of(k))
        assert torch.equal(p_dev.inverse_of(k), p_host.inverse_of(k))


@pytest.mark.parametrize("schedule", ["pointer", "pointer-morton"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_device_planned_matches_jax_device_planned(setup, backend,
                                                   schedule):
    clouds = setup[4]
    jm = _jax(setup, backend, schedule)
    tm = _port(setup, backend, schedule)
    assert jm.device_planning and tm.device_planning
    _close(tm.forward(clouds[0]).numpy(),
           jm.forward(jnp.asarray(clouds[0])), backend)
    _close(tm.batched_forward(clouds).numpy(),
           jm.batched_forward(jnp.asarray(clouds)), backend)
    jp = jm.build_device_plan(jnp.asarray(clouds[2]))
    tp = tm.build_device_plan(clouds[2])
    for k in (1, 2):
        np.testing.assert_array_equal(tp.order_of(k).numpy(),
                                      np.asarray(jp.order_of(k)))
        np.testing.assert_array_equal(tp.inverse_of(k).numpy(),
                                      np.asarray(jp.inverse_of(k)))


def test_device_planned_padded_cloud_and_prebuilt_plans(setup):
    clouds = setup[4]
    tm = _port(setup, "reram-fused", "pointer")
    padded = np.concatenate([clouds[0], np.zeros((8, 3), np.float32)])
    assert torch.equal(tm.forward(padded, n_valid=64),
                       tm.forward(clouds[0]))
    both = np.stack([padded, np.concatenate([clouds[1],
                                             np.ones((8, 3), np.float32)])])
    assert torch.equal(tm.batched_forward(both, n_valid=[64, 64]),
                       tm.batched_forward(clouds[:2]))
    plans = [tm.build_device_plan(c) for c in clouds]
    stacked = DevicePlan.stack(plans)
    assert torch.equal(tm.batched_forward(clouds, dplan=stacked),
                       tm.batched_forward(clouds))
    assert torch.equal(tm.forward(clouds[1], dplan=plans[1]),
                       tm.forward(clouds[1]))


class _NoHostTransfer:
    """Make every tensor -> host read raise while active."""

    NAMES = ("cpu", "numpy", "item", "tolist", "__bool__", "__int__",
             "__float__")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def refuse(*a, **k):
            raise AssertionError("host transfer")
        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse)

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)


@pytest.mark.parametrize("backend", BACKENDS)
def test_device_planned_call_reads_nothing_back(setup, backend):
    """Under device planning ``batched_forward`` (and ``forward`` on the
    fused and float backends) never moves a tensor to the host: no
    ``.cpu()``, ``.item()`` or ``bool`` of a tensor. Host planning does."""
    x = torch.from_numpy(setup[4])
    dev = _port(setup, backend, "pointer")
    host = _port(setup, backend, "pointer", device_planning=False)
    want = dev.batched_forward(x)
    with _NoHostTransfer():
        got = dev.batched_forward(x)
        if backend != "reram":          # 'reram' checks its activations
            dev.forward(x[0])
    assert torch.equal(got, want)
    with pytest.raises(AssertionError, match="host transfer"):
        with _NoHostTransfer():
            host.batched_forward(x)


def test_device_planned_stats_record_no_stream(setup):
    """As in the reference, only host planning records the plan-ordered
    streams ``stats()`` reports after a call; a cloud given to ``stats``
    still gets its report."""
    clouds = setup[4]
    jm = _jax(setup, "reram-fused", "pointer")
    tm = _port(setup, "reram-fused", "pointer")
    tm.forward(clouds[0])
    tm.batched_forward(clouds)
    jm.forward(jnp.asarray(clouds[0]))
    assert "dma" not in tm.stats() and "dma" not in jm.stats()
    assert tm.stats(clouds[0])["dma"] == jm.stats(clouds[0])["dma"]


# ---------------------------------------------------------------------------
# jit_forward / jit_batched_forward / eval_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["baseline", "pointer",
                                      "pointer-morton"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_jit_entry_points_equal_eager_on_cpu(setup, backend, schedule):
    clouds = setup[4]
    tm = _port(setup, backend, schedule)
    reset_launch_counts()
    for batch in (clouds, clouds[:2]):
        assert torch.equal(tm.jit_batched_forward(batch),
                           tm.batched_forward(batch))
    assert torch.equal(tm.jit_forward(clouds[1]), tm.forward(clouds[1]))
    labels = np.array([1, 7, 3])
    nll, acc = tm.loss_fn(clouds, labels)
    e_nll, e_acc = tm.eval_step(clouds, labels)
    assert float(e_nll) == float(nll) and float(e_acc) == float(acc)
    assert set(launch_counts().values()) == {0}
    assert tm._graphs == {}             # nothing captured on the CPU


def test_jit_refuses_a_host_planned_model_as_jax_does(setup):
    clouds = setup[4]
    tm = _port(setup, "reram-fused", "pointer", device_planning=False)
    jm = _jax(setup, "reram-fused", "pointer", device_planning=False)
    for name in ("jit_forward", "jit_batched_forward"):
        arg = clouds[0] if name == "jit_forward" else clouds
        with pytest.raises(TypeError, match="plans on host per cloud"):
            getattr(tm, name)(arg)
        with pytest.raises(TypeError, match="plans on host per cloud"):
            getattr(jm, name)(jnp.asarray(arg))
    # eval_step runs such a model eagerly, in both
    labels = np.array([0, 1, 2])
    nll, _ = tm.eval_step(clouds, labels)
    j_nll, _ = jm.eval_step(jnp.asarray(clouds), jnp.asarray(labels))
    np.testing.assert_allclose(float(nll), float(j_nll), rtol=1e-5)
    # a prebuilt plan needs no planning: traceable
    fixed = _port(setup, "reram-fused",
                  tm.build_device_plan(clouds[0]))
    assert torch.equal(fixed.jit_forward(clouds[0]),
                       tm.forward(clouds[0]))
