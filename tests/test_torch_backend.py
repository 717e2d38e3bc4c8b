"""The port end to end against the JAX package's ``compile_model`` on the
same weights (``params_from_numpy``) and the same clouds.

Tolerances, and why:
- 'float': the matmuls sum in another order in each framework, and
  ``lift_features``' sin/cos may differ by an ulp: ``rtol=1e-4`` with
  ``atol=1e-4 * max|ref|``;
- 'reram-fused': the integer pipeline is exact, but an ulp of difference
  in a lifted feature can move one requantized value by one step, so
  ``atol=1e-2 * max|ref|``.
Both require equal argmax. The JAX side plans on the host
(``device_planning=False``), the path the port takes. Within the port,
planned and baseline logits must be equal bit for bit (the scatter back to
index order makes them order-invariant).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro                                                       # noqa: E402
import repro_torch                                                 # noqa: E402
from repro.core.workload import PointNetConfig as JConfig          # noqa: E402
from repro.core.workload import SALayerSpec as JSpec               # noqa: E402
from repro.models import pointnet2 as jpn                          # noqa: E402
from repro_torch.convert import params_from_numpy                  # noqa: E402
from repro_torch.core.schedule import DevicePlan, build_plan       # noqa: E402
from repro_torch.core.workload import (PointNetConfig,             # noqa: E402
                                       PointNetWorkload, SALayerSpec)
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402

SCHEDULES = ["baseline", "pointer", "pointer-morton"]
BACKENDS = ["float", "reram-fused"]


def _tiny(cfg_cls, spec_cls):
    return cfg_cls(name="tiny", n_points=64, layers=(
        spec_cls(n_centers=24, n_neighbors=4, in_features=4,
                 mlp=(4, 8, 8, 16)),
        spec_cls(n_centers=8, n_neighbors=4, in_features=16,
                 mlp=(16, 16, 16, 32))))


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg_t = _tiny(JConfig, JSpec), _tiny(PointNetConfig, SALayerSpec)
    jparams = jpn.init_params(jax.random.PRNGKey(0), cfg_j, n_classes=10)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(1)
    clouds = rng.normal(size=(2, 64, 3)).astype(np.float32)
    return cfg_j, cfg_t, jparams, tparams, clouds


@pytest.fixture(scope="module")
def jax_logits(setup):
    cfg_j, _, jparams, _, clouds = setup
    cache = {}

    def get(backend, schedule):
        if (backend, schedule) not in cache:
            kw = {} if schedule == "baseline" else {"device_planning": False}
            m = repro.compile_model(jparams, cfg_j, backend=backend,
                                    schedule=schedule, **kw)
            cache[backend, schedule] = (
                np.asarray(m.forward(jnp.asarray(clouds[0]))),
                np.asarray(m.batched_forward(jnp.asarray(clouds))))
        return cache[backend, schedule]
    return get


def _port(setup, backend, schedule):
    _, cfg_t, _, tparams, _ = setup
    return repro_torch.compile_model(tparams, cfg_t, backend=backend,
                                     schedule=schedule, device="cpu")


def _close(got, ref, backend):
    scale = max(1.0, float(np.abs(ref).max()))
    if backend == "float":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * scale)
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(ref, -1))


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_forward_matches_jax(setup, jax_logits, backend, schedule):
    ref, _ = jax_logits(backend, schedule)
    got = _port(setup, backend, schedule).forward(setup[4][0]).numpy()
    assert got.shape == ref.shape == (10,)
    _close(got, ref, backend)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_forward_matches_jax(setup, jax_logits, backend, schedule):
    _, ref = jax_logits(backend, schedule)
    got = _port(setup, backend, schedule).batched_forward(setup[4]).numpy()
    assert got.shape == ref.shape == (2, 10)
    _close(got, ref, backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_planned_equals_baseline_bitwise(setup, backend):
    clouds = setup[4]
    base = _port(setup, backend, "baseline")
    for schedule in ("pointer", "pointer-12", "pointer-morton",
                     {"intra": "greedy", "coordinated": False}):
        model = _port(setup, backend, schedule)
        assert model.planned
        assert torch.equal(model.forward(clouds[0]), base.forward(clouds[0]))
        assert torch.equal(model.batched_forward(clouds),
                           base.batched_forward(clouds))


def test_fused_batched_rows_equal_single_forward_bitwise(setup):
    clouds = setup[4]
    model = _port(setup, "reram-fused", "pointer")
    batched = model.batched_forward(clouds)
    for b in range(clouds.shape[0]):
        assert torch.equal(batched[b], model.forward(clouds[b]))


def test_prebuilt_plans_drive_execution(setup):
    _, cfg_t, _, _, clouds = setup
    spec = _port(setup, "reram-fused", "pointer")
    wl = PointNetWorkload.build(clouds[0].astype(np.float64), cfg_t)
    plan = build_plan(wl, intra="greedy", coordinated=True)
    from_plan = _port(setup, "reram-fused", plan)
    assert from_plan.device_plan is not None
    assert torch.equal(from_plan.forward(clouds[0]),
                       spec.forward(clouds[0]))
    batched = _port(setup, "reram-fused",
                    DevicePlan.lower([plan, plan], (24, 8)))
    assert batched.device_plan.batched
    assert torch.equal(batched.batched_forward(clouds),
                       spec.batched_forward(clouds))
    with pytest.raises(ValueError, match="batched"):
        batched.forward(clouds[0])


def test_padded_cloud_matches_unpadded(setup):
    clouds = setup[4]
    model = _port(setup, "reram-fused", "pointer")
    padded = np.concatenate([clouds[0], np.zeros((16, 3), np.float32)])
    assert torch.equal(model.forward(padded, n_valid=64),
                       model.forward(clouds[0]))
    both = np.stack([padded, padded])
    assert torch.equal(model.batched_forward(both, n_valid=[64, 64])[0],
                       model.forward(clouds[0]))


#: Backends this file compares under the 'pointer' schedule only.
POINTER_BACKENDS = ["reram", "reram-fused-mtiled", "reram-fused-wstat"]


@pytest.mark.parametrize("backend", POINTER_BACKENDS)
def test_more_backends_match_jax(setup, jax_logits, backend):
    ref_one, ref = jax_logits(backend, "pointer")
    model = _port(setup, backend, "pointer")
    got = model.batched_forward(setup[4]).numpy()
    assert got.shape == ref.shape == (2, 10)
    _close(got, ref, backend)
    _close(model.forward(setup[4][0]).numpy(), ref_one, backend)


@pytest.mark.parametrize("backend", POINTER_BACKENDS)
def test_per_layer_and_pinned_modes_equal_fused_bitwise(setup, backend):
    # zero biases: one function, so one result, batched and single
    clouds = setup[4]
    fused = _port(setup, "reram-fused", "pointer")
    model = _port(setup, backend, "pointer")
    assert torch.equal(model.batched_forward(clouds),
                       fused.batched_forward(clouds))
    assert torch.equal(model.forward(clouds[0]), fused.forward(clouds[0]))


def test_backend_names_equal_jax():
    assert repro_torch.available_backends() == repro.available_backends()
    for name in repro_torch.available_backends():
        cls = repro_torch.models.backend._REGISTRY[name]
        assert cls.name == name


def test_mode_option_pins_the_dataflow(setup):
    _, cfg_t, _, tparams, clouds = setup
    auto = _port(setup, "reram-fused", "pointer")
    assert auto.backend.mode is None
    wstat = repro_torch.compile_model(tparams, cfg_t, backend="reram-fused",
                                      schedule="pointer", device="cpu",
                                      mode="wstat")
    assert wstat.backend.mode == "wstat"
    assert torch.equal(wstat.batched_forward(clouds),
                       auto.batched_forward(clouds))
    # the launches: the pinned mode, else the Hopper choice (K1 at the SA
    # layers, K3 at the head at these shapes); the TPU's choice, reported
    # in stats(), stays 'whole'
    assert {g.mode for g in wstat.backend._launch_cache.values()} == {
        "wstat"}
    assert {k[0] if k[0] == "head" else "sa": g.mode
            for k, g in auto.backend._launch_cache.items()} == {
        "sa": "whole", "head": "wstat"}
    assert {r["mode"] for r in auto.stats()["fused_plan"].values()} == {
        "whole"}
    assert _port(setup, "reram-fused-mtiled", "baseline").backend.mode \
        == "mtiled"
    with pytest.raises(ValueError, match="mode"):
        repro_torch.compile_model(tparams, cfg_t, backend="reram-fused",
                                  device="cpu", mode="diagonal")
    with pytest.raises(TypeError):
        repro_torch.compile_model(tparams, cfg_t, backend="float",
                                  device="cpu", mode="wstat")


def test_registry_and_schedule_errors(setup):
    assert {"float", "reram-fused"} <= set(repro_torch.available_backends())
    with pytest.raises(ValueError, match="reram-fused"):
        _port(setup, "resistive", "baseline")
    with pytest.raises(ValueError, match="unknown schedule"):
        _port(setup, "float", "sideways")
    with pytest.raises(ValueError, match="intra"):
        _port(setup, "float", {"intra": "spiral"})
    with pytest.raises(ValueError, match="do not match"):
        _port(setup, "float", DevicePlan([], [], (24,)))
    with pytest.raises(TypeError, match="preset name"):
        _port(setup, "float", 3)


def test_cpu_model_launches_no_kernel(setup):
    reset_launch_counts()
    model = _port(setup, "reram-fused", "pointer")
    model.batched_forward(setup[4])
    model.forward(setup[4][0])
    assert set(launch_counts().values()) == {0}
    assert model.device.type == "cpu"
