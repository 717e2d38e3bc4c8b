"""The port's point-cloud serving tier on the CPU, against its own
``forward`` and against the JAX package's engine.

- Shape buckets, and the bucketing contract: a cloud padded with rows past
  ``n_valid`` gives ``forward``'s logits, bit for bit, alone and in a
  batch.
- The served-bitwise matrix: every row 'reram-fused' serves equals the
  port's ``forward`` on the bare request, bit for bit, under FIFO and EDF,
  with the plan cache on and off, frame reuse on and off, planning on the
  device and on the host, with point pads and batch pads. 'float' is held
  to 1e-5 of the largest logit with equal argmax: its batched matmuls sum
  in another order than a single cloud's (ROADMAP queue 3).
- Against the JAX engine on the same stream: the same service order, the
  same engine and servable ``stats()`` (batches, ``trace_shapes``, plan
  cache and frame tracker counters, p50/p99 under a ``VirtualClock``), and
  logits within the port-vs-reference tolerance of
  ``tests/test_torch_device_planning.py``.
- Counters and refusals: a warm repeat adds no step key; an oversized
  cloud is refused before the queue changes; a ``mesh=`` without a
  'replica' axis is refused.

On the card each bucket shape replays one CUDA graph
(``tests/test_torch_cuda.py``); here the step runs eagerly."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro                                                       # noqa: E402
import repro_torch                                                 # noqa: E402
from repro.core.schedule import FrameTracker as JFrameTracker      # noqa: E402
from repro.core.workload import PointNetConfig as JConfig          # noqa: E402
from repro.core.workload import SALayerSpec as JSpec               # noqa: E402
from repro.data.pointcloud import request_stream as j_stream       # noqa: E402
from repro.launch import serve as jserve                           # noqa: E402
from repro.models import pointnet2 as jpn                          # noqa: E402
from repro_torch.convert import params_from_numpy                  # noqa: E402
from repro_torch.core.schedule import FrameTracker, PlanCache      # noqa: E402
from repro_torch.core.workload import (PointNetConfig,             # noqa: E402
                                       SALayerSpec)
from repro_torch.data import request_stream                        # noqa: E402
from repro_torch.launch import serve as tserve                     # noqa: E402
from repro_torch.launch.serve import (PointCloudServable,          # noqa: E402
                                      ServingEngine, ShapeBuckets)
from repro_torch.models.backend import graph_key                   # noqa: E402

SIZES = (40, 48, 56, 64, 44)          # point pads in the (48, 64) buckets


def tiny_config(cfg_cls, spec_cls, n=64):
    return cfg_cls(name="tiny-serve", n_points=n, layers=(
        spec_cls(n_centers=24, n_neighbors=4, in_features=4,
                 mlp=(4, 8, 8, 16)),
        spec_cls(n_centers=8, n_neighbors=4, in_features=16,
                 mlp=(16, 16, 16, 32))))


@pytest.fixture(scope="module")
def setup():
    cfg_j = tiny_config(JConfig, JSpec)
    cfg_t = tiny_config(PointNetConfig, SALayerSpec)
    jparams = jpn.init_params(jax.random.PRNGKey(0), cfg_j, n_classes=10)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    return cfg_j, cfg_t, jparams, tparams


@pytest.fixture(scope="module")
def models(setup):
    """Port models on the CPU: (backend, schedule, device_planning)."""
    out = {}
    for backend, schedule, dp in [
            ("reram-fused", "pointer", None), ("reram-fused", "pointer", False),
            ("reram", "pointer", None), ("float", "pointer", None),
            ("reram-fused", "baseline", None)]:
        out[(backend, schedule, dp)] = repro_torch.compile_model(
            setup[3], setup[1], backend=backend, schedule=schedule,
            device="cpu", device_planning=dp)
    return out


def _cloud(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


def _clouds():
    return [_cloud(n, seed=i) for i, n in enumerate(SIZES)]


# ---------------------------------------------------------------------------
# shape buckets and the bucketing contract
# ---------------------------------------------------------------------------

def test_buckets_pick_smallest_fit():
    b = ShapeBuckets(points=(48, 64), batch=(1, 2, 4))
    assert [b.point_bucket(n) for n in (40, 48, 49, 64)] == [48, 48, 64, 64]
    assert [b.batch_bucket(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
    ref = jserve.ShapeBuckets()
    assert b.max_batch == 4
    assert (ShapeBuckets().points, ShapeBuckets().batch) == (ref.points,
                                                             ref.batch)


@pytest.mark.parametrize("case", ["points", "batch", "order", "empty"])
def test_buckets_refuse_overflow_and_bad_order(case):
    b = ShapeBuckets(points=(48, 64), batch=(2,))
    with pytest.raises(ValueError, match="exceeds" if case in (
            "points", "batch") else "ascending"):
        if case == "points":
            b.point_bucket(65)
        elif case == "batch":
            b.batch_bucket(3)
        elif case == "order":
            ShapeBuckets(points=(64, 48))
        else:
            ShapeBuckets(points=(64,), batch=())


@pytest.mark.parametrize("backend", ["float", "reram", "reram-fused"])
@pytest.mark.parametrize("schedule", ["baseline", "pointer"])
def test_padded_forward_bitwise_equal(setup, backend, schedule):
    model = repro_torch.compile_model(setup[3], setup[1], backend=backend,
                                      schedule=schedule, device="cpu")
    cloud = _cloud(48, seed=3)
    padded = np.zeros((64, 3), np.float32)
    padded[:48] = cloud
    assert torch.equal(model.forward(padded, n_valid=48),
                       model.forward(cloud))


@pytest.mark.parametrize("key", [("reram-fused", "pointer", None),
                                 ("reram-fused", "pointer", False),
                                 ("reram", "pointer", None),
                                 ("reram-fused", "baseline", None)])
def test_padded_batched_forward_bitwise_equal(models, key):
    model = models[key]
    clouds = _clouds()
    padded = np.zeros((len(clouds), 64, 3), np.float32)
    for i, c in enumerate(clouds):
        padded[i, :c.shape[0]] = c
    nv = np.asarray(SIZES, np.int32)
    got = model.batched_forward(padded, n_valid=nv)
    for i, c in enumerate(clouds):
        assert torch.equal(got[i], model.forward(c)), i
    if key[2] is False:             # host planning: nothing to capture ...
        with pytest.raises(TypeError, match="plans on host"):
            model.jit_batched_forward(padded, n_valid=nv)
        dplan = repro_torch.DevicePlan.stack(     # ... without a plan
            [model.build_device_plan(c) for c in clouds])
        captured = model.jit_batched_forward(padded, n_valid=nv, dplan=dplan)
    else:
        captured = model.jit_batched_forward(padded, n_valid=nv)
    assert torch.equal(captured, got)


# ---------------------------------------------------------------------------
# the served-bitwise matrix
# ---------------------------------------------------------------------------

def _serve_bare(model, scheduler, **kw):
    servable = PointCloudServable(
        model, buckets=ShapeBuckets(points=(48, 64), batch=(1, 2, 4)), **kw)
    eng = ServingEngine(servable, scheduler=scheduler)
    # the last request is a near-duplicate of the one before it in the
    # batch, under both disciplines (a frame hit with reuse on)
    clouds = _clouds() + [_clouds()[4] + np.float32(1e-6)]
    reqs = [eng.submit(c, t=i * 1e-3,
                       deadline_us=10_000 if i in (1, 3) else None)
            for i, c in enumerate(clouds)]
    eng.drain(now=0.1)
    return servable, reqs, clouds


@pytest.mark.parametrize("scheduler", ["fifo", "edf"])
@pytest.mark.parametrize("cache,reuse", [(True, False), (True, True),
                                         (False, False)])
@pytest.mark.parametrize("device_planning", [None, False])
def test_served_rows_bitwise_equal_forward(models, scheduler, cache, reuse,
                                           device_planning):
    model = models[("reram-fused", "pointer", device_planning)]
    servable, reqs, clouds = _serve_bare(
        model, scheduler, plan_cache=cache,
        frame_reuse=FrameTracker(tol=1e-3) if reuse else False)
    for req, cloud in zip(reqs, clouds):
        assert isinstance(req.result, torch.Tensor)
        assert req.result.shape == (10,)
        assert torch.equal(req.result, model.forward(cloud)), req.id
    s = servable.stats()
    assert s["requests"] == len(clouds)
    # host planning with the cache off has no plan to hand the captured
    # step: it runs eagerly, and counts no step key (as the reference)
    eager = not cache and device_planning is False
    assert s["jit_traces"] == len(s["trace_shapes"])
    assert len(set(s["trace_shapes"])) == len(s["trace_shapes"])
    assert (s["jit_traces"] == 0) == eager
    assert ("plan_cache" in s) == cache
    if reuse:
        assert s["frame_tracker"]["frame_hits"] >= 1


@pytest.mark.parametrize("backend", ["reram", "float"])
def test_served_rows_other_backends(models, backend):
    """'reram' bit for bit; 'float' within 1e-5 of the largest logit with
    equal argmax (its batched matmuls sum in another order)."""
    model = models[(backend, "pointer", None)]
    _, reqs, clouds = _serve_bare(model, "edf",
                                  frame_reuse=FrameTracker(tol=1e-3))
    for req, cloud in zip(reqs, clouds):
        ref = model.forward(cloud)
        if backend == "reram":
            assert torch.equal(req.result, ref), req.id
        else:
            tol = 1e-5 * float(ref.abs().max())
            assert float((req.result - ref).abs().max()) <= tol, req.id
            assert int(req.result.argmax()) == int(ref.argmax())


def test_baseline_model_serves_without_a_plan(models):
    model = models[("reram-fused", "baseline", None)]
    servable, reqs, clouds = _serve_bare(model, "fifo")
    assert servable.plan_cache is None
    for req, cloud in zip(reqs, clouds):
        assert torch.equal(req.result, model.forward(cloud)), req.id
    with pytest.raises(ValueError, match="no per-cloud plan"):
        PointCloudServable(model, plan_cache=PlanCache())


def test_tensor_payloads_serve_like_arrays(models):
    """A tensor payload is pulled to the host once and keyed as its
    array: the same plan-cache hits and the same rows."""
    model = models[("reram-fused", "pointer", None)]
    servable = PointCloudServable(
        model, buckets=ShapeBuckets(points=(48, 64), batch=(1, 2, 4)))
    eng = ServingEngine(servable)
    clouds = _clouds()
    reqs = ([eng.submit(c) for c in clouds]
            + [eng.submit(torch.from_numpy(c)) for c in clouds])
    eng.drain()
    assert servable.plan_cache.stats()["hits"] == len(clouds)
    for a, b in zip(reqs[:len(clouds)], reqs[len(clouds):]):
        assert torch.equal(a.result, b.result)


# ---------------------------------------------------------------------------
# against the JAX engine on the same stream
# ---------------------------------------------------------------------------

RUNS = {
    # name: (stream kwargs, buckets, scheduler, frame reuse, plan cache)
    "pool_fifo": (dict(n_requests=8, rate_hz=400.0, n_points=(64, 40),
                       pool=3, repeat_p=0.7, seed=0),
                  ((48, 64), (1, 2, 4)), "fifo", False, True),
    "pool_edf": (dict(n_requests=8, rate_hz=400.0, n_points=(64, 40),
                      pool=3, repeat_p=0.7, seed=0),
                 ((48, 64), (1, 2, 4)), "edf", False, True),
    "lidar_edf_reuse": (dict(n_requests=6, rate_hz=800.0, n_points=(64,),
                             pool=3, seed=1, mode="lidar"),
                        ((64,), (1, 2)), "edf", True, True),
    "pool_fifo_no_cache": (dict(n_requests=5, rate_hz=400.0,
                                n_points=(64, 40), pool=3, repeat_p=0.7,
                                seed=2),
                           ((48, 64), (1, 2)), "fifo", False, False),
}


def _run(mod, model, name, stream, tracker_cls):
    _, (points, batch), sched, reuse, cache = RUNS[name]
    servable = mod.PointCloudServable(
        model, buckets=mod.ShapeBuckets(points=points, batch=batch),
        plan_cache=cache, frame_reuse=tracker_cls(tol=1e-3) if reuse
        else False)
    eng = mod.ServingEngine(servable, scheduler=sched,
                            clock=mod.VirtualClock(tick_s=1e-3))
    stats = eng.serve_stream(stream, deadline_us=lambda it: (
        2_000 if it[2] % 3 == 0 else 50_000))
    batches, seen = [], set()
    for r in eng.completed:
        if r.t_done not in seen:
            seen.add(r.t_done)
            batches.append([])
        batches[-1].append(r.id)
    return {"stats": stats, "engine": eng.stats(), "batches": batches,
            "logits": {r.id: np.asarray(r.result) for r in eng.completed}}


@pytest.fixture(scope="module")
def jax_runs(setup):
    """The JAX engine's runs, once per module (each jits its step per
    bucket shape)."""
    model = repro.compile_model(setup[2], setup[0], backend="reram-fused",
                                schedule="pointer")
    out = {}
    for name, (kw, *_rest) in RUNS.items():
        out[name] = _run(jserve, model, name, list(j_stream(**kw)),
                         JFrameTracker)
    yield out
    jax.clear_caches()


@pytest.mark.parametrize("name", list(RUNS))
def test_engine_equals_the_jax_engine(models, jax_runs, name):
    model = models[("reram-fused", "pointer", None)]
    stream = list(request_stream(**RUNS[name][0]))
    got, want = _run(tserve, model, name, stream, FrameTracker), jax_runs[name]
    assert got["batches"] == want["batches"]
    assert got["stats"] == want["stats"]
    assert got["engine"] == want["engine"]
    for rid, ref in want["logits"].items():
        row = got["logits"][rid]
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(row, ref, rtol=0, atol=1e-2 * scale)
        assert np.argmax(row) == np.argmax(ref)
    if RUNS[name][4]:
        assert got["stats"]["plan_cache"]["hits"] > 0 \
            or got["stats"]["frame_tracker"]["frame_hits"] > 0


# ---------------------------------------------------------------------------
# counters and refusals
# ---------------------------------------------------------------------------

def test_warm_repeat_adds_no_step_key(models):
    model = models[("reram-fused", "pointer", None)]
    servable = PointCloudServable(
        model, buckets=ShapeBuckets(points=(64,), batch=(1, 2)))
    engine = ServingEngine(servable)
    c = _cloud(64, seed=9)
    engine.submit(c)
    engine.submit(c)
    engine.drain()
    assert servable.jit_traces == 1
    assert servable.trace_shapes == [(2, 64)]
    engine.submit(c)                 # a singleton batch runs at 2, too
    engine.drain()
    assert servable.jit_traces == 1 and servable.batches == 2
    assert servable.plan_cache.stats()["hits"] == 2


@pytest.mark.parametrize("scheduler", ["fifo", "edf"])
def test_oversized_cloud_is_refused_before_the_queue_changes(models,
                                                             scheduler):
    servable = PointCloudServable(
        models[("reram-fused", "pointer", None)],
        buckets=ShapeBuckets(points=(48,), batch=(1,)))
    eng = ServingEngine(servable, scheduler=scheduler)
    eng.submit(_cloud(64))
    with pytest.raises(ValueError, match="exceeds"):
        eng.step()
    assert len(eng.queue) == 1 and servable.batches == 0


def test_mesh_and_unplanned_options_are_refused(models):
    model = models[("reram-fused", "pointer", None)]
    with pytest.raises(ValueError, match="replica"):
        PointCloudServable(model, mesh=object())
    with pytest.raises(ValueError, match="frame_reuse"):
        PointCloudServable(model, plan_cache=False, frame_reuse=True)


def test_graph_key_is_batch_points_and_plan_kind(models):
    """One capture per batch size, point count and kind of plan."""
    model = models[("reram-fused", "pointer", None)]
    step = model._batched_step
    x = torch.zeros((2, 64, 3))
    nv = torch.full((2,), 64, dtype=torch.int32)
    single = model.build_device_plan(_cloud(64))
    batched = repro_torch.DevicePlan.stack([single, single])
    keys = [graph_key(step, (x, nv, None)), graph_key(step, (x, nv, batched)),
            graph_key(step, (x, nv, single)),
            graph_key(step, (torch.zeros((4, 64, 3)), nv, None)),
            graph_key(step, (torch.zeros((2, 48, 3)), nv, None))]
    assert len(set(keys)) == len(keys)
    other = repro_torch.DevicePlan.stack([model.build_device_plan(
        _cloud(64, seed=5))] * 2)
    assert graph_key(step, (x + 1, nv, other)) == keys[1]
