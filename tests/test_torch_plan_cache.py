"""The port's plan cache and frame tracker against the JAX package's:
``cloud_content_key`` and ``frame_fingerprint`` give the reference's hex
strings, bit for bit, on padded, permuted, re-typed and re-shaped clouds
(and on torch tensors, pulled to the host once); ``PlanCache`` and
``FrameTracker`` count, evict and re-anchor as the reference's do over the
same sequence of operations; ``DevicePlan.stack`` validates as the
reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import schedule as jsched                          # noqa: E402
from repro_torch.core import schedule as tsched                    # noqa: E402
from repro_torch.core.schedule import (DevicePlan, FrameTracker,   # noqa: E402
                                       PlanCache, cloud_content_key,
                                       frame_fingerprint)


def _cloud(n, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(dtype)


def _variants():
    """(name, cloud, n_valid) — the shapes a key meets in serving."""
    base = _cloud(48, seed=1)
    padded = np.concatenate([base, np.zeros((16, 3), np.float32)])
    junk = np.concatenate([base, _cloud(16, seed=9)])
    perm = base[np.random.default_rng(2).permutation(48)]
    return [
        ("bare", base, None),
        ("padded_trimmed", padded, 48),
        ("junk_padded_trimmed", junk, 48),
        ("padded_untrimmed", padded, None),
        ("permuted", perm, None),
        ("float64", base.astype(np.float64), None),
        ("float16", base.astype(np.float16), None),
        ("other_shape", _cloud(40, seed=1), None),
        ("two_columns", base[:, :2].copy(), None),
        ("fortran_order", np.asfortranarray(base), None),
        ("trim_to_zero", base, 0),
        ("jittered", base + np.float32(3e-4), None),
    ]


VARIANTS = _variants()


@pytest.mark.parametrize("name,cloud,n_valid", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_content_key_is_the_reference_string(name, cloud, n_valid):
    want = jsched.cloud_content_key(cloud, n_valid=n_valid)
    assert cloud_content_key(cloud, n_valid=n_valid) == want
    assert cloud_content_key(torch.from_numpy(np.ascontiguousarray(cloud)),
                             n_valid=n_valid) == want


@pytest.mark.parametrize("cell", [1e-3, 0.25])
@pytest.mark.parametrize("name,cloud,n_valid", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_fingerprint_is_the_reference_string(name, cloud, n_valid, cell):
    want = jsched.frame_fingerprint(cloud, n_valid=n_valid, cell=cell)
    assert frame_fingerprint(cloud, n_valid=n_valid, cell=cell) == want
    assert frame_fingerprint(torch.from_numpy(np.ascontiguousarray(cloud)),
                             n_valid=n_valid, cell=cell) == want


def test_keys_tell_the_variants_apart():
    """Row order, dtype, shape and any real byte change miss; pads do
    not (the contract behind the strings above)."""
    keys = {name: cloud_content_key(c, n_valid=nv)
            for name, c, nv in VARIANTS}
    assert keys["padded_trimmed"] == keys["junk_padded_trimmed"] \
        == keys["bare"] == keys["fortran_order"]
    others = [keys[n] for n in ("padded_untrimmed", "permuted", "float64",
                                "float16", "other_shape", "two_columns",
                                "trim_to_zero", "jittered")]
    assert len(set(others + [keys["bare"]])) == len(others) + 1
    with pytest.raises(ValueError, match="cell"):
        frame_fingerprint(VARIANTS[0][1], cell=0.0)


def _drive_cache(mod, capacity, ops):
    cache = mod.PlanCache(capacity=capacity)
    seen = []
    for op, key in ops:
        if op == "get":
            seen.append(cache.get(key))
        elif op == "put":
            cache.put(key, f"plan-{key}")
        elif op == "build":
            seen.append(cache.get_or_build(key, lambda k=key: f"built-{k}"))
        else:
            cache.clear()
        seen.append((len(cache), key in cache, cache.stats()))
    return seen


CACHE_OPS = [
    [("get", "a"), ("put", "a"), ("get", "a"), ("build", "b"),
     ("build", "b"), ("build", "c"), ("get", "a"), ("build", "d"),
     ("get", "b"), ("clear", None), ("get", "a"), ("build", "a")],
    [("put", "x"), ("put", "y"), ("put", "x"), ("put", "z"), ("get", "y"),
     ("get", "x"), ("build", "w"), ("get", "z")],
]


@pytest.mark.parametrize("capacity", [1, 2, 3])
@pytest.mark.parametrize("ops", CACHE_OPS, ids=["mixed", "refresh"])
def test_plan_cache_counts_and_evicts_as_the_reference(capacity, ops):
    assert _drive_cache(tsched, capacity, ops) \
        == _drive_cache(jsched, capacity, ops)


def test_plan_cache_lru_and_counters():
    cache = PlanCache(capacity=2)
    assert cache.get("a") is None
    cache.put("a", "A")
    cache.put("b", "B")
    assert cache.get("a") == "A"            # a is now the most recent
    cache.put("c", "C")                     # evicts b, the coldest
    assert "b" not in cache and "a" in cache and "c" in cache
    assert cache.get_or_build("b", lambda: "B2") == "B2"
    s = cache.stats()
    assert (s["hits"], s["misses"], s["evictions"], s["size"]) == (1, 2, 2, 2)
    assert s["hit_rate"] == pytest.approx(1 / 3)
    cache.clear()
    assert len(cache) == 0 and cache.stats()["misses"] == 2
    assert PlanCache().stats()["hit_rate"] == 0.0
    with pytest.raises(ValueError, match="capacity"):
        PlanCache(capacity=0)


def _drive_tracker(mod, tol, clouds):
    tracker = mod.FrameTracker(tol=tol)
    out = []
    for i, (cloud, n_valid) in enumerate(clouds):
        plan = tracker.lookup(cloud, n_valid=n_valid)
        if plan is None:
            tracker.update(cloud, f"plan-{i}", n_valid=n_valid)
        out.append((plan, tracker.stats()))
        if i == 5:
            tracker.clear()
    return out


def _frames():
    a = _cloud(64, seed=0)
    pad = np.concatenate([a + np.float32(2e-5),
                          np.ones((8, 3), np.float32)])
    return [(a, None), (a + np.float32(1e-5), None), (pad, 64),
            (a + np.float32(5e-4), None), (a + np.float32(1.0), None),
            (a + np.float32(1.0), None), (a, None), (a.astype(np.float64),
                                                     None),
            (_cloud(48, seed=0), None), (a + np.float32(9e-4), None)]


@pytest.mark.parametrize("tol", [1e-3, 1e-6, 10.0])
def test_frame_tracker_counts_as_the_reference(tol):
    assert _drive_tracker(tsched, tol, _frames()) \
        == _drive_tracker(jsched, tol, _frames())


def test_frame_tracker_reanchors_and_validates():
    tracker = FrameTracker(tol=1e-3)
    a = _cloud(64, seed=0)
    assert tracker.lookup(a) is None                  # no anchor yet
    tracker.update(a, "plan-a")
    assert tracker.lookup(a + np.float32(1e-5)) == "plan-a"
    far = a + np.float32(1.0)
    assert tracker.lookup(far) is None                # beyond tol
    tracker.update(far, "plan-b")
    assert tracker.lookup(torch.from_numpy(far)) == "plan-b"   # re-anchored
    s = tracker.stats()
    assert (s["frame_hits"], s["frame_misses"], s["reanchors"]) == (2, 2, 2)
    assert s["fingerprint_hits"] >= 1         # the exact re-read of far
    tracker.clear()
    assert tracker.lookup(far) is None
    with pytest.raises(ValueError, match="tol"):
        FrameTracker(tol=0.0)
    with pytest.raises(ValueError, match="cell"):
        FrameTracker(tol=1e-3, cell=-1.0)


def _plan(sizes=(6, 3), seed=0):
    rng = np.random.default_rng(seed)
    orders = [torch.from_numpy(rng.permutation(n).astype(np.int32))
              for n in sizes]
    inverses = [torch.argsort(o).to(torch.int32) for o in orders]
    return DevicePlan(orders, inverses, sizes, intra="greedy",
                      coordinated=True)


def test_device_plan_stack_batches():
    plans = [_plan(seed=s) for s in range(3)]
    stacked = DevicePlan.stack(plans)
    assert stacked.batched and stacked.batch_size == 3
    assert (stacked.intra, stacked.coordinated) == ("greedy", True)
    for k in (1, 2):
        for b, p in enumerate(plans):
            assert torch.equal(stacked.order_of(k)[b], p.order_of(k))
            assert torch.equal(stacked.inverse_of(k)[b], p.inverse_of(k))


@pytest.mark.parametrize("case", ["empty", "batched", "sizes"])
def test_device_plan_stack_refuses_as_the_reference(case):
    if case == "empty":
        plans, match = [], "at least one"
    elif case == "batched":
        plans, match = [DevicePlan.stack([_plan(), _plan()])], "single-cloud"
    else:
        plans, match = [_plan(), _plan(sizes=(6, 4))], "layer sizes"
    with pytest.raises(ValueError, match=match):
        DevicePlan.stack(plans)
    jplans = [jsched.DevicePlan([o.numpy() for o in p.orders],
                                [i.numpy() for i in p.inverses],
                                p.layer_sizes) for p in plans]
    with pytest.raises(ValueError, match=match):
        jsched.DevicePlan.stack(jplans)
