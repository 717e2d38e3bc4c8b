"""The port's serving engine without a model, against the JAX package's:
``VirtualClock``, FIFO and EDF selection, and ``serve_stream`` over one
pure-Python fake servable — the same service order and the same stats on
the same stream, property-tested over random streams (hypothesis when it
is installed, else the seeded sweep of ``tests/_hypothesis_fallback.py``)
— and the data generators (``synthetic_cloud``, ``PointCloudDataset``,
``request_stream`` in both modes), bit for bit."""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # deterministic sweep, see _hypothesis_fallback.py
    from _hypothesis_fallback import given, settings, st

from repro.data import pointcloud as jdata                         # noqa: E402
from repro.launch import serve as jserve                           # noqa: E402
from repro_torch.data import pointcloud as tdata                   # noqa: E402
from repro_torch.launch import serve as tserve                     # noqa: E402
from repro_torch.launch.serve import (EDFScheduler,                # noqa: E402
                                      SCHEDULERS, ServingEngine,
                                      VirtualClock)


class FakeServable:
    """Bucket by payload string length; 'run' is upper-casing."""
    max_batch = 8

    def __init__(self, max_batch=8):
        self.max_batch = max_batch
        self.batches = 0

    def bucket_of(self, payload):
        return len(payload)

    def run_batch(self, payloads):
        self.batches += 1
        return [p.upper() for p in payloads]

    def stats(self):
        return {"batches": self.batches}


def _engine(scheduler, **kw):
    return ServingEngine(FakeServable(), scheduler=scheduler, **kw)


# ---------------------------------------------------------------------------
# VirtualClock
# ---------------------------------------------------------------------------

def test_virtual_clock_ticks_per_monotonic_call():
    vc = VirtualClock(tick_s=0.25)
    assert vc.monotonic() == 0.25
    assert vc.monotonic() == 0.5
    vc.advance(1.0)
    assert vc.monotonic() == 1.75


def test_virtual_clock_zero_tick_and_start():
    vc = VirtualClock(start=3.0)
    assert vc.monotonic() == 3.0 and vc.monotonic() == 3.0


def test_virtual_clock_validation():
    with pytest.raises(ValueError, match="tick_s"):
        VirtualClock(tick_s=-1.0)
    with pytest.raises(ValueError, match="dt"):
        VirtualClock().advance(-0.1)


# ---------------------------------------------------------------------------
# FIFO / EDF selection
# ---------------------------------------------------------------------------

def test_unknown_scheduler_name_raises():
    with pytest.raises(ValueError, match="unknown scheduler"):
        _engine("nope")


def test_registry_names_round_trip():
    assert set(SCHEDULERS) == set(jserve.SCHEDULERS) == {"fifo", "edf"}
    for name, cls in SCHEDULERS.items():
        assert cls.name == name
        assert _engine(name).scheduler.name == name


def test_fifo_same_bucket_skim_preserves_other_buckets():
    eng = _engine("fifo")
    for i, p in enumerate(["aa", "bb", "ccc", "dd"]):
        eng.submit(p, t=float(i))
    batch = eng.step()
    assert [r.payload for r in batch] == ["aa", "bb", "dd"]
    assert [r.result for r in batch] == ["AA", "BB", "DD"]
    assert [r.payload for r in eng.queue] == ["ccc"]  # kept its place


def test_fifo_ignores_deadlines_and_priority():
    eng = _engine("fifo", max_batch=1)
    first = eng.submit("aa", t=0.0)
    eng.submit("bb", t=0.0, deadline_us=1, priority=99)
    assert eng.step()[0] is first


@pytest.mark.parametrize("case", ["deadline", "no_deadline_last",
                                  "priority", "feasible", "aging",
                                  "aging_off"])
def test_edf_selection_rules(case):
    if case == "deadline":
        eng = _engine("edf", max_batch=1)
        eng.submit("aa", t=0.0, deadline_us=100_000)
        want = eng.submit("bb", t=0.0, deadline_us=500)
        now = 0.0
    elif case == "no_deadline_last":
        eng = _engine("edf", max_batch=1)
        eng.submit("aa", t=0.0)
        want = eng.submit("bb", t=0.0, deadline_us=900_000)
        now = 0.0
    elif case == "priority":
        eng = _engine("edf", max_batch=1)
        eng.submit("aa", t=0.0, deadline_us=500)
        want = eng.submit("bb", t=0.0, priority=5)
        now = 0.0
    elif case == "feasible":
        # est 1 ms: the 0.5 ms deadline is a lost cause and must not delay
        # the meetable 100 ms one
        eng = _engine("edf", max_batch=1)
        eng.seed_service_estimate(2, 1e-3)
        want = eng.submit("aa", t=0.0, deadline_us=100_000)
        eng.submit("bb", t=0.0, deadline_us=500)
        now = 0.0
    elif case == "aging":
        eng = _engine(EDFScheduler(aging_s=1.0), max_batch=1)
        want = eng.submit("aa", t=0.0)
        eng.submit("bb", t=5.0, priority=99, deadline_us=10)
        now = 5.0
    else:
        eng = _engine(EDFScheduler(aging_s=None), max_batch=1)
        eng.submit("aa", t=0.0)
        want = eng.submit("bb", t=1000.0, priority=1)
        now = 1000.0
    assert eng.step(now=now)[0] is want


@pytest.mark.parametrize("est2,want", [(1e-2, [1, 1]), (2e-3, [2])])
def test_edf_admission(est2, want):
    """A two-batch that blows the 2 ms budgets stays at one request (the
    second keeps its slot); one that meets them batches both."""
    eng = _engine("edf")
    eng.seed_service_estimate(2, 1e-3, batch_size=1)
    eng.seed_service_estimate(2, est2, batch_size=2)
    eng.submit("aa", t=0.0, deadline_us=2_000)
    eng.submit("bb", t=0.0, deadline_us=2_000)
    assert [len(eng.step(now=0.0)) for _ in want] == want
    assert not eng.queue


def test_edf_admission_protects_admitted_head():
    eng = _engine("edf")
    eng.seed_service_estimate(2, 1e-3, batch_size=1)
    eng.seed_service_estimate(2, 1e-2, batch_size=2)
    tight = eng.submit("aa", t=0.0, deadline_us=2_000)
    eng.submit("bb", t=0.0, deadline_us=500_000)
    assert eng.step(now=0.0) == [tight]
    with pytest.raises(ValueError, match="aging_s"):
        EDFScheduler(aging_s=0.0)


def test_service_estimate_lookup_rules():
    eng = _engine("fifo")
    assert eng.service_estimate(2, 4) == 0.0
    eng.seed_service_estimate(2, 1e-3, batch_size=2)
    eng.seed_service_estimate(2, 4e-3, batch_size=8)
    assert eng.service_estimate(2, 1) == 1e-3
    assert eng.service_estimate(2, 3) == 4e-3
    assert eng.service_estimate(2, 9) == 4e-3
    eng._record_service(2, 2, 2e-3)
    assert eng.service_estimate(2, 2) == pytest.approx(0.7e-3 + 0.6e-3)


def test_queue_and_stats_snapshot():
    eng = _engine("edf")
    a = eng.submit("aa", t=0.0, deadline_us=100)
    b = eng.submit("bb", t=0.0, deadline_us=5)
    assert eng.queue == (a, b)                   # arrival order, not EDF
    assert eng.stats() == {"queued": 2, "completed": 0, "scheduler": "edf",
                           "batches": 0}
    eng.drain(now=1.0)
    assert a.latency == 1.0 and a.missed and b.missed
    assert eng.stats()["completed"] == 2


# ---------------------------------------------------------------------------
# against the reference: the same order and stats on the same stream
# ---------------------------------------------------------------------------

def _random_stream(rng, n):
    t, out = 0.0, []
    for _ in range(n):
        t += rng.random() * 2e-3
        out.append((t, "x" * (2 + rng.randrange(3)),
                    None if rng.random() < 0.3 else rng.random() * 8_000,
                    rng.randrange(3)))
    return out


def _serve(mod, sched, stream, max_batch, tick):
    if sched == "edf":
        sched = mod.EDFScheduler(aging_s=4e-3)
    eng = mod.ServingEngine(FakeServable(max_batch), scheduler=sched,
                            clock=mod.VirtualClock(tick_s=tick))
    stats = eng.serve_stream(stream, deadline_us=lambda it: it[2],
                             priority_of=lambda it: it[3])
    order = [(r.id, r.result, r.t_done) for r in eng.completed]
    return order, stats


@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=1, max_value=24),
       st.integers(min_value=0, max_value=2 ** 31),
       st.sampled_from(["fifo", "edf"]),
       st.integers(min_value=1, max_value=4))
def test_property_serve_stream_equals_the_reference(n, seed, sched,
                                                    max_batch):
    stream = _random_stream(random.Random(seed), n)
    tick = 1e-3 * (1 + seed % 3)
    got = _serve(tserve, sched, stream, max_batch, tick)
    want = _serve(jserve, sched, stream, max_batch, tick)
    assert got == want
    assert got[1]["n_requests"] == n


@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=1, max_value=20),
       st.integers(min_value=0, max_value=2 ** 31))
def test_property_select_equals_the_reference(n, seed):
    """Batch by batch, both disciplines pick the reference's requests at
    the same instants, with the same service estimates."""
    rng = random.Random(seed)
    reqs = [(i, rng.random() * 5e-3,
             None if rng.random() < 0.3 else rng.random() * 20_000,
             rng.randrange(3), "x" * (2 + rng.randrange(2)))
            for i in range(n)]
    for kind in ("fifo", "edf"):
        scheds = {}
        for mod in (tserve, jserve):
            s = (mod.FIFOScheduler() if kind == "fifo"
                 else mod.EDFScheduler(aging_s=0.01))
            for rid, t, dl, prio, p in reqs:
                s.push(mod.Request(id=rid, payload=p, t_arrival=t,
                                   deadline_us=dl, priority=prio))
            scheds[mod] = s
        now = 0.0
        while len(scheds[jserve]):
            picks = [[r.id for r in s.select(
                bucket_of=len, max_batch=3, now=now,
                est_service=lambda b, k: 1e-3 * k)] for s in scheds.values()]
            assert picks[0] == picks[1] and picks[0]
            now += 2e-3
        assert not len(scheds[tserve])


def test_pinned_percentiles_equal_the_reference():
    """The reference's pinned virtual-clock row (12 arrivals at 800 Hz
    against 2 ms batches of one), through the port's engine."""
    stream = [(i / 800.0, "aa", i) for i in range(12)]

    def replay(mod):
        eng = mod.ServingEngine(FakeServable(1), scheduler="fifo",
                                max_batch=1,
                                clock=mod.VirtualClock(tick_s=2e-3))
        eng.seed_service_estimate(2, 2e-3)
        return eng.serve_stream(
            stream, deadline_us=lambda it: 4_000 if it[2] % 3 == 0
            else 100_000)

    got, want = replay(tserve), replay(jserve)
    assert got == want
    assert got["p50_ms"] == pytest.approx(6.125, abs=1e-9)
    assert got["p99_ms"] == pytest.approx(10.1675, abs=1e-9)
    assert got["n_deadline_misses"] == 3 and got["n_deadlined"] == 12


# ---------------------------------------------------------------------------
# the data generators, bit for bit
# ---------------------------------------------------------------------------

STREAMS = [
    dict(n_requests=12, rate_hz=200.0, n_points=(64, 40), pool=3,
         repeat_p=0.7, seed=0),
    dict(n_requests=9, rate_hz=50.0, n_points=(1024, 700), pool=8,
         repeat_p=0.0, seed=3),
    dict(n_requests=7, rate_hz=10.0, n_points=(256,), pool=4, seed=0,
         mode="lidar"),
    dict(n_requests=5, rate_hz=800.0, n_points=(64,), pool=3, seed=2,
         mode="lidar", drift=1e-4, jitter=0.0),
]


@pytest.mark.parametrize("kw", STREAMS,
                         ids=["pool", "pool_no_repeat", "lidar",
                              "lidar_no_jitter"])
def test_request_stream_equals_the_reference(kw):
    got = list(tdata.request_stream(**kw))
    want = list(jdata.request_stream(**kw))
    assert len(got) == len(want) == kw["n_requests"]
    for (tg, cg, lg), (tw, cw, lw) in zip(got, want):
        assert tg == tw and lg == lw
        assert cg.dtype == cw.dtype == np.float32
        assert np.array_equal(cg, cw)


@pytest.mark.parametrize("label", [0, 7, 13, 39])
def test_synthetic_cloud_equals_the_reference(label):
    got = tdata.synthetic_cloud(label, 300, seed=5)
    assert np.array_equal(got, jdata.synthetic_cloud(label, 300, seed=5))


def test_dataset_batches_equal_the_reference():
    kw = dict(n_points=128, n_clouds=50, seed=1)
    got = list(tdata.PointCloudDataset(**kw).batches(3, 2))
    want = list(jdata.PointCloudDataset(**kw).batches(3, 2))
    for (cg, lg), (cw, lw) in zip(got, want):
        assert np.array_equal(cg, cw) and np.array_equal(lg, lw)
    with pytest.raises(NotImplementedError):
        tdata.PointCloudDataset.from_modelnet40("/nonexistent")


def test_request_stream_validation():
    with pytest.raises(ValueError, match="mode"):
        list(tdata.request_stream(1, mode="radar"))
    with pytest.raises(ValueError, match="repeat_p"):
        list(tdata.request_stream(1, repeat_p=1.5))
    with pytest.raises(ValueError, match="drift"):
        list(tdata.request_stream(1, mode="lidar", drift=-1.0))
