"""Percentiles over all requests, and the fleet's arrivals."""
import math

import numpy as np
import pytest

from benchlib import fleet, harness, stats


def test_nearest_rank_over_every_value():
    v = list(range(1, 101))
    assert stats.nearest_rank(v, 95) == 95
    assert stats.nearest_rank(v, 50) == 50
    assert stats.nearest_rank([3.0], 95) == 3.0


def test_a_request_never_served_counts_as_infinitely_late():
    v = [1.0] * 94 + [math.inf] * 6
    assert stats.nearest_rank(v, 95) == math.inf
    assert stats.nearest_rank(v[1:] + [1.0], 95) == math.inf


def test_fleet_latency_runs_from_the_due_time(tiny):
    import torch
    import time
    from types import SimpleNamespace
    from benchlib import inputs
    config, traffic = tiny
    env = SimpleNamespace(config=config, traffic=traffic["fleet"],
                          seed=5, seconds=0.3, trace=False,
                          device=torch.device("cpu"),
                          spans=harness.Spans(False), counters={},
                          mark=lambda name: None)
    env.weights = inputs.he_weights(config, 5, env.device)
    t = time.perf_counter()
    fleet.run(env)
    due, counts, _ = fleet.schedule(env.traffic, 0.3, 5)
    assert env.attempted == counts.sum() and env.failed == 0
    assert np.all(env.latency_s >= env.queue_wait_s)
    assert np.all(env.queue_wait_s >= 0)
    # every latency is later than the due time it is counted from
    assert env.window_start > t
    assert np.all(env.latency_s > 0)


FLEET = {"sensors": 13, "arrivals_seed": 1, "frame_hz": 10.0,
         "rate_spread": 0.02, "objects_mean": 32, "pool_clouds": 64}


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_every_seed_offers_the_same_arrivals_in_another_order(seed):
    a = fleet.schedule(FLEET, 30.0, seed)
    b = fleet.schedule(FLEET, 30.0, seed)
    c = fleet.schedule(FLEET, 30.0, seed + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    # the same frames at the same times, the same set of sizes, dealt and
    # filled with clouds in another order
    assert np.array_equal(a[0], c[0])
    assert np.array_equal(np.sort(a[1]), np.sort(c[1]))
    assert not np.array_equal(a[1], c[1])
    due, counts, order = a
    assert np.all(np.diff(due) >= 0) and 0 <= due[0] and due[-1] < 30.0
    assert len(order) == counts.sum() and order.max() < 64


@pytest.mark.parametrize("arrivals_seed", [2, 3])
def test_the_phases_are_the_traffic_files_draw(arrivals_seed):
    a, _, _ = fleet.schedule(FLEET, 2.0, 5)
    b, _, _ = fleet.schedule(dict(FLEET, arrivals_seed=arrivals_seed), 2.0, 5)
    # not a fixed set: another draw puts the sensors' frames elsewhere,
    # and within one period they fall apart from one another
    assert not np.array_equal(a[:13], b[:13])
    assert len(np.unique(np.round(b[:13], 6))) == 13


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 9])
def test_each_sensor_keeps_its_rate_within_the_spread(seed):
    due, _, _ = fleet.schedule(FLEET, 30.0, seed)
    frames = 13 * 10.0 * 30.0
    assert frames * 0.98 - 13 <= len(due) <= frames * 1.02 + 13


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_a_frames_objects_are_poisson_of_the_mean_and_never_none(seed):
    _, counts, _ = fleet.schedule(FLEET, 30.0, seed)
    assert counts.min() >= 1
    # a Poisson count: mean and variance both near 32, so frames over
    # and under the largest batch both come
    assert abs(counts.mean() - 32) < 1.0
    assert 24 < counts.var() < 40
    assert (counts > 32).any() and (counts < 32).any()
