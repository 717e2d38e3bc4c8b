"""The port's simulator against the JAX package's: its copies of the NumPy
modules (``core/buffer.py``, ``core/reram.py``, ``core/simulator.py`` and
``core/energy.py::HWParams``) give the reference's numbers exactly, every
design point of every paper model included, over the port's own host
planner and workload. Also the roofline constants: the H100's derived from
the card's published figures, the TPU's kept as the reference's."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import buffer as j_buffer                          # noqa: E402
from repro.core import energy as j_energy                          # noqa: E402
from repro.core import reram as j_reram                            # noqa: E402
from repro.core import simulator as j_sim                          # noqa: E402
from repro.core.schedule import build_plan as j_build_plan         # noqa: E402
from repro.core.workload import PAPER_MODELS as J_MODELS           # noqa: E402
from repro.core.workload import PointNetWorkload as JWorkload      # noqa: E402
from repro_torch.core import buffer, energy, reram, simulator      # noqa: E402
from repro_torch.core.schedule import MODE_PRESETS, build_plan     # noqa: E402
from repro_torch.core.workload import (PAPER_MODELS,               # noqa: E402
                                       PointNetWorkload)

MODELS = ("model0", "model1", "model2")


@pytest.fixture(scope="module")
def workloads():
    return {m: (JWorkload.random(J_MODELS[m], seed=0),
                PointNetWorkload.random(PAPER_MODELS[m], seed=0))
            for m in MODELS}


def _same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for prop in ("time_us", "energy_uj", "total_dram_bytes"):
        assert getattr(a, prop) == getattr(b, prop), prop


@pytest.mark.parametrize("design", list(simulator.DESIGN_POINTS))
@pytest.mark.parametrize("model", MODELS)
def test_run_design_equals_jax(workloads, model, design):
    assert simulator.DESIGN_POINTS == j_sim.DESIGN_POINTS
    jwl, twl = workloads[model]
    _same(j_sim.run_design(jwl, design), simulator.run_design(twl, design))


@pytest.mark.parametrize("kw", [
    {"policy": "fifo"}, {"policy": "lru", "buffer_bytes": 512 * 64},
    {"policy": "belady", "overlap": True},
    {"engine": "mac", "mac_group": 4},
    {"engine": "reram", "parallel_layers": True, "overlap": True},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_simulate_options_equal_jax(workloads, kw):
    jwl, twl = workloads["model0"]
    mode = MODE_PRESETS["pointer"]
    _same(j_sim.simulate(jwl, j_build_plan(jwl, **mode), **kw),
          simulator.simulate(twl, build_plan(twl, **mode), **kw))


def test_simulate_rejects_unknown_engine(workloads):
    _, twl = workloads["model0"]
    with pytest.raises(ValueError, match="unknown engine"):
        simulator.simulate(twl, build_plan(twl), engine="gpu")


def test_buffer_models_equal_jax():
    rng = np.random.default_rng(0)
    refs = [(int(k), int(s)) for k, s in zip(rng.integers(0, 40, 400),
                                              rng.integers(8, 200, 400))]
    for policy in ("lru", "fifo"):
        a, b = j_buffer.BufferModel(1024, policy), buffer.BufferModel(
            1024, policy)
        assert [a.access(k, s) for k, s in refs] == [
            b.access(k, s) for k, s in refs]
        assert a.used_bytes == b.used_bytes
    keys = [k for k, _ in refs]
    a = j_buffer.BeladyBuffer(1024, keys)
    b = buffer.BeladyBuffer(1024, keys)
    assert [a.access(k, s) for k, s in refs] == [
        b.access(k, s) for k, s in refs]
    with pytest.raises(ValueError, match="unknown policy"):
        buffer.BufferModel(10, "mru")


@pytest.mark.parametrize("model", MODELS)
def test_crossbar_mapping_equals_jax(model):
    want = j_reram.map_mlp_to_arrays(J_MODELS[model])
    got = reram.map_mlp_to_arrays(PAPER_MODELS[model])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.fits and got.utilization == want.utilization


def test_functional_crossbar_model_equals_jax():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(40, 24))
    x = rng.integers(-127, 128, size=(7, 40))
    (wi, s), (wj, sj) = reram.quantize_weights(w), j_reram.quantize_weights(w)
    assert s == sj and np.array_equal(wi, wj)
    planes = reram.bit_slice(wi)
    assert np.array_equal(planes, j_reram.bit_slice(wj))
    got = reram.crossbar_matmul(x, planes)
    assert np.array_equal(got, j_reram.crossbar_matmul(x, planes))
    assert np.array_equal(got, x @ wi)         # the crossbar is exact
    with pytest.raises(ValueError, match="NaN/Inf"):
        reram.quantize_weights(np.array([1.0, np.nan]))


def test_hw_params_equal_jax():
    a, b = energy.DEFAULT_HW, j_energy.DEFAULT_HW
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for prop in ("n_arrays", "dram_bytes_per_cycle", "cells_per_weight",
                 "weights_per_array"):
        assert getattr(a, prop) == getattr(b, prop), prop


def test_roofline_tpu_constants_are_the_references():
    tpu, ref = energy.TPU_ROOFLINE, j_energy.DEFAULT_ROOFLINE
    for f in dataclasses.fields(ref):
        assert getattr(tpu, f.name) == getattr(ref, f.name), f.name
    assert tpu.hbm_bytes_per_cycle == ref.hbm_bytes_per_cycle


def test_roofline_h100_derived_from_published_figures():
    h = energy.DEFAULT_ROOFLINE
    assert h == energy.RooflineParams()
    # 1,979 dense int8 TOP/s, 3.35 TB/s, 228 KB of shared memory per SM
    peak = 2 * h.mxu_macs_per_cycle * h.freq_ghz * 1e9
    assert abs(peak / 1979e12 - 1) < 1e-3
    assert h.mxu_macs_per_cycle == h.sms * 4096
    assert h.hbm_bytes_per_cycle * h.freq_ghz * 1e9 == 3.35e12
    assert h.vmem_bytes == 228 * 1024
