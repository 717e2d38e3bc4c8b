"""The comparison that decides ``correct``: the reference against the
program's CPU path, the control, and a run whose timed path is broken."""
import time

import pytest
import torch

from benchlib import harness, inputs, judge, manifest, program

ROOT = manifest.BENCH.parent
MAN = manifest.load(ROOT)
#: a run of each traffic kind: the offline cell of the manifest, and the
#: served cell that waits for the engine's growing history to be bounded
#: (PERF.md), with the end-to-end metric it would report
CELLS = {"offline": (manifest.cell(MAN, "model1.offline_b128"),
                     manifest.end_to_end(MAN, "model1.offline_b128")),
         "fleet": ({"name": "model1.fleet_serve", "config": "model1",
                    "traffic": "fleet_s14", "chips": 1},
                   [{"name": "latency_p95_ms", "unit": "ms"},
                    {"name": "setup_s", "unit": "s"}])}


def _run(tiny, kind, seed=11):
    config, traffic = tiny
    cell, metrics = CELLS[kind]
    return harness.run_cell(cell, config, traffic[kind], metrics,
                            seed=seed, seconds=0.3, trace=False,
                            device="cpu", t_start=time.perf_counter())


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 3])
def test_reference_equals_the_programs_cpu_path(tiny, seed):
    config, _ = tiny
    clouds = inputs.surface_clouds(6, config["n_points"], seed, "cpu")[0]
    weights = inputs.he_weights(config, seed, "cpu")
    model = program.build_model(config, weights, "cpu")
    ref = judge.reference(config).logits(config, weights, clouds)
    assert torch.equal(model.batched_forward(clouds), ref)


def test_the_reference_imports_nothing_of_the_program():
    src = (manifest.BENCH / "references" / "pointnet2_crossbar.py").read_text()
    assert "repro" not in src.replace("reproduc", "")
    assert "import jax" not in src


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_a_sound_run_is_correct(tiny, kind):
    out = _run(tiny, kind)
    assert out["correct"], out["checks"]
    assert out["checks"]["logit_gap"]["value"] == 0.0
    assert set(out["metrics"]) == {m["name"] for m in CELLS[kind][1]}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("kind", sorted(CELLS))
@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 9])
def test_the_control_is_not_correct(tiny, kind, seed):
    from benchlib import control
    with control.in_place_of_the_program():
        out = _run(tiny, kind, seed)
    assert not out["correct"]
    gap = out["checks"]["logit_gap"]["value"]
    assert gap > 3 * tiny[0]["limits"]["logit_gap"], gap


@pytest.mark.parametrize("kind", sorted(CELLS))
@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_a_broken_timed_path_is_not_correct(tiny, kind, fault):
    from benchlib import control
    with control.planted(fault):
        out = _run(tiny, kind)
    assert not out["correct"], out["checks"]


def test_a_request_never_served_is_not_correct(tiny, monkeypatch):
    from benchlib import fleet
    monkeypatch.setitem(tiny[1]["fleet"], "drain_s", 0.0)
    run = fleet.run

    def stalled(env):
        from repro_torch.launch.serve import ServingEngine
        step = ServingEngine.step
        calls = []

        def slow(self, *, now=0.0):
            if now > 0.0:                # in the window: serves once only
                calls.append(now)
                if len(calls) > 1:
                    time.sleep(0.05)
                    return []
            return step(self, now=now)

        monkeypatch.setattr(ServingEngine, "step", slow)
        run(env)

    monkeypatch.setattr(fleet, "run", stalled)
    out = _run(tiny, "fleet")
    assert 0 < out["failed"] < out["attempted"]
    assert out["checks"]["missing"]["value"] == out["failed"]
    assert not out["correct"]


@pytest.mark.parametrize("names,found", [
    (["repro_torch", "repro_torch.models", "numpy"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["jax.numpy", "jaxlib.xla_client", "flax"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "reprox"], [])])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert harness.forbidden_modules(names) == found


@pytest.mark.cuda
def test_reference_equals_the_program_on_the_card(tiny, cuda_device):
    config, _ = tiny
    clouds = inputs.surface_clouds(6, config["n_points"], 7, cuda_device)[0]
    weights = inputs.he_weights(config, 7, cuda_device)
    model = program.build_model(config, weights, cuda_device)
    ref = judge.reference(config).logits(config, weights, clouds)
    assert torch.equal(model.jit_batched_forward(clouds), ref)
