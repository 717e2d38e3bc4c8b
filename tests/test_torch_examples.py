"""The port's twins of the JAX package's examples that have no other test:
``examples/serve_pointcloud_torch.py`` (the served stream held to the
per-request ``forward`` inside the example, bit for bit on 'reram-fused'
and within 1e-5 of the largest logit on 'float') and
``examples/accelerator_ablation_torch.py`` (every row of the design sweep
equal to the reference simulator's), on the CPU."""
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _example(name: str):
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(ROOT / "examples"))


@pytest.mark.parametrize("backend", ["reram-fused", "float"])
def test_serve_pointcloud_example_serves_the_stream(capsys, backend):
    stats = _example("serve_pointcloud_torch").main(
        ["--device", "cpu", "--backend", backend, "--requests", "12"])
    assert stats["n_requests"] == 12
    assert stats["plan_cache"]["hits"] > 0
    assert "check vs per-request forward: OK" in capsys.readouterr().out


def test_accelerator_ablation_example_is_the_references_sweep(capsys):
    pytest.importorskip("jax")
    from repro.core import PAPER_MODELS as J_MODELS
    from repro.core import PointNetWorkload as JWorkload
    from repro.core import run_design as j_run_design
    rows = _example("accelerator_ablation_torch").main()
    assert "buffer-size sweep" in capsys.readouterr().out
    for name, cfg in J_MODELS.items():
        wl = JWorkload.random(cfg, seed=0)
        for (model, design, policy), got in rows.items():
            if model != name:
                continue
            want = j_run_design(wl, design, policy=policy)
            assert got.cycles == want.cycles, (model, design, policy)
            assert got.energy_j == want.energy_j, (model, design, policy)
            assert got.traffic == want.traffic, (model, design, policy)
