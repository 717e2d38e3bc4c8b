"""The port's boundaries: it never imports JAX or the JAX package, its
entry points want a card unless told ``device="cpu"``, and a tensor on a
device without a kernel is refused rather than run some other way."""
import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro_torch                                                 # noqa: E402
from repro_torch.core.workload import PointNetConfig, SALayerSpec  # noqa: E402
from repro_torch.kernels import aggregate_diff_batched             # noqa: E402
from repro_torch.models.pointnet2 import init_params               # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _tiny():
    return PointNetConfig(name="tiny", n_points=64, layers=(
        SALayerSpec(n_centers=24, n_neighbors=4, in_features=4,
                    mlp=(4, 8, 8, 16)),
        SALayerSpec(n_centers=8, n_neighbors=4, in_features=16,
                    mlp=(16, 16, 16, 32))))


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = ("import sys, repro_torch, repro_torch.kernels, "
            "repro_torch.models.backend, repro_torch.convert, "
            "repro_torch.launch, repro_torch.launch.serve, "
            "repro_torch.data, repro_torch.reliability, "
            "repro_torch.core.policy, repro_torch.core.simulator\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_port_sources(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_compile_without_device_wants_a_card():
    params = init_params(_tiny(), seed=0, n_classes=10)
    if torch.cuda.is_available():
        model = repro_torch.compile_model(params, _tiny())
        assert model.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            repro_torch.compile_model(params, _tiny(), backend="reram-fused",
                                      schedule="pointer")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        repro_torch.compile_model(params, _tiny(), device="meta")


def test_wrapper_refuses_a_device_without_kernel():
    feats = torch.zeros((1, 8, 4), device="meta")
    nbr = torch.zeros((1, 2, 3), dtype=torch.int32, device="meta")
    ctr = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        aggregate_diff_batched(feats, nbr, ctr)


def test_init_params_seeded_he_scaled():
    a = init_params(_tiny(), seed=3, n_classes=10)
    b = init_params(_tiny(), seed=3, n_classes=10)
    assert all(torch.equal(x["w"], y["w"])
               for ma, mb in zip(a["sa"] + [a["head"]], b["sa"] + [b["head"]])
               for x, y in zip(ma, mb))
    w = a["head"][0]["w"]
    assert w.dtype == torch.float32 and tuple(w.shape) == (32, 256)
    assert abs(float(w.std()) - (2.0 / 32) ** 0.5) < 0.05
