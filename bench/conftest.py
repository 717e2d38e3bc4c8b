import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none")


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, when a test
    asks, never while a module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def tiny():
    """model1's configuration file at a size the CPU runs in a second, and
    the cells' traffic cut to match: ``(config, {traffic kind: traffic})``."""
    import json
    import pathlib
    bench = pathlib.Path(__file__).resolve().parent
    config = json.loads((bench / "configs" / "model1.json").read_text())
    config.update(n_points=64, head=[64, 256, 40], layers=[
        {"n_centers": 16, "n_neighbors": 4, "mlp": [8, 16, 16, 32]},
        {"n_centers": 8, "n_neighbors": 4, "mlp": [32, 32, 32, 64]}])
    offline = json.loads((bench / "traffic" / "offline_b128.json")
                         .read_text())
    offline.update(batch=4, pool_batches=3, sample_batches=2)
    fleet = json.loads((bench / "traffic" / "fleet_s14.json").read_text())
    # a sound run ends when its last request is served: the long drain
    # only keeps a CPU that other tests load from counting requests missing
    fleet.update(sensors=3, objects_mean=4, pool_clouds=64,
                 sample_requests=16, drain_s=120.0,
                 buckets={"points": [64], "batch": [1, 2, 4]})
    return config, {"offline": offline, "fleet": fleet}
