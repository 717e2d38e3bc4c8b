import os
import sys

# Tests must see exactly ONE CPU device (the dry-run forces 512 in its own
# process); also keep compilation deterministic and quiet.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none")
