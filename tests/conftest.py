import os
import sys

# tests must see exactly ONE device (the dry-run's 512-device trick is
# confined to launch/dryrun.py and subprocess tests)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips with a reason without one")
