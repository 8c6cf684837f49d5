"""CPU tests of the benchmark; the tests marked ``gpu`` need a CUDA card and
skip without one (see README.md)."""
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: runs the benchmark on a CUDA card; skips without one")
