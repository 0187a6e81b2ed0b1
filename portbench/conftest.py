"""pytest settings of the benchmark's own tests (``python -m pytest portbench``).

The ``chip`` marker is for tests that need a CUDA card; each decides at
run time, in its body, and skips here with a reason.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips with a reason where there is none")
