"""The benchmark's own tests (CPU; the card's tests carry ``cuda``):
``python -m pytest portbench/tests -q`` from the repository's root."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a melt small enough for the CPU: 70 trimers, a short descent
TINY = {"args": {"n_mols": 70}, "descent_steps": 50}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")
