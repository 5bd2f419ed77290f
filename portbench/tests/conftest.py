"""The benchmark's own tests: plain references against the port at tiny
sizes, the yardstick's arithmetic, the no-JAX rule, dry runs of every
traffic kind and metric reader on the CPU, the control and planted faults.

    python -m pytest portbench/tests -q
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
