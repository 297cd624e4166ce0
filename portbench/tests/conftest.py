"""Shared settings of the benchmark's own tests: the ``cuda`` marker for
the tests that need the card (they skip elsewhere, deciding inside the
test), the checkout root on the path, one torch thread, and a tiny size
of a cell for CPU runs."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")


def shrink(cfg: dict, traffic: dict) -> None:
    """A cell at a size a CPU test holds: 64² frames, 3 classes, 2
    iterations, batches of 2 from a pool of 2; every width as published."""
    cfg["image_size"] = [64, 64]
    cfg["model"]["num_class"] = 3
    cfg["model"]["iters"] = cfg["model"]["test_iters"] = 2
    cfg["symmetric_classes"] = [1]
    traffic.update(batch=2, pool=2, focal_px=125.0, warmup_steps=1)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
