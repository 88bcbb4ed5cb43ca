"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
repository's root (the `cuda` ones run only where there is a card)."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.dirname(os.path.dirname(HERE)), os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where there is none)")


def pytest_sessionstart(session):
    # one intra-op thread a worker: the tiny runs gain nothing from more,
    # and parallel workers would oversubscribe the cores
    import torch
    torch.set_num_threads(1)
