"""Tests of the benchmark harness. Run them from the root of the repo:

    python3 -m pytest bench_gpu/tests -q

Those marked `card` need a CUDA card and skip without one (decided inside
the test, through the `card` fixture).
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.fixture
def sharded_cell():
    """The four-card cell of config 5 that BENCHMARK.json does not list:
    its runs on four cards spread wider than the widest bound allows
    (PERF.md). The tests run it by its keys."""
    return {"name": "cfg5-sharded-4gpu", "config": "cfg5-sharded",
            "traffic": "onebad-each-chunk", "chips": 4}
