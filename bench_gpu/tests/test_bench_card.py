"""Each cell and its control on the CUDA card, short runs through the
command line: the check passes on the port and fails on the control. Skips
without a card, and a cell that asks for more cards than there are."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench_gpu import spec

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture
def cards(card, cell):
    import torch

    chips = spec.workload(cell)["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} CUDA cards")


def run(module, cell, seed, trace=0):
    r = subprocess.run([sys.executable, "-m", module, "--workload", cell,
                        "--seed", str(seed), "--seconds", "2", "--trace",
                        str(trace)], cwd=REPO, capture_output=True, text=True,
                       timeout=1500)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cards, cell):
    res = run("bench_gpu.run", cell, 2**31 + 101)
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["count"] == spec.workload(cell)["chips"]
    assert res["metrics"]["verifies_per_s"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cards, cell):
    res = run("bench_gpu.control", cell, 2**31 + 102)
    assert not res["correct"]
    assert res["checks"]["wrong_verdicts"]["value"] > 0


@pytest.mark.card
def test_sharded_cell_two_gloo_ranks_on_one_card(card, sharded_cell):
    """The four-card cell's whole run at its full size on one card, as two
    ranks over gloo (NCCL refuses two ranks on one card): the rank
    machinery on the card where no four are at hand."""
    from bench_gpu import harness

    res = harness.run_cell(sharded_cell, 2**31 + 103, 2, False,
                           overrides={"backend": "gloo", "chips": 2})
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 2
