"""Each cell and its control on the CUDA card, short runs through the
command line: the check passes on the port and fails on the control. Skips
without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
CELLS = ["cfg4-b8192-valid", "cfg5-chunked-32k", "cfg4-b8192-onebad"]


def run(module, cell, seed, trace=0):
    r = subprocess.run([sys.executable, "-m", module, "--workload", cell,
                        "--seed", str(seed), "--seconds", "2", "--trace",
                        str(trace)], cwd=REPO, capture_output=True, text=True,
                       timeout=1500)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(card, cell):
    res = run("bench_gpu.run", cell, 2**31 + 101)
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["metrics"]["verifies_per_s"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(card, cell):
    res = run("bench_gpu.control", cell, 2**31 + 102)
    assert not res["correct"]
    assert res["checks"]["wrong_verdicts"]["value"] > 0
