"""On the card: one short run of each cell through the command the
benchmark gives, its last line, and its checks.  Without a CUDA device
the command exits non-zero and prints no result."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _run(workload, seed, seconds=3):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)


@pytest.mark.card
@pytest.mark.parametrize("workload", ["microbe5m_single.wgsim",
                                      "chr21_mg.wgsim"])
def test_cell_runs_on_the_card(cuda_card, workload):
    r = _run(workload, 2**31 + 99)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"reads_per_s", "setup_s"}
    assert r.stderr.strip().splitlines()[-1].startswith("check ")


def test_without_a_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is here")
    r = _run("microbe5m_single.wgsim", 1)
    assert r.returncode == 2
    assert r.stdout.strip() == ""
