"""One short run of each cell on the card, through the command the
benchmark is run by: it prints one result line, correct, with the
cell's end-to-end metrics. Skips where there is no card."""

import json
import subprocess
import sys

import pytest

from h100_bench.spec import Bench
from conftest import REPO

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("workload", [w["name"] for w in Bench(
    REPO).spec["workloads"]])
def test_a_cell_runs_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU "
                    "mode")
    out = subprocess.run(
        [sys.executable, "-m", "h100_bench.run", "--workload", workload,
         "--seed", str(2 ** 31 + 99), "--seconds", "10", "--trace", "0"],
        cwd=str(REPO), capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    names = {m["name"] for m in Bench(REPO).metrics(workload, False)}
    assert names <= set(res["metrics"])
