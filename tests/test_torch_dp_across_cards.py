"""``scripts/dp_across_cards.py`` on the CPU: the script at smoke size over
4 gloo ranks (``torchrun``, one process a rank).

On 4 cards it trains gemma3-1b at full width over NCCL; here its
agreement and n_micro phases run the smoke config with every kernel's
plain version (the steps phase, a card's timing and profile, is left
out).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "dp_across_cards.py"


@pytest.fixture(scope="module")
def smoke_lines():
    """The script at smoke size over 4 gloo ranks: (exit code, rank 0's
    JSON lines by phase, the tail of the ranks' errors)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", str(SCRIPT), "--smoke", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    lines = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            lines[rec["phase"]] = rec
    return proc.returncode, lines, proc.stderr[-4000:]


def test_the_script_runs_its_cpu_phases(smoke_lines):
    rc, lines, err = smoke_lines
    assert rc == 0, err
    assert sorted(lines) == ["agreement", "n_micro", "n_micro_agreement"]
    agree = lines["agreement"]
    assert agree["ranks"] == 4 and agree["loss_rel_err"] <= 1e-3
    assert agree["grad_norm_rel_err"] <= 1e-2


def test_n_micro_over_four_ranks_agrees_with_one_rank(smoke_lines):
    """n_micro 2 over 4 data ranks against one rank on the concatenated
    batch at n_micro 2 (loss and gradient norm), and against n_micro 1
    (the gradient norm; the loss reported at n_micro 2 is the last
    microbatch's)."""
    _, lines, _ = smoke_lines
    rec = lines["n_micro_agreement"]
    assert rec["passed"] and rec["batch"] == 8
    assert rec["rel_err"]["n_micro 2 vs one rank"]["loss"] <= 1e-3
    assert rec["rel_err"]["n_micro 2 vs one rank"]["grad_norm"] <= 1e-2
    assert rec["rel_err"]["n_micro 1 vs 2"]["grad_norm"] <= 1e-2


def test_n_micro_timing_and_collectives(smoke_lines):
    """The two settings timed in turns (3 steps each after a warm-up), and
    a step's collectives: the gradients' all-reduces at both, and at
    n_micro 2 the all-to-alls that give each rank its share of each
    microbatch (tokens and labels), none at n_micro 1."""
    _, lines, _ = smoke_lines
    rec = lines["n_micro"]
    assert [len(rec["step_seconds"][n]) for n in ("1", "2")] == [3, 3]
    coll = rec["collectives_a_step"]
    assert "all-to-all" not in coll["1"]
    assert coll["2"]["all-to-all"]["count"] == 2 and coll["2"]["all-to-all"]["bytes"] > 0
    assert coll["1"]["all-reduce"]["count"] > 0
    assert rec["peak_gb_per_rank"] is None
    assert rec["reckoned_gb"]["2"] > rec["reckoned_gb"]["1"]
