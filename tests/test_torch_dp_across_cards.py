"""``scripts/dp_across_cards.py`` on the CPU: the script at smoke size over
4 gloo ranks (``torchrun``, one process a rank).

On 4 cards it trains gemma3-1b at full width over NCCL, each step after
the first one replay of a captured CUDA graph; here its phases run the
smoke config with every kernel's plain version, and the graphed step
(``GraphedTrainStep``, eager on its fixed buffers on the CPU) against the
eager step, bit-equal; the steps' times, peaks and profiles are left out.
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
    assert sorted(lines) == ["agreement", "n_micro", "n_micro_agreement", "steps"]
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


def test_steps_hold_the_graphed_step_against_the_eager_step(smoke_lines):
    """The steps phase: eager, graphed and eager runs from one seed, the
    graphed bit-equal to the eager on the CPU on every rank, with the same
    launches (none of a kernel on the CPU) and collectives a step (the
    gradients' all-reduces over data); times, peaks and profiles not
    measured off a card."""
    _, lines, _ = smoke_lines
    rec = lines["steps"]
    assert rec["failures"] == [] and rec["bit_equal"] and rec["eager_runs_bit_equal"]
    assert rec["batch"] == 16 and len(rec["per_rank"]) == 4
    assert all(r["bit_equal"] and not r["failures"] for r in rec["per_rank"])
    assert rec["launches_a_step"] == {"flash_attention": 0, "flash_attention_bwd": 0}
    count, nbytes = rec["collectives_a_step"]["all-reduce data"]
    assert count > 0 and nbytes > 0
    assert len(rec["graphed_step_seconds"]) == len(rec["eager_step_seconds"]) == 3
    assert rec["graphed_step_ms"] is None and rec["graphed_profile"] is None
    assert rec["capture_s"] == 0 and rec["replay_launches"] == {}
    assert rec["graphed_rel_err"] == [{"loss": 0.0, "grad_norm": 0.0}] * 3


def test_n_micro_graphed_runs_agree_with_eager_runs(smoke_lines):
    """launch.train at n_micro 1 and 2 through its graphed step class and
    the same class run eagerly: 3 steps each, bit-equal on the CPU (where
    launch.train reports ``graphed`` False), and each step's collectives
    the same, at n_micro 2 the two all-to-alls over data among them."""
    _, lines, _ = smoke_lines
    rec = lines["n_micro_agreement"]
    assert rec["graph_passed"] and rec["bit_equal"] == {"1": True, "2": True}
    for n in ("1", "2"):
        graphed, eager = rec["runs"][n]["graphed"], rec["runs"][n]["eager"]
        assert graphed["graphed"] is False and len(graphed["metrics"]) == 3
        assert graphed["collectives"] == eager["collectives"]
        for step in graphed["collectives"]:
            assert step["all-reduce data"][0] > 0
            assert ("all-to-all data" in step) == (n == "2")
            if n == "2":
                assert step["all-to-all data"][0] == 2
