"""``scripts/tp_across_cards.py`` on the CPU: the whole script at smoke size
over 4 gloo ranks (``torchrun``, one process a rank), the meshes it picks
at full size, and the rank-sliced draw of the train state it relies on.

On 4 cards the script trains olmoe-1b-7b and gemma-7b at full width over
NCCL; here the same phases run the smoke configs (gemma-7b's with 4 query
and 4 KV heads, one a rank), with every kernel's plain version.
"""
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import flatten  # noqa: E402
from repro_torch.configs import all_archs, get, get_smoke  # noqa: E402
from repro_torch.models.transformer import init_abstract_params, init_params  # noqa: E402
from repro_torch.train.step import train_memory_gb  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "tp_across_cards.py"


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


tp = _module("tp_across_cards", SCRIPT)
cs = _module("chip_smoke", ROOT / "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke_lines():
    """The script at smoke size over 4 gloo ranks: (exit code, rank 0's
    JSON lines, the tail of the ranks' errors)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", str(SCRIPT), "--smoke", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    return proc.returncode, lines, proc.stderr[-4000:]


def test_the_script_runs_every_phase_at_smoke_size(smoke_lines):
    """Exit 0; for both default architectures an agreement line, a steps
    line for each (data, model) mesh of 4 ranks with a model axis and a
    decode line, each agreeing with one rank; finite losses."""
    rc, lines, err = smoke_lines
    assert rc == 0, err
    by_phase = {}
    for line in lines:
        assert line["ranks"] == 4 and line["device"] == "cpu"
        by_phase.setdefault(line["phase"], []).append(line)
    want = [f"{a}-smoke" for a in tp.ARCHS]
    assert [line["arch"] for line in by_phase["agreement"]] == want
    assert [line["arch"] for line in by_phase["decode"]] == want
    assert [(line["arch"], line["mesh"]["data"], line["mesh"]["model"])
            for line in by_phase["steps"]] == [
        (a, d, m) for a in want for d, m in ((1, 4), (2, 2))]
    for line in by_phase["agreement"] + by_phase["decode"]:
        assert line["agrees"] is True, line
    for line in by_phase["agreement"]:
        assert line["mesh"] == {"data": 1, "model": 4} and line["split_leaves"] > 0
    for line in by_phase["steps"]:
        assert math.isfinite(line["loss"]) and line["ok"] is True
        assert line["batch"] == line["mesh"]["data"] * tp.ROWS
    for line in by_phase["decode"]:
        assert len(line["per_rank"]) == 4
        assert all(r["cache_shard_shapes_equal"] for r in line["per_rank"])
        # two sums over model a layer and the logits' head
        assert line["collectives_a_step"]["all-reduce"]["count"] > 0
        assert line["ms_a_step"] > 0 and line["one_card_ms_a_step"] > 0
        assert line["tokens_per_s"] == pytest.approx(
            1e3 * line["slots"] / line["ms_a_step"])


def test_full_size_meshes_are_the_ones_train_memory_gb_fits():
    """On 4 cards and chip_smoke's 72 GB budget: gemma-7b at (1, 4) only
    (78.3 GB at (2, 2)), olmoe-1b-7b at (1, 4) and (2, 2); the reckoning
    is ``train_memory_gb``'s, model 4 first."""
    budget = cs.TRAIN_BUDGET_GB

    def fits(arch):
        return [(d, m) for d, m, _, ok in tp.step_meshes(get(arch), 4, budget) if ok]

    assert fits("gemma-7b") == [(1, 4)]
    assert fits("olmoe-1b-7b") == [(1, 4), (2, 2)]
    meshes = tp.step_meshes(get("gemma-7b"), 4, budget)
    assert [(d, m) for d, m, _, _ in meshes] == [(1, 4), (2, 2)]
    for d, m, gb, _ in meshes:
        assert gb == train_memory_gb(get("gemma-7b"), d, m)["total_gb"]
    assert meshes[1][2] == pytest.approx(78.33, abs=0.01)
    assert not any(ok for *_, ok in tp.step_meshes(get("qwen2-moe-a2.7b"), 4, budget))


@pytest.mark.parametrize("arch", all_archs())
def test_the_refusal_names_a_mesh_the_script_runs(arch):
    """Where launch.train's refusal sends a configuration to the script
    (the fewest cards that fit it are 4), the mesh it names, (data 1,
    model 4), is one the script trains at chip_smoke's budget, with the
    same reckoning; elsewhere the refusal does not name the script."""
    from repro_torch.launch import train as train_cli
    cfg = get(arch)
    cards, text = train_cli._tensor_parallel_fit(cfg, 85.0)
    if cards != train_cli.TP_SCRIPT_CARDS:
        assert "tp_across_cards" not in text
        return
    fits = [(d, m, gb) for d, m, gb, ok in tp.step_meshes(cfg, cards, cs.TRAIN_BUDGET_GB)
            if ok]
    d, m, gb = fits[0]
    assert (d, m) == (1, cards)
    assert f"trains it on {cards} cards at (data 1, model {cards}), ~{gb:.1f} GB" in text
    assert text.endswith(f"scripts/tp_across_cards.py --arch {arch}")


def test_every_leaf_the_agreement_gathers_is_a_parameter():
    """The agreement phase's leaves are paths of each architecture's tree."""
    for arch, leaves in tp.LEAVES.items():
        paths = set(flatten(init_abstract_params(get(arch))))
        assert set(leaves) <= paths, arch


@pytest.mark.parametrize("arch", all_archs())
def test_a_placed_init_draws_the_same_leaves(arch):
    """``init_params`` with ``place`` hands every leaf to it once, under its
    path, as soon as it is made, with the values of the plain init (the
    same draws in the same order): what lets ``init_train_state`` keep a
    rank's slices without the whole tree."""
    cfg = get_smoke(arch)
    gen = torch.Generator()
    gen.manual_seed(0)
    want = flatten(init_params(cfg, gen))
    gen.manual_seed(0)
    seen = []

    def place(path, leaf):
        seen.append(path)
        return leaf[:1].clone() if leaf.dim() else leaf.clone()

    got = flatten(init_params(cfg, gen, place))
    assert sorted(seen) == sorted(want) and list(got) == list(want)
    for path, leaf in want.items():
        assert torch.equal(got[path], leaf[:1] if leaf.dim() else leaf), path
