"""``scripts/tp_across_cards.py`` on the CPU: the whole script at smoke size
over 4 gloo ranks (``torchrun``, one process a rank), the meshes it picks
at full size, and the rank-sliced draw of the train state it relies on.

On 4 cards the script trains olmoe-1b-7b and gemma-7b at full width over
NCCL, graphed (one captured CUDA graph a step) and eager; here the same
phases run the smoke configs (gemma-7b's with 4 query and 4 KV heads, one
a rank), with every kernel's plain version, the graphed step
(``GraphedTrainStep``, eager on its fixed buffers on the CPU) held
against the eager step, bit-equal.
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


#: the two largest architectures, beside the cells' default ones
NEW_ARCHS = ("qwen2-moe-a2.7b", "internvl2-26b")


def _torchrun(args, timeout=240):
    """``args`` under torchrun over 4 gloo ranks: (exit code, rank 0's JSON
    lines, the tail of the ranks' errors)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", *map(str, args)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    return proc.returncode, lines, proc.stderr[-4000:]


@pytest.fixture(scope="module")
def smoke_lines():
    """The script at smoke size over 4 gloo ranks: (exit code, rank 0's
    JSON lines, the tail of the ranks' errors)."""
    return _torchrun([SCRIPT, "--smoke", "--device", "cpu"])


@pytest.fixture(scope="module")
def cells_lines():
    """The cells phase at smoke size over 4 gloo ranks (its default
    architectures): (exit code, rank 0's JSON lines, the tail of the
    ranks' errors)."""
    return _torchrun([SCRIPT, "--smoke", "--device", "cpu", "--phases", "cells"],
                     timeout=300)


@pytest.fixture(scope="module")
def decode_cells_lines():
    """The decode_cells phase at smoke size over 4 gloo ranks (its default
    architectures): (exit code, rank 0's JSON lines, the tail of the ranks'
    errors)."""
    return _torchrun([SCRIPT, "--smoke", "--device", "cpu", "--phases", "decode_cells"])


@pytest.fixture(scope="module")
def new_archs_lines():
    """The cells and decode_cells phases at smoke size over 4 gloo ranks for
    qwen2-moe-a2.7b and internvl2-26b."""
    return _torchrun([SCRIPT, "--smoke", "--device", "cpu", "--phases", "cells",
                      "decode_cells", "--arch", *NEW_ARCHS])


#: runs the script with chip_smoke.TRAIN_BUDGET_GB and CUT_BUDGET_GB set to
#: its second argument (the repository root its first)
BUDGET_WRAPPER = """
import importlib.util, sys
from pathlib import Path
root, budget = Path(sys.argv[1]), float(sys.argv[2])
sys.path[:0] = [str(root), str(root / "src")]
import chip_smoke
spec = importlib.util.spec_from_file_location("tp_across_cards",
                                              root / "scripts" / "tp_across_cards.py")
tp = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tp)
chip_smoke.TRAIN_BUDGET_GB = tp.CUT_BUDGET_GB = budget
tp.main(sys.argv[3:])
"""


@pytest.fixture(scope="module")
def cut_lines(tmp_path_factory):
    """The cells phase at smoke size for qwen2-moe-a2.7b with both budgets
    between its one-layer and its two-layer reckoning on every mesh: full
    depth refused, the one-layer cut run.  (the budget, the run's lines)"""
    cfg = tp.cell_config("qwen2-moe-a2.7b", True)

    def gb(layers, d, m):
        return train_memory_gb(cs.cut_depth(cfg, layers), d, m, rows=tp.CELL_ROWS,
                               seq=tp.SMOKE_CELL_SEQ)["total_gb"]
    one = max(gb(1, d, m) for d, m in ((1, 4), (2, 2)))
    full = min(gb(2, d, m) for d, m in ((1, 4), (2, 2)))
    assert one < full
    wrapper = tmp_path_factory.mktemp("cut") / "wrapper.py"
    wrapper.write_text(BUDGET_WRAPPER)
    budget = (one + full) / 2
    return budget, _torchrun([wrapper, ROOT, budget, "--smoke", "--device", "cpu",
                              "--phases", "cells", "--arch", "qwen2-moe-a2.7b"])


def test_the_cells_phases_of_the_two_largest_archs_at_smoke_size(new_archs_lines):
    """qwen2-moe-a2.7b (its shared expert and sigmoid gate over model, the
    grouped GEMM at f / 4) and internvl2-26b (2 KV heads a rank under 4
    query heads each, its patch positions all on rank 0's quarter of the
    sequence) at the cell options, both vocabularies short of their
    padding: the agreement with one rank, the train cell graphed against
    eager at (1, 4) and (2, 2), bit-equal, with the sequence's
    reduce-scatter and all-gather over model, the prefill's agreement and
    run, the logits left vocab-sharded; then the decode cell at (1, 4)
    against one card on the whole cache and graphed against eager."""
    rc, lines, err = new_archs_lines
    assert rc == 0, err
    by_phase = {}
    for line in lines:
        by_phase.setdefault(line["phase"], []).append(line)
    want = [f"{a}-smoke" for a in NEW_ARCHS]
    assert set(by_phase) == {"cell_agreement", "cells", "prefill_agreement", "prefill",
                             "decode_cell_agreement", "decode_cells"}
    for phase in ("cell_agreement", "prefill_agreement", "prefill",
                  "decode_cell_agreement", "decode_cells"):
        assert [line["arch"] for line in by_phase[phase]] == want, phase
    for line in by_phase["cell_agreement"]:
        assert line["agrees"] and line["held"] == "master" and line["split_leaves"] > 0
        assert line["replayed_routing"] == (line["routing_flips"] > 0)
        assert set(line["leaf_max_abs_diff_over_lr"]) == set(
            tp.LEAVES[line["arch"].removesuffix("-smoke")])
    assert [(line["arch"], line["mesh"]["data"], line["layers"], line["n_layers"])
            for line in by_phase["cells"]] == [(a, d, 2, 2) for a in want for d in (1, 2)]
    for line in by_phase["cells"]:
        assert line["ok"] and line["bit_equal"] and line["failures"] == []
        assert {"reduce-scatter model", "all-gather model"} <= set(line["collectives_a_step"])
    for line in by_phase["prefill_agreement"]:
        assert line["agrees"] and line["within_bounds"]
    for line in by_phase["prefill"]:
        cfg = tp.cell_config(line["arch"].removesuffix("-smoke"), True)
        assert cfg.vocab_size < cfg.padded_vocab
        assert line["local_logits_shape"] == [tp.PREFILL_ROWS, tp.SMOKE_CELL_SEQ,
                                              cfg.padded_vocab // 4]
    for line in by_phase["decode_cell_agreement"]:
        assert line["agrees"] and line["mesh"] == {"data": 1, "model": 4}
        assert all(r["untouched_equal"] and r["cache_within_rounding"]
                   for r in line["per_rank"])
    for line in by_phase["decode_cells"]:
        assert line["ok"] and line["bit_equal"] and line["failures"] == []
        assert line["mesh"] == {"data": 1, "model": 4}


def test_the_train_cell_runs_its_deepest_cut_where_full_depth_does_not_fit(cut_lines):
    """Where full depth passes the budget the cells phase keeps its
    cells_skipped line, then runs on the same mesh the deepest cut within
    CUT_BUDGET_GB through the same gates: graphed bit-equal to eager, the
    sequence's collectives over model; its line carries the cut's layers
    and the config's n_layers."""
    budget, (rc, lines, err) = cut_lines
    assert rc == 0, err
    skipped = [line for line in lines if line["phase"] == "cells_skipped"]
    cut = [line for line in lines if line["phase"] == "cells"]
    assert [(line["mesh"]["data"], line["layers"]) for line in skipped] == [(1, 2), (2, 2)]
    assert [(line["mesh"]["data"], line["layers"], line["n_layers"]) for line in cut] == [
        (1, 1, 2), (2, 1, 2)]
    for line in cut:
        assert line["ok"] and line["bit_equal"] and line["failures"] == []
        assert line["cut_budget_gb"] == budget and line["reckoned_gb"] <= budget
        assert {"reduce-scatter model", "all-gather model"} <= set(line["collectives_a_step"])
    assert [line["phase"] for line in lines].count("prefill") == 1


@pytest.mark.parametrize("arch", tp.CELL_ARCHS + NEW_ARCHS)
def test_the_cut_rule_at_full_size(arch):
    """At CELL_ROWS x 4096 a data rank and the cell options: qwen2-moe-a2.7b
    and internvl2-26b pass chip_smoke's budget at full depth on both meshes
    of 4 cards, so the cells phase refuses full depth and runs the deepest
    cut within CUT_BUDGET_GB: 16 and 13 of 24 layers, 23 and 19 of 48 at
    (1, 4) and (2, 2); every CELL_ARCHS arch fits whole and keeps its
    full depth."""
    from repro_torch.models.config import SHAPES
    cfg = tp.cell_config(arch, False)
    seq = SHAPES["train_4k"].seq_len
    meshes = tp.step_meshes(cfg, 4, cs.TRAIN_BUDGET_GB, tp.CELL_ROWS, seq)
    if arch in tp.CELL_ARCHS:
        assert all(fits for *_, fits in meshes)
        return
    assert [(d, m) for d, m, _, fits in meshes if not fits] == [(1, 4), (2, 2)]
    cuts = [tp.cut_layers(cfg, d, m, tp.CELL_ROWS, seq, tp.CUT_BUDGET_GB)
            for d, m, _, _ in meshes]
    assert cuts == {"qwen2-moe-a2.7b": [16, 13], "internvl2-26b": [23, 19]}[arch]
    for (d, m, _, _), layers in zip(meshes, cuts):
        def gb(n):
            return train_memory_gb(cs.cut_depth(cfg, n), d, m, rows=tp.CELL_ROWS,
                                   seq=seq)["total_gb"]
        assert gb(layers) <= tp.CUT_BUDGET_GB < gb(layers + 1)
    assert tp.CUT_BUDGET_GB < cs.TRAIN_BUDGET_GB


def test_the_prefill_gate_holds_the_recorded_prefill_peaks():
    """The dry run's reckoning of the reference's prefill_32k rank at 16x4,
    the prefill cell's gate, against each rank-0 peak the cells phase
    recorded on the cards (olmoe-1b-7b 15.32, gemma-7b 13.36, deepseek-7b
    7.82 GB; PERF.md §5): within DRYRUN_PEAK_REL_TOL."""
    code = ("import json; from repro_torch.launch import dryrun; print(json.dumps({a: "
            "dryrun.run_cell(a, 'prefill_32k', False, mesh_shape=(16, 4))['memory']"
            "['peak_bytes'] / 1e9 for a in ('olmoe-1b-7b', 'gemma-7b', 'deepseek-7b')}))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    reckoned = json.loads(proc.stdout.splitlines()[-1])
    for arch, peak in (("olmoe-1b-7b", 15.32), ("gemma-7b", 13.36), ("deepseek-7b", 7.82)):
        assert abs(reckoned[arch] / peak - 1) <= cs.DRYRUN_PEAK_REL_TOL, arch


def test_the_decode_cells_phase_at_smoke_size(decode_cells_lines):
    """For each of the cells' architectures at the reference's cell options,
    on a SMOKE_DECODE_LEN-deep cache filled from one seed (each rank its
    shard of it), DECODE_CELL_SLOTS sequences a data rank: at (1, 4), and
    for olmoe-1b-7b also at (2, 2), the first layers against one card on
    the whole cache (logits, fp32 distance, every cache shard within
    rounding where the tokens wrote and bit for bit elsewhere), then full
    depth graphed against eager (eager on its own buffers on the CPU),
    bit-equal, the collectives of both equal, the sums over ``model``
    among them."""
    rc, lines, err = decode_cells_lines
    assert rc == 0, err
    by_phase = {}
    for line in lines:
        by_phase.setdefault(line["phase"], []).append(line)
    assert set(by_phase) == {"decode_cell_agreement", "decode_cells"}
    want = [(f"{a}-smoke", d, m) for a in tp.CELL_ARCHS
            for d, m in tp.decode_cell_meshes(a, 4)]
    assert [(a, d, m) for a, d, m in want if a.startswith("olmoe")] == [
        ("olmoe-1b-7b-smoke", 1, 4), ("olmoe-1b-7b-smoke", 2, 2)]
    for phase in by_phase:
        assert [(line["arch"], line["mesh"]["data"], line["mesh"]["model"])
                for line in by_phase[phase]] == want
    for line in by_phase["decode_cell_agreement"] + by_phase["decode_cells"]:
        assert line["slots"] == line["mesh"]["data"] * tp.DECODE_CELL_SLOTS
        assert line["cache_len"] == tp.SMOKE_DECODE_LEN
        assert line["start_pos"] == tp.SMOKE_DECODE_LEN - cs.DECODE_CELL_TOKENS
        assert line["param_dtype"] == "bfloat16"
    for line in by_phase["decode_cell_agreement"]:
        assert line["agrees"] and line["layers"] == min(tp.AGREEMENT_LAYERS, 2)
        moe = line["arch"].startswith("olmoe")
        assert (line["routing_calls"] > 0) == moe
        assert line["replayed_routing"] == (line["routing_flips"] > 0)
        assert len(line["per_rank"]) == 4
        for rank in line["per_rank"]:
            assert rank["untouched_equal"] and rank["cache_within_rounding"]
            assert rank["agreement"]["within_bounds"]
            assert set(rank["cache_rel_err"]) == {"segments/[0]/k", "segments/[0]/v"}
    for line in by_phase["decode_cells"]:
        assert line["ok"] and line["bit_equal"] and line["failures"] == []
        assert line["collectives_a_step"]["all-reduce"]["count"] > 0
        assert not any(r["graph"] for r in line["per_rank"])


def test_the_dry_run_reckons_the_decode_cells(tmp_path):
    """``launch.dryrun`` reckons decode_32k at 16x4 (a rank: 8 of the 128
    sequences, model 4) for every architecture with a decode step, and
    long_500k at 1x1 for every one with an SSM or a window; every rank
    fits a card, and the rank the decode_cells phases hold their peaks
    against is there."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for shape, mesh in (("decode_32k", "16x4"), ("long_500k", "1x1")):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--shape", shape,
             "--mesh-shape", mesh, "--out", str(tmp_path)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    for arch in all_archs():
        cfg = get(arch)
        for shape, mesh, applies in (("decode_32k", "16x4", cfg.has_decode()),
                                     ("long_500k", "1x1", cfg.has_decode()
                                      and cfg.subquadratic())):
            path = tmp_path / f"{arch.replace('.', '_')}__{shape}__{mesh}.json"
            assert path.exists() == applies, (arch, shape)
            if applies:
                rec = json.loads(path.read_text())
                assert rec["memory"]["fits_80gb"] and rec["chips"] == (64 if mesh == "16x4"
                                                                      else 1)
                assert rec["roofline"]["dominant"] == "memory", (arch, shape)


def test_the_cells_phase_at_smoke_size(cells_lines):
    """For each of the cells' architectures at the reference's cell options
    (bf16 parameters, the CE chunked, the sequence over ``model``): the
    agreement at (1, 4) with one rank (its fp32 master held), the train
    cell graphed against eager at (1, 4) and (2, 2), bit-equal, with the
    sequence's reduce-scatter and all-gather over ``model`` among its
    collectives, and the prefill cell's agreement with one rank and its
    run, the logits left vocab-sharded."""
    rc, lines, err = cells_lines
    assert rc == 0, err
    want = [f"{a}-smoke" for a in tp.CELL_ARCHS]
    by_phase = {}
    for line in lines:
        by_phase.setdefault(line["phase"], []).append(line)
    assert set(by_phase) == {"cell_agreement", "cells", "prefill_agreement", "prefill"}
    assert [line["arch"] for line in by_phase["cell_agreement"]] == want
    for line in by_phase["cell_agreement"]:
        assert line["agrees"] and line["held"] == "master" and line["split_leaves"] > 0
        assert (line["param_dtype"], line["loss_chunk"], line["seq_shard"]) == (
            "bfloat16", tp.SMOKE_LOSS_CHUNK, True)
        assert line["mesh"] == {"data": 1, "model": 4} and line["batch"] == tp.CELL_ROWS
        assert line["replayed_routing"] == (line["routing_flips"] > 0)
    assert [(line["arch"], line["mesh"]["data"], line["mesh"]["model"])
            for line in by_phase["cells"]] == [
        (a, d, m) for a in want for d, m in ((1, 4), (2, 2))]
    for line in by_phase["cells"]:
        assert line["ok"] and line["bit_equal"] and line["failures"] == []
        assert line["param_dtype"] == "bfloat16" and line["seq_shard"]
        assert line["batch"] == line["mesh"]["data"] * tp.CELL_ROWS
        assert {"reduce-scatter model", "all-gather model"} <= set(line["collectives_a_step"])
    for line in by_phase["prefill_agreement"]:
        assert line["agrees"] and line["within_bounds"]
    for line in by_phase["prefill"]:
        rows, seq, cols = line["local_logits_shape"]
        cfg = tp.cell_config(line["arch"].removesuffix("-smoke"), True)
        assert (rows, seq, cols) == (tp.PREFILL_ROWS, tp.SMOKE_CELL_SEQ,
                                     cfg.padded_vocab // 4)


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


def test_graphed_mesh_steps_against_eager_at_smoke_size(smoke_lines):
    """For each default architecture a graph_agreement line (the graphed
    mesh step against the eager one on copies of one state, 3 steps at
    (1, 4)) bit-equal, and on each mesh the steps phase's graphed run
    bit-equal to its eager runs, with the eager step's launches (the
    config's kernels, none launched on the CPU; olmoe's grouped GEMM, dx
    and dw among them) and collectives a step: the sums over ``model``,
    and at (2, 2) over ``data`` too."""
    _, lines, _ = smoke_lines
    agreements = [line for line in lines if line["phase"] == "graph_agreement"]
    assert [line["arch"] for line in agreements] == [f"{a}-smoke" for a in tp.ARCHS]
    for line in agreements:
        assert line["agrees"] and line["bit_equal"] and line["graphed"] is False
        assert line["mesh"] == {"data": 1, "model": 4} and line["steps"] == 3
        assert line["losses"] == line["eager_losses"]
    for line in (line for line in lines if line["phase"] == "steps"):
        assert line["failures"] == [] and line["bit_equal"], line["failures"]
        want = {"flash_attention", "flash_attention_bwd"}
        if line["arch"].startswith("olmoe"):
            want |= {"grouped_matmul", "grouped_matmul_dx", "grouped_matmul_dw"}
        assert set(line["launches_a_step"]) == want
        assert line["launches_a_step"] == line["want_launches"]
        axes = {key.split()[1] for key in line["collectives_a_step"]}
        assert axes == ({"model", "data"} if line["mesh"]["data"] > 1 else {"model"})
        assert len(line["graphed_step_seconds"]) == 3 and line["graphed_step_ms"] is None


def test_graphed_mesh_decode_against_eager_at_smoke_size(smoke_lines):
    """For each default architecture a decode_graphed line: the graphed
    mesh step (GraphedServeStep, eager on its fixed buffers on the CPU)
    against the eager one at (1, 4) on the same shards and tokens, agreeing
    and bit-equal on every rank, its collectives a step the eager step's."""
    _, lines, _ = smoke_lines
    graphed = [line for line in lines if line["phase"] == "decode_graphed"]
    assert [line["arch"] for line in graphed] == [f"{a}-smoke" for a in tp.ARCHS]
    for line in graphed:
        assert line["agrees"] and line["bit_equal"] and line["failures"] == []
        assert line["mesh"] == {"data": 1, "model": 4} and len(line["per_rank"]) == 4
        assert line["collectives_a_step"] == line["eager_collectives_a_step"]
        assert line["collectives_a_step"]["all-reduce"]["count"] > 0
        assert not any(r["graph"] for r in line["per_rank"])


def test_full_size_meshes_are_the_ones_train_memory_gb_fits():
    """On 4 cards and chip_smoke's 72 GB budget: gemma-7b at (1, 4) only
    (77.6 GB at (2, 2)), olmoe-1b-7b at (1, 4) and (2, 2); the reckoning
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
    assert meshes[1][2] == pytest.approx(77.56, abs=0.01)
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
