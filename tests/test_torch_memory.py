"""``train.step.train_memory_gb`` against the peaks the card measured.

Every eager train step whose peak allocated memory ``PERF.md`` §5 records
(NVIDIA H100 80GB HBM3, power limit 700.00 W, as ``nvidia-smi
--query-gpu=name,power.limit`` reads it): the reckoning lies within
[1, 1.25] times the peak, and each run is still admitted by the check that
admitted it (``launch.train``'s refusal, ``chip_smoke.py``'s depth and
full-depth checks, ``scripts/tp_across_cards.py``'s meshes).  The
reckoning is arithmetic on the configs: nothing is allocated.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.configs import get  # noqa: E402
from repro_torch.launch.dryrun import cell_config  # noqa: E402
from repro_torch.train.step import params_per_device, train_memory_gb  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _module("chip_smoke", ROOT / "chip_smoke.py")
tp = _module("tp_across_cards", ROOT / "scripts" / "tp_across_cards.py")

#: the card's memory as torch reads it (total_memory / 1e9; NVIDIA H100
#: 80GB HBM3), what ``launch.train`` admits a run against
CARD_GB = 85.017493504
#: (arch, layers (None: all), rows a data rank, seq, data, model, the peak
#: allocated GB of an eager step measured on the card, the run): PERF.md §5
MEASURED = [
    ("gemma3-1b", None, 4, 2048, 1, 1, 61.84, "chip_smoke.py graph_train"),
    ("mamba2-780m", None, 4, 2048, 1, 1, 28.73, "chip_smoke.py graph_train"),
    ("hymba-1.5b", None, 4, 2048, 1, 1, 37.66, "chip_smoke.py graph_train"),
    ("hubert-xlarge", None, 4, 2048, 1, 1, 28.31, "chip_smoke.py graph_train"),
    ("h2o-danube-1.8b", None, 4, 2048, 1, 1, 50.33, "chip_smoke.py graph_train"),
    # its graph_train figure (62.11 GB) held an earlier case's state too:
    # the step alone, moe_train_path's "train" line
    ("olmoe-1b-7b", 4, 4, 2048, 1, 1, 53.96, "chip_smoke.py train"),
    ("gemma3-1b", None, 4, 2048, 4, 1, 51.29, "dp_across_cards.py steps"),
    ("olmoe-1b-7b", None, 4, 2048, 1, 4, 49.79, "tp_across_cards.py steps"),
    ("olmoe-1b-7b", None, 4, 2048, 2, 2, 63.68, "tp_across_cards.py steps"),
    ("gemma-7b", None, 4, 2048, 1, 4, 57.82, "tp_across_cards.py steps"),
    ("deepseek-7b", None, 4, 2048, 1, 4, 44.49, "tp_across_cards.py steps"),
    ("deepseek-7b", None, 4, 2048, 2, 2, 58.38, "tp_across_cards.py steps"),
    ("gemma3-1b", None, 2, 2048, 4, 1, 29.46, "dp_across_cards.py n_micro 1"),
]
#: the reckoning's room over a measured peak
SLACK = 1.25


def _config(arch, layers):
    cfg = get(arch)
    return cfg if layers is None else cs.cut_depth(cfg, layers)


@pytest.mark.parametrize("arch,layers,rows,seq,data,model,peak,run", MEASURED,
                         ids=[f"{m[0]}-{m[4]}x{m[5]}-{m[2]}rows" for m in MEASURED])
def test_the_reckoning_holds_every_measured_peak(arch, layers, rows, seq, data, model,
                                                 peak, run):
    got = train_memory_gb(_config(arch, layers), data, model, rows=rows, seq=seq)
    assert peak <= got["total_gb"] <= SLACK * peak, (run, got)


@pytest.mark.parametrize("arch,layers,rows,seq,data,model,peak,run", MEASURED,
                         ids=[f"{m[0]}-{m[4]}x{m[5]}-{m[2]}rows" for m in MEASURED])
def test_every_measured_run_is_still_admitted(arch, layers, rows, seq, data, model,
                                              peak, run):
    """The check that admitted each run still does: a mesh with a model
    axis is one of ``step_meshes``' fits at chip_smoke's budget; a cut of
    depth is ``train_depth``'s; a data-parallel or one-card run passes
    ``launch.train``'s refusal (its reckoning within the card), and the
    one-card runs at full depth that chip_smoke checks against its budget
    (hymba-1.5b, h2o-danube-1.8b) still fit it."""
    cfg = get(arch)
    if model > 1:
        fits = {(d, m) for d, m, _, ok in tp.step_meshes(cfg, data * model,
                                                         cs.TRAIN_BUDGET_GB, rows, seq) if ok}
        assert (data, model) in fits
    elif layers is not None:
        assert cs.train_depth(cfg) == layers
    else:
        need = train_memory_gb(cfg, data, rows=rows, seq=seq)["total_gb"]
        assert need <= CARD_GB
        if arch in ("hymba-1.5b", "h2o-danube-1.8b"):
            assert cs.train_reckoning_gb(cfg, cfg.n_layers)["total_gb"] <= cs.TRAIN_BUDGET_GB


@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b", "deepseek-7b"])
@pytest.mark.parametrize("data,model", [(1, 1), (2, 2), (1, 4)])
def test_bf16_parameters_reckon_four_fewer_replicated_bytes(arch, data, model):
    """A bf16 parameter and its gradient take 4 bytes on every device that
    holds it, fp32 ones 8; AdamW's fp32 master and moments stay 12."""
    fp32 = get(arch)
    bf16 = dataclasses.replace(fp32, param_dtype="bfloat16")
    n = params_per_device(fp32, model)
    a, b = train_memory_gb(fp32, data, model), train_memory_gb(bf16, data, model)
    assert a["replicated_gb"] - b["replicated_gb"] == pytest.approx(4 * n / 1e9)
    assert a["state_gb"] - b["state_gb"] == pytest.approx(4 * n / 1e9)
    assert b["state_gb"] == pytest.approx((4 + 12 / data) * n / 1e9)


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-780m", "deepseek-7b"])
def test_a_chunked_loss_reckons_less(arch):
    """At 4 x 2048 the CE over chunks of 1024 positions holds half the
    logits of the whole sequence's."""
    whole = get(arch)
    chunked = dataclasses.replace(whole, loss_chunk=1024)
    a, b = train_memory_gb(whole), train_memory_gb(chunked)
    assert b["logits_gb"] == pytest.approx(a["logits_gb"] / 2)
    assert b["activation_gb"] < a["activation_gb"]
    assert b["total_gb"] <= a["total_gb"]
    assert train_memory_gb(get("gemma3-1b"), rows=4, seq=2048)["total_gb"] > train_memory_gb(
        dataclasses.replace(get("gemma3-1b"), loss_chunk=1024))["total_gb"]


def test_the_activations_follow_the_tokens_the_vocabulary_and_the_mesh():
    """The activations grow with the rows and the sequence; a vocab-parallel
    head holds 1/model of the logits (two fp32 copies of its block, where a
    whole head holds five of the whole); ``seq_shard`` divides the residual
    stream saved at each layer by ``model``; the defaults are 4 x 2048."""
    cfg = get("gemma-7b")
    assert train_memory_gb(cfg) == train_memory_gb(cfg, rows=4, seq=2048)
    four, eight = (train_memory_gb(cfg, 1, 4, rows=r) for r in (4, 8))
    assert eight["residual_gb"] == pytest.approx(2 * four["residual_gb"])
    assert eight["logits_gb"] == pytest.approx(2 * four["logits_gb"])
    whole = train_memory_gb(cfg)["logits_gb"]
    assert four["logits_gb"] == pytest.approx(whole * 2 / 5 / 4)
    sharded = dataclasses.replace(cfg, seq_shard=True)
    assert train_memory_gb(sharded, 1, 4)["residual_gb"] == pytest.approx(
        four["residual_gb"] / 4)
    assert train_memory_gb(sharded)["residual_gb"] == pytest.approx(
        train_memory_gb(cfg)["residual_gb"])


def test_the_total_counts_the_larger_of_the_update_and_the_activations():
    """The update runs after the backward has freed the activations: the
    total is the state, the larger of the two, the microbatches' sum and
    the workspace."""
    for arch, data, model in (("gemma3-1b", 1, 1), ("olmoe-1b-7b", 2, 2),
                              ("deepseek-7b", 1, 4)):
        got = train_memory_gb(get(arch), data, model, n_micro=2)
        assert got["total_gb"] == pytest.approx(
            got["state_gb"] + max(got["update_gb"], got["activation_gb"])
            + got["accumulator_gb"] + got["workspace_gb"])


@pytest.mark.parametrize("arch", tp.CELL_ARCHS)
def test_the_cells_fit_on_four_cards(arch):
    """At the reference's cell options and 8 x 4096 tokens a data rank, the
    cells phase trains each of its architectures at both meshes of 4
    cards, bf16 parameters and the chunked CE halving what fp32 would
    need."""
    cfg = cell_config(arch)
    meshes = tp.step_meshes(cfg, 4, cs.TRAIN_BUDGET_GB, tp.CELL_ROWS, 4096)
    assert [(d, m, ok) for d, m, _, ok in meshes] == [(1, 4, True), (2, 2, True)]
    fp32 = dataclasses.replace(cfg, param_dtype="float32", loss_chunk=0)
    for d, m, gb, _ in meshes:
        assert gb < train_memory_gb(fp32, d, m, rows=tp.CELL_ROWS, seq=4096)["total_gb"]
