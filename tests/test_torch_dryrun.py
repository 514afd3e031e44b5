"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

The dry run plays one rank of a 256- or 512-rank mesh in a ``fake``
process group, which is process-wide, so every run of it here is a
subprocess:

* every applicable (arch × shape) cell of the smoke configs at 16×16 and
  2×16×16 writes its record (the reference's keys, the rank played, the
  link of each axis), and the inapplicable ones are skipped for the
  reference's reasons, with the reference's mesh and file names;
* ``model_flops`` of every full-size cell equals the reference's;
* the argument bytes a device of each full-size arch's train cell equal
  the sum of the shard bytes of the reference's ``state_shardings`` and
  ``batch_shardings`` specs over an ``AbstractMesh`` (no compile, no
  placeholder devices);
* the collective bytes the counter reads under the fake group at (data,
  model) = (1, 2) equal those it reads on a real two-rank gloo run of the
  same step (tests/torch_mesh_worker.py);
* at ``n_micro`` 2 over two data ranks the counter sees the microbatches'
  all-to-all on ``data``, the FLOPs stay and the peak falls.

In this process: a kernel's meta route refuses what its kernel refuses
and reports the cost formula's numbers, and the strict counter raises on
a tensor made off the meta device.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch_mesh_worker as worker  # noqa: E402
from repro.configs import get as jget  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models.config import SHAPES as JSHAPES  # noqa: E402
from repro.models.model import input_specs as jinput_specs  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW, cosine_schedule as jcosine  # noqa: E402
from repro.train.step import abstract_train_state as jabstract_state  # noqa: E402

from repro_torch import events  # noqa: E402
from repro_torch.configs import all_archs  # noqa: E402
from repro_torch.kernels import costs as kcosts  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from repro_torch.launch import costs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KEYS = {"arch", "shape", "mesh", "applicable", "chips", "rank", "links", "memory",
        "per_kind", "hlo_flops_per_device", "hlo_bytes_per_device", "kernels",
        "collectives", "roofline", "model_flops_total", "model_flops_per_device",
        "useful_flops_ratio"}
#: the dry run's settings (the reference's run_cell opts)
OPTS = dict(loss_chunk=1024, vocab_pad=256, param_dtype="bfloat16", attn_q_chunk=1024,
            seq_shard=True)
#: the smoke configs cut to shapes the kernels take at model 16 (an
#: expert's f / 16 a multiple of 8)
SMOKE_OVERRIDES = {"olmoe-1b-7b": {"moe_d_ff": 128},
                   "qwen2-moe-a2.7b": {"moe_d_ff": 128}}


def _python(code: str, timeout: int = 300) -> str:
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout.strip().splitlines()[-1]


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """The smoke sweep over both meshes: (exit code, stdout, records)."""
    out = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    code = ("from pathlib import Path\n"
            "from repro_torch.configs import all_archs\n"
            "from repro_torch.launch import dryrun\n"
            "from repro_torch.models.config import SHAPES\n"
            f"failed = dryrun.sweep(all_archs(), list(SHAPES), [False, True], Path({str(out)!r}),"
            f" smoke=True, arch_overrides={SMOKE_OVERRIDES!r})\n"
            "raise SystemExit(1 if failed else 0)\n")
    res = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    records = {p.name: json.loads(p.read_text()) for p in out.glob("*.json")}
    return res.returncode, res.stdout, records


@pytest.fixture(scope="module")
def reference():
    """The reference's names, skip reasons and model_flops for every cell,
    from a subprocess (``repro.launch.dryrun`` sets XLA_FLAGS when
    imported)."""
    code = """
import dataclasses, json
from repro.configs import all_archs, get
from repro.launch import dryrun
from repro.models.config import SHAPES, cell_applicable
out = {}
for arch in all_archs():
    cfg = dataclasses.replace(get(arch), **%r)
    for shape in SHAPES:
        ok, reason = cell_applicable(cfg, SHAPES[shape])
        for multi_pod in (False, True):
            rec = dryrun.run_cell(arch, shape, multi_pod) if not ok else None
            out[f"{arch}|{shape}|{multi_pod}"] = {
                "ok": ok, "reason": reason, "flops": dryrun.model_flops(cfg, SHAPES[shape]),
                "skip": rec}
print(json.dumps(out))
""" % (OPTS,)
    return json.loads(_python(code))


def test_sweep_writes_every_applicable_cell(sweep, reference):
    rc, stdout, records = sweep
    assert rc == 0, stdout[-3000:]
    assert "FAIL" not in stdout
    applicable = [k for k, v in reference.items() if v["ok"]]
    assert len(applicable) == 66 and len(records) == 66
    for key in applicable:
        arch, shape, multi_pod = key.split("|")
        mesh = "2x16x16" if multi_pod == "True" else "16x16"
        name = f"{arch.replace('.', '_')}__{shape}__{mesh}.json"
        rec = records[name]
        assert KEYS <= set(rec), name
        assert (rec["arch"], rec["shape"], rec["mesh"], rec["applicable"]) == (
            arch, shape, mesh, True)
        assert rec["chips"] == (512 if multi_pod == "True" else 256)
        assert set(rec["links"]) == ({"pod", "data", "model"} if multi_pod == "True"
                                     else {"data", "model"})
        assert all(v["link"] == "inter-node" for v in rec["links"].values())
        assert rec["hlo_flops_per_device"] > 0 and rec["memory"]["peak_bytes"] > 0
        assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
        assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
        if shape != "decode_32k" and shape != "long_500k":
            assert rec["kernels"], name      # the card's route: the kernels reported


def test_skips_and_mesh_names_match_reference(sweep, reference):
    """An inapplicable cell prints the reference's reason; the reference's
    run_cell record of it (arch, shape, mesh, skip_reason) is the port's."""
    from repro_torch.launch import dryrun
    _, stdout, _ = sweep
    for key, ref in reference.items():
        if ref["ok"]:
            continue
        arch, shape, multi_pod = key.split("|")
        assert f"SKIP {arch} {shape}: {ref['reason']}" in stdout
        rec = dryrun.run_cell(arch, shape, multi_pod == "True")
        assert rec == ref["skip"]


def test_model_flops_match_reference(reference):
    from repro_torch.configs import get
    from repro_torch.launch import dryrun
    from repro_torch.models.config import SHAPES
    for key, ref in reference.items():
        arch, shape, _ = key.split("|")
        cfg = dataclasses.replace(get(arch), **OPTS)
        assert dryrun.model_flops(cfg, SHAPES[shape]) == ref["flops"], key


def _shard_bytes(tree, specs, sizes):
    """Σ bytes / (ranks each leaf's spec splits it over)."""
    import jax
    total = 0
    for leaf, sharding in zip(jax.tree.leaves(tree), jax.tree.leaves(
            specs, is_leaf=lambda x: hasattr(x, "spec"))):
        n = 1
        for entry in sharding.spec:
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                n *= sizes.get(axis, 1) if axis else 1
        total += math.prod(leaf.shape) * leaf.dtype.itemsize // n
    return total


def test_train_argument_bytes_equal_reference_shards():
    """Each full-size arch's train cell at 16×16 and 2×16×16: the port's
    argument bytes a device (its rank's shards of the state and the batch)
    equal the reference's specs' shard bytes."""
    from jax.sharding import AbstractMesh
    code = """
import json
from repro_torch.configs import all_archs
from repro_torch.launch import costs, dryrun
from repro_torch.models.config import SHAPES
out = {}
for arch in all_archs():
    cfg = dryrun.cell_config(arch)
    for multi_pod in (False, True):
        shape, axes, name = dryrun.mesh_of(multi_pod, None)
        mesh = dryrun.fake_mesh(shape, axes, 0)
        _, args = dryrun.build_step(cfg, SHAPES["train_4k"], mesh)
        counter = costs.Counter("meta")
        counter.track(*args)
        out[f"{arch}|{name}"] = counter.argument_bytes
print(json.dumps(out))
"""
    port = json.loads(_python(code))
    meshes = {"16x16": ((16, 16), ("data", "model")),
              "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
    for arch in all_archs():
        cfg = dataclasses.replace(jget(arch), **OPTS)
        state = jabstract_state(cfg, JAdamW(schedule=jcosine(3e-4, 2000, 100_000)))
        batch = jinput_specs(cfg, JSHAPES["train_4k"])
        for name, (shape, axes) in meshes.items():
            mesh = AbstractMesh(shape, axes)
            sizes = dict(zip(axes, shape))
            want = (_shard_bytes(state, jshd.state_shardings(state, mesh), sizes)
                    + _shard_bytes(batch, jshd.batch_shardings(batch, mesh), sizes))
            assert port[f"{arch}|{name}"] == want, (arch, name)


CELLS = [{"arch": "gemma3-1b", "shape": ("train_small", 64, 4, "train")},
         {"arch": "gemma3-1b", "shape": ("decode_small", 64, 4, "decode")},
         {"arch": "mamba2-780m", "shape": ("decode_small", 64, 4, "decode")},
         {"arch": "olmoe-1b-7b", "shape": ("prefill_small", 64, 4, "prefill"),
          "overrides": SMOKE_OVERRIDES["olmoe-1b-7b"]}]


def test_fake_group_collectives_equal_a_gloo_run(tmp_path):
    """At (data, model) = (1, 2): the collectives (count and bytes by kind)
    the counter reads as the dry run plays rank 0 in the fake group, and as
    rank 0 of two gloo ranks runs the same step on zeros."""
    code = """
import json
from repro_torch.launch import dryrun
from repro_torch.models.config import ShapeConfig
out = []
for cell in %r:
    rec = dryrun.run_cell(cell["arch"], ShapeConfig(*cell["shape"]), False,
                          mesh_shape=(1, 2), smoke=True, ranks=(0,),
                          overrides=cell.get("overrides"))
    out.append(rec["collectives"])
print(json.dumps(out))
""" % (CELLS,)
    fake = json.loads(_python(code))
    gloo = worker.spawn(2, [worker.Job("counted", {"cells": CELLS}, (1, 2))], tmp_path)
    for cell, want, got in zip(CELLS, fake, gloo[0][0]):
        assert got["collectives"] == want, cell
        assert sum(v["bytes"] for v in want.values()) > 0, cell


#: a smoke train cell whose activations outweigh the fp32 sum of the
#: microbatches' gradients, as at full size: (name, seq, batch, kind)
MICRO_CELL = ("train_micro", 256, 8, "train")


def test_n_micro_moves_each_ranks_share_in_the_dry_run():
    """run_cell and build_step at n_micro = 2 on gemma3-1b's smoke train
    cell at (data 2, model 1) on the meta device: the counter reports the
    microbatches' all-to-all on data, (D - 1) / D of the rank's batch
    (tokens and labels, int32), which n_micro = 1 has none of; the FLOPs
    are within 1% of n_micro = 1's; the live-bytes peak is lower (a
    microbatch's activations)."""
    code = """
import json
from repro_torch.launch import dryrun
from repro_torch.models.config import ShapeConfig
out = {}
for n in (1, 2):
    rec = dryrun.run_cell("gemma3-1b", ShapeConfig(*%r), False, mesh_shape=(2, 1),
                          smoke=True, ranks=(0,), n_micro=n)
    out[n] = {"by_axis": rec["collectives_by_axis"], "flops": rec["hlo_flops_per_device"],
              "peak": rec["memory"]["peak_bytes"], "count": rec["collectives"]["all-to-all"]}
print(json.dumps(out))
""" % (MICRO_CELL,)
    got = json.loads(_python(code))
    one, two = got["1"], got["2"]
    _, seq, batch, _ = MICRO_CELL
    d = 2
    rank_batch = 2 * (batch // d) * seq * 4          # tokens and labels, int32
    assert "all-to-all" not in one["by_axis"]["data"]
    assert two["by_axis"]["data"]["all-to-all"] == rank_batch * (d - 1) // d
    assert two["count"] == {"count": 2, "bytes": rank_batch * (d - 1) // d}
    assert set(two["by_axis"]) == {"data"}
    assert two["flops"] == pytest.approx(one["flops"], rel=1e-2)
    assert two["peak"] < one["peak"]


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_meta_route_refuses_what_the_kernel_refuses():
    calls = []
    with events.counting(lambda event, *a: calls.append(a)):
        with pytest.raises(ValueError, match="head dim 96"):
            fa.flash_attention(_meta(1, 64, 2, 96), _meta(1, 64, 1, 96), _meta(1, 64, 1, 96))
        with pytest.raises(ValueError, match="multiples of 8"):
            moe_gmm.grouped_matmul(_meta(16, 32), _meta(4, 32, 12),
                                   _meta(4, dtype=torch.int32))
        with pytest.raises(ValueError, match="not supported by the kernel"):
            kssd.ssd_scan(_meta(1, 64, 2, 16), _meta(1, 64, 2, dtype=torch.float32),
                          _meta(1, 64, 1, 4), _meta(1, 64, 1, 4), chunk=64)
        with pytest.raises(TypeError, match="bfloat16"):
            fa.flash_attention(*(_meta(1, 64, 2, 64, dtype=torch.float32),) * 3)
        assert calls == []
        out = fa.flash_attention(_meta(2, 128, 4, 64), _meta(2, 128, 1, 64),
                                 _meta(2, 128, 1, 64), causal=True, window=32)
        moe_gmm.grouped_matmul(_meta(16, 32), _meta(4, 32, 16), _meta(4, dtype=torch.int32))
        kssd.ssd_scan(_meta(1, 64, 2, 64), _meta(1, 64, 2, dtype=torch.float32),
                      _meta(1, 64, 1, 128), _meta(1, 64, 1, 128), chunk=32)
    assert out.shape == (2, 128, 4, 64) and out.device.type == "meta"
    assert calls == [
        ("flash_attention", *kcosts.attention(2, 128, 4, 1, 64, True, 32)),
        ("grouped_matmul", *kcosts.gmm(16, 32, 16, 4)),
        ("ssd_chunk_state", *kcosts.ssd(1, 64, 2, 64, 1, 128, 32, "chunk_state")),
        ("ssd_chunk_scan", *kcosts.ssd(1, 64, 2, 64, 1, 128, 32, "chunk_scan"))]
    assert fa.launches == 0 and moe_gmm.launches == 0 and kssd.state_launches == 0


def test_meta_route_takes_the_16_8_pair():
    """hymba-1.5b's smoke SSD pair (head dim 16, state 8): each of the four
    SSD kernels' meta routes takes it and reports its cost, with no launch
    counted; (16, 4), which no instance compiles, still raises."""
    f32 = torch.float32
    b, s, h, p, g, n, q = 2, 64, 8, 16, 1, 8, 16
    x, dy = _meta(b, s, h, p), _meta(b, s, h, p)
    la, bm, cm = _meta(b, s, h, dtype=f32), _meta(b, s, g, n), _meta(b, s, g, n)
    calls = []
    with events.counting(lambda event, *a: calls.append(a)):
        prev, final = kssd.chunk_state(x, la, bm, chunk=q)
        y = kssd.chunk_scan(x, la, bm, cm, prev, chunk=q)
        gnext, dinit, d_total = kssd.chunk_state_bwd(dy, la, cm, prev, chunk=q)
        dx, dla, db, dc = kssd.chunk_scan_bwd(x, la, bm, cm, prev, dy, gnext, d_total,
                                              chunk=q)
        with pytest.raises(ValueError, match="not supported by the kernel"):
            kssd.chunk_state(x, la, _meta(b, s, g, 4), chunk=q)
    assert prev.shape == (b, h, s // q, p, n) and final.shape == (b, h, p, n)
    assert y.shape == (b, s, h, p) and dx.shape == (b, s, h, p)
    assert db.shape == dc.shape == (b, s, g, 1, n)
    assert all(t.device.type == "meta" for t in (prev, y, gnext, dinit, d_total, dla))
    assert calls == [
        ("ssd_chunk_state", *kcosts.ssd(b, s, h, p, g, n, q, "chunk_state")),
        ("ssd_chunk_scan", *kcosts.ssd(b, s, h, p, g, n, q, "chunk_scan")),
        ("ssd_chunk_state_bwd", *kcosts.ssd_bwd(b, s, h, p, g, n, q, "chunk_state_bwd")),
        ("ssd_chunk_scan_bwd", *kcosts.ssd_bwd(b, s, h, p, g, n, q, "chunk_scan_bwd"))]
    assert (kssd.state_launches, kssd.scan_launches, kssd.state_bwd_launches,
            kssd.scan_bwd_launches) == (0, 0, 0, 0)


def test_without_a_counter_a_meta_tensor_has_no_kernel():
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa.flash_attention(_meta(1, 64, 2, 64), _meta(1, 64, 1, 64), _meta(1, 64, 1, 64))


def test_strict_counter_raises_on_a_tensor_made_off_meta():
    with pytest.raises(RuntimeError, match="made a tensor on cpu"):
        with costs.Counter("meta", strict=True):
            torch.zeros(3)


def test_counter_counts_flops_bytes_and_the_live_peak():
    counter = costs.Counter("meta")
    a, b = _meta(128, 256), _meta(256, 64)
    counter.track({"a": a, "b": b})
    with counter:
        c = a @ b
        d = c.t()                         # a view: no bytes
        del c, d
        e = torch.empty(1000, device="meta")
        del e
    assert counter.aten_flops == 2 * 128 * 256 * 64
    assert counter.aten_bytes == 2 * (128 * 256 + 256 * 64 + 128 * 64)
    assert counter.argument_bytes == 2 * (128 * 256 + 256 * 64)
    assert counter.peak == counter.argument_bytes + 2 * 128 * 64   # c, freed before e
    assert counter.live == counter.argument_bytes


def test_dryrun_sets_no_environment_variable_at_import():
    """The reference's dry run sets XLA_FLAGS when imported; the port's
    sets nothing."""
    code = ("import os, json\nbefore = dict(os.environ)\n"
            "import repro_torch.launch.dryrun\n"
            "print(json.dumps(dict(os.environ) == before))")
    assert json.loads(_python(code)) is True
