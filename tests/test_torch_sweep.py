"""The port's PaPaS driver: ``repro_torch.launch.{sweep,lint,report}``
against the reference's CLIs (stdout equal apart from runtimes and paths),
a study of training runs gang-packed on the CPU, the sweep with jax,
PyYAML and the reference blocked, and the kernel build under threads."""
import contextlib
import io
import math
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under 6 xdist workers

from repro.launch import lint as ref_lint  # noqa: E402
from repro.launch import report as ref_report  # noqa: E402
from repro.launch import sweep as ref_sweep  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import lint as port_lint  # noqa: E402
from repro_torch.launch import report as port_report  # noqa: E402
from repro_torch.launch import sweep as port_sweep  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MATMUL = ROOT / "examples" / "matmul_perf.yaml"
BROKEN = ROOT / "tests" / "fixtures" / "broken_study.yaml"
LANE_KILL = ROOT / "examples" / "chaos" / "lane_kill.yaml"
MATMUL_ARGS = ["--window", "64", "--pool", "lane", "--report", "speedup",
               "--group-by", "size,threads"]
#: the study of tests/test_system.py's training runs
TRAIN_STUDY = """
lr_sweep:
  args:
    lr: [0.001, 0.002]
    seed: ["0:1"]
    arch: [gemma3-1b]
    steps: [3]
    batch: [2]
    seq: [16]
  command: train
"""
GANG_LINE = "[gang] 4 tasks in 1 dispatches (batching ×4)"


def normalized(text: str, *roots: Path) -> str:
    """Output with the study roots, runtimes, ShellResult runtimes and the
    lanes that ran each task taken out."""
    for root in roots:
        text = text.replace(str(root), "<root>")
    text = re.sub(r"\(\d+\.\d+s\) @lane\d+", "(<t>s) @lane", text)
    text = re.sub(r"\(\d+\.\d+s\)", "(<t>s)", text)
    return re.sub(r"runtime=[0-9.e+-]+", "runtime=<t>", text)


def call(main, argv, monkeypatch) -> tuple[int, str, str]:
    """A CLI's exit code, stdout and stderr, in this process (the
    reference's sweep reads sys.argv)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            if main is ref_sweep.main:
                monkeypatch.setattr(sys, "argv", ["sweep", *argv])
                ret = main()
            else:
                ret = main(argv)
            code = ret if isinstance(ret, int) else 0
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
    return code, out.getvalue(), err.getvalue()


def both_sweeps(tmp_path, monkeypatch, argv: list[str], tail: list[str] = ()):
    """The reference's and the port's sweep on the same arguments, each
    under its own root; their outputs with the roots taken out."""
    outs = []
    for tag, main in (("ref", ref_sweep.main), ("port", port_sweep.main)):
        root = tmp_path / tag
        code, out, err = call(main, [*argv, "--root", str(root), *tail], monkeypatch)
        outs.append((code, normalized(out, root), normalized(err, root)))
    return outs


def test_matmul_speedup_report(tmp_path, monkeypatch):
    ref, port = both_sweeps(tmp_path, monkeypatch, [str(MATMUL), *MATMUL_ARGS])
    assert port == ref
    assert ref[0] == 0 and "12/12 instances complete" in ref[1]
    assert "# speedup of mean(time), baseline threads=1" in ref[1]


def test_check_refuses_the_broken_study(tmp_path, monkeypatch):
    ref, port = both_sweeps(tmp_path, monkeypatch, [str(BROKEN), "--check"])
    assert port == ref
    assert ref[0] == 1 and "ERROR E001" in ref[2] and "unknown dependency 'ghost'" in ref[2]


def test_resume(tmp_path, monkeypatch):
    marker = tmp_path / "go"
    study = tmp_path / "s.yaml"
    study.write_text(f"""
t:
  args:
    i: ["1:4"]
  command: sh -c "test ${{args:i}} -le 2 || test -e {marker}"
""")
    first = both_sweeps(tmp_path, monkeypatch, [str(study)])
    marker.touch()
    second = both_sweeps(tmp_path, monkeypatch, [str(study), "--resume"])
    assert first[1] == first[0] and second[1] == second[0]
    assert "2/4 instances complete" in first[0][1]
    assert "4/4 instances complete" in second[0][1]


def test_chaos_lane_kill(tmp_path, monkeypatch):
    ref, port = both_sweeps(tmp_path, monkeypatch,
                            [str(MATMUL), "--pool", "lane", "--slots", "2",
                             "--chaos", str(LANE_KILL)])
    assert port == ref
    assert "12/12 instances complete" in ref[1]


@pytest.mark.parametrize("argv", [
    [str(BROKEN), str(MATMUL)],
    [str(BROKEN), "--format", "json"],
    [str(MATMUL), "--strict"],
], ids=["text", "json", "strict"])
def test_lint_cli(monkeypatch, argv):
    ref = call(ref_lint.main, argv, monkeypatch)
    port = call(port_lint.main, argv, monkeypatch)
    assert port == ref
    assert ref[1].strip()


def test_report_cli_on_each_engines_records(tmp_path, monkeypatch):
    """The offline report of a study run by the port's sweep, by both
    report CLIs, and of one run by the reference's."""
    for tag, main in (("ref", ref_sweep.main), ("port", port_sweep.main)):
        call(main, [str(MATMUL), "--pool", "lane", "--root", str(tmp_path / tag)],
             monkeypatch)
    argv = ["--group-by", "size,threads", "--report", "table", "--baseline", "threads=1"]
    outs = {(mod.__name__, tag): call(mod.main, [str(tmp_path / tag / "matmulOMP"), *argv],
                                      monkeypatch)
            for mod in (ref_report, port_report) for tag in ("ref", "port")}
    assert len(set(outs.values())) == 1
    assert next(iter(outs.values()))[0] == 0


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """The study of training runs through the port's sweep on the CPU: as a
    gang, and one dispatch a task."""
    root = tmp_path_factory.mktemp("train")
    study = root / "lr.yaml"
    study.write_text(TRAIN_STUDY)
    runs = {}
    for tag, extra in (("gang", ["--gang"]), ("one", [])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            results = port_sweep.main([str(study), "--root", str(root / tag),
                                       "--device", "cpu", *extra])
        runs[tag] = (results, out.getvalue())
    return study, runs


def test_train_gang_on_the_port(train_runs, tmp_path, monkeypatch):
    """One dispatch for the 4 members, as the reference's sweep makes of
    the same study; each member's loss within 5e-3 of its own run (seeds do
    not cross frameworks, so the values are the port's alone)."""
    study, runs = train_runs
    gang, gang_out = runs["gang"]
    one, one_out = runs["one"]
    assert GANG_LINE in gang_out.splitlines()
    assert "[gang]" not in one_out
    assert len(gang) == len(one) == 4
    for rid, res in gang.items():
        assert res.status == one[rid].status == "ok"
        assert math.isfinite(res.value)
        assert res.value == pytest.approx(one[rid].value, rel=5e-3)
    code, ref_out, _ = call(ref_sweep.main, [str(study), "--root", str(tmp_path), "--gang"],
                            monkeypatch)
    assert code == 0 and GANG_LINE in ref_out.splitlines()


def test_the_sweep_needs_no_jax_yaml_or_reference(train_runs, tmp_path, monkeypatch):
    """``python -m repro_torch.launch.sweep`` with jax, yaml and repro
    unimportable: the gang study and the matmul study give the outputs of
    the runs that could import them."""
    study, runs = train_runs
    code = (
        "import runpy, sys\n"
        "sys.modules['yaml'] = sys.modules['jax'] = sys.modules['repro'] = None\n"
        "for argv in sys.argv[1:]:\n"
        "    sys.argv = ['sweep', *argv.split('|')]\n"
        "    runpy.run_module('repro_torch.launch.sweep', run_name='__main__')\n"
        "    print('=====')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'yaml', 'repro')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    gang_root, matmul_root = tmp_path / "gang", tmp_path / "matmul"
    res = subprocess.run(
        [sys.executable, "-c", code,
         "|".join([str(study), "--root", str(gang_root), "--gang", "--device", "cpu"]),
         "|".join([str(MATMUL), *MATMUL_ARGS, "--root", str(matmul_root)])],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    gang_out, matmul_out, _ = res.stdout.split("=====\n")
    want_gang = normalized(runs["gang"][1], study.parent / "gang")
    assert normalized(gang_out, gang_root) == want_gang
    ref = call(ref_sweep.main, [str(MATMUL), *MATMUL_ARGS, "--root", str(tmp_path / "r")],
               monkeypatch)
    assert normalized(matmul_out, matmul_root) == normalized(ref[1], tmp_path / "r")


def test_two_threads_build_each_source_once(tmp_path, monkeypatch):
    """Two threads reach the first build at once (train tasks under
    ``--pool thread``): each source is compiled once, both calls return and
    every library is whole.  nvcc is a script that writes its output in two
    halves with a pause between."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        "out=''; src=''\n"
        "while [ $# -gt 0 ]; do\n"
        "  case \"$1\" in -o) out=\"$2\"; shift;; *.cu) src=\"$1\";; esac; shift\n"
        "done\n"
        f"echo \"$src\" >> {calls}\n"
        "printf 'first-half ' > \"$out\"; sleep 0.3; printf 'second-half' >> \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "build_log", {})
    start, errors = threading.Barrier(2), []

    def first_use():
        start.wait()
        try:
            _build.build(csrc)
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert sorted(calls.read_text().split()) == [str(p) for p in _build.sources(csrc)]
    for src in _build.sources(csrc):
        assert _build._target(src).read_text() == "first-half second-half"
    assert not list((tmp_path / "build").glob("*.tmp"))
