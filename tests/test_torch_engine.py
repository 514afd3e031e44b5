"""The port's study engine (``repro_torch.core``) against the reference's
(``repro.core``) on the same shell-command studies: results, records,
journals, lint findings, report tables, the DAG's renderings, resume
across engines both ways, and parameter expansion and interpolation."""
import contextlib
import io
import json
import math
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import repro.core as ref
import repro_torch.core as port
from repro.core import interpolate as ref_interp
from repro.core import paramspace as ref_space
from repro.launch import lint as ref_lint
from repro.launch import report as ref_report
from repro_torch.core import interpolate as port_interp
from repro_torch.core import paramspace as port_space
from repro_torch.launch import lint as port_lint
from repro_torch.launch import report as port_report

ROOT = Path(__file__).resolve().parents[1]
ENGINES = {"ref": ref, "port": port}
MATMUL = (ROOT / "examples" / "matmul_perf.yaml").read_text()

#: a DAG with a capture, a failing instance and its skipped dependents
PIPELINE = """
prep:
  args:
    n: ["1:3"]
  command: echo prep-${args:n}
work:
  after: [prep]
  args:
    k: [a, b]
  command: sh -c "echo k=${args:k} v=${prep:args:n}; test ${prep:args:n} -ne 2"
  capture:
    v: "v=([0-9]+)"
post:
  after: [work]
  command: echo post-${work:args:k}
"""


def _value(v):
    """A task's value without its runtime (a ShellResult is each engine's
    own class)."""
    if hasattr(v, "returncode"):
        return (v.returncode, v.stdout, v.stderr)
    return v


def _metrics(m):
    return None if m is None else {k: v for k, v in m.items() if k != "duration"}


def results_view(results: dict) -> dict:
    return {rid: (r.status, _value(r.value), _metrics(r.metrics), r.error, r.attempts)
            for rid, r in results.items()}


def records_view(study_dir: Path, order: bool = True) -> list[dict]:
    """records.jsonl and its segments (one a slot) with times, hosts and
    paths dropped, in a set order (or in the files', which is each task's
    attempts in turn)."""
    out = []
    lines = [line for path in sorted(study_dir.glob("records.jsonl*"))
             for line in path.read_text().splitlines()]
    for line in lines:
        rec = json.loads(line)
        for key in ("runtime", "timestamp", "host"):
            rec.pop(key, None)
        rec["metrics"] = _metrics(rec.get("metrics"))
        if isinstance(rec.get("error"), str):
            rec["error"] = rec["error"].replace(str(study_dir.parents[1]), "<tmp>")
        out.append(rec)
    if not order:
        return out
    return sorted(out, key=lambda r: (r["task_id"], r.get("attempts", 0), r["status"]))


def journal_view(study_dir: Path) -> dict:
    return json.loads((study_dir / "journal.json").read_text())


def run(core, text: str, root: Path, name: str, **kw):
    study = core.ParameterStudy(core.parse_yaml(text), root=root, name=name)
    return study, study.run(**kw)


@pytest.mark.parametrize("text,kw", [
    (PIPELINE, {}),
    (PIPELINE, {"slots": 2, "pool": "thread"}),
    (PIPELINE, {"window": 2}),
    (MATMUL, {"pool": "lane", "window": 64, "slots": 2}),
], ids=["inline", "thread", "window", "matmul-lane"])
def test_same_results_records_and_journal(tmp_path, text, kw):
    views = {}
    for tag, core in ENGINES.items():
        study, results = run(core, text, tmp_path / tag, "s", **kw)
        records = records_view(study.db.dir)
        if kw.get("pool") in ("thread", "lane"):
            for rec in records:
                rec.pop("slot", None)
        views[tag] = (results_view(results), records, journal_view(study.db.dir))
    assert views["port"] == views["ref"]
    statuses = {r[0] for r in views["ref"][0].values()}
    assert "ok" in statuses


@pytest.mark.parametrize("first,second", [("ref", "port"), ("port", "ref")])
@pytest.mark.parametrize("window", [None, 4])
def test_resume_across_engines(tmp_path, first, second, window):
    """A study begun by one engine (half its instances failing until a
    marker exists) is finished by the other, which reruns only what
    failed and ends where one engine alone ends."""
    marker = tmp_path / "go"
    text = f"""
t:
  args:
    i: ["1:6"]
  command: sh -c "test ${{args:i}} -le 3 || test -e {marker}"
"""
    _, res1 = run(ENGINES[first], text, tmp_path / "a", "s", window=window)
    assert sorted(r.status for r in res1.values()) == ["failed"] * 3 + ["ok"] * 3
    marker.touch()
    study, res2 = run(ENGINES[second], text, tmp_path / "a", "s", window=window,
                      resume=True)
    assert all(r.status == "ok" for r in res2.values())
    runs = {}
    for rec in records_view(study.db.dir, order=False):
        runs.setdefault(rec["task_id"], []).append(rec["status"])
    assert sorted(map(tuple, runs.values())) == [("failed", "ok")] * 3 + [("ok",)] * 3
    # the same two runs through one engine leave the same journal
    marker.unlink()
    run(ENGINES[second], text, tmp_path / "b", "s", window=window)
    marker.touch()
    alone, _ = run(ENGINES[second], text, tmp_path / "b", "s", window=window, resume=True)
    assert journal_view(study.db.dir) == journal_view(alone.db.dir)


LINTED = [ROOT / "tests" / "fixtures" / "broken_study.yaml",
          ROOT / "examples" / "matmul_perf.yaml"]


def _findings(report):
    return [(f.rule, f.severity, f.message, f.task, f.keyword, f.file, f.line)
            for f in report.findings]


@pytest.mark.parametrize("path", LINTED, ids=lambda p: p.name)
def test_same_lint_findings(path):
    want = ref_lint.lint_file(path)
    got = port_lint.lint_file(path)
    assert _findings(got) == _findings(want)
    assert got.suppressed == want.suppressed and got.ok == want.ok
    assert port_lint.render_text({str(path): got}) == ref_lint.render_text({str(path): want})
    if path.name == "broken_study.yaml":
        assert {f[0] for f in _findings(got)} >= {"E101", "E201", "E202", "E301", "W601"}


def test_same_lint_findings_of_the_quickstart_study():
    """The quickstart's deliberately broken study, through parse_yaml."""
    import ast
    texts = [n.value for n in ast.walk(ast.parse((ROOT / "examples" / "quickstart.py").read_text()))
             if isinstance(n, ast.Constant) and isinstance(n.value, str) and "ghost" in n.value]
    assert texts
    for text in texts:
        want = ref.lint(ref.parse_yaml(text, validate=False, filename="q.yaml"))
        got = port.lint(port.parse_yaml(text, validate=False, filename="q.yaml"))
        assert _findings(got) and _findings(got) == _findings(want)


@pytest.fixture(scope="module")
def matmul_dirs(tmp_path_factory):
    """The matmul study's provenance, once from each engine."""
    root = tmp_path_factory.mktemp("matmul")
    dirs = {}
    for tag, core in ENGINES.items():
        study, _ = run(core, MATMUL, root / tag, "matmulOMP", pool="lane", window=64,
                       slots=2)
        dirs[tag] = study.db.dir
    return dirs


def _report(mod, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("fmt", ["md", "csv", "json"])
@pytest.mark.parametrize("kind", ["summary", "table", "speedup"])
def test_same_report_tables(matmul_dirs, kind, fmt):
    """Each engine's report of each engine's records is the reference's
    report of its own."""
    argv = ["--group-by", "size,threads", "--metric", "time", "--report", kind,
            "--format", fmt, "--baseline", "threads=1"]
    want = _report(ref_report, [str(matmul_dirs["ref"]), *argv])
    assert want[0] == 0 and want[1].strip()
    for mod, tag in ((port_report, "port"), (port_report, "ref"), (ref_report, "port")):
        assert _report(mod, [str(matmul_dirs[tag]), *argv]) == want


def test_same_dag_renderings(tmp_path):
    studies = {tag: core.ParameterStudy(core.parse_yaml(PIPELINE), root=tmp_path / tag,
                                        name="s")
               for tag, core in ENGINES.items()}
    dags = {tag: s.build_dag() for tag, s in studies.items()}
    ids = sorted(n.id for n in dags["ref"].topological())
    states = {nid: ("ok", "failed", "pending", "skipped")[i % 4] for i, nid in enumerate(ids)}
    for kw in ({}, {"states": states}):
        assert port.to_ascii(dags["port"], **kw) == ref.to_ascii(dags["ref"], **kw)
        assert port.to_dot(dags["port"], **kw) == ref.to_dot(dags["ref"], **kw)
    assert "->" in port.to_dot(dags["port"])


def test_same_json_and_ini_studies():
    doc = {"t": {"args": {"x": ["1:4"], "y": [0.5, 1.0]}, "command": "run ${args:x}"}}
    for text, parse in ((json.dumps(doc), "parse_json"),
                        ("[t]\nargs.x = 1:4\nargs.y = 0.5, 1.0\ncommand = run ${args:x}\n",
                         "parse_ini")):
        got = getattr(port, parse)(text, filename="s")
        want = getattr(ref, parse)(text, filename="s")
        assert got.origin == want.origin
        assert {n: t.parameters() for n, t in got.tasks.items()} == \
            {n: t.parameters() for n, t in want.tasks.items()}


# -- expansion and interpolation ---------------------------------------------
_names = st.sampled_from(["x", "y", "size", "n", "mode"])
_values = st.lists(
    st.integers(-5, 50) | st.floats(-1e3, 1e3, allow_nan=False)
    | st.sampled_from(["1:4", "2:2:9", "1:*2:16", "0.5:0.5:2", "fast", "a b"]),
    min_size=1, max_size=3)


@st.composite
def _tasks(draw):
    args = draw(st.dictionaries(_names, _values, min_size=1, max_size=3))
    body = {"args": args, "command": "run " + " ".join(f"${{args:{k}}}" for k in args)}
    if draw(st.booleans()):
        body["environ"] = {"OMP": draw(_values)}
    if draw(st.booleans()):
        body["sampling"] = {"method": draw(st.sampled_from(["uniform", "random"])),
                            "count": draw(st.integers(1, 6)), "seed": draw(st.integers(0, 9))}
    return {"t": body}


def _space(core_mod, space_mod, text):
    task = core_mod.parse_yaml(text, validate=False).tasks["t"]
    space = space_mod.from_task(task.parameters(), task.fixed, task.sampling)
    sample = space.sample()
    return (space.size(), space.space_hash(), sample,
            [space_mod.combo_id(c) for c in sample])


@settings(max_examples=40, deadline=None, suppress_health_check=list(HealthCheck))
@given(_tasks())
def test_same_parameter_expansion(doc):
    text = yaml.safe_dump(doc, default_flow_style=None)
    want = _space(ref, ref_space, text)
    got = _space(port, port_space, text)
    assert got[:2] == want[:2] and got[3] == want[3]
    assert all(math.isclose(a, b) if isinstance(a, float) else a == b
               for gc, wc in zip(got[2], want[2]) for a, b in zip(gc.values(), wc.values()))


_refs = st.sampled_from(["${args:x}", "${x}", "${environ:OMP}", "${args:nope}", "${y}",
                         "${t:args:x}", "$x", "${", "}", "${args:x}${args:x}"])


@settings(max_examples=60, deadline=None, suppress_health_check=list(HealthCheck))
@given(st.lists(st.text(alphabet="ab ${}:_-", max_size=6) | _refs, max_size=6),
       st.dictionaries(st.sampled_from(["args:x", "args:y", "environ:OMP", "mode"]),
                       st.integers(0, 99) | st.sampled_from(["v", "${args:x}", 1.5]),
                       max_size=4))
def test_same_interpolation(parts, combo):
    text = "".join(parts)

    def outcome(mod):
        try:
            return ("ok", mod.interpolate(text, combo, task="t"))
        except Exception as e:           # the same error, by type name and text
            return (type(e).__name__, str(e))
    assert outcome(port_interp) == outcome(ref_interp)
