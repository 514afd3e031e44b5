"""The port's YAML reader (``repro_torch.core._yaml``, no PyYAML) against
``yaml.safe_load`` and the reference's line map: every YAML file and study
text of the repo, the YAML 1.1 scalar traps, studies written by
``yaml.safe_dump`` in every style, and the constructs outside the subset."""
import ast
import dataclasses
import datetime
import math
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.core import wdl as ref_wdl
from repro_torch.core import _yaml
from repro_torch.core import wdl

ROOT = Path(__file__).resolve().parents[1]
YAML_FILES = sorted([*ROOT.glob("examples/*.yaml"), *ROOT.glob("examples/chaos/*.yaml"),
                     *ROOT.glob("tests/fixtures/*.yaml")])


def _study_texts() -> list[tuple[str, str]]:
    """String constants of the repo's tests and examples that safe_load
    reads as a mapping of mappings (this file's own texts, which hold the
    refused constructs, excepted)."""
    out = []
    for path in sorted([*ROOT.glob("tests/*.py"), *ROOT.glob("examples/*.py")]):
        if path.name == Path(__file__).name:
            continue
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
                continue
            try:
                doc = yaml.safe_load(node.value)
            except Exception:
                continue
            if isinstance(doc, dict) and doc and all(isinstance(v, dict)
                                                     for v in doc.values()):
                out.append((f"{path.relative_to(ROOT)}:{node.lineno}", node.value))
    return out


STUDY_TEXTS = _study_texts()


def same(a, b) -> bool:
    """Equal values of equal types all the way down (NaN equals NaN; dict
    keys in the same order)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return (len(a) == len(b)
                and all(same(x, y) and same(a[x], b[y]) for x, y in zip(a, b)))
    return a == b


def _spec(mod, text: str):
    """The parsed study (as plain data) or the error, without validation."""
    try:
        return dataclasses.asdict(mod.parse_yaml(text, validate=False))
    except mod.WDLError as e:
        return ("error", str(e), e.line)


def assert_reads_as_pyyaml(text: str) -> None:
    want = yaml.safe_load(text)
    got = _yaml.safe_load(text)
    assert same(got, want), (got, want)
    assert wdl._yaml_line_map(text) == ref_wdl._yaml_line_map(text)
    if isinstance(want, dict):
        assert same(_spec(wdl, text), _spec(ref_wdl, text))


@pytest.mark.parametrize("path", YAML_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_repo_yaml_files(path):
    assert_reads_as_pyyaml(path.read_text())


def test_the_texts_were_collected():
    names = {name.split(":")[0] for name, _ in STUDY_TEXTS}
    assert len(STUDY_TEXTS) >= 140
    assert {"tests/test_lint.py", "tests/test_system.py", "examples/quickstart.py"} <= names


@pytest.mark.parametrize("text", [t for _, t in STUDY_TEXTS],
                         ids=[name for name, _ in STUDY_TEXTS])
def test_repo_study_texts(text):
    assert_reads_as_pyyaml(text)


#: the YAML 1.1 traps: (input, what safe_load gives)
TRAPS = [
    ("1e-3", "1e-3"),                   # a float needs a dot
    ("1.0e-3", 0.001),
    ("1:30", 90),                       # base 60
    ("[1:16, 2:*2:8]", [76, "2:*2:8"]),
    ("010", 8),
    ("0o10", "0o10"),
    ("0x1F", 31),
    ("1_000", 1000),
    ("yes", True),
    ("On", True),
    ("~", None),
    (".inf", math.inf),
    ("2018-01-01", datetime.date(2018, 1, 1)),
    ("-.inf", -math.inf),
    (".NaN", math.nan),
    ("-.5", "-.5"),
    ("1.0e3", "1.0e3"),
    ("0b101", 5),
    ("190:20:30.15", 685230.15),
    ("1:70", "1:70"),
    ("off", False),
    ("NULL", None),
    ("''", ""),
    ("'it''s'", "it's"),
    ('"\\x41\\u00e9\\t"', "A\u00e9\t"),
    ("2001-12-14t21:59:43.10-05:00", datetime.datetime(
        2001, 12, 14, 21, 59, 43, 100000,
        tzinfo=datetime.timezone(-datetime.timedelta(hours=5)))),
    ("16:*2:16384", "16:*2:16384"),
    ("a: b", None),                     # no: a mapping value on its key's line
]


@pytest.mark.parametrize("raw,want", TRAPS, ids=[t[0] for t in TRAPS])
def test_scalar_traps(raw, want):
    text = f"t:\n  v: {raw}\n"
    if raw == "a: b":
        with pytest.raises(yaml.YAMLError):
            yaml.safe_load(text)
        with pytest.raises(_yaml.YAMLError):
            _yaml.safe_load(text)
        return
    assert same(yaml.safe_load(text)["t"]["v"], want)
    assert_reads_as_pyyaml(text)
    # the same scalar in a flow sequence, and as a block sequence entry
    assert_reads_as_pyyaml(f"t:\n  v: [{raw}, x]\n")
    assert_reads_as_pyyaml(f"t:\n  v:\n  - {raw}\n")


#: constructs of the subset that the repo's studies do not spell out
SHAPES = [
    "t:\n  command: >-\n    awk 'BEGIN { x }'\n    more\n\n    para\n",
    "t:\n  command: |\n    one\n      two\n\n  args: {a: [1, 2]}\n",
    "t:\n  command: |+\n    kept\n\n\nu:\n  command: x\n",
    "t:\n  command: >2\n     indented\n    text\n",
    "t:\n  v: 'a # not a comment'  # a comment\n",
    "t:\n  v: \"folded\n    over\n\n    lines\"\n",
    "t:\n  v: plain\n    continued\n",
    "t:\n  v: [a, {b: 1, c: [2, 3]},\n      d]\n",
    "t:\n  v: {a: 1, b, c: }\n",
    "t:\n  v: [k: 1, x]\n",
    "t:\n  v:\n  - a: 1\n    b: 2\n  - - x\n    - y\n",
    "t: {v: 1}\nu:\n  w: x#y\n",
    "t:\n  v: \"esc \\\n    aped\"\n",
    "\n# only comments here\nt:\n    v: 1   \n\n",
    "t:\n  =: 1\n  yes: 2\n  1: 3\n",
]


@pytest.mark.parametrize("text", SHAPES)
def test_subset_shapes(text):
    assert_reads_as_pyyaml(text)


#: (text, the 1-based line that the error names)
OUTSIDE = [
    ("t:\n  a: &x 1\n  b: *x\n", 2),                  # anchor
    ("t:\n  a: 1\n  b: *x\n", 3),                     # alias
    ("t:\n  a: !!str 1\n", 2),                        # tag
    ("base: {a: 1}\nt:\n  <<: {a: 1}\n  b: 2\n", 3),  # merge key
    ("t:\n  a: 1\n---\nu:\n  a: 2\n", 3),             # a second document
    ("---\nt:\n  a: 1\n", 1),                         # a document marker
    ("t:\n  ? a\n  : 1\n", 2),                        # complex key
    ("t:\n  [a, b]: 1\n", 2),                         # collection key
    ("%YAML 1.1\n---\nt: {a: 1}\n", 1),               # directive
    ("t:\n  a:\t1\n", 2),                             # tab as separation
    ("t:\n  a: 1\n   b: 2\n", 3),                     # bad indentation
    ("t:\n  a: 'open\n", 3),                          # unterminated quote
]


@pytest.mark.parametrize("text,line", OUTSIDE, ids=[str(i) for i in range(len(OUTSIDE))])
def test_outside_the_subset_raises_with_its_line(text, line):
    with pytest.raises(wdl.WDLError) as err:
        wdl.parse_yaml(text, filename="study.yaml")
    assert err.value.line == line, str(err.value)
    assert err.value.file == "study.yaml"
    assert str(err.value).startswith(f"study.yaml:{line}: YAML parse error")
    with pytest.raises(_yaml.YAMLError):
        _yaml.safe_load(text)


# -- studies written by yaml.safe_dump ----------------------------------------
_keys = st.from_regex(r"[A-Za-z_][A-Za-z0-9_]{0,10}", fullmatch=True) | st.sampled_from(
    ["yes", "on", "null", "1", "2018-01-01", "a b", "x:y", "~", "=", "0x1F", "1e-3"])
_texts = st.text(max_size=40) | st.sampled_from(
    ["1:16", "16:*2:16384", "${args:x}", "a: b", "- x", "#", " lead", "trail ",
     "multi\nline", "tab\there", "", "1:30", "yes", "0o10", "1e-3"])
_scalars = (st.none() | st.booleans() | st.integers() | st.floats() | _texts
            | st.dates())


def _studies(scalars):
    leaf = scalars | st.lists(scalars, max_size=4)
    kw = leaf | st.dictionaries(_keys, leaf | st.dictionaries(_keys, leaf, max_size=3),
                                max_size=3)
    return st.dictionaries(_keys, st.dictionaries(_keys, kw, max_size=4),
                           min_size=1, max_size=3)


_dump = {"default_flow_style": st.sampled_from([False, True, None]),
         "width": st.sampled_from([80, 20, 4000]), "allow_unicode": st.booleans(),
         "indent": st.sampled_from([2, 4]), "sort_keys": st.just(False)}


@settings(max_examples=60, deadline=None, suppress_health_check=list(HealthCheck))
@given(st.one_of(
    st.tuples(_studies(_scalars), st.fixed_dictionaries(_dump)),
    # quoted and block styles throughout (strings only: other types would
    # carry explicit tags, which the subset refuses)
    st.tuples(_studies(_texts), st.fixed_dictionaries(
        {**_dump, "default_style": st.sampled_from(["'", '"', "|", ">"])}))))
def test_safe_dump_studies(case):
    doc, options = case
    assert_reads_as_pyyaml(yaml.safe_dump(doc, **options))
