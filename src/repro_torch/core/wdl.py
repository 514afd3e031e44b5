"""PaPaS Workflow Description Language (WDL) parser.

Implements the keyword-value WDL of Ponce et al. (PEARC'18) §5:

* A parameter study is a mapping of task names to up-to-two-level
  keyword/value entries.
* Serialization formats: YAML, JSON, and INI-like (subset).
* Numeric ranges with step size: ``start:step:end`` (inclusive) and the
  multiplicative form ``start:*k:end`` used by the paper's matmul example
  (``16:*2:16384``).  The two-field form ``a:b`` means step 1.
* ``#`` comments, colon-delimited entries, indentation scoping (all three
  handled natively by the YAML reader; the INI reader implements a
  restricted equivalent).  The YAML reader is this package's own
  (``_yaml``, the standard library alone): it reads the YAML that studies
  are written in as ``yaml.safe_load`` reads it and refuses the rest
  (anchors, aliases, tags, merge keys, more than one document, complex
  keys) with a :class:`WDLError` naming the line.
* All keywords parse as strings; values are type-inferred.

Reserved keywords (paper §5): command, name, environ, after, infiles,
outfiles, substitute, parallel, batch, nnodes, ppnode, hosts, fixed,
sampling — plus framework extensions: ``timeout`` (per-attempt
wall-clock bound enforced by the scheduler), ``straggler_quantile``
(straggler cutoff as a runtime quantile, e.g. ``p90`` or ``0.9``,
instead of the default ``straggler_factor × median``), ``allow_nonzero``
(nonzero shell exits are data, not failures), ``capture`` (declarative
metric extraction — a mapping of metric names to extractors over task
output: a regex string, or a mapping with exactly one of
``regex:``/``json:``/``csv:``/``builtin:`` plus optional ``source:``
(stdout | stderr | outfile:<name> | file:<path template>),
``required:``, ``type:``, and ``group:``; builtins are ``rc``,
``duration``, ``host``, ``slot`` — see ``repro_torch.core.results``),
``baseline`` (the reference parameter point for derived
speedup/efficiency metrics, e.g. ``baseline: {threads: 1}``), and
``retry`` (per-task retry policy threaded to the scheduler: ``max:``
attempts beyond the first, ``backoff: exponential | fixed``, ``base:``
seconds before the first re-dispatch, ``jitter:`` a ±fraction spread,
``max_delay:`` a cap on any single backoff (default 30 s),
``retry_on:`` the failure kinds worth retrying — any of ``nonzero``,
``timeout``, ``host``, ``error`` — e.g. ``retry: {max: 3, backoff:
exponential, base: 0.5, retry_on: [timeout, host]}``; see
``repro_torch.core.scheduler.RetryPolicy``).  Anything else is a user-defined
keyword usable in interpolations (e.g. ``args`` in the paper's Fig. 5).

One top-level section name is reserved for the framework: ``lint:`` is
not a task but the study-local static-analysis policy consumed by
``papas lint`` / ``sweep --check`` (see ``repro_torch.core.lint``)::

    lint:
      suppress: [W601, E302]   # rule ids to silence for this study
      max_runtime_days: 90     # cost-estimate budget (default 30)
      slots: 16                # assumed concurrency for the estimate

Parse diagnostics are structured: every :class:`WDLError` carries the
task name, the dotted keyword path (``matmul.capture.gflops.regex``),
and the source file/line when parsed from YAML/INI.
"""
from __future__ import annotations

import configparser
import dataclasses
import json
import re
from pathlib import Path
from typing import Any, Mapping, Sequence

from . import _yaml

RESERVED_KEYWORDS = frozenset(
    {
        "command",
        "name",
        "environ",
        "after",
        "infiles",
        "outfiles",
        "substitute",
        "parallel",
        "batch",
        "nnodes",
        "ppnode",
        "hosts",
        "fixed",
        "sampling",
        "timeout",
        "allow_nonzero",
        "capture",
        "baseline",
        "straggler_quantile",
        "retry",
    }
)

#: ``start:step:end`` — step may be ``*k`` for multiplicative ranges.
_RANGE_RE = re.compile(
    r"^\s*(?P<start>[+-]?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)\s*:"
    r"(?:\s*(?P<step>\*?\s*[+-]?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)\s*:)?"
    r"\s*(?P<end>[+-]?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)\s*$"
)


class WDLError(ValueError):
    """Raised on malformed workflow description input.

    Every diagnostic carries structured context — ``task`` (the task
    section it arose in), ``keyword`` (the dotted keyword path inside
    the task, e.g. ``capture.gflops.regex``), and ``file``/``line``
    (the source location when parsed from YAML/INI) — so tools like
    ``papas lint`` can point at the exact declaration.  ``str()``
    prefixes whatever context is known::

        study.yaml:12: matmul.capture.gflops.regex: bad regex ...
    """

    def __init__(self, message: str, *, task: str | None = None,
                 keyword: str | None = None, file: str | None = None,
                 line: int | None = None) -> None:
        super().__init__(message)
        self.message = message
        self.task = task
        self.keyword = keyword
        self.file = file
        self.line = line

    def with_context(self, *, task: str | None = None,
                     keyword: str | None = None, file: str | None = None,
                     line: int | None = None) -> "WDLError":
        """Fill in context fields not already set (inner raise sites know
        more than outer ones — first writer wins); returns ``self``."""
        if self.task is None:
            self.task = task
        if self.keyword is None:
            self.keyword = keyword
        if self.file is None:
            self.file = file
        if self.line is None:
            self.line = line
        return self

    @property
    def keyword_path(self) -> str:
        """``task.keyword.sub`` dotted path ('' when no context)."""
        return ".".join(p for p in (self.task, self.keyword) if p)

    def __str__(self) -> str:
        prefix = []
        if self.file:
            prefix.append(f"{self.file}:{self.line}" if self.line
                          else str(self.file))
        if self.keyword_path:
            prefix.append(self.keyword_path)
        if prefix:
            return f"{': '.join(prefix)}: {self.message}"
        return self.message


def _num(text: str) -> int | float:
    """Parse a numeric literal, preferring int."""
    f = float(text)
    if f.is_integer() and "e" not in text.lower() and "." not in text:
        return int(text)
    return f


def parse_range(text: str) -> list[int | float] | None:
    """Expand ``start[:step]:end`` range notation to a value list.

    Returns None when ``text`` is not range syntax.  Supports additive
    steps (``1:2:9`` → 1,3,5,7,9) and multiplicative steps
    (``16:*2:128`` → 16,32,64,128).  Two-field ``1:8`` means step 1.
    """
    if not isinstance(text, str):
        return None
    m = _RANGE_RE.match(text)
    if not m:
        return None
    start = _num(m.group("start"))
    end = _num(m.group("end"))
    step_raw = m.group("step")
    values: list[int | float] = []
    if step_raw is None:
        step: int | float = 1
        multiplicative = False
    else:
        step_raw = step_raw.replace(" ", "")
        multiplicative = step_raw.startswith("*")
        step = _num(step_raw[1:] if multiplicative else step_raw)
    if multiplicative:
        if step == 0 or abs(step) == 1 or start == 0:
            raise WDLError(f"degenerate multiplicative range: {text!r}")
        cur = start
        # multiplicative ranges iterate |cur| toward |end|
        while (abs(cur) <= abs(end)) if abs(step) > 1 else (abs(cur) >= abs(end)):
            values.append(cur)
            cur = cur * step
            if len(values) > 1_000_000:
                raise WDLError(f"range too large: {text!r}")
    else:
        if step == 0:
            raise WDLError(f"zero step in range: {text!r}")
        cur = start
        if step > 0:
            while cur <= end + 1e-12:
                values.append(cur if isinstance(start, float) or isinstance(step, float) else int(cur))
                cur = cur + step
                if len(values) > 1_000_000:
                    raise WDLError(f"range too large: {text!r}")
        else:
            while cur >= end - 1e-12:
                values.append(cur if isinstance(start, float) or isinstance(step, float) else int(cur))
                cur = cur + step
    return values


def infer_value(raw: Any) -> Any:
    """Type-infer a scalar WDL value (paper: 'values are inferred')."""
    if isinstance(raw, str):
        rng = parse_range(raw)
        if rng is not None:
            return rng
        txt = raw.strip()
        for caster in (int, float):
            try:
                return caster(txt)
            except ValueError:
                continue
        if txt.lower() in ("true", "false"):
            return txt.lower() == "true"
        return raw
    return raw


def _expand_values(raw: Any) -> list[Any]:
    """Normalize a keyword's raw value(s) into the multi-value list form."""
    if isinstance(raw, list):
        out: list[Any] = []
        for item in raw:
            v = infer_value(item)
            if isinstance(v, list):
                out.extend(v)
            else:
                out.append(v)
        return out
    v = infer_value(raw)
    return v if isinstance(v, list) else [v]


@dataclasses.dataclass
class TaskSpec:
    """One task (section) of a parameter study."""

    task: str
    command: str | None = None
    name: str = ""
    environ: dict[str, list[Any]] = dataclasses.field(default_factory=dict)
    after: list[str] = dataclasses.field(default_factory=list)
    infiles: dict[str, str] = dataclasses.field(default_factory=dict)
    outfiles: dict[str, str] = dataclasses.field(default_factory=dict)
    substitute: dict[str, list[Any]] = dataclasses.field(default_factory=dict)
    parallel: str | None = None
    batch: str | None = None
    nnodes: int | None = None
    ppnode: int | None = None
    hosts: list[str] = dataclasses.field(default_factory=list)
    fixed: list[list[str]] = dataclasses.field(default_factory=list)
    sampling: dict[str, Any] | None = None
    timeout: float | None = None
    allow_nonzero: bool = False
    #: straggler cutoff as a runtime quantile (e.g. 0.9 or "p90") —
    #: replaces the default ``straggler_factor × median`` rule
    straggler_quantile: float | None = None
    #: metric name → CaptureSpec (declarative result extraction)
    capture: dict[str, Any] = dataclasses.field(default_factory=dict)
    #: reference parameter point for speedup/efficiency derivation
    baseline: dict[str, Any] = dataclasses.field(default_factory=dict)
    #: retry policy for the scheduler (``max``, ``backoff``, ``base``,
    #: ``jitter``, ``retry_on``) — empty means the engine default
    retry: dict[str, Any] = dataclasses.field(default_factory=dict)
    #: user-defined keywords → {subkey: [values]} or {None: [values]}
    user: dict[str, dict[str | None, list[Any]]] = dataclasses.field(
        default_factory=dict
    )

    def parameters(self) -> dict[str, list[Any]]:
        """All sweepable parameters, name → value list.

        Names are colon paths mirroring interpolation syntax:
        ``environ:VAR``, ``<user_kw>:<sub>`` or bare ``<user_kw>``.
        """
        params: dict[str, list[Any]] = {}
        for var, values in self.environ.items():
            params[f"environ:{var}"] = values
        for kw, subs in self.user.items():
            for sub, values in subs.items():
                key = kw if sub is None else f"{kw}:{sub}"
                params[key] = values
        for pattern, values in self.substitute.items():
            params[f"substitute:{pattern}"] = values
        return params


@dataclasses.dataclass
class StudySpec:
    """A parsed parameter study: ordered tasks (+ a ``lint:`` policy
    block and, when parsed from a file, the source origin)."""

    tasks: dict[str, TaskSpec]
    #: parsed top-level ``lint:`` block — keys ``suppress`` (rule ids),
    #: ``max_runtime_days``, ``slots`` (see ``repro_torch.core.lint``)
    lint: dict[str, Any] = dataclasses.field(default_factory=dict)
    #: source provenance: {"file": str|None, "lines": {(task, kw, ...):
    #: line}} — populated by the YAML/INI parsers, diagnostic-only
    origin: dict[str, Any] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def validate(self) -> None:
        names = set(self.tasks)
        for t in self.tasks.values():
            for dep in t.after:
                if dep not in names:
                    raise WDLError(
                        f"task {t.task!r}: unknown dependency {dep!r}",
                        task=t.task, keyword="after")
            for mname, cap in t.capture.items():
                source = getattr(cap, "source", "stdout")
                if source.startswith("outfile:") \
                        and source[len("outfile:"):] not in t.outfiles:
                    raise WDLError(
                        f"task {t.task!r}: capture {mname!r} reads "
                        f"{source!r} but the task declares no such "
                        f"outfile (declared: {sorted(t.outfiles) or 'none'})",
                        task=t.task, keyword=f"capture.{mname}.source")
            for group in t.fixed:
                params = t.parameters()
                lens = []
                for pname in group:
                    if pname not in params:
                        # allow bare names matching a unique tail
                        matches = [k for k in params if k == pname or k.endswith(":" + pname)]
                        if len(matches) != 1:
                            raise WDLError(
                                f"task {t.task!r}: fixed refers to unknown/ambiguous "
                                f"parameter {pname!r}",
                                task=t.task, keyword="fixed")
                        pname = matches[0]
                    lens.append(len(params[pname]))
                if len(set(lens)) > 1:
                    raise WDLError(
                        f"task {t.task!r}: fixed group {group} has mismatched "
                        f"value counts {lens} (bijection requires equal lengths)",
                        task=t.task, keyword="fixed")


def _parse_task(name: str, body: Mapping[str, Any]) -> TaskSpec:
    if not isinstance(body, Mapping):
        raise WDLError(
            f"task {name!r}: body must be a mapping, got "
            f"{type(body).__name__}", task=str(name))
    spec = TaskSpec(task=str(name))
    for kw_raw, val in body.items():
        kw = str(kw_raw)
        try:
            _parse_keyword(spec, name, kw, val)
        except WDLError as e:
            # inner sites may know a deeper path (capture.gflops.regex);
            # default to the keyword being dispatched
            raise e.with_context(task=str(name), keyword=kw)
    return spec


def _parse_keyword(spec: TaskSpec, name: str, kw: str, val: Any) -> None:
    if kw == "command":
        if not isinstance(val, str):
            raise WDLError(f"task {name!r}: command must be a string")
        spec.command = val
    elif kw == "name":
        spec.name = str(val)
    elif kw == "environ":
        if not isinstance(val, Mapping):
            raise WDLError(f"task {name!r}: environ must be a mapping")
        spec.environ = {str(k): _expand_values(v) for k, v in val.items()}
    elif kw == "after":
        spec.after = [str(v) for v in (val if isinstance(val, list) else [val])]
    elif kw in ("infiles", "outfiles"):
        if not isinstance(val, Mapping):
            raise WDLError(f"task {name!r}: {kw} must be a mapping")
        getattr(spec, kw).update({str(k): str(v) for k, v in val.items()})
    elif kw == "substitute":
        if not isinstance(val, Mapping):
            raise WDLError(f"task {name!r}: substitute must be a mapping")
        spec.substitute = {str(k): _expand_values(v) for k, v in val.items()}
    elif kw == "parallel":
        spec.parallel = str(val)
    elif kw == "batch":
        spec.batch = str(val)
    elif kw in ("nnodes", "ppnode"):
        setattr(spec, kw, int(val))
    elif kw == "hosts":
        spec.hosts = [str(v) for v in (val if isinstance(val, list) else [val])]
    elif kw == "fixed":
        if isinstance(val, list) and val and isinstance(val[0], list):
            spec.fixed = [[str(p) for p in grp] for grp in val]
        elif isinstance(val, list):
            spec.fixed = [[str(p) for p in val]]
        else:
            raise WDLError(f"task {name!r}: fixed must be a list")
    elif kw == "timeout":
        try:
            spec.timeout = float(val)
        except (TypeError, ValueError) as e:
            raise WDLError(f"task {name!r}: timeout must be a number") from e
        if spec.timeout <= 0:
            raise WDLError(f"task {name!r}: timeout must be positive")
    elif kw == "allow_nonzero":
        spec.allow_nonzero = (
            val if isinstance(val, bool)
            else str(val).strip().lower() in ("1", "true", "yes", "on"))
    elif kw == "straggler_quantile":
        txt = str(val).strip().lower()
        try:
            # "p90"/"P99" shorthand or a plain fraction like 0.9
            q = float(txt[1:]) / 100.0 if txt.startswith("p") \
                else float(txt)
        except (TypeError, ValueError) as e:
            raise WDLError(
                f"task {name!r}: straggler_quantile must be a "
                f"fraction in (0, 1) or 'pNN' (e.g. p90), "
                f"got {val!r}") from e
        if not 0.0 < q < 1.0:
            raise WDLError(
                f"task {name!r}: straggler_quantile must be in "
                f"(0, 1), got {q!r}")
        spec.straggler_quantile = q
    elif kw == "capture":
        from .results import CaptureError, parse_captures

        try:
            spec.capture = parse_captures(name, val)
        except CaptureError as e:
            # CaptureError knows the deep path (capture.gflops.regex)
            raise WDLError(str(e),
                           keyword=getattr(e, "keyword", None)) from e
    elif kw == "baseline":
        if not isinstance(val, Mapping):
            raise WDLError(
                f"task {name!r}: baseline must be a mapping of "
                f"parameter (or captured metric) to reference value")
        spec.baseline = {}
        for k, v in val.items():
            iv = infer_value(v)
            if isinstance(iv, list):
                raise WDLError(
                    f"task {name!r}: baseline value for {k!r} must be "
                    f"a scalar, got {v!r}")
            spec.baseline[str(k)] = iv
    elif kw == "retry":
        spec.retry = _parse_retry_block(name, val)
    elif kw == "sampling":
        if isinstance(val, str):
            spec.sampling = {"method": val}
        elif isinstance(val, Mapping):
            spec.sampling = {str(k): v for k, v in val.items()}
        else:
            raise WDLError(f"task {name!r}: sampling must be a string or mapping")
    else:
        # user-defined keyword: scalar, list, or one more level of k/v
        if isinstance(val, Mapping):
            spec.user[kw] = {str(k): _expand_values(v) for k, v in val.items()}
        else:
            spec.user[kw] = {None: _expand_values(val)}


#: recognized keys of a task's ``retry:`` block.
_RETRY_KEYS = frozenset(
    {"max", "backoff", "base", "jitter", "max_delay", "retry_on"})
#: failure kinds ``retry_on:`` may list (scheduler.classify_failure).
_RETRY_ON = ("nonzero", "timeout", "host", "error")


def _parse_retry_block(name: str, val: Any) -> dict[str, Any]:
    """Validate a task's ``retry:`` block into the plain mapping the
    scheduler's ``RetryPolicy.from_any`` consumes."""
    if not isinstance(val, Mapping):
        raise WDLError(
            f"task {name!r}: retry must be a mapping "
            f"(keys: {', '.join(sorted(_RETRY_KEYS))})")
    out: dict[str, Any] = {}
    for k_raw, v in val.items():
        k = str(k_raw)
        if k not in _RETRY_KEYS:
            raise WDLError(
                f"task {name!r}: unknown retry key {k!r} "
                f"(valid: {', '.join(sorted(_RETRY_KEYS))})",
                keyword=f"retry.{k}")
        if k == "max":
            try:
                out["max"] = int(v)
            except (TypeError, ValueError) as e:
                raise WDLError(
                    f"task {name!r}: retry max must be an integer",
                    keyword="retry.max") from e
            if out["max"] < 0:
                raise WDLError(
                    f"task {name!r}: retry max must be >= 0",
                    keyword="retry.max")
        elif k == "backoff":
            b = str(v).strip().lower()
            if b not in ("exponential", "fixed"):
                raise WDLError(
                    f"task {name!r}: retry backoff must be "
                    f"'exponential' or 'fixed', got {v!r}",
                    keyword="retry.backoff")
            out["backoff"] = b
        elif k in ("base", "jitter", "max_delay"):
            try:
                out[k] = float(v)
            except (TypeError, ValueError) as e:
                raise WDLError(
                    f"task {name!r}: retry {k} must be a number",
                    keyword=f"retry.{k}") from e
            if out[k] < 0 or (k == "jitter" and out[k] > 1):
                raise WDLError(
                    f"task {name!r}: retry {k} must be "
                    f"{'in [0, 1]' if k == 'jitter' else '>= 0'}, "
                    f"got {v!r}", keyword=f"retry.{k}")
        else:   # retry_on
            kinds = v if isinstance(v, list) else [v]
            norm = [str(x).strip().lower() for x in kinds]
            bad = sorted(set(norm) - set(_RETRY_ON))
            if bad:
                raise WDLError(
                    f"task {name!r}: unknown retry_on kind(s) "
                    f"{', '.join(bad)} (valid: {', '.join(_RETRY_ON)})",
                    keyword="retry.retry_on")
            out["retry_on"] = norm
    return out


#: recognized keys of the top-level ``lint:`` block.
_LINT_KEYS = frozenset({"suppress", "max_runtime_days", "slots"})


def _parse_lint_block(val: Any) -> dict[str, Any]:
    """Parse the top-level ``lint:`` block (study-local lint policy)."""
    if val is None:
        return {}
    if not isinstance(val, Mapping):
        raise WDLError("lint: must be a mapping", keyword="lint")
    out: dict[str, Any] = {}
    for k_raw, v in val.items():
        k = str(k_raw)
        if k not in _LINT_KEYS:
            raise WDLError(
                f"lint: unknown key {k!r} "
                f"(valid: {', '.join(sorted(_LINT_KEYS))})",
                keyword=f"lint.{k}")
        if k == "suppress":
            out[k] = [str(s) for s in (v if isinstance(v, list) else [v])]
        elif k == "max_runtime_days":
            try:
                out[k] = float(v)
            except (TypeError, ValueError) as e:
                raise WDLError("lint: max_runtime_days must be a number",
                               keyword="lint.max_runtime_days") from e
        elif k == "slots":
            try:
                out[k] = int(v)
            except (TypeError, ValueError) as e:
                raise WDLError("lint: slots must be an integer",
                               keyword="lint.slots") from e
    return out


def _attach_origin(e: WDLError, origin: Mapping[str, Any] | None) -> WDLError:
    """Fill an error's file/line from a parse origin (line lookup walks
    the longest known prefix of the task.keyword path)."""
    if not origin:
        return e
    lines: Mapping[tuple, int] = origin.get("lines") or {}
    parts: list[str] = []
    if e.task:
        parts.append(e.task)
    if e.keyword:
        parts.extend(e.keyword.split("."))
    line = None
    for n in range(len(parts), 0, -1):
        line = lines.get(tuple(parts[:n]))
        if line is not None:
            break
    return e.with_context(file=origin.get("file"), line=line)


def parse_dict(doc: Mapping[str, Any], validate: bool = True, *,
               origin: Mapping[str, Any] | None = None) -> StudySpec:
    """Parse an already-deserialized study document.

    ``validate=False`` skips ``StudySpec.validate()`` — tools that want
    to collect *all* diagnostics instead of aborting at the first (the
    linter) parse unvalidated and run the rule packs themselves.
    """
    if not isinstance(doc, Mapping) or not doc:
        raise _attach_origin(
            WDLError("study document must be a non-empty mapping of tasks"),
            origin)
    tasks: dict[str, TaskSpec] = {}
    lint_block: dict[str, Any] = {}
    for tname, body in doc.items():
        tname = str(tname)
        try:
            if tname == "lint":
                lint_block = _parse_lint_block(body)
            else:
                tasks[tname] = _parse_task(tname, body or {})
        except WDLError as e:
            raise _attach_origin(e, origin)
    if not tasks:
        raise _attach_origin(
            WDLError("study document declares no tasks"), origin)
    spec = StudySpec(tasks=tasks, lint=lint_block,
                     origin=dict(origin) if origin else {})
    if validate:
        try:
            spec.validate()
        except WDLError as e:
            raise _attach_origin(e, origin)
    return spec


def _yaml_line_map(text: str) -> dict[tuple, int]:
    """(task,), (task, kw), (task, kw, sub) → 1-based source line."""
    try:
        root = _yaml.compose(text)
    except _yaml.YAMLError:  # parse error surfaces via load_yaml
        return {}
    return _node_lines(root)


def _node_lines(root: "_yaml.Node | None") -> dict[tuple, int]:
    lines: dict[tuple, int] = {}
    if root is None or root.kind != "map":
        return lines
    for tkey, tval in root.value:
        tname = str(tkey.value)
        lines[(tname,)] = tkey.line + 1
        if tval.kind != "map":
            continue
        for kkey, kval in tval.value:
            kname = str(kkey.value)
            lines[(tname, kname)] = kkey.line + 1
            if kval.kind != "map":
                continue
            for skey, _sval in kval.value:
                lines[(tname, kname, str(skey.value))] = skey.line + 1
    return lines


def load_yaml(text: str, filename: str | None = None) -> Any:
    """The document of a YAML text, as ``yaml.safe_load`` gives it."""
    return _load(text, filename)[0]


def _load(text: str, filename: str | None) -> tuple[Any, dict[tuple, int]]:
    try:
        root = _yaml.compose(text)
        return _yaml.construct(root), _node_lines(root)
    except _yaml.YAMLError as e:
        raise WDLError(f"YAML parse error: {e.message}", file=filename,
                       line=e.line) from e


def _ini_line_map(text: str) -> dict[tuple, int]:
    """Best-effort section/key → line scan for the INI flavor."""
    lines: dict[tuple, int] = {}
    section: str | None = None
    for i, raw in enumerate(text.splitlines(), 1):
        s = raw.strip()
        if not s or s.startswith(("#", ";")):
            continue
        if s.startswith("[") and s.endswith("]"):
            section = s[1:-1].strip()
            lines.setdefault((section,), i)
        elif section is not None and ("=" in s or ":" in s):
            key = re.split(r"[=:]", s, 1)[0].strip()
            if not key:
                continue
            top, _, sub = key.partition(".")
            lines.setdefault((section, top), i)
            if sub:
                lines.setdefault((section, top, sub), i)
    return lines


def parse_yaml(text: str, validate: bool = True,
               filename: str | None = None) -> StudySpec:
    doc, lines = _load(text, filename)
    origin = {"file": filename, "lines": lines}
    return parse_dict(doc or {}, validate, origin=origin)


def parse_json(text: str, validate: bool = True,
               filename: str | None = None) -> StudySpec:
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        raise WDLError(f"JSON parse error: {e}", file=filename) from e
    return parse_dict(doc, validate,
                      origin={"file": filename, "lines": {}})


def parse_ini(text: str, validate: bool = True,
              filename: str | None = None) -> StudySpec:
    """INI-like flavor: sections are tasks; dotted keys give 2nd level;
    comma-separated values are lists."""
    cp = configparser.ConfigParser(interpolation=None, comment_prefixes=("#", ";"))
    try:
        cp.read_string(text)
    except configparser.Error as e:
        raise WDLError(f"INI parse error: {e}", file=filename) from e
    doc: dict[str, dict[str, Any]] = {}
    for section in cp.sections():
        body: dict[str, Any] = {}
        for key, raw in cp.items(section):
            value: Any = [v.strip() for v in raw.split(",")] if "," in raw else raw
            if "." in key:
                top, sub = key.split(".", 1)
                body.setdefault(top, {})[sub] = value
            else:
                body[key] = value
        doc[section] = body
    return parse_dict(doc, validate,
                      origin={"file": filename, "lines": _ini_line_map(text)})


def parse_file(path: str | Path, validate: bool = True) -> StudySpec:
    """Parse a parameter file, dispatching on extension."""
    path = Path(path)
    text = path.read_text()
    suffix = path.suffix.lower()
    if suffix == ".json":
        return parse_json(text, validate, filename=str(path))
    if suffix in (".ini", ".cfg"):
        return parse_ini(text, validate, filename=str(path))
    return parse_yaml(text, validate, filename=str(path))


def merge(*specs: StudySpec) -> StudySpec:
    """Compose a study from multiple parameter files (paper §4.1: a
    workflow description may be divided across files).

    Two specs declaring the *same* task field-merge (dicts union, lists
    concatenate, scalars overwrite).  Contradictory singletons raise:
    two different ``baseline:`` or ``retry:`` blocks for one task
    (matching the treatment of conflicting ``sampling`` blocks at
    space-construction time), and two different scalar values for one
    ``lint:`` policy key (``suppress`` lists union)."""
    tasks: dict[str, TaskSpec] = {}
    lint: dict[str, Any] = {}
    for spec in specs:
        for key, v in (spec.lint or {}).items():
            if key == "suppress":
                cur = lint.setdefault("suppress", [])
                cur.extend(s for s in v if s not in cur)
            elif key in lint and lint[key] != v:
                raise WDLError(
                    f"conflicting lint.{key} in merged specs: "
                    f"{lint[key]!r} vs {v!r}", keyword=f"lint.{key}")
            else:
                lint[key] = v
        for tname, t in spec.tasks.items():
            if tname in tasks:
                base = tasks[tname]
                if base.baseline and t.baseline \
                        and base.baseline != t.baseline:
                    raise WDLError(
                        f"task {tname!r}: conflicting baseline blocks in "
                        f"merged specs: {base.baseline!r} vs "
                        f"{t.baseline!r} — a study has one reference "
                        f"point", task=tname, keyword="baseline")
                if base.retry and t.retry and base.retry != t.retry:
                    raise WDLError(
                        f"task {tname!r}: conflicting retry blocks in "
                        f"merged specs: {base.retry!r} vs {t.retry!r} "
                        f"— a task has one retry policy",
                        task=tname, keyword="retry")
                for f in dataclasses.fields(TaskSpec):
                    val = getattr(t, f.name)
                    if f.name == "task":
                        continue
                    if isinstance(val, dict):
                        merged = dict(getattr(base, f.name))
                        for k, v in val.items():
                            if (k in merged and isinstance(v, dict)
                                    and isinstance(merged[k], dict)):
                                merged[k] = {**merged[k], **v}
                            else:
                                merged[k] = v
                        setattr(base, f.name, merged)
                    elif isinstance(val, list):
                        setattr(base, f.name, list(getattr(base, f.name)) + list(val))
                    elif val not in (None, ""):
                        setattr(base, f.name, val)
            else:
                tasks[tname] = dataclasses.replace(t)
    out = StudySpec(tasks=tasks, lint=lint)
    out.validate()
    return out
