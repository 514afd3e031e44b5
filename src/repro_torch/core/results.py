"""Results subsystem — declarative metric capture + streaming aggregation.

The paper's performance studies (§6: the OpenMP matmul sweep) end in a
*table*: metrics extracted from every task's output, aggregated over the
swept space into speedup/efficiency curves.  This module is that layer:

* **Declarative extractors** (``CaptureSpec`` / ``CaptureSet``) — the
  WDL ``capture:`` task keyword names metrics and says where each one
  comes from: a regex group over stdout/stderr/an output file, a JSON or
  CSV field path, or a built-in the engine already measures (``rc``,
  ``duration``, ``host``, ``slot``).  Extracted text is type-inferred
  like WDL scalar values.  A metric is ``required`` or optional: a
  missing *required* metric classifies the attempt as a task failure
  (same machinery as a nonzero exit — retries and failure closure
  apply), a missing optional metric records ``null``.
* **Streaming aggregation** (``ResultsAggregator``) — consumes the
  engine's per-completion result stream (``ParameterStudy.run(
  aggregator=…, keep_results=False)``), grouping by any parameter (or
  captured-metric) subset and maintaining count/mean/min/max/std via
  Welford accumulators plus an exact median on the scheduler's dual-heap
  stream.  Group state is O(groups) — a 10^5-instance windowed run with
  ``keep_results=False`` aggregates without ever materializing results.
  (The exact median additionally keeps each group's samples on its two
  heaps; pass ``track_median=False`` for strictly O(1) per-group
  state.)
* **Derived performance-study metrics** — ``speedup()`` computes
  speedup and parallel efficiency relative to a declared baseline
  combination (the WDL ``baseline:`` keyword, e.g. 1 thread), the
  paper's Fig. 6/7 curves, from the same O(groups) state.

Captured metrics persist through ``StudyDB.record(metrics=…)`` on the
group-commit path, so they ride the same durability guarantees as the
journal and survive a journal-v2 resume: completed instances are never
re-extracted, and ``repro_torch.launch.report`` reproduces any live table
offline from ``records.jsonl``.
"""
from __future__ import annotations

import csv
import dataclasses
import io
import json
import math
import re
from typing import Any, Callable, Iterable, Iterator, Mapping, Sequence

from .interpolate import interpolate
from .scheduler import _StreamingMedian

#: metrics the engine measures itself — always present, never "missing".
BUILTIN_CAPTURES = ("rc", "duration", "host", "slot")

#: sources a text extractor may read from.
_SOURCES = ("stdout", "stderr")


class CaptureError(ValueError):
    """Raised on a malformed ``capture:`` declaration.

    ``keyword`` carries the keyword path of the offending entry relative
    to the task (e.g. ``capture.gflops.regex``) so parse diagnostics can
    point at the exact WDL line (see ``WDLError.with_context``).
    """

    def __init__(self, message: str, keyword: str | None = None) -> None:
        super().__init__(message)
        self.keyword = keyword


def infer_scalar(text: str) -> Any:
    """Type-infer one captured scalar, mirroring WDL value inference for
    scalars (int, then float, then bool, else the raw string).  Range
    syntax is deliberately *not* expanded — ``16:32`` in task output is
    data, not a sweep declaration."""
    txt = text.strip()
    for caster in (int, float):
        try:
            return caster(txt)
        except ValueError:
            continue
    if txt.lower() in ("true", "false"):
        return txt.lower() == "true"
    return text


_CASTERS: dict[str, Callable[[str], Any]] = {
    "int": lambda s: int(float(s)),
    "float": float,
    "str": str,
    "bool": lambda s: s.strip().lower() in ("1", "true", "yes", "on"),
}


@dataclasses.dataclass(frozen=True)
class CaptureSpec:
    """One declared metric: where it comes from and how to read it.

    ``kind`` is ``regex`` (``pattern`` + ``group``), ``json`` / ``csv``
    (``path`` — a dotted field path / a column name), or ``builtin``
    (``path`` names one of ``rc``/``duration``/``host``/``slot``).
    ``source`` is ``stdout`` (default), ``stderr``, ``outfile:<name>``
    (the task's declared output file, path template rendered per
    instance), or ``file:<template>`` (any path template).  ``cast``
    forces the type; otherwise scalar WDL inference applies.
    """

    name: str
    kind: str                       # regex | json | csv | builtin
    pattern: re.Pattern | None = None
    path: str | None = None         # json/csv field path or builtin name
    group: int | str | None = None  # regex group override
    source: str = "stdout"
    required: bool = False
    cast: str | None = None

    def convert(self, raw: Any) -> Any:
        if raw is None:
            return None
        if self.cast is not None:
            return _CASTERS[self.cast](raw if isinstance(raw, str)
                                       else str(raw))
        return infer_scalar(raw) if isinstance(raw, str) else raw


def parse_capture(task: str, name: str, raw: Any) -> CaptureSpec:
    """Parse one ``capture:`` entry.

    Shorthand (string value): a builtin name (``rc``, ``duration``,
    ``host``, ``slot``) or a regex applied to stdout (optional metric —
    mark required via the mapping form).  Mapping form: exactly one of
    ``regex:`` / ``json:`` / ``csv:`` / ``builtin:``, plus optional
    ``source:``, ``required:``, ``type:``, ``group:``.
    """
    where = f"task {task!r}: capture {name!r}"
    kwpath = f"capture.{name}"
    if isinstance(raw, str):
        if raw in BUILTIN_CAPTURES:
            return CaptureSpec(name=name, kind="builtin", path=raw)
        return CaptureSpec(name=name, kind="regex",
                           pattern=_compile(where, raw, kwpath))
    if not isinstance(raw, Mapping):
        raise CaptureError(
            f"{where}: entry must be a string (regex or builtin name) "
            f"or a mapping, got {type(raw).__name__}", kwpath)
    body = {str(k): v for k, v in raw.items()}
    kinds = [k for k in ("regex", "json", "csv", "builtin") if k in body]
    if len(kinds) != 1:
        raise CaptureError(
            f"{where}: declare exactly one of regex/json/csv/builtin "
            f"(got {kinds or 'none'})", kwpath)
    kind = kinds[0]
    extra = set(body) - {kind, "source", "required", "type", "group"}
    if extra:
        raise CaptureError(
            f"{where}: unknown key(s) {sorted(extra)} (valid: "
            f"regex/json/csv/builtin, source, required, type, group)", kwpath)
    source = str(body.get("source", "stdout"))
    if kind == "builtin":
        if "source" in body:
            raise CaptureError(f"{where}: builtin captures take no source",
                               f"{kwpath}.source")
        if body["builtin"] not in BUILTIN_CAPTURES:
            raise CaptureError(
                f"{where}: unknown builtin {body['builtin']!r} "
                f"(valid: {', '.join(BUILTIN_CAPTURES)})",
                f"{kwpath}.builtin")
    elif source not in _SOURCES and not source.startswith(("outfile:",
                                                           "file:")):
        raise CaptureError(
            f"{where}: unknown source {source!r} (valid: stdout, stderr, "
            f"outfile:<name>, file:<path template>)", f"{kwpath}.source")
    cast = body.get("type")
    if cast is not None and str(cast) not in _CASTERS:
        raise CaptureError(
            f"{where}: unknown type {cast!r} "
            f"(valid: {', '.join(sorted(_CASTERS))})", f"{kwpath}.type")
    required = body.get("required", False)
    if not isinstance(required, bool):
        required = str(required).strip().lower() in ("1", "true", "yes", "on")
    group = body.get("group")
    if group is not None and not isinstance(group, int):
        group = str(group)
    if kind == "regex":
        pattern = _compile(where, str(body["regex"]), f"{kwpath}.regex")
    else:
        pattern = None
    path = None
    if kind in ("json", "csv", "builtin"):
        path = str(body[kind])
        if not path:
            raise CaptureError(f"{where}: empty {kind} field path",
                               f"{kwpath}.{kind}")
    return CaptureSpec(name=name, kind=kind, pattern=pattern, path=path,
                       group=group, source=source, required=required,
                       cast=str(cast) if cast is not None else None)


def _compile(where: str, pattern: str,
             keyword: str | None = None) -> re.Pattern:
    try:
        return re.compile(pattern)
    except re.error as e:
        raise CaptureError(f"{where}: bad regex {pattern!r}: {e}",
                           keyword) from e


def parse_captures(task: str, raw: Any) -> dict[str, CaptureSpec]:
    """Parse a whole ``capture:`` block (metric name → spec)."""
    if not isinstance(raw, Mapping):
        raise CaptureError(
            f"task {task!r}: capture must be a mapping of metric names",
            "capture")
    return {str(name): parse_capture(task, str(name), val)
            for name, val in raw.items()}


class CaptureSet:
    """All of one task's compiled extractors, applied to a task value.

    ``extract`` pulls the text-sourced metrics (regex/json/csv) out of a
    completed attempt's value — a ``ShellResult`` contributes stdout and
    stderr; any other value stringifies as its stdout — and reports
    which *required* metrics are missing (the scheduler classifies that
    as an attempt failure).  ``finalize`` fills the built-ins from the
    resolved ``TaskResult`` (rc, duration, host, slot), which only exist
    once the scheduler has resolved the node.
    """

    def __init__(self, task: str,
                 specs: Mapping[str, CaptureSpec],
                 outfiles: Mapping[str, str] | None = None) -> None:
        self.task = task
        self.specs = dict(specs)
        self.outfiles = dict(outfiles or {})
        self.text_specs = [s for s in self.specs.values()
                           if s.kind != "builtin"]
        self.builtin_specs = [s for s in self.specs.values()
                              if s.kind == "builtin"]

    @property
    def uses_stderr(self) -> bool:
        """True when any extractor reads stderr — backends that spool
        stderr lazily (worker lanes) must route it back eagerly."""
        return any(s.source == "stderr" for s in self.text_specs)

    # -- source resolution ---------------------------------------------
    def _source_text(self, spec: CaptureSpec, value: Any,
                     combo: Mapping[str, Any] | None) -> str | None:
        if spec.source == "stdout":
            if hasattr(value, "stdout"):
                return value.stdout or ""
            return "" if value is None else str(value)
        if spec.source == "stderr":
            return (value.stderr or "") if hasattr(value, "stderr") else ""
        if spec.source.startswith("outfile:"):
            name = spec.source[len("outfile:"):]
            template = self.outfiles.get(name)
            if template is None:
                return None
            return self._read_file(template, combo)
        return self._read_file(spec.source[len("file:"):], combo)

    def _read_file(self, template: str,
                   combo: Mapping[str, Any] | None) -> str | None:
        try:
            path = interpolate(template, combo or {}, self.task)
        except KeyError:
            return None
        try:
            with open(path) as f:
                return f.read()
        except OSError:
            return None

    # -- extraction -----------------------------------------------------
    def extract(self, value: Any,
                combo: Mapping[str, Any] | None = None
                ) -> tuple[dict[str, Any], list[str]]:
        """Text-sourced metrics from one attempt's value: ``(metrics,
        missing required names)``.  Builtins are deferred to
        ``finalize`` (they come from the resolved ``TaskResult``)."""
        metrics: dict[str, Any] = {}
        missing: list[str] = []
        json_cache: dict[str, Any] = {}
        for spec in self.text_specs:
            text = self._source_text(spec, value, combo)
            raw = None if text is None else self._pull(spec, text, value,
                                                       json_cache)
            if raw is None:
                metrics[spec.name] = None
                if spec.required:
                    missing.append(spec.name)
            else:
                try:
                    metrics[spec.name] = spec.convert(raw)
                except (TypeError, ValueError):
                    metrics[spec.name] = None
                    if spec.required:
                        missing.append(spec.name)
        return metrics, missing

    def _pull(self, spec: CaptureSpec, text: str, value: Any,
              json_cache: dict[int, Any]) -> Any:
        if spec.kind == "regex":
            return _last_match(spec, text)
        if spec.kind == "json":
            # one parse per distinct source per attempt, shared across
            # every json capture reading it
            if spec.source not in json_cache:
                json_cache[spec.source] = _json_doc(text, value, spec.source)
            return _json_path(json_cache[spec.source], spec.path or "")
        if spec.kind == "csv":
            return _csv_field(text, spec.path or "")
        return None     # pragma: no cover - builtins never reach here

    def finalize(self, metrics: Mapping[str, Any] | None,
                 result: Any) -> dict[str, Any]:
        """Merge text metrics with built-ins measured by the engine,
        preserving declaration order.  ``result`` is the resolved
        ``TaskResult`` (duck-typed: runtime/host/slot/value)."""
        text = dict(metrics or {})
        out: dict[str, Any] = {}
        for name, spec in self.specs.items():
            if spec.kind != "builtin":
                out[name] = text.get(name)
                continue
            builtin = spec.path
            if builtin == "rc":
                out[name] = getattr(getattr(result, "value", None),
                                    "returncode", None)
            elif builtin == "duration":
                out[name] = getattr(result, "runtime", None)
            elif builtin == "host":
                out[name] = getattr(result, "host", None)
            else:       # slot
                out[name] = getattr(result, "slot", None)
            if spec.cast is not None and out[name] is not None:
                try:
                    out[name] = _CASTERS[spec.cast](str(out[name]))
                except (TypeError, ValueError):
                    pass
        return out


def _last_match(spec: CaptureSpec, text: str) -> str | None:
    """The last match wins: performance runs often log progressively and
    the final line is the settled measurement."""
    last: re.Match | None = None
    for m in spec.pattern.finditer(text):    # type: ignore[union-attr]
        last = m
    if last is None:
        return None
    if spec.group is not None:
        try:
            return last.group(spec.group)
        except IndexError:      # unknown group name/number
            return None
    if "value" in (last.groupdict() or {}):
        return last.group("value")
    return last.group(1) if last.re.groups else last.group(0)


def _json_doc(text: str, value: Any, source: str) -> Any:
    """The parsed JSON document for a source: a Mapping/list value is
    used directly (registry tasks return structured results), text is
    parsed."""
    if source == "stdout" and isinstance(value, (Mapping, list)):
        return value
    try:
        return json.loads(text)
    except (json.JSONDecodeError, TypeError):
        return None


def _json_path(doc: Any, path: str) -> Any:
    """Navigate a dotted field path (``perf.gflops`` / ``runs.0.time``)."""
    cur = doc
    for part in path.split("."):
        if isinstance(cur, Mapping):
            if part not in cur:
                return None
            cur = cur[part]
        elif isinstance(cur, Sequence) and not isinstance(cur, str):
            try:
                cur = cur[int(part)]
            except (ValueError, IndexError):
                return None
        else:
            return None
    return None if isinstance(cur, (Mapping, list)) else cur


def _csv_field(text: str, column: str) -> str | None:
    """A column from the *last* data row of CSV text.  The first row is
    the header; a purely numeric ``column`` falls back to a positional
    index when no header matches."""
    rows = [r for r in csv.reader(io.StringIO(text)) if r]
    if not rows:
        return None
    header, data = rows[0], rows[1:]
    if column in header:
        if not data:
            return None
        idx = header.index(column)
        row = data[-1]
        return row[idx] if idx < len(row) else None
    if column.lstrip("-").isdigit():
        if not data:    # header-only text must read as missing, not as
            return None  # a header cell
        try:
            return data[-1][int(column)]
        except IndexError:
            return None
    return None


def build_capture_sets(spec: Any) -> dict[str, CaptureSet]:
    """Per-task compiled capture sets for a ``StudySpec`` (tasks without
    a ``capture:`` block contribute nothing)."""
    out: dict[str, CaptureSet] = {}
    for tname, task in spec.tasks.items():
        if getattr(task, "capture", None):
            out[tname] = CaptureSet(tname, task.capture, task.outfiles)
    return out


# ---------------------------------------------------------------------------
# Streaming aggregation
# ---------------------------------------------------------------------------


class MetricStats:
    """Streaming accumulator for one (group, metric) cell: count, mean,
    min, max via Welford's algorithm (numerically stable, O(1) state),
    plus an exact median on the scheduler's dual-heap stream (O(n)
    samples retained — disable with ``track_median=False`` for strictly
    O(1) cells)."""

    __slots__ = ("n", "mean", "_m2", "min", "max", "_median")

    def __init__(self, track_median: bool = True) -> None:
        self.n = 0
        self.mean = 0.0
        self._m2 = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._median = _StreamingMedian() if track_median else None

    def add(self, x: float) -> None:
        x = float(x)
        self.n += 1
        delta = x - self.mean
        self.mean += delta / self.n
        self._m2 += delta * (x - self.mean)
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if self._median is not None:
            self._median.add(x)

    @property
    def std(self) -> float:
        """Sample standard deviation (0.0 below two samples)."""
        return math.sqrt(self._m2 / (self.n - 1)) if self.n > 1 else 0.0

    @property
    def median(self) -> float | None:
        """The upper median — matches ``sorted(xs)[len(xs) // 2]``."""
        if self._median is None or self.n == 0:
            return None
        return self._median.median()

    def stat(self, name: str) -> float | int | None:
        if self.n == 0:
            return None
        if name == "count":
            return self.n
        if name == "mean":
            return self.mean
        if name == "min":
            return self.min
        if name == "max":
            return self.max
        if name == "std":
            return self.std
        if name == "median":
            return self.median
        raise ValueError(
            f"unknown stat {name!r} (valid: {', '.join(STATS)})")

    def as_dict(self) -> dict[str, Any]:
        return {s: self.stat(s) for s in STATS
                if not (s == "median" and self._median is None)}


STATS = ("count", "mean", "std", "min", "max", "median")


def _canon(v: Any) -> Any:
    """Canonical group-key element: integral floats fold to int so a
    CLI-typed baseline (``threads=1``) matches a WDL-typed combo value."""
    if isinstance(v, bool):
        return v
    if isinstance(v, float) and v.is_integer():
        return int(v)
    return v


class KeyResolutionError(KeyError):
    """A group-by / baseline key matched no (or several) parameters."""


def resolve_key(key: str, available: Iterable[str]) -> str | None:
    """Resolve a short key against available names, mirroring WDL
    interpolation lookup: exact match first, then a unique tail match
    after ``:`` or ``/`` (``size`` → ``args:size``, ``t/args:size``)."""
    names = list(available)
    if key in names:
        return key
    tails = [n for n in names
             if n.endswith(":" + key) or n.endswith("/" + key)]
    if len(tails) == 1:
        return tails[0]
    if len(tails) > 1:
        raise KeyResolutionError(
            f"ambiguous key {key!r}: matches {sorted(tails)}")
    return None


class ResultsAggregator:
    """Group-by aggregation over a stream of (combo, metrics) pairs.

    State is O(groups × metrics) accumulator cells — never O(results) —
    so a windowed ``keep_results=False`` run aggregates 10^5 instances
    in constant memory per group.  Wire it into a run via
    ``ParameterStudy.run(aggregator=…)`` (the engine feeds every ``ok``
    resolution), or replay a finished study with ``add_records``.

    ``group_by`` keys name parameters (short forms resolve like WDL
    interpolation: ``size`` matches ``args:size``) or captured metrics
    (``threads`` matches a ``capture: threads:`` extraction) — so a
    study can pivot on a value the task *reported* as easily as one it
    was *given*.  ``metrics`` restricts which captured metrics
    aggregate; default: every numeric metric seen.
    """

    def __init__(self, group_by: Sequence[str],
                 metrics: Sequence[str] | None = None,
                 track_median: bool = True) -> None:
        if not group_by:
            raise ValueError("group_by must name at least one key")
        self.group_by = [str(k) for k in group_by]
        self.metrics = [str(m) for m in metrics] if metrics else None
        self.track_median = track_median
        #: group key tuple → metric name → MetricStats
        self.groups: dict[tuple, dict[str, MetricStats]] = {}
        self.n_results = 0          # results offered
        self.n_grouped = 0          # results that resolved every group key
        #: group key → resolution failure (ambiguous/unmatched) — a live
        #: run must not crash mid-study on a bad --group-by; callers
        #: surface these after the run instead
        self.key_errors: dict[str, str] = {}
        #: combo-keyset → per-group-key (resolved name, from_metrics)
        self._plans: dict[tuple[str, ...], list[tuple[str, bool]] | None] = {}

    # -- key resolution ---------------------------------------------------
    def _plan(self, combo: Mapping[str, Any],
              metrics: Mapping[str, Any]) -> list[tuple[str, bool]] | None:
        sig = tuple(combo) + ("|",) + tuple(sorted(metrics))
        if sig in self._plans:
            return self._plans[sig]
        plan: list[tuple[str, bool]] | None = []
        for key in self.group_by:
            try:
                name = resolve_key(key, combo)
                if name is None:
                    name = resolve_key(key, metrics)
            except KeyResolutionError as e:
                self.key_errors[key] = str(e)
                name = None
            if name is None:
                plan = None
                break
            plan.append((name, name in metrics and name not in combo))
        self._plans[sig] = plan
        return plan

    # -- ingestion --------------------------------------------------------
    def add(self, combo: Mapping[str, Any],
            metrics: Mapping[str, Any] | None = None) -> bool:
        """Fold one completed instance in.  Returns False when a group
        key resolves against neither the combo nor the metrics (the
        result is counted but not grouped — multi-task studies capture
        on a subset of tasks)."""
        self.n_results += 1
        metrics = metrics or {}
        plan = self._plan(combo, metrics)
        if plan is None:
            return False
        key = tuple(_canon(metrics[name] if from_m else combo[name])
                    for name, from_m in plan)
        cells = self.groups.get(key)
        if cells is None:
            cells = self.groups[key] = {}
        for mname, mval in metrics.items():
            if self.metrics is not None and mname not in self.metrics:
                continue
            if isinstance(mval, bool) or not isinstance(mval, (int, float)):
                continue
            stats = cells.get(mname)
            if stats is None:
                stats = cells[mname] = MetricStats(self.track_median)
            stats.add(mval)
        self.n_grouped += 1
        return True

    def add_records(self, records: Iterable[Mapping[str, Any]]) -> int:
        """Replay provenance records (``StudyDB.records()`` /
        ``records.jsonl`` lines): the latest ``ok`` record per task id
        wins, so a resumed or retried study aggregates each instance
        exactly once.  Returns the number of instances folded in."""
        latest: dict[str, Mapping[str, Any]] = {}
        for rec in records:
            if rec.get("status") == "ok" and rec.get("combo") is not None:
                latest[rec["task_id"]] = rec
        n = 0
        for rec in latest.values():
            if self.add(rec["combo"], rec.get("metrics") or {}):
                n += 1
        return n

    # -- queries ----------------------------------------------------------
    def metric_names(self) -> list[str]:
        names: list[str] = []
        for cells in self.groups.values():
            for m in cells:
                if m not in names:
                    names.append(m)
        return names

    def table(self, metric: str, stat: str = "mean"
              ) -> dict[tuple, float | int | None]:
        """Group key tuple → one statistic of one metric."""
        out: dict[tuple, float | int | None] = {}
        for key, cells in self.groups.items():
            stats = cells.get(metric)
            out[key] = stats.stat(stat) if stats is not None else None
        return out

    def summary(self, metric: str) -> dict[tuple, dict[str, Any]]:
        """Group key tuple → every statistic of one metric."""
        return {key: cells[metric].as_dict()
                for key, cells in sorted(self.groups.items(),
                                         key=lambda kv: _sort_key(kv[0]))
                if metric in cells}

    # -- derived performance-study metrics --------------------------------
    def _baseline_axis(self, baseline: Mapping[str, Any]) -> tuple[int, Any]:
        if len(baseline) != 1:
            raise ValueError(
                "baseline must pin exactly one group-by axis to a value "
                f"(got {dict(baseline)!r})")
        (bkey, bval), = baseline.items()
        axis = None
        for i, g in enumerate(self.group_by):
            if g == bkey or resolve_key(bkey, [g]) is not None \
                    or resolve_key(g, [bkey]) is not None:
                axis = i
                break
        if axis is None:
            raise KeyResolutionError(
                f"baseline key {bkey!r} is not a group-by axis "
                f"(axes: {self.group_by})")
        return axis, _canon(bval)

    def speedup(self, metric: str, baseline: Mapping[str, Any],
                stat: str = "mean"
                ) -> dict[tuple, dict[str, float | None]]:
        """Speedup and parallel efficiency per group, relative to the
        baseline combination (paper Fig. 6/7).

        ``baseline`` pins one group-by axis to its reference value
        (``{"threads": 1}``).  For every group, speedup is
        ``stat(metric)`` at the baseline point (same values on every
        *other* axis) divided by the group's own; efficiency divides
        speedup by the axis ratio (``threads / baseline_threads``) when
        both are numeric.  Groups with no recorded baseline point get
        ``None``."""
        axis, bval = self._baseline_axis(baseline)
        cells = self.table(metric, stat)
        out: dict[tuple, dict[str, float | None]] = {}
        for key, val in cells.items():
            base_key = key[:axis] + (bval,) + key[axis + 1:]
            base = cells.get(base_key)
            speedup = eff = None
            # explicit None checks: a legitimate 0 aggregate is data,
            # not a missing baseline (only division by 0 stays None)
            if val is not None and base is not None and val != 0:
                speedup = base / val
                axis_val = key[axis]
                if isinstance(axis_val, (int, float)) \
                        and isinstance(bval, (int, float)) and bval != 0 \
                        and axis_val != 0:
                    eff = speedup / (axis_val / bval)
            out[key] = {"value": val, "speedup": speedup,
                        "efficiency": eff}
        return out


def _sort_key(key: tuple) -> tuple:
    """Sort group tuples with mixed types: numerics first, by value."""
    return tuple((0, v) if isinstance(v, (int, float))
                 and not isinstance(v, bool) else (1, str(v))
                 for v in key)
