"""``papas lint`` — pre-flight static analysis for parameter studies.

A typo'd ``${...}`` reference, a dangling ``after:`` edge, or a
``baseline:`` outside the declared space only surfaces *mid-sweep*
otherwise — after hours of real compute on a 10^5-combination study.
This module proves the whole class of "this study can never succeed"
errors statically, before a single instance is rendered: every check
works on parameter *key sets* and index math (``sample_count()``), so
linting a 10^5-combo study costs the same as a 10-combo one.

Architecture: a flat registry of :class:`Rule` metadata (stable ids,
``E``/``W``/``I`` severity classes) plus a list of check functions, each
of which walks the :class:`~repro_torch.core.wdl.StudySpec` through a
:class:`LintContext` and emits :class:`Finding`\\ s.  ``lint()`` runs
every check, applies the study's ``lint: suppress:`` list, and returns a
:class:`LintReport`.

Rule catalog (study pack):

== ======= ====================================================
id  sev    meaning
== ======= ====================================================
E001 error file does not parse (emitted by the CLI front end)
E101 error unresolvable ``${...}`` reference in a template
E102 error ambiguous ``${...}`` reference (several tails match)
E201 error ``after:`` names an unknown task
E202 error dependency cycle among tasks
E203 error task unreachable (depends on a cycle / unknown task)
E301 error parameterized infile has no producing outfile
E302 error infile's producer is not an ``after:`` ancestor
W303 warn  static infile path not found on disk
E401 error capture regex ``group:`` does not exist in pattern
E403 error capture reads ``outfile:<name>`` never declared
E501 error baseline key matches no parameter / captured metric
E502 error baseline value outside the declared parameter values
E503 error two tasks declare different ``baseline:`` points
E504 error parameter space cannot be constructed (sampling, fixed)
E505 error conflicting remote keywords across tasks
E506 error conflicting ``straggler_quantile`` across tasks
W601 warn  estimated sweep runtime exceeds the study budget
I601 info  sweep cost estimate (count × duration / slots)
W701 warn  retry backoff ceiling exceeds the task timeout
W802 warn  capture metric declared but consumed by nothing
E901 error engine lock acquisition-order cycle (locklint pack)
== ======= ====================================================

Suppression: a study opts out per rule id via its ``lint:`` block
(``suppress: [W601]``).  ``E001`` and the engine pack cannot be
suppressed from a study file.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Callable, Iterable, Mapping

from .interpolate import _INTERP_RE, classify_reference
from .paramspace import ParameterSpace, from_task
from .results import BUILTIN_CAPTURES, KeyResolutionError, _canon, resolve_key
from .wdl import StudySpec, TaskSpec

__all__ = [
    "Finding",
    "LintReport",
    "Rule",
    "RULES",
    "findings_from_lock_report",
    "lint",
]

SEVERITIES = ("error", "warn", "info")

#: default cost-estimate budget (days) — override via ``lint:
#: max_runtime_days:`` in the study or ``lint(max_runtime_days=...)``.
DEFAULT_MAX_RUNTIME_DAYS = 30.0
#: default assumed concurrency for the cost estimate.
DEFAULT_SLOTS = 8


@dataclasses.dataclass(frozen=True)
class Rule:
    """Registry metadata for one diagnostic: a stable id, a severity
    class, and a one-line summary (the full message is per-finding)."""

    id: str
    severity: str
    summary: str


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: a rule id plus the location that triggered it."""

    rule: str
    severity: str
    message: str
    task: str | None = None
    keyword: str | None = None
    file: str | None = None
    line: int | None = None

    @property
    def keyword_path(self) -> str:
        """``task.keyword`` dotted path ('' when unlocated)."""
        return ".".join(p for p in (self.task, self.keyword) if p)

    def render(self) -> str:
        loc = []
        if self.file:
            loc.append(f"{self.file}:{self.line}" if self.line
                       else str(self.file))
        if self.keyword_path:
            loc.append(self.keyword_path)
        where = " ".join(loc)
        return (f"{self.severity.upper():5s} {self.rule} "
                f"{where + ': ' if where else ''}{self.message}")

    def as_dict(self) -> dict[str, Any]:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


#: rule id → metadata.  Checks emit by id; severity lives here so a
#: rule's class can never drift between emit sites.
RULES: dict[str, Rule] = {r.id: r for r in (
    Rule("E001", "error", "file does not parse as WDL"),
    Rule("E101", "error", "unresolvable ${...} reference"),
    Rule("E102", "error", "ambiguous ${...} reference"),
    Rule("E201", "error", "after: names an unknown task"),
    Rule("E202", "error", "dependency cycle among tasks"),
    Rule("E203", "error", "task unreachable behind a cycle/unknown dep"),
    Rule("E301", "error", "parameterized infile has no producer"),
    Rule("E302", "error", "infile producer is not an after: ancestor"),
    Rule("W303", "warn", "static infile not found on disk"),
    Rule("E401", "error", "capture regex group does not exist"),
    Rule("E403", "error", "capture reads an undeclared outfile"),
    Rule("E501", "error", "baseline key matches nothing"),
    Rule("E502", "error", "baseline value outside declared values"),
    Rule("E503", "error", "conflicting baselines across tasks"),
    Rule("E504", "error", "parameter space cannot be constructed"),
    Rule("E505", "error", "conflicting remote keywords"),
    Rule("E506", "error", "conflicting straggler_quantile"),
    Rule("W601", "warn", "estimated runtime exceeds budget"),
    Rule("I601", "info", "sweep cost estimate"),
    Rule("W701", "warn", "retry backoff ceiling exceeds task timeout"),
    Rule("W802", "warn", "capture metric declared but never consumed"),
    Rule("E901", "error", "lock acquisition-order cycle"),
)}

#: the study rule pack: check functions run in order by ``lint()``.
CHECKS: list[Callable[["LintContext"], None]] = []


def check(fn: Callable[["LintContext"], None]
          ) -> Callable[["LintContext"], None]:
    CHECKS.append(fn)
    return fn


class LintContext:
    """Everything the rule pack needs, computed once per study.

    Per-task parameter mappings, their key-set scopes, the (lazily
    constructed, cached) global :class:`ParameterSpace`, duration
    priors, and the source line map for locating findings."""

    def __init__(self, spec: StudySpec, slots: int | None = None,
                 priors: Mapping[str, float] | None = None,
                 max_runtime_days: float | None = None) -> None:
        self.spec = spec
        lint_block = spec.lint or {}
        self.slots = int(slots if slots is not None
                         else lint_block.get("slots", DEFAULT_SLOTS))
        self.max_runtime_days = float(
            max_runtime_days if max_runtime_days is not None
            else lint_block.get("max_runtime_days",
                                DEFAULT_MAX_RUNTIME_DAYS))
        self.priors = dict(priors or {})
        self.findings: list[Finding] = []
        #: task → {param key → value list}
        self.params: dict[str, dict[str, list[Any]]] = {
            tname: t.parameters() for tname, t in spec.tasks.items()}
        #: task → parameter key set (scope for classify_reference)
        self.scopes: dict[str, set[str]] = {
            tname: set(p) for tname, p in self.params.items()}
        self._lines: Mapping[tuple, int] = \
            (spec.origin or {}).get("lines") or {}
        self._file: str | None = (spec.origin or {}).get("file")
        self._space: ParameterSpace | None = None
        self._space_err: Exception | None = None

    def space_or_err(self) -> tuple[ParameterSpace | None, Exception | None]:
        """The study-global namespaced space (cached), or the exception
        its construction raised — mirrors ``ParameterStudy.space()``."""
        if self._space is None and self._space_err is None:
            try:
                self._space = self._build_space()
            except Exception as e:
                self._space_err = e
        return self._space, self._space_err

    def _build_space(self) -> ParameterSpace:
        params: dict[str, list[Any]] = {}
        fixed: list[list[str]] = []
        sampling: dict[str, Any] | None = None
        sampling_owner: str | None = None
        for tname, task in self.spec.tasks.items():
            tspace = from_task(self.params[tname], task.fixed, task.sampling)
            for pname, values in tspace.params.items():
                params[f"{tname}/{pname}"] = values
            for group in tspace.fixed:
                fixed.append([f"{tname}/{p}" for p in group])
            if task.sampling:
                block = dict(task.sampling)
                if sampling is None:
                    sampling, sampling_owner = block, tname
                elif block != sampling:
                    raise ValueError(
                        f"conflicting sampling blocks: task "
                        f"{sampling_owner!r} declares {sampling!r} but "
                        f"task {tname!r} declares {block!r}")
        return ParameterSpace(params=params, fixed=fixed, sampling=sampling)

    def emit(self, rule_id: str, message: str, task: str | None = None,
             keyword: str | None = None) -> None:
        meta = RULES[rule_id]
        parts: list[str] = []
        if task:
            parts.append(task)
        if keyword:
            parts.extend(keyword.split("."))
        line = None
        for n in range(len(parts), 0, -1):
            line = self._lines.get(tuple(parts[:n]))
            if line is not None:
                break
        self.findings.append(Finding(
            rule=rule_id, severity=meta.severity, message=message,
            task=task, keyword=keyword, file=self._file, line=line))


@dataclasses.dataclass
class LintReport:
    """The outcome of one ``lint()`` run."""

    findings: list[Finding]
    suppressed: list[str] = dataclasses.field(default_factory=list)

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "warn"]

    @property
    def infos(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "info"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def render(self) -> str:
        lines = [f.render() for f in self.findings]
        n_e, n_w = len(self.errors), len(self.warnings)
        lines.append(f"{n_e} error(s), {n_w} warning(s), "
                     f"{len(self.infos)} info")
        if self.suppressed:
            lines.append(f"suppressed: {', '.join(self.suppressed)}")
        return "\n".join(lines)

    def as_dict(self) -> dict[str, Any]:
        return {"ok": self.ok,
                "errors": len(self.errors),
                "warnings": len(self.warnings),
                "suppressed": list(self.suppressed),
                "findings": [f.as_dict() for f in self.findings]}


# ---------------------------------------------------------------------------
# study rule pack
# ---------------------------------------------------------------------------

def _static_values(path: str, params: Mapping[str, list[Any]],
                   studies: Mapping[str, Mapping[str, list[Any]]] | None
                   ) -> list[Any] | None:
    """The value list a resolvable reference draws from (the static
    counterpart of ``resolve()``'s ok branches); None when unbound."""
    if path in params:
        return params[path]
    tails = [k for k in params if k.endswith(":" + path)]
    if len(tails) == 1:
        return params[tails[0]]
    head, _, rest = path.partition(":")
    if studies and head in studies and rest:
        other = studies[head]
        if rest in other:
            return other[rest]
        otails = [k for k in other if k.endswith(":" + rest)]
        if len(otails) == 1:
            return other[otails[0]]
    return None


def _check_template(ctx: LintContext, tname: str, text: str, keyword: str,
                    inter_task: bool) -> None:
    """Classify every ``${...}`` slot in one template, following nested
    references (a resolved value containing ``${...}``) the same way the
    render fixpoint does — but over key sets, never values-per-instance."""
    scope = ctx.scopes[tname]
    studies_scopes = ctx.scopes if inter_task else None
    studies_params = ctx.params if inter_task else None
    seen: set[str] = set()
    work = list(_INTERP_RE.findall(text))
    while work:
        path = work.pop()
        if path in seen:
            continue
        seen.add(path)
        status, detail = classify_reference(path, scope, studies_scopes)
        if status == "ok":
            values = _static_values(path, ctx.params[tname], studies_params)
            for v in values or ():
                if isinstance(v, str) and "${" in v:
                    work.extend(_INTERP_RE.findall(v))
            continue
        rid = "E101" if status == "unbound" else "E102"
        ctx.emit(rid,
                 f"reference ${{{path}}} cannot resolve: {detail}",
                 task=tname, keyword=keyword)


@check
def check_references(ctx: LintContext) -> None:
    """E101/E102 — every template's ``${...}`` slots must bind.

    Contexts and their runtime scope, mirrored exactly: the command
    renders with inter-task ``${task:...}`` lookup; infile/outfile name
    templates and ``capture: file:`` sources render against the combo
    alone (no ``studies`` — see ``staging.stage_inputs`` and
    ``CaptureSet._read_file``).  Environ values are never interpolated,
    so they are deliberately not checked."""
    for tname, task in ctx.spec.tasks.items():
        if task.command:
            _check_template(ctx, tname, task.command, "command",
                            inter_task=True)
        for fname, ftmpl in task.infiles.items():
            _check_template(ctx, tname, ftmpl, f"infiles.{fname}",
                            inter_task=False)
        for fname, ftmpl in task.outfiles.items():
            _check_template(ctx, tname, ftmpl, f"outfiles.{fname}",
                            inter_task=False)
        for mname, cap in task.capture.items():
            source = getattr(cap, "source", "stdout")
            if source.startswith("file:"):
                _check_template(ctx, tname, source[len("file:"):],
                                f"capture.{mname}.source",
                                inter_task=False)


@check
def check_dag(ctx: LintContext) -> None:
    """E201/E202/E203 — the task graph must be closed and acyclic."""
    names = set(ctx.spec.tasks)
    blocked: set[str] = set()
    for tname, task in ctx.spec.tasks.items():
        for dep in task.after:
            if dep not in names:
                ctx.emit("E201",
                         f"after: references unknown task {dep!r} "
                         f"(tasks: {', '.join(sorted(names))})",
                         task=tname, keyword="after")
                blocked.add(tname)
    # cycle detection over known edges (task level, not instance level:
    # every instance replicates the same sub-DAG)
    color: dict[str, int] = {}          # 0 unvisited / 1 on stack / 2 done
    cycle_members: set[str] = set()
    cycles: list[list[str]] = []

    def dfs(node: str, stack: list[str]) -> None:
        color[node] = 1
        stack.append(node)
        for dep in ctx.spec.tasks[node].after:
            if dep not in names:
                continue
            c = color.get(dep, 0)
            if c == 1:
                cyc = stack[stack.index(dep):]
                if not cycle_members.issuperset(cyc):
                    cycles.append(list(cyc))
                cycle_members.update(cyc)
            elif c == 0:
                dfs(dep, stack)
        stack.pop()
        color[node] = 2

    for tname in ctx.spec.tasks:
        if color.get(tname, 0) == 0:
            dfs(tname, [])
    for cyc in cycles:
        ctx.emit("E202",
                 f"dependency cycle: {' -> '.join(cyc + [cyc[0]])} — no "
                 f"instance of these tasks can ever start",
                 task=cyc[0], keyword="after")
    blocked |= cycle_members
    # propagate unreachability downstream of cycles / unknown deps
    downstream: dict[str, list[str]] = {}
    for tname, task in ctx.spec.tasks.items():
        for dep in task.after:
            if dep in names:
                downstream.setdefault(dep, []).append(tname)
    frontier = list(blocked)
    unreachable: set[str] = set()
    while frontier:
        for succ in downstream.get(frontier.pop(), ()):
            if succ not in blocked and succ not in unreachable:
                unreachable.add(succ)
                frontier.append(succ)
    for tname in sorted(unreachable):
        ctx.emit("E203",
                 f"task can never start: it depends (transitively) on "
                 f"a cycle or an unknown task",
                 task=tname, keyword="after")


@check
def check_dataflow(ctx: LintContext) -> None:
    """E301/E302/W303 — infiles must come from somewhere.

    A *parameterized* infile path (it has ``${...}`` slots) is expected
    to be produced by an upstream outfile — matching by logical name or
    by identical path template; no producer is E301 and a producer the
    consumer is not ordered after is E302.  A *static* infile is an
    external input: it only warns (W303) when absent on disk at lint
    time."""
    # consumer → transitive after-ancestors (known tasks only)
    names = set(ctx.spec.tasks)

    def ancestors(tname: str) -> set[str]:
        out: set[str] = set()
        stack = [d for d in ctx.spec.tasks[tname].after if d in names]
        while stack:
            dep = stack.pop()
            if dep not in out:
                out.add(dep)
                stack.extend(d for d in ctx.spec.tasks[dep].after
                             if d in names)
        return out

    for tname, task in ctx.spec.tasks.items():
        anc = ancestors(tname) if task.infiles else set()
        for fname, ftmpl in task.infiles.items():
            producers = [
                other for other, ot in ctx.spec.tasks.items()
                if other != tname
                and (fname in ot.outfiles
                     or ftmpl in ot.outfiles.values())]
            if producers:
                if not any(p in anc for p in producers):
                    ctx.emit(
                        "E302",
                        f"infile {fname!r} is produced by "
                        f"{sorted(producers)} but none is an after: "
                        f"ancestor of this task — staging may race "
                        f"production",
                        task=tname, keyword=f"infiles.{fname}")
                continue
            if "${" in ftmpl:
                ctx.emit(
                    "E301",
                    f"infile {fname!r} has a parameterized path "
                    f"{ftmpl!r} but no task declares a matching "
                    f"outfile (by name or identical template)",
                    task=tname, keyword=f"infiles.{fname}")
            elif not os.path.exists(ftmpl):
                ctx.emit(
                    "W303",
                    f"static infile {ftmpl!r} does not exist (external "
                    f"input expected on disk before the run)",
                    task=tname, keyword=f"infiles.{fname}")


@check
def check_captures(ctx: LintContext) -> None:
    """E401/E403 — capture extraction must be able to succeed."""
    for tname, task in ctx.spec.tasks.items():
        for mname, cap in task.capture.items():
            source = getattr(cap, "source", "stdout")
            if source.startswith("outfile:") \
                    and source[len("outfile:"):] not in task.outfiles:
                ctx.emit(
                    "E403",
                    f"capture {mname!r} reads {source!r} but the task "
                    f"declares no such outfile "
                    f"(declared: {sorted(task.outfiles) or 'none'})",
                    task=tname, keyword=f"capture.{mname}.source")
            pattern = getattr(cap, "pattern", None)
            group = getattr(cap, "group", None)
            if pattern is None or group is None:
                continue
            if isinstance(group, int):
                if group > pattern.groups:
                    ctx.emit(
                        "E401",
                        f"capture {mname!r} extracts group {group} but "
                        f"its regex has only {pattern.groups} group(s)",
                        task=tname, keyword=f"capture.{mname}.group")
            elif group not in pattern.groupindex:
                ctx.emit(
                    "E401",
                    f"capture {mname!r} extracts named group {group!r} "
                    f"but its regex defines "
                    f"{sorted(pattern.groupindex) or 'no named groups'}",
                    task=tname, keyword=f"capture.{mname}.group")


@check
def check_baseline(ctx: LintContext) -> None:
    """E501/E502/E503 — the speedup reference point must exist."""
    declared: tuple[str, dict[str, Any]] | None = None
    for tname, task in ctx.spec.tasks.items():
        if not task.baseline:
            continue
        if declared is not None and declared[1] != task.baseline:
            ctx.emit(
                "E503",
                f"conflicting baseline: task {declared[0]!r} declares "
                f"{declared[1]!r} but this task declares "
                f"{task.baseline!r} — a study has one reference point",
                task=tname, keyword="baseline")
        elif declared is None:
            declared = (tname, dict(task.baseline))
        params = ctx.params[tname]
        metric_names = set(task.capture) | set(BUILTIN_CAPTURES)
        for bkey, bval in task.baseline.items():
            # the aggregator resolves baseline keys against group-by
            # axes drawn from parameters *and* captured metrics
            if bkey in metric_names:
                continue   # reported-value axis: membership unknowable
            try:
                resolved = resolve_key(bkey, params)
            except KeyResolutionError as e:
                ctx.emit("E501", str(e), task=tname,
                         keyword=f"baseline.{bkey}")
                continue
            if resolved is None:
                if resolve_key(bkey, metric_names) is not None:
                    continue
                ctx.emit(
                    "E501",
                    f"baseline key {bkey!r} matches no parameter "
                    f"(declared: {sorted(params) or 'none'}) and no "
                    f"captured metric "
                    f"(declared: {sorted(metric_names)})",
                    task=tname, keyword=f"baseline.{bkey}")
                continue
            values = {_canon(v) for v in params[resolved]}
            if _canon(bval) not in values:
                shown = sorted(values, key=repr)
                preview = ", ".join(repr(v) for v in shown[:8])
                if len(shown) > 8:
                    preview += f", ... ({len(shown)} values)"
                ctx.emit(
                    "E502",
                    f"baseline {bkey!r}={bval!r} is not one of the "
                    f"declared values of {resolved!r}: [{preview}]",
                    task=tname, keyword=f"baseline.{bkey}")


@check
def check_space(ctx: LintContext) -> None:
    """E504/E505/E506 — global-singleton keywords must agree.

    ``sampling`` applies to the global combination space and the
    pool/straggler policy is built once per study, so divergent per-task
    declarations can never be honored (same checks ``ParameterStudy``
    runs at run time, surfaced before admission)."""
    _space, err = ctx.space_or_err()
    if err is not None:
        ctx.emit("E504", f"parameter space cannot be constructed: {err}")
    merged: dict[str, tuple[str, Any]] = {}
    for tname, task in ctx.spec.tasks.items():
        declared: dict[str, Any] = {
            "hosts": task.hosts or None, "batch": task.batch,
            "nnodes": task.nnodes, "ppnode": task.ppnode}
        for key, val in declared.items():
            if val is None:
                continue
            if key not in merged:
                merged[key] = (tname, val)
            elif merged[key][1] != val:
                ctx.emit(
                    "E505",
                    f"conflicting remote keyword {key!r}: task "
                    f"{merged[key][0]!r} declares {merged[key][1]!r} "
                    f"but this task declares {val!r}",
                    task=tname, keyword=key)
        q = task.straggler_quantile
        if q is not None:
            if "straggler_quantile" not in merged:
                merged["straggler_quantile"] = (tname, q)
            elif merged["straggler_quantile"][1] != q:
                ctx.emit(
                    "E506",
                    f"conflicting straggler_quantile: task "
                    f"{merged['straggler_quantile'][0]!r} declares "
                    f"{merged['straggler_quantile'][1]!r} but this "
                    f"task declares {q!r}",
                    task=tname, keyword="straggler_quantile")


def _fmt_duration(seconds: float) -> str:
    if seconds >= 2 * 86400:
        return f"{seconds / 86400:.1f} days"
    if seconds >= 2 * 3600:
        return f"{seconds / 3600:.1f} hours"
    if seconds >= 120:
        return f"{seconds / 60:.1f} minutes"
    return f"{seconds:.1f} s"


@check
def check_cost(ctx: LintContext) -> None:
    """W601/I601 — the sweep must be feasible before it is admitted.

    ``sample_count()`` is mixed-radix index math (O(params), never
    O(instances)); per-task duration priors come from observed medians
    (``priors``) or, failing that, the declared ``timeout:`` — an upper
    bound, which is the right direction for an admission gate.  Tasks
    with neither contribute nothing (and the estimate says so)."""
    space, err = ctx.space_or_err()
    if err is not None:
        return
    count = space.sample_count()
    per_instance = 0.0
    unpriced: list[str] = []
    for tname, task in ctx.spec.tasks.items():
        dur = ctx.priors.get(tname)
        if dur is None:
            dur = task.timeout
        if dur is None:
            unpriced.append(tname)
        else:
            per_instance += float(dur)
    if per_instance <= 0:
        return
    total = count * per_instance
    wall = total / max(1, ctx.slots)
    days = wall / 86400.0
    detail = (f"{count} instance(s) x {_fmt_duration(per_instance)} "
              f"/ {ctx.slots} slot(s) ~= {_fmt_duration(wall)}")
    if unpriced:
        detail += (f" (tasks without timeout/prior excluded: "
                   f"{', '.join(sorted(unpriced))})")
    if days > ctx.max_runtime_days:
        ctx.emit("W601",
                 f"estimated sweep runtime {days:.1f} days at "
                 f"{ctx.slots} slots exceeds the "
                 f"{ctx.max_runtime_days:g}-day budget: {detail}")
    else:
        ctx.emit("I601", f"estimated sweep cost: {detail}")


@check
def check_retry(ctx: LintContext) -> None:
    """W701 — the retry backoff must not outlive the task it retries.

    The worst-case single backoff delay (``RetryPolicy.ceiling``: the
    last exponential step, jitter included) is compared against the
    task's declared ``timeout:`` — a policy that waits longer between
    attempts than the task is even allowed to run idles slots for no
    recovery benefit, and usually means ``base:`` was given in the
    wrong unit."""
    from .scheduler import RetryPolicy
    for tname, task in ctx.spec.tasks.items():
        if not task.retry or task.timeout is None:
            continue
        try:
            policy = RetryPolicy.from_any(task.retry)
        except ValueError:
            continue         # shape errors are the parser's to report
        ceil = policy.ceiling()
        timeout = float(task.timeout)
        if ceil > timeout:
            ctx.emit(
                "W701",
                f"worst-case retry backoff {_fmt_duration(ceil)} "
                f"(max={policy.retries(1)}, {policy.backoff}, "
                f"base={policy.base:g}s) exceeds the task timeout "
                f"{_fmt_duration(timeout)} — retries would idle the "
                f"slot longer than the task may run",
                task=tname, keyword="retry")


@check
def check_dead_captures(ctx: LintContext) -> None:
    """W802 — a declared capture should be consumed by something.

    A ``capture:`` metric that is not ``required:``, is not a builtin
    passthrough, and is referenced by no ``baseline:`` key is extracted
    on every instance and then dropped on the floor — usually a
    leftover from an earlier report shape, sometimes a typo'd name on
    the consuming side.  Report axes chosen at the CLI (``--group-by``,
    ``--metric``) are invisible statically, so this is a warning, never
    an error."""
    consumed: set[str] = set()
    for task in ctx.spec.tasks.values():
        consumed.update(task.baseline)
    for tname, task in ctx.spec.tasks.items():
        for mname, cap in task.capture.items():
            if getattr(cap, "required", False):
                continue   # a contract with the run: missing = failure
            if getattr(cap, "kind", None) == "builtin":
                continue   # zero extraction cost — nothing is wasted
            used = False
            for bkey in consumed:
                try:
                    if resolve_key(bkey, {mname}) is not None:
                        used = True
                        break
                except KeyResolutionError:
                    used = True   # ambiguous — it may be this metric
                    break
            if not used:
                ctx.emit(
                    "W802",
                    f"capture {mname!r} is extracted on every instance "
                    f"but consumed by nothing in the study file (no "
                    f"baseline: reference, not required:) — dead "
                    f"metric, or a typo on the consuming side",
                    task=tname, keyword=f"capture.{mname}")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def lint(spec: StudySpec, *, slots: int | None = None,
         priors: Mapping[str, float] | None = None,
         max_runtime_days: float | None = None) -> LintReport:
    """Run the study rule pack over a parsed spec.

    ``slots`` and ``max_runtime_days`` parameterize the cost estimator
    (explicit argument > study ``lint:`` block > defaults); ``priors``
    maps task names to observed median durations in seconds (see
    ``ParameterStudy.lint`` for the variant that loads them from the
    study's own provenance records).  Suppressed rule ids (the study's
    ``lint: suppress:`` list) are dropped from the report and recorded
    in ``report.suppressed``.
    """
    ctx = LintContext(spec, slots=slots, priors=priors,
                      max_runtime_days=max_runtime_days)
    for fn in CHECKS:
        fn(ctx)
    suppress = {str(s) for s in (spec.lint or {}).get("suppress", ())}
    findings = [f for f in ctx.findings if f.rule not in suppress]
    suppressed = sorted({f.rule for f in ctx.findings
                         if f.rule in suppress})
    return LintReport(findings=findings, suppressed=suppressed)


def findings_from_lock_report(report: Mapping[str, Any]) -> LintReport:
    """The engine rule pack's verdict: convert a
    :mod:`repro_torch.core.locklint` auditor report into E901 findings (one
    per acquisition-order cycle), so CI renders engine and study
    diagnostics through one formatter."""
    findings = [
        Finding(rule="E901", severity="error",
                message=(f"lock acquisition-order cycle "
                         f"{' -> '.join(list(cyc) + [cyc[0]])} — "
                         f"potential deadlock"))
        for cyc in report.get("cycles", ())]
    if not findings:
        locks = report.get("locks", [])
        findings.append(Finding(
            rule="I601", severity="info",
            message=(f"acquisition-order graph over "
                     f"{len(locks)} lock(s) "
                     f"({', '.join(locks) or 'none'}), "
                     f"{report.get('n_acquisitions', 0)} acquisition(s), "
                     f"{len(report.get('edges', []))} edge(s): "
                     f"no cycles")))
    return LintReport(findings=findings)
