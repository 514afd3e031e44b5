"""Performance-study reports over captured metrics (paper §6).

Renders pivot tables from a parameter study's captured metrics — either
a live ``ResultsAggregator`` fed by a running study, or offline from a
finished study's ``records.jsonl`` (the group-commit provenance stream),
so the table a streaming run printed is reproducible later without
re-running anything:

    PYTHONPATH=src python -m repro_torch.launch.report .papas/mystudy \\
        --group-by size,threads --metric time \\
        --report speedup --baseline threads=1

Three report shapes, each printable as Markdown (default), CSV, or JSON:

* ``summary`` — one row per group: count/mean/std/min/max/median of a
  metric (Welford + dual-heap median, the aggregator's O(groups) state).
* ``table``  — a pivot of one statistic: the last ``--group-by`` axis
  spreads across columns, earlier axes label the rows.
* ``speedup`` — the paper's Fig. 6/7 derivation: speedup and parallel
  efficiency of a timing metric relative to the declared baseline point
  (``--baseline threads=1``; ``repro_torch.launch.sweep --report`` defaults it
  from the WDL ``baseline:`` keyword), pivoted the same way.
* ``runtime`` — where the wall-clock went: one row per task (or per
  host with ``--group-by host``) with count/total/min/median/max over
  the ok records, plus a ``chaos_events`` column counting fault-ledger
  entries that targeted the group — a DEGRADED run shows where faults
  landed next to where time went.  Needs no ``--group-by`` and no
  ``capture:`` metrics; it surfaces ``StudyDB.runtime_summary()``
  (live) or rebuilds the same summary offline from ``records.jsonl``.

Group-by keys name parameters (short forms resolve like WDL
interpolation: ``size`` matches ``args:size``) or captured metrics
(``threads`` matches a ``capture: threads:`` extraction).  Offline
aggregation streams the records file and keeps the *latest* ``ok``
record per task id, so resumed or retried studies count each instance
exactly once.  This module deliberately avoids jax and the training
stack — reports run anywhere the provenance files do.
"""
from __future__ import annotations

import argparse
import csv
import heapq
import io
import json
import sys
from pathlib import Path
from typing import Any, Iterable, Iterator, Mapping, Sequence

from repro_torch.core.groupcommit import iter_jsonl
from repro_torch.core.results import (
    STATS, KeyResolutionError, ResultsAggregator, infer_scalar,
)

REPORTS = ("summary", "table", "speedup", "runtime")
FORMATS = ("md", "csv", "json")


# ---------------------------------------------------------------------------
# Offline loading
# ---------------------------------------------------------------------------


def records_path(path: "str | Path") -> Path:
    """Resolve a records file: accepts the ``records.jsonl`` itself or a
    study directory containing one."""
    p = Path(path)
    if p.is_dir():
        p = p / "records.jsonl"
    if not p.exists():
        raise FileNotFoundError(
            f"no provenance records at {p} (pass a study directory or a "
            f"records.jsonl path)")
    return p


def iter_records(path: "str | Path") -> Iterator[dict[str, Any]]:
    """Stream provenance records from disk, skipping blank lines.

    A sharded run leaves per-shard segments (``records.jsonl.s<k>``)
    next to the base file; they are k-way-merged back into one
    timestamp-ordered stream, so offline reports see exactly what a
    single-handle run would have written."""
    base = records_path(path)
    segs = sorted((p for p in base.parent.glob(base.name + ".s*")
                   if p.name[len(base.name) + 2:].isdigit()),
                  key=lambda p: int(p.name.rsplit(".s", 1)[1]))

    def _stream(p: Path) -> Iterator[dict[str, Any]]:
        # corruption-tolerant (shared with the live loaders): a torn
        # tail warns and drops that record, not the whole report
        yield from iter_jsonl(p, "records")
    if not segs:
        yield from _stream(base)
        return
    yield from heapq.merge(*(_stream(p) for p in [base] + segs),
                           key=lambda r: r.get("timestamp") or 0.0)


def aggregate_records(
    path: "str | Path",
    group_by: Sequence[str],
    metrics: Sequence[str] | None = None,
) -> ResultsAggregator:
    """Offline aggregation: fold a finished study's records into a fresh
    aggregator (latest ``ok`` record per task wins)."""
    agg = ResultsAggregator(group_by, metrics=metrics)
    agg.add_records(iter_records(path))
    return agg


def degraded_banner(path: "str | Path") -> str | None:
    """A warning banner when the study's ``study.json`` marks the run
    degraded (it finished on surviving hosts after losing some): names
    the lost hosts with their failure causes and summarizes the
    attached fault ledger, so a report over partial infrastructure
    never masquerades as a clean one."""
    p = Path(path)
    meta_path = (p if p.is_dir() else p.parent) / "study.json"
    if not meta_path.exists():
        return None
    try:
        meta = json.loads(meta_path.read_text())
    except ValueError:
        return None
    if not meta.get("degraded"):
        return None
    lines = ["DEGRADED RUN: the study lost hosts mid-run and finished "
             "on the survivors"]
    causes = meta.get("host_causes") or {}
    for host in meta.get("lost_hosts") or sorted(causes):
        cause = causes.get(host, "")
        lines.append(f"  lost host {host}" + (f": {cause}" if cause
                                              else ""))
    faults = meta.get("fault_ledger") or []
    if faults:
        lines.append(f"  fault ledger: {len(faults)} injected fault(s) "
                     + ", ".join(f"{f.get('fault')}@{f.get('target')}"
                                 for f in faults[:8])
                     + ("…" if len(faults) > 8 else ""))
    return "\n".join(lines)


def parse_baseline(text: str) -> dict[str, Any]:
    """Parse a ``key=value`` baseline declaration (value type-inferred,
    matching WDL scalars)."""
    key, sep, val = text.partition("=")
    if not sep or not key.strip():
        raise ValueError(
            f"baseline must be key=value (e.g. threads=1), got {text!r}")
    return {key.strip(): infer_scalar(val.strip())}


# ---------------------------------------------------------------------------
# Pivoting + rendering
# ---------------------------------------------------------------------------


def _fmt_cell(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def render_rows(headers: Sequence[str], rows: Iterable[Sequence[Any]],
                fmt: str = "md") -> str:
    """Render one table in the requested format.  JSON emits a list of
    header-keyed objects (raw values, not formatted strings)."""
    rows = [list(r) for r in rows]
    if fmt == "json":
        return json.dumps([dict(zip(headers, r)) for r in rows], indent=2,
                          default=str)
    if fmt == "csv":
        buf = io.StringIO()
        w = csv.writer(buf, lineterminator="\n")
        w.writerow(headers)
        for r in rows:
            w.writerow([_fmt_cell(v) for v in r])
        return buf.getvalue().rstrip("\n")
    if fmt != "md":
        raise ValueError(f"unknown format {fmt!r} (valid: {FORMATS})")
    cells = [[_fmt_cell(v) for v in r] for r in rows]
    widths = [max(len(str(h)), *(len(r[i]) for r in cells), 1)
              if cells else len(str(h))
              for i, h in enumerate(headers)]
    def line(vals: Sequence[str]) -> str:
        return "| " + " | ".join(str(v).ljust(w)
                                 for v, w in zip(vals, widths)) + " |"
    out = [line([str(h) for h in headers]),
           "|" + "|".join("-" * (w + 2) for w in widths) + "|"]
    out += [line(r) for r in cells]
    return "\n".join(out)


def _sorted_keys(keys: Iterable[tuple]) -> list[tuple]:
    def k(t: tuple) -> tuple:
        return tuple((0, v) if isinstance(v, (int, float))
                     and not isinstance(v, bool) else (1, str(v))
                     for v in t)
    return sorted(keys, key=k)


def pivot_rows(entries: Mapping[tuple, Any], group_by: Sequence[str]
               ) -> tuple[list[str], list[list[Any]]]:
    """Pivot group-keyed cells: the last group-by axis spreads across
    columns, earlier axes label the rows.  A single axis degenerates to
    one row per value."""
    group_by = list(group_by)
    if len(group_by) == 1:
        headers = [group_by[0], "value"]
        rows = [[key[0], entries[key]] for key in _sorted_keys(entries)]
        return headers, rows
    col_axis = group_by[-1]
    col_vals = _sorted_keys({(key[-1],) for key in entries})
    cols = [c[0] for c in col_vals]
    by_row: dict[tuple, dict[Any, Any]] = {}
    for key, val in entries.items():
        by_row.setdefault(key[:-1], {})[key[-1]] = val
    headers = group_by[:-1] + [f"{col_axis}={c}" for c in cols]
    rows = [list(rkey) + [by_row[rkey].get(c) for c in cols]
            for rkey in _sorted_keys(by_row)]
    return headers, rows


def summary_report(agg: ResultsAggregator, metric: str,
                   fmt: str = "md") -> str:
    headers = list(agg.group_by) + list(STATS)
    rows = [list(key) + [stats.get(s) for s in STATS]
            for key, stats in agg.summary(metric).items()]
    return render_rows(headers, rows, fmt)


def table_report(agg: ResultsAggregator, metric: str, stat: str = "mean",
                 fmt: str = "md") -> str:
    headers, rows = pivot_rows(agg.table(metric, stat), agg.group_by)
    return render_rows(headers, rows, fmt)


def speedup_report(agg: ResultsAggregator, metric: str,
                   baseline: Mapping[str, Any], stat: str = "mean",
                   fmt: str = "md") -> str:
    """Speedup + parallel efficiency pivots relative to ``baseline``
    (the paper's Fig. 6/7 tables)."""
    derived = agg.speedup(metric, baseline, stat)
    if fmt == "json":
        return json.dumps(
            [dict(zip(agg.group_by, key), **vals)
             for key, vals in sorted(derived.items(),
                                     key=lambda kv: str(kv[0]))],
            indent=2, default=str)
    (bkey, bval), = baseline.items()
    sections = []
    for field in ("speedup", "efficiency"):
        entries = {key: vals[field] for key, vals in derived.items()}
        headers, rows = pivot_rows(entries, agg.group_by)
        title = (f"{field} of {stat}({metric}), "
                 f"baseline {bkey}={bval}")
        body = render_rows(headers, rows, fmt)
        sections.append(f"# {title}\n{body}")
    return "\n\n".join(sections)


def _offline_runtime_summary(path: "str | Path",
                             by: str) -> dict[str, dict[str, Any]]:
    """Rebuild ``StudyDB.runtime_summary(by=...)`` from the on-disk
    record stream: latest ``ok`` record per task id wins, so resumed
    or retried studies count each instance exactly once."""
    latest: dict[str, dict[str, Any]] = {}
    for r in iter_records(path):
        if r.get("status") == "ok":
            latest[r["task_id"]] = r
    groups: dict[str, list[float]] = {}
    for r in latest.values():
        key = (r["task_id"].partition("@")[0] if by == "task"
               else str(r.get("host") or "local"))
        groups.setdefault(key, []).append(float(r.get("runtime") or 0.0))
    out: dict[str, dict[str, Any]] = {}
    for key, times in sorted(groups.items()):
        times.sort()
        out[key] = {"count": len(times), "total": sum(times),
                    "min": times[0], "median": times[len(times) // 2],
                    "max": times[-1]}
    return out


def _fault_counts(path: "str | Path", by: str) -> dict[str, int]:
    """Fault-ledger entries per group key, from ``study.json`` — the
    runtime table's ``chaos_events`` column (0 everywhere on a run
    without an armed chaos controller)."""
    p = Path(path)
    meta_path = (p if p.is_dir() else p.parent) / "study.json"
    if not meta_path.exists():
        return {}
    try:
        meta = json.loads(meta_path.read_text())
    except ValueError:
        return {}
    counts: dict[str, int] = {}
    for f in meta.get("fault_ledger") or []:
        target = str(f.get("target") or "")
        key = target.partition("@")[0] if by == "task" else target
        counts[key] = counts.get(key, 0) + 1
    return counts


def runtime_report(source: Any, by: str = "task", fmt: str = "md") -> str:
    """Per-task / per-host runtime table.  ``source`` is a ``StudyDB``
    (live — uses its ``runtime_summary``) or a study directory /
    ``records.jsonl`` path (offline rebuild of the same summary)."""
    if by not in ("task", "host"):
        raise ValueError(
            f"runtime report groups by 'task' or 'host', got {by!r}")
    if hasattr(source, "runtime_summary"):
        summary = source.runtime_summary(by=by)
        where: Any = source.dir
    else:
        summary = _offline_runtime_summary(source, by)
        where = source
    faults = _fault_counts(where, by)
    headers = [by, "count", "total", "min", "median", "max",
               "chaos_events"]
    rows = [[key, s.get("count"), s.get("total"), s.get("min"),
             s.get("median"), s.get("max"), faults.get(key, 0)]
            for key, s in summary.items()]
    return render_rows(headers, rows, fmt)


def run_report(agg: ResultsAggregator, report: str, metric: str,
               stat: str = "mean",
               baseline: Mapping[str, Any] | None = None,
               fmt: str = "md") -> str:
    """Dispatch one report by name (shared by this CLI and
    ``repro_torch.launch.sweep --report``)."""
    if report == "summary":
        return summary_report(agg, metric, fmt)
    if report == "table":
        return table_report(agg, metric, stat, fmt)
    if report == "speedup":
        if not baseline:
            raise ValueError(
                "speedup report needs a baseline (--baseline key=value, "
                "or a WDL 'baseline:' declaration when run via sweep)")
        return speedup_report(agg, metric, baseline, stat, fmt)
    if report == "runtime":
        raise ValueError("runtime report reads provenance directly — "
                         "call runtime_report(study_dir_or_db, by, fmt)")
    raise ValueError(f"unknown report {report!r} (valid: {REPORTS})")


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Render pivot tables from a study's captured metrics "
                    "(records.jsonl)")
    ap.add_argument("path",
                    help="study directory or records.jsonl path")
    ap.add_argument("--group-by", default=None,
                    help="comma-separated group keys (parameters or "
                         "captured metrics; short names resolve like WDL "
                         "interpolation).  Required for every report "
                         "except runtime, where it picks the table axis "
                         "('task', the default, or 'host')")
    ap.add_argument("--report", choices=REPORTS, default="summary")
    ap.add_argument("--metric", default="time",
                    help="captured metric to aggregate (default: time)")
    ap.add_argument("--stat", choices=[s for s in STATS if s != "count"],
                    default="mean",
                    help="statistic for table/speedup cells")
    ap.add_argument("--baseline", default=None,
                    help="baseline point for --report speedup, as "
                         "key=value (e.g. threads=1)")
    ap.add_argument("--format", choices=FORMATS, default="md")
    args = ap.parse_args(argv)

    if args.report == "runtime":
        try:
            out = runtime_report(args.path, args.group_by or "task",
                                 args.format)
        except (FileNotFoundError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        banner = degraded_banner(args.path)
        if banner:
            print(banner, file=sys.stderr)
        print(out)
        return 0
    if not args.group_by:
        ap.error(f"--group-by is required for --report {args.report}")

    group_by = [k.strip() for k in args.group_by.split(",") if k.strip()]
    try:
        agg = aggregate_records(args.path, group_by)
        baseline = parse_baseline(args.baseline) if args.baseline else None
        out = run_report(agg, args.report, args.metric, args.stat,
                         baseline, args.format)
    except (FileNotFoundError, KeyResolutionError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if agg.n_grouped == 0:
        detail = "; ".join(agg.key_errors.values())
        print("error: no records matched the group-by keys "
              f"{group_by} (saw {agg.n_results} ok records"
              + (f"; {detail}" if detail else "") + ")",
              file=sys.stderr)
        return 2
    banner = degraded_banner(args.path)
    if banner:
        print(banner, file=sys.stderr)
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
