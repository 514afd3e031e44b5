"""``papas lint`` CLI — static analysis for WDL parameter files.

    PYTHONPATH=src python -m repro_torch.launch.lint examples/*.yaml
    PYTHONPATH=src python -m repro_torch.launch.lint study.yaml --format json
    PYTHONPATH=src python -m repro_torch.launch.lint study.yaml --strict

Each file is linted as its own study (lint a merged composition by
running ``sweep.py --check`` instead, which lints exactly what it is
about to run).  Exit status: 1 when any file has error-severity
findings (or warnings under ``--strict``), else 0 — so the command
gates CI and pre-run hooks.  A file that does not parse at all is
reported as rule ``E001`` with the parser's file/line context rather
than a traceback.

``--root`` points at a study root (``.papas``) to price the cost
estimator from observed runtimes; without it the declared ``timeout:``
keywords are the only duration priors.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any

from repro_torch.core.lint import Finding, LintReport, lint
from repro_torch.core.wdl import WDLError, parse_file


def lint_file(path: str | Path, slots: int | None = None,
              priors: dict[str, float] | None = None,
              max_runtime_days: float | None = None) -> LintReport:
    """Lint one parameter file, mapping parse failures to E001."""
    try:
        spec = parse_file(path, validate=False)
    except WDLError as e:
        return LintReport(findings=[Finding(
            rule="E001", severity="error", message=e.message,
            task=e.task, keyword=e.keyword,
            file=e.file or str(path), line=e.line)])
    except OSError as e:
        return LintReport(findings=[Finding(
            rule="E001", severity="error",
            message=f"cannot read file: {e}", file=str(path))])
    return lint(spec, slots=slots, priors=priors,
                max_runtime_days=max_runtime_days)


def render_text(reports: "dict[str, LintReport]") -> str:
    """The findings table: one block per file, aligned columns."""
    lines: list[str] = []
    for fname, rep in reports.items():
        status = "clean" if rep.ok and not rep.findings else \
            ("ok" if rep.ok else "FAIL")
        lines.append(f"== {fname} [{status}]")
        lines.extend("  " + f.render() for f in rep.findings)
        if rep.suppressed:
            lines.append(f"  suppressed: {', '.join(rep.suppressed)}")
    total_e = sum(len(r.errors) for r in reports.values())
    total_w = sum(len(r.warnings) for r in reports.values())
    lines.append(f"{len(reports)} file(s): {total_e} error(s), "
                 f"{total_w} warning(s)")
    return "\n".join(lines)


def render_json(reports: "dict[str, LintReport]") -> str:
    doc: dict[str, Any] = {
        "ok": all(r.ok for r in reports.values()),
        "files": {fname: rep.as_dict()
                  for fname, rep in reports.items()},
    }
    return json.dumps(doc, indent=2, sort_keys=True)


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        description="static analysis for WDL parameter studies")
    ap.add_argument("paramfile", nargs="+",
                    help="parameter files (each linted as its own study)")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    dest="fmt", help="findings output format")
    ap.add_argument("--slots", type=int, default=None,
                    help="assumed concurrency for the cost estimate "
                         "(default: the study's lint: block, else 8)")
    ap.add_argument("--max-runtime-days", type=float, default=None,
                    help="cost-estimate budget before W601 fires "
                         "(default: the study's lint: block, else 30)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on warnings too, not just errors")
    ap.add_argument("--root", default=None,
                    help="study root (.papas) for observed-duration "
                         "priors (default: declared timeouts only)")
    args = ap.parse_args(argv)

    reports: dict[str, LintReport] = {}
    for fname in args.paramfile:
        priors = None
        if args.root:
            priors = _observed_priors(args.root, fname)
        reports[fname] = lint_file(
            fname, slots=args.slots, priors=priors,
            max_runtime_days=args.max_runtime_days)

    out = (render_json(reports) if args.fmt == "json"
           else render_text(reports))
    print(out)
    failed = any(not r.ok for r in reports.values()) or (
        args.strict and any(r.warnings for r in reports.values()))
    return 1 if failed else 0


def _observed_priors(root: str, paramfile: str) -> "dict[str, float] | None":
    """Median observed runtime per task from an existing study root —
    best effort: a missing/foreign root simply prices from timeouts."""
    try:
        from repro_torch.core.study import load_study

        study = load_study(paramfile, root=root)
        samples: dict[str, list[float]] = {}
        for rec in study.db.records():
            if rec.get("status") != "ok":
                continue
            tname = str(rec.get("task_id", "")).split("@", 1)[0]
            rt = rec.get("runtime")
            if tname and isinstance(rt, (int, float)):
                samples.setdefault(tname, []).append(float(rt))
        return {t: sorted(v)[len(v) // 2] for t, v in samples.items()} \
            or None
    except Exception:
        return None


if __name__ == "__main__":
    sys.exit(main())
