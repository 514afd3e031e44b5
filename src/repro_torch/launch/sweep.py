"""The PaPaS driver on the port: run a WDL parameter file where tasks are
TRAINING RUNS of this framework — the paper's technique applied to itself.

    PYTHONPATH=src python -m repro_torch.launch.sweep study.yaml
    PYTHONPATH=src python -m repro_torch.launch.sweep study.yaml --device cpu

Tasks whose command starts with ``train`` (``train arch=gemma3-1b
steps=5``: ``key=value`` defaults under the swept ``args``) are resolved
to in-process training calls on the smoke config of their arch
(registry execution, ``repro_torch.train.ensemble.train_members``, one
member a call); anything else runs as a shell command.  ``--gang``
gang-packs stackable instances into ONE batched run for each (arch,
steps, batch, seq) their combos give (the scalars, lr and seed, differ
within it) through ``repro_torch.train.ensemble.train_ensemble``
— the members stacked on a leading axis of every tensor and folded into
each kernel's launch: the paper's job-batching (§4.3) on one card.
``--device`` (``cuda`` by default, ``cpu`` for the tests) is where the
training tasks run; nothing here touches the card before a task does.
Under ``--pool process`` a ``train`` task fails as the reference's does:
its registry entry is a closure, which does not pickle ("Can't get local
object"), and the engine records each attempt as failed.  ``--slots N --pool thread|process`` runs instances
concurrently through the engine's worker pools (the paper's
``nnodes × ppnode`` resource knob); ``--pool lane`` feeds rendered shell
commands to persistent worker lanes — the short-task throughput path
(sub-100ms tasks dispatch at thousands/sec instead of being
scheduler-bound on process spawn).

Remote backends (paper §4.3 distributed parallelization):
``--pool ssh --hosts a,b --ppnode 2`` dispatches rendered shell
commands over ``hosts × ppnode`` slots; ``--pool slurm|pbs --nnodes N
--ppnode P`` submits grouped allocations.  ``--transport``/
``--submitter`` default to the no-network fakes (commands run locally,
per-"host" accounting preserved) — pass ``--transport ssh`` /
``--submitter scheduler`` to reach real hosts / a real queue.

``--window N`` streams the study instead of materializing it: instances
are addressed by space index, at most ``slots + N`` task nodes stay
live, and checkpoints use the compact v2 journal — constant startup time
and bounded memory for arbitrarily large parameter spaces.

``--report {summary,table,speedup} --group-by size,threads`` turns the
run into a performance study (paper §6): tasks' ``capture:`` metrics
stream through a ``ResultsAggregator`` as completions arrive (the run
switches to ``keep_results=False`` — O(groups) memory however large the
sweep) and the chosen pivot table prints at the end.  ``--baseline
threads=1`` (default: the WDL ``baseline:`` keyword) anchors the
speedup/efficiency derivation; ``--metric``/``--stat``/``--format``
pick what fills the cells.  The same table is reproducible offline from
``records.jsonl`` via ``python -m repro_torch.launch.report``.

The engine (``repro_torch.core``) is the reference engine's own copy with
a YAML reader of its own, so the sweep runs where neither jax nor
PyYAML is installed; the files it writes (``records.jsonl``, the
journal, ``study.json``) are the reference's, and either engine resumes
the other's study.
"""
from __future__ import annotations

import argparse
import shlex
import sys
from pathlib import Path
from typing import Any

from repro_torch.core import (
    GangExecutor, LocalSubmitter, LocalTransport, ResultsAggregator,
    SchedulerSubmitter, SSHTransport, Telemetry, WDLError, load_study,
    stackable_key,
)
from repro_torch.launch import report as report_mod


def _train_combo(combo: dict[str, Any], defaults: dict[str, Any],
                 device: str) -> float:
    """One member training run (used for one-per-task dispatch)."""
    from repro_torch.train.ensemble import train_members
    args = {**defaults, **combo}
    return train_members([args], device=device)[0]


def _window_arg(text: str) -> Any:
    """``--window`` accepts a positive int or the literal ``auto``."""
    if text.strip().lower() == "auto":
        return "auto"
    try:
        return int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"window must be a positive int or 'auto', got {text!r}")


def main(argv: list[str] | None = None) -> dict[str, Any]:
    """Runs the study; returns its results by node id, as ``run`` gives
    them (empty under ``--report``, which streams them)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("paramfile", nargs="+")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--gang", action="store_true",
                    help="vmap-stack stackable instances (one dispatch)")
    ap.add_argument("--slots", type=int, default=1,
                    help="concurrent execution slots (local pools)")
    ap.add_argument("--pool", default="inline",
                    help="execution backend for non-gang runs: inline, "
                         "thread, process, lane (persistent shell worker "
                         "lanes — short-task throughput), ssh, slurm, "
                         "or pbs")
    ap.add_argument("--hosts", default=None,
                    help="comma-separated host list for --pool ssh "
                         "(default: the WDL hosts: keyword)")
    ap.add_argument("--ppnode", type=int, default=None,
                    help="processes per node for ssh/batch pools")
    ap.add_argument("--nnodes", type=int, default=None,
                    help="allocation node count for batch pools")
    ap.add_argument("--transport", choices=("local", "ssh"), default="local",
                    help="ssh-pool transport: 'local' = no-network fake "
                         "(runs commands on this machine, one slot per "
                         "host×ppnode), 'ssh' = real ssh subprocesses")
    ap.add_argument("--submitter", choices=("local", "scheduler"),
                    default="local",
                    help="batch-pool submitter: 'local' = run the rendered "
                         "script with sh (no scheduler binary), "
                         "'scheduler' = real sbatch/qsub")
    ap.add_argument("--speculate", action="store_true",
                    help="duplicate straggler tasks (idempotent tasks only)")
    ap.add_argument("--window", type=_window_arg, default=None,
                    help="streaming admission: keep at most slots+WINDOW "
                         "task nodes live, address instances by index "
                         "instead of materializing the space, and journal "
                         "in compact v2 form; 'auto' sizes the window "
                         "from the observed completion rate (default: "
                         "eager whole-DAG)")
    ap.add_argument("--straggler-quantile", type=float, default=None,
                    metavar="Q",
                    help="straggler cutoff as a runtime quantile in "
                         "(0, 1), e.g. 0.9 for p90 — replaces the "
                         "default straggler_factor x median rule "
                         "(default: the WDL straggler_quantile: keyword)")
    ap.add_argument("--report", choices=report_mod.REPORTS, default=None,
                    help="aggregate captured metrics while the study "
                         "streams and print this pivot table at the end "
                         "(requires --group-by; implies keep_results=False "
                         "— O(groups) memory).  'runtime' instead prints "
                         "the per-task (or per-host, --group-by host) "
                         "runtime table from provenance — no captures "
                         "needed")
    ap.add_argument("--group-by", default=None,
                    help="comma-separated group keys for --report: "
                         "parameters or captured metrics (short names "
                         "resolve like WDL interpolation)")
    ap.add_argument("--baseline", default=None,
                    help="speedup baseline as key=value (default: the "
                         "WDL 'baseline:' keyword)")
    ap.add_argument("--metric", default="time",
                    help="captured metric the report aggregates "
                         "(default: time)")
    ap.add_argument("--stat", default="mean",
                    choices=[s for s in report_mod.STATS if s != "count"],
                    help="statistic for table/speedup cells")
    ap.add_argument("--format", choices=report_mod.FORMATS, default="md",
                    dest="report_format", help="report output format")
    ap.add_argument("--chaos", default=None, metavar="PLAN",
                    help="arm deterministic fault injection from a "
                         "fault-plan YAML (repro_torch.core.chaos): faults "
                         "fire by plan, the run degrades gracefully "
                         "instead of dying, and study.json carries the "
                         "fault ledger")
    ap.add_argument("--trace", nargs="?", const=True, default=None,
                    metavar="PATH",
                    help="arm the telemetry layer (repro_torch.core.telemetry) "
                         "and write a Chrome-trace-event JSON of the run "
                         "— task-lifecycle spans per slot/lane/host, "
                         "retry waits, chaos firings — loadable in "
                         "https://ui.perfetto.dev (default path: "
                         "<study dir>/trace.json)")
    ap.add_argument("--status", action="store_true",
                    help="live in-place progress line on stderr: "
                         "done/running/failed/retrying, tasks/s, and an "
                         "ETA from the streaming median runtime "
                         "(implies telemetry arming)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="N",
                    help="serve Prometheus text /metrics and JSON "
                         "/status from a daemon thread on 127.0.0.1:N "
                         "while the study runs (0 picks a free port; "
                         "implies telemetry arming)")
    ap.add_argument("--check", action="store_true",
                    help="pre-flight static analysis (repro_torch.core.lint) "
                         "before admitting the run: print findings and "
                         "exit 1 on any error-severity rule — the same "
                         "checks 'python -m repro_torch.launch.lint' runs")
    ap.add_argument("--root", default=".papas")
    ap.add_argument("--device", default="cuda",
                    help="where train tasks run: cuda (default) or cpu")
    args = ap.parse_args(argv)

    try:
        study = load_study(*[Path(p) for p in args.paramfile],
                           root=args.root)
    except WDLError as e:
        if not args.check:
            raise
        print(f"ERROR E001 {e}", file=sys.stderr)
        sys.exit(1)

    if args.check:
        report = study.lint(slots=args.slots)
        if report.findings:
            print(report.render(), file=sys.stderr)
        if not report.ok:
            print("lint: study rejected (fix the errors above or "
                  "suppress rule ids via the study's lint: block)",
                  file=sys.stderr)
            sys.exit(1)

    aggregator = None
    if args.report == "runtime":
        # runtime tables come straight from provenance — no capture
        # aggregation; --group-by (optional) picks the task/host axis
        if args.group_by not in (None, "task", "host"):
            ap.error("--report runtime groups by 'task' or 'host'")
    elif args.report is not None:
        if not args.group_by:
            ap.error("--report requires --group-by")
        aggregator = ResultsAggregator(
            [k.strip() for k in args.group_by.split(",") if k.strip()])
    elif args.group_by:
        ap.error("--group-by only makes sense with --report")

    # registry: any task whose command begins with "train" runs in-process
    registry = {}
    for tname, task in study.spec.tasks.items():
        if task.command and task.command.split()[0] == "train":
            defaults = dict(
                tok for tok in
                (t.split("=", 1) for t in shlex.split(task.command)[1:]
                 if "=" in t))
            registry[tname] = (
                lambda combo, _d=defaults: _train_combo(combo, _d,
                                                        args.device))
    study.registry.update(registry)

    counts = {"ok": 0, "total": 0}
    extra_kwargs: dict = {}
    if aggregator is not None:
        if args.resume:
            # metrics recorded before the resume never re-stream —
            # seed the aggregator from the surviving records
            aggregator.add_records(study.db.records())

        def _count(res) -> None:
            counts["total"] += 1
            if res.status == "ok":
                counts["ok"] += 1
        extra_kwargs = dict(aggregator=aggregator, on_result=_count,
                            keep_results=False)

    if args.straggler_quantile is not None:
        extra_kwargs["straggler_quantile"] = args.straggler_quantile
    if args.chaos is not None:
        extra_kwargs["chaos"] = args.chaos

    # telemetry: one instance owns the trace, metrics, status line, and
    # (optionally) the HTTP endpoint; the study arms it for the run and
    # snapshots metrics into study.json, sweep owns its lifetime
    tel = None
    if (args.trace is not None or args.status
            or args.metrics_port is not None):
        tel = Telemetry(path=None if args.trace in (None, True)
                        else args.trace)
        extra_kwargs["trace"] = tel
        if args.metrics_port is not None:
            port = tel.serve(args.metrics_port)
            print(f"[telemetry] http://127.0.0.1:{port}/metrics "
                  f"(Prometheus text) and /status (JSON)")
        if args.status:
            tel.attach_status()
            _prev_cb = extra_kwargs.get("on_result")

            def _tick(res, _prev=_prev_cb, _tel=tel):
                if _prev is not None:
                    _prev(res)
                _tel.tick()
            extra_kwargs["on_result"] = _tick

    if args.gang:
        from repro_torch.train import ensemble

        def gang_runner(nodes):
            members = [dict(n.combo) for n in nodes]
            return ensemble.train_ensemble(members, device=args.device)

        def gang_key(node):
            # an axis over a shape-affecting key (arch, steps, batch, seq)
            # makes one gang a value: members of one dispatch share them
            return (*stackable_key(node), ensemble.shape_key(node.combo))
        gang = GangExecutor(gang_key, gang_runner)
        results = study.run(gang=gang, resume=args.resume,
                            window=args.window, **extra_kwargs)
        print(f"[gang] {gang.stats.tasks} tasks in "
              f"{gang.stats.dispatches} dispatches "
              f"(batching ×{gang.stats.batching_factor:.0f})")
    else:
        transport = None
        if args.pool == "ssh":
            transport = (SSHTransport() if args.transport == "ssh"
                         else LocalTransport())
        submitter = None
        if args.pool in ("slurm", "pbs"):
            submitter = (SchedulerSubmitter(args.pool)
                         if args.submitter == "scheduler"
                         else LocalSubmitter())
        hosts = ([h.strip() for h in args.hosts.split(",") if h.strip()]
                 if args.hosts else None)
        try:
            results = study.run(resume=args.resume, slots=args.slots,
                                pool=args.pool, speculate=args.speculate,
                                hosts=hosts, ppnode=args.ppnode,
                                nnodes=args.nnodes, transport=transport,
                                submitter=submitter, window=args.window,
                                **extra_kwargs)
        except ValueError as e:
            ap.error(str(e))    # e.g. unknown --pool kind, missing hosts

    if tel is not None:
        if args.status:
            tel.finish_status()
        trace_path = (Path(tel.path) if tel.path
                      else study.db.dir / "trace.json")
        print(f"[telemetry] trace written to {trace_path} — load it in "
              f"https://ui.perfetto.dev")
        tel.close()

    if aggregator is not None:
        ok, total = counts["ok"], counts["total"]
    else:
        ok = sum(1 for r in results.values() if r.status == "ok")
        total = len(results)
    print(f"{ok}/{total} instances complete; "
          f"provenance in {study.db.dir}")
    banner = report_mod.degraded_banner(study.db.dir)
    if banner:
        print(banner, file=sys.stderr)
    stats = getattr(study, "last_run_stats", None)
    if args.window is not None and stats:
        print(f"[window] admitted {stats['admitted_instances']}"
              f"/{stats['n_instances']} instances "
              f"({stats['skipped_complete']} already complete), "
              f"peak live nodes {stats['peak_live_nodes']} "
              f"(bound {stats['slots']} slots + {stats['window']} window)")
    if args.report == "runtime":
        # live path: surfaces StudyDB.runtime_summary() directly (the
        # offline twin reads records.jsonl via repro_torch.launch.report)
        print(report_mod.runtime_report(study.db, args.group_by or "task",
                                        args.report_format))
        return results
    if aggregator is not None:
        for key, err in aggregator.key_errors.items():
            print(f"warning: group-by key {key!r}: {err}",
                  file=sys.stderr)
        try:
            if aggregator.n_grouped == 0:
                raise ValueError(
                    f"no results matched the group-by keys "
                    f"{aggregator.group_by}")
            baseline = (report_mod.parse_baseline(args.baseline)
                        if args.baseline else _wdl_baseline(study.spec))
            print(report_mod.run_report(
                aggregator, args.report, args.metric, args.stat,
                baseline, args.report_format))
        except (KeyError, ValueError) as e:
            ap.error(str(e))    # e.g. missing baseline, bad group key
        return results

    for rid, res in sorted(results.items()):
        val = res.value if res.value is not None else ""
        where = f" @{res.host}" if res.host else ""
        print(f"  {rid}: {res.status} ({res.runtime:.2f}s){where} {val}")
    return results


def _wdl_baseline(spec) -> dict | None:
    """The study-declared baseline point, merged across tasks (two tasks
    declaring different values for the same key is a spec error)."""
    out: dict = {}
    for t in spec.tasks.values():
        for k, v in t.baseline.items():
            if k in out and out[k] != v:
                raise ValueError(
                    f"conflicting baseline for {k!r}: {out[k]!r} vs {v!r}")
            out[k] = v
    return out or None


if __name__ == "__main__":
    main()
