"""The Parameter Study engine (paper §4.1) — the top of the stack.

A study is parsed from WDL (or built via the Python API), expanded into
workflow instances (one per unique parameter combination, §5.1), compiled
into a task DAG (tasks × instances), and executed through a chosen
backend with provenance + checkpoint/restart.

Semantics: the global parameter space is the product of every task's
parameter space (parameters are task-namespaced as ``task/param``); a
*workflow instance* is one combination applied across the whole task DAG,
exactly the paper's "a workflow corresponds to an instance having a
unique parameter combination".

Two execution shapes share every backend, retry, and journal semantic:

* **Eager** (``run()``) — materialize all instances, build the full
  tasks × instances DAG up front, journal v1.  Right for small studies
  and for gang policies that want the whole ready set visible.
* **Streaming** (``run(window=N)``) — instances are *addressed, never
  enumerated*: ``iter_instances()`` streams ``(space index, combo)``
  pairs via the space's O(1) mixed-radix ``combo_at``, an
  ``InstanceWindow`` stamps out each instance's task sub-DAG only when
  the scheduler's bounded frontier has room, resolved nodes retire
  immediately, and the journal is compact v2 (space hash + completed
  instance indices, range-compressed).  Startup cost and live state are
  O(slots + window) — independent of N_W — which is what makes
  million-combination studies (§5.1 "large parameter spaces") tractable.
"""
from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Any, Callable, Iterator, Mapping, Sequence

from . import chaos as chaos_mod
from . import telemetry as telemetry_mod
from .interpolate import compile_environ, compile_template
from .dag import TaskDAG, TaskNode
from .executors import (
    GangExecutor, GangPool, WorkerPool, make_pool, payload_timeout,
    run_subprocess, stackable_key,
)
from .paramspace import ParameterSpace, combo_id, from_task
from .provenance import StudyDB
from .results import build_capture_sets
from .scheduler import AdaptiveWindow, Scheduler, TaskResult
from .state import StudyJournal
from .wdl import StudySpec, TaskSpec, parse_file
from .viz import to_ascii, to_dot

#: registry type: task name → callable(combo: dict) -> Any
TaskRegistry = Mapping[str, Callable[[dict[str, Any]], Any]]


def _ns(task: str, pname: str) -> str:
    return f"{task}/{pname}"


def _strip_ns(combo: Mapping[str, Any], task: str) -> dict[str, Any]:
    """Project the global combo onto one task's local parameter names."""
    local: dict[str, Any] = {}
    prefix = f"{task}/"
    for key, value in combo.items():
        if key.startswith(prefix):
            local[key[len(prefix):]] = value
    return local


class _LazyStudies(Mapping):
    """Per-task combo projections for inter-task ``${task:...}``
    references, materialized only if a reference actually resolves
    through them — rendering a node with no inter-task refs never pays
    the O(tasks × combo) projection the eager dict paid per node."""

    __slots__ = ("_tasks", "_combo", "_cache")

    def __init__(self, tasks: Mapping[str, Any],
                 combo: Mapping[str, Any]) -> None:
        self._tasks = tasks
        self._combo = combo
        self._cache: dict[str, dict[str, Any]] = {}

    def __getitem__(self, key: str) -> dict[str, Any]:
        if key not in self._tasks:
            raise KeyError(key)
        hit = self._cache.get(key)
        if hit is None:
            hit = self._cache[key] = _strip_ns(self._combo, key)
        return hit

    def __iter__(self) -> Iterator[str]:
        return iter(self._tasks)

    def __len__(self) -> int:
        return len(self._tasks)


class ParameterStudy:
    """Orchestrates expansion → DAG → scheduling → provenance."""

    def __init__(
        self,
        spec: StudySpec,
        registry: TaskRegistry | None = None,
        root: str | Path = ".papas",
        name: str | None = None,
        flush_count: int = 64,
        flush_interval: float | None = 0.2,
    ) -> None:
        """``flush_count``/``flush_interval`` set the group-commit policy
        ``run()`` applies to the journal and provenance DB for the
        duration of a run (see ``StudyJournal.group_commit``): records
        buffer and flush per batch instead of per task, and are always
        flushed before ``run()`` returns or raises.  Outside a run both
        stores keep their durable-per-write default."""
        self.spec = spec
        self.registry = dict(registry or {})
        self.name = name or "_".join(spec.tasks)[:48]
        self.flush_count = flush_count
        self.flush_interval = flush_interval
        self.db = StudyDB(root, self.name)
        self.journal = StudyJournal(self.db.dir / "journal.json")
        #: task → compiled ``capture:`` extractors (results subsystem)
        self.captures = build_capture_sets(spec)

    # -- expansion --------------------------------------------------------
    def space(self) -> ParameterSpace:
        """The global parameter space (task-namespaced product).

        ``sampling`` applies to the *global* combination space, so at
        most one distinct sampling block may appear across tasks —
        conflicting blocks raise ``ValueError`` instead of silently
        letting the first task win."""
        params: dict[str, list[Any]] = {}
        fixed: list[list[str]] = []
        sampling: dict[str, Any] | None = None
        sampling_owner: str | None = None
        for tname, task in self.spec.tasks.items():
            tparams = task.parameters()
            tspace = from_task(tparams, task.fixed, task.sampling)
            for pname, values in tspace.params.items():
                params[_ns(tname, pname)] = values
            for group in tspace.fixed:
                fixed.append([_ns(tname, p) for p in group])
            if task.sampling:
                block = dict(task.sampling)
                if sampling is None:
                    sampling, sampling_owner = block, tname
                elif block != sampling:
                    raise ValueError(
                        f"conflicting sampling blocks: task "
                        f"{sampling_owner!r} declares {sampling!r} but "
                        f"task {tname!r} declares {block!r} (sampling is "
                        f"global to the study — declare it once, or "
                        f"identically)")
        return ParameterSpace(params=params, fixed=fixed, sampling=sampling)

    def instance_count(self) -> int:
        """Post-sampling instance count, without enumerating the space."""
        return self.space().sample_count()

    def iter_instances(self) -> Iterator[tuple[int, dict[str, Any]]]:
        """Stream ``(space index, combo)`` pairs in deterministic
        sampling order — O(1) memory regardless of space size."""
        space = self.space()
        for i in space.iter_sample():
            yield i, space.combo_at(i)

    def instances(self) -> list[dict[str, Any]]:
        """All workflow instances (post-sampling), deterministic order —
        materialized; prefer ``iter_instances`` for large spaces."""
        return self.space().sample()

    # -- static analysis ---------------------------------------------------
    def lint(self, slots: int | None = None,
             max_runtime_days: float | None = None) -> Any:
        """Pre-flight static analysis (``repro_torch.core.lint`` rule pack).

        Cost-estimator priors are this study's own observed median
        runtimes per task (from provenance records of earlier runs),
        falling back to each task's declared ``timeout:`` — so a
        re-lint after a partial run prices the sweep from real data.
        Index math only; never materializes an instance."""
        from .lint import lint as lint_spec

        samples: dict[str, list[float]] = {}
        try:
            for rec in self.db.records():
                if rec.get("status") != "ok":
                    continue
                tname = str(rec.get("task_id", "")).split("@", 1)[0]
                rt = rec.get("runtime")
                if tname and isinstance(rt, (int, float)):
                    samples.setdefault(tname, []).append(float(rt))
        except Exception:        # unreadable records never block linting
            samples = {}
        priors = {t: sorted(v)[len(v) // 2] for t, v in samples.items()}
        return lint_spec(self.spec, slots=slots, priors=priors,
                         max_runtime_days=max_runtime_days)

    # -- DAG construction ---------------------------------------------------
    def _instance_nodes(self, combo: Mapping[str, Any],
                        index: int | None = None) -> list[TaskNode]:
        """One instance's task sub-DAG (self-contained: deps stay inside
        the instance).  ``index`` is the combo's space index, carried in
        the payload for journal v2 / provenance."""
        cid = combo_id(combo)
        nodes: list[TaskNode] = []
        for tname, task in self.spec.tasks.items():
            payload: dict[str, Any] = {"global_combo": dict(combo),
                                       "timeout": task.timeout,
                                       "allow_nonzero": task.allow_nonzero}
            if task.retry:
                payload["retry"] = task.retry
            if index is not None:
                payload["index"] = index
            nodes.append(TaskNode(
                id=f"{tname}@{cid}", task=tname,
                combo=_strip_ns(combo, tname),
                deps=[f"{d}@{cid}" for d in task.after],
                payload=payload))
        return nodes

    def build_dag(self, instances: Sequence[Mapping[str, Any]] | None = None
                  ) -> TaskDAG:
        dag = TaskDAG()
        combos = list(instances) if instances is not None else self.instances()
        for combo in combos:
            for node in self._instance_nodes(combo):
                dag.add(node)
        dag.validate()
        return dag

    # -- rendering ----------------------------------------------------------
    def render_node(self, node: TaskNode) -> tuple[str | None, dict[str, str]]:
        """Render the command line and environment for one node.

        Uses compiled instance templates: each distinct command/environ
        template parses once per process (``interpolate.compile_template``)
        and every instance render is a list join over resolved slots —
        byte-identical to the reference ``interpolate()`` path, minus the
        per-instance regex work.  Inter-task ``${task:...}`` projections
        are built lazily, only if a reference resolves through them."""
        task = self.spec.tasks[node.task]
        cmd = None
        if task.command:
            studies = _LazyStudies(self.spec.tasks,
                                   node.payload["global_combo"])
            cmd = compile_template(task.command).render(
                node.combo, node.task, studies)
        env = compile_environ(tuple(task.environ)).render(node.combo)
        return cmd, env

    def visualize(self, fmt: str = "ascii",
                  states: Mapping[str, str] | None = None) -> str:
        dag = self.build_dag()
        return to_dot(dag, states, self.name) if fmt == "dot" else to_ascii(dag, states)

    # -- execution ------------------------------------------------------------
    def _default_runner(self, node: TaskNode) -> Any:
        if node.task in self.registry:
            return self.registry[node.task](dict(node.combo))
        cmd, env = self.render_node(node)
        if cmd is None:
            raise RuntimeError(
                f"task {node.task!r} has no command and no registered callable")
        # ambient env snapshotted once per run, not copied per task
        return run_subprocess(cmd, env=env, timeout=payload_timeout(node),
                              base_env=getattr(self, "_run_base_env", None))

    def _remote_spec_defaults(self) -> dict[str, Any]:
        """Remote-execution keywords from the WDL, merged across tasks.

        A keyword a task leaves unset (``None`` / empty ``hosts``) defers
        to whichever task declares it; two tasks declaring *different*
        values for the same keyword is a spec error (the pool is built
        once per study, so per-task divergence cannot be honored)."""
        out: dict[str, Any] = {"hosts": None, "batch": None,
                               "nnodes": None, "ppnode": None}
        owner: dict[str, str] = {}
        for tname, task in self.spec.tasks.items():
            declared = {"hosts": task.hosts or None, "batch": task.batch,
                        "nnodes": task.nnodes, "ppnode": task.ppnode}
            for key, val in declared.items():
                if val is None:
                    continue
                if out[key] is None:
                    out[key], owner[key] = val, tname
                elif out[key] != val:
                    raise ValueError(
                        f"conflicting remote keyword {key!r}: task "
                        f"{owner[key]!r} declares {out[key]!r} but task "
                        f"{tname!r} declares {val!r}")
        return out

    def _spec_straggler_quantile(self) -> float | None:
        """The WDL ``straggler_quantile:`` keyword, merged across tasks
        (the scheduler has one cutoff rule per run, so divergent
        declarations are a spec error)."""
        out: float | None = None
        owner: str | None = None
        for tname, task in self.spec.tasks.items():
            q = task.straggler_quantile
            if q is None:
                continue
            if out is None:
                out, owner = q, tname
            elif out != q:
                raise ValueError(
                    f"conflicting straggler_quantile: task {owner!r} "
                    f"declares {out!r} but task {tname!r} declares {q!r}")
        return out

    @staticmethod
    def _auto_shards(worker: WorkerPool) -> int:
        """Journal/DB shard count for a backend: high-rate local
        parallel pools (lanes, processes) split the completion stream so
        group commits never serialize on one handle; everything else
        keeps the legacy single-segment layout."""
        slots = int(getattr(worker, "slots", 1) or 1)
        if getattr(worker, "kind", "") in ("lane", "process") and slots > 1:
            return min(4, slots)
        return 1

    def _make_worker(
        self,
        pool: str | WorkerPool,
        gang: GangExecutor | None,
        slots: int,
        hosts: Sequence[str] | None,
        ppnode: int | None,
        nnodes: int | None,
        transport: Any,
        submitter: Any,
    ) -> tuple[WorkerPool, bool]:
        """Resolve the execution backend (shared by the eager and
        windowed paths).  Returns ``(worker, owned)`` — an owned worker
        is shut down by the run that created it."""
        if gang is not None:
            return GangPool(gang), True
        if isinstance(pool, WorkerPool):
            return pool, False
        if pool == "lane":
            # a capture sourcing stderr needs the spool routed back even
            # on success (lanes otherwise read stderr only on failure)
            wants_stderr = any(cs.uses_stderr for cs in self.captures.values())
            return make_pool("lane", slots, render=self.render_node,
                             capture_stderr=wants_stderr), True
        if pool in ("ssh", "slurm", "pbs", "batch"):
            d = self._remote_spec_defaults()
            kind = pool if pool != "batch" else (d["batch"] or "slurm")
            return make_pool(
                kind, slots,
                hosts=list(hosts) if hosts else d["hosts"],
                ppnode=ppnode or d["ppnode"],
                nnodes=nnodes or d["nnodes"],
                render=self.render_node, transport=transport,
                submitter=submitter,
                spool_root=self.db.dir / "batch"), True
        return make_pool(pool, slots), True

    # -- chaos / degraded-run health ------------------------------------
    @staticmethod
    def _resolve_chaos(chaos: Any) -> Any:
        """Normalize ``run(chaos=…)`` to a live ``ChaosController``:
        accepts a controller, a ``FaultPlan``, a plan mapping, or a
        path to a plan YAML.  ``None`` falls through to whatever is
        already armed process-wide (``PAPAS_CHAOS`` / ``install``)."""
        if chaos is None:
            return chaos_mod.current()
        if isinstance(chaos, chaos_mod.ChaosController):
            return chaos
        if isinstance(chaos, chaos_mod.FaultPlan):
            return chaos.controller()
        if isinstance(chaos, Mapping):
            return chaos_mod.FaultPlan.from_dict(chaos).controller()
        return chaos_mod.FaultPlan.load(chaos).controller()

    # -- telemetry -------------------------------------------------------
    @staticmethod
    def _resolve_trace(trace: Any) -> Any:
        """Normalize ``run(trace=…)`` to a live ``Telemetry`` (or None):
        accepts a ``Telemetry``, ``True`` (fresh collector, default
        ``trace.json`` location), a path for the trace file, or
        ``False`` to force-disarm.  ``None`` falls through to whatever
        is already armed process-wide (``PAPAS_TRACE`` / ``install``)."""
        if trace is None:
            return telemetry_mod.current()
        if trace is False:
            return None
        if isinstance(trace, telemetry_mod.Telemetry):
            return trace
        if trace is True:
            return telemetry_mod.Telemetry()
        return telemetry_mod.Telemetry(path=trace)

    def _finalize_telemetry(self, tel: Any) -> None:
        """Persist the armed run's observability artifacts: the Chrome
        trace next to the provenance files and the metrics snapshot —
        including per-shard group-commit counters, captured *before*
        post-run compaction folds the segments — into ``study.json``."""
        snapshot = tel.metrics.snapshot()
        snapshot["groupcommit_shards"] = {
            "journal": self.journal.shard_counters(),
            "records": self.db.shard_counters(),
        }
        trace_path = Path(tel.path) if tel.path else self.db.dir / "trace.json"
        tel.trace.write(trace_path)
        meta = self.db.read_meta()
        meta["telemetry"] = snapshot
        meta["trace"] = str(trace_path)
        self.db.write_meta(meta)

    def _finalize_run_health(self, worker: Any, ctrl: Any
                             ) -> dict[str, Any]:
        """Post-run health verdict (graceful degradation): a run that
        survived faults — permanently lost hosts, injected chaos —
        completes *degraded* instead of dying, and ``study.json``
        records what was lost (per-host causes, the fault ledger) so
        reports can flag the result set (§4.3 fault tolerance)."""
        health: dict[str, Any] = {}
        lost = sorted(getattr(worker, "dead_hosts", None) or ())
        if lost:
            causes = getattr(worker, "host_causes", None) or {}
            health["lost_hosts"] = lost
            health["host_causes"] = {h: causes.get(h, "unknown")
                                     for h in lost}
        if ctrl is not None and len(ctrl.ledger):
            health["fault_ledger"] = ctrl.ledger.as_list()
        if health:
            health["degraded"] = True
            meta = self.db.read_meta()
            meta.update(health)
            self.db.write_meta(meta)
        return health

    # -- results capture ------------------------------------------------
    def _capture_state(self, aggregator: Any) -> tuple[
            Callable[[TaskNode, Any], str | None] | None,
            Callable[[TaskNode, TaskResult], dict[str, Any] | None] | None]:
        """Per-run capture machinery: ``(classify, finish)``.

        ``classify`` runs the text extractors against a completed
        attempt's value and fails the attempt when a *required* metric
        is missing (scheduler seam — retries and failure closure apply
        like any task failure); extracted metrics are cached so the
        final resolution never re-extracts.  ``finish`` folds in the
        engine-measured builtins, attaches the metrics to the
        ``TaskResult``, and feeds the streaming aggregator.  Both are
        ``None`` when the study declares no captures (and no aggregator
        rides along) — the hot path pays nothing.
        """
        if not self.captures and aggregator is None:
            return None, None
        cache: dict[str, dict[str, Any]] = {}

        def classify(node: TaskNode, value: Any) -> str | None:
            cs = self.captures.get(node.task)
            if cs is None:
                return None
            metrics, missing = cs.extract(value, combo=node.combo)
            cache[node.id] = metrics
            if missing:
                plural = "s" if len(missing) > 1 else ""
                return (f"missing required metric{plural}: "
                        f"{', '.join(sorted(missing))}")
            return None

        def finish(node: TaskNode, res: TaskResult
                   ) -> dict[str, Any] | None:
            cs = self.captures.get(node.task)
            metrics = None
            if cs is not None:
                metrics = cs.finalize(cache.pop(res.id, None), res)
                res.metrics = metrics
            if aggregator is not None and res.status == "ok":
                aggregator.add(node.combo, metrics or {})
            return metrics

        return (classify if self.captures else None), finish

    @staticmethod
    def _ids_from_indices(space: ParameterSpace,
                          completed_indices: Mapping[str, set[int]]
                          ) -> set[str]:
        """Reconstruct completed node ids from a v2 journal's per-task
        instance indices (eager resume of a streaming journal)."""
        cids: dict[int, str] = {}
        ids: set[str] = set()
        for tname, idxs in completed_indices.items():
            for i in idxs:
                cid = cids.get(i)
                if cid is None:
                    cid = cids[i] = combo_id(space.combo_at(i))
                ids.add(f"{tname}@{cid}")
        return ids

    @staticmethod
    def _indices_from_v1(space: ParameterSpace, instances: Sequence[Mapping[str, Any]],
                         completed: set[str]) -> dict[str, set[int]]:
        """Migrate a v1 journal's completed node ids to per-task space
        indices (streaming resume of an eager journal).  Instances no
        longer addressable in the current space are dropped — they would
        not be admitted anyway.

        A crash-state v1 journal (the eager run died between
        ``mark_complete`` and compaction) has completions in the sidecar
        log but an *empty* base instance list; completed ids their
        instance list cannot explain are resolved by streaming the
        sampled space until every cid is found — completions cluster at
        the front of sampling order, so the scan usually stops early.
        """
        idx_by_cid: dict[str, int] = {}
        for inst in instances:
            try:
                idx_by_cid[combo_id(inst)] = space.index_of(inst)
            except (KeyError, ValueError):
                continue
        unmatched = ({nid.partition("@")[2] for nid in completed}
                     - set(idx_by_cid))
        if unmatched:
            for i in space.iter_sample():
                cid = combo_id(space.combo_at(i))
                if cid in unmatched:
                    idx_by_cid[cid] = i
                    unmatched.discard(cid)
                    if not unmatched:
                        break
        out: dict[str, set[int]] = {}
        for nid in completed:
            tname, _, cid = nid.partition("@")
            if cid in idx_by_cid:
                out.setdefault(tname, set()).add(idx_by_cid[cid])
        return out

    def run(
        self,
        slots: int = 1,
        resume: bool = False,
        runner: Callable[[TaskNode], Any] | None = None,
        gang: GangExecutor | None = None,
        max_retries: int = 1,
        pool: str | WorkerPool = "inline",
        speculate: bool = False,
        hosts: Sequence[str] | None = None,
        ppnode: int | None = None,
        nnodes: int | None = None,
        transport: Any = None,
        submitter: Any = None,
        window: int | str | None = None,
        on_result: Callable[[TaskResult], None] | None = None,
        keep_results: bool = True,
        aggregator: Any = None,
        straggler_quantile: float | None = None,
        retry: Any = None,
        chaos: Any = None,
        trace: Any = None,
    ) -> dict[str, TaskResult]:
        """Execute the study through the unified event engine.

        ``resume=True`` reloads the journal and skips completed nodes
        (checkpoint/restart; either journal version resumes under either
        path).  ``pool`` selects the execution backend: ``"inline"``
        (deterministic, serial), ``"thread"`` / ``"process"`` (real
        parallelism across ``slots`` workers), ``"lane"`` (persistent
        shell worker lanes — the short-task throughput path; tasks must
        render to shell commands), ``"ssh"`` / ``"slurm"`` / ``"pbs"``
        (remote dispatch of rendered commands — slot count comes from
        ``hosts × ppnode`` / ``nnodes × ppnode``, defaulting to the WDL
        ``hosts:``/``batch:``/``nnodes``/``ppnode`` keywords;
        ``transport`` / ``submitter`` inject the network seam, e.g. the
        no-network ``LocalTransport``/``LocalSubmitter`` fakes), or any
        ``WorkerPool`` instance.  ``gang`` switches to batched dispatch —
        stackable ready groups launched as single programs, the paper's
        single-cluster-job technique — implemented as a pool policy on
        the same engine, so retries, failure closure, and journaling
        apply there too.  ``speculate`` enables straggler duplication
        (idempotent runners only).

        ``window=N`` switches to streaming admission: instances are
        stamped out lazily from their space index, at most
        ``slots + N`` task nodes stay live, and the journal is compact
        v2 — startup and memory stay O(slots + window) however large the
        space (``window=None`` keeps the eager whole-DAG path).
        ``window="auto"`` sizes the admission window adaptively from the
        observed completion rate (about half a second of throughput,
        clamped to [slots, 4096]) so short-task sweeps stop hand-tuning
        ``--window``.  ``straggler_quantile`` (e.g. 0.9 for p90)
        replaces the default ``straggler_factor × median`` straggler
        cutoff with the running runtime quantile; the WDL
        ``straggler_quantile:`` keyword sets the same thing, with the
        argument winning when both appear.

        ``on_result`` streams each ``TaskResult`` to the caller as it
        resolves (after journal/provenance bookkeeping).
        ``keep_results=False`` additionally skips the O(N_W) result
        accumulation — the returned dict is empty and, combined with
        ``window=N``, a 10^5-combination run holds O(slots + window)
        engine state end to end.  Journal and provenance DB writes are
        group-committed for the duration of the run (see
        ``flush_count``/``flush_interval`` on the constructor) and are
        always flushed before this method returns or raises.

        When tasks declare ``capture:`` metrics, every attempt is
        extracted once: a missing *required* metric classifies the
        attempt as failed (retried, then failure-closed, like a nonzero
        exit), the final metrics ride ``TaskResult.metrics`` and the
        provenance record (``metrics=…``), and ``aggregator`` (a
        ``ResultsAggregator``) is fed each ``ok`` resolution's
        ``(combo, metrics)`` — with ``keep_results=False`` a streaming
        run aggregates in O(groups) memory with no result accumulation
        anywhere.

        ``retry`` sets the run's default retry policy (a
        ``scheduler.RetryPolicy`` or a WDL ``retry:``-shaped mapping:
        ``max``/``backoff``/``base``/``jitter``/``retry_on``) — failed
        attempts re-queue after a backoff delay instead of instantly,
        and per-task WDL ``retry:`` blocks override it.  ``chaos``
        arms deterministic fault injection for the run (a
        ``chaos.FaultPlan``, a plan mapping, a plan-YAML path, or a
        live ``ChaosController``); the run then completes *degraded*
        rather than dying when hosts are permanently lost, with the
        fault ledger and per-host causes attached to ``study.json``.

        ``trace`` arms the telemetry layer for the run (``True``, a
        ``telemetry.Telemetry``, or a path for the Chrome-trace JSON;
        ``False`` force-disarms, ``None`` defers to ``PAPAS_TRACE``):
        the scheduler, pools, and group-commit writers emit lifecycle
        spans and metrics, ``trace.json`` lands in the study directory
        (Perfetto/``chrome://tracing`` loadable), and the metrics
        snapshot is attached to ``study.json`` under ``telemetry``.
        """
        if isinstance(window, str) and window != "auto":
            raise ValueError(
                f"window must be a positive int, 'auto', or None; "
                f"got {window!r}")
        if straggler_quantile is None:
            straggler_quantile = self._spec_straggler_quantile()
        if window is not None:
            return self._run_windowed(
                window=window, slots=slots, resume=resume, runner=runner,
                gang=gang, max_retries=max_retries, pool=pool,
                speculate=speculate, hosts=hosts, ppnode=ppnode,
                nnodes=nnodes, transport=transport, submitter=submitter,
                on_result=on_result, keep_results=keep_results,
                aggregator=aggregator,
                straggler_quantile=straggler_quantile,
                retry=retry, chaos=chaos, trace=trace)
        ctrl = self._resolve_chaos(chaos)
        tel = self._resolve_trace(trace)
        instances = self.instances()
        completed: set[str] = set()
        if resume and self.journal.exists():
            state = self.journal.load_state()
            completed = set(state.completed)
            if state.version == 1 and state.instances:
                instances = state.instances
            elif state.version == 2 and state.completed_indices:
                space = self.space()
                if state.space_hash and state.space_hash != space.space_hash():
                    raise ValueError(
                        f"cannot resume: journal was written for space "
                        f"{state.space_hash} but this study declares "
                        f"{space.space_hash()}")
                completed |= self._ids_from_indices(
                    space, state.completed_indices)
        dag = self.build_dag(instances)
        self.db.write_meta({
            "name": self.name,
            "n_instances": len(instances),
            "n_tasks": len(self.spec.tasks),
            "n_nodes": len(dag.nodes),
            "started": time.time(),
        })
        run_fn = runner or self._default_runner
        host_map: dict[str, str] = {}
        if resume:
            host_map.update(self.journal.hosts())
        self.journal.save(instances, completed, {"name": self.name},
                          hosts=host_map)

        # arm chaos + telemetry for the backend's whole lifetime — lane
        # pools capture both at construction, transports consult chaos
        # per dispatch — restoring whatever was armed before
        _prev_chaos = chaos_mod.current()
        chaos_mod.install(ctrl)
        _prev_tel = telemetry_mod.current()
        telemetry_mod.install(tel)
        if tel is not None:
            tel.begin_run(total=max(0, len(dag.nodes) - len(completed)),
                          slots=slots)
        worker: WorkerPool | None = None
        owned = False
        try:
            worker, owned = self._make_worker(pool, gang, slots, hosts,
                                              ppnode, nnodes, transport,
                                              submitter)
            # lane-style pools report transient local labels as hosts:
            # they stay in the per-attempt records, never the journal
            # host map (which must stay O(remote tasks), not O(N_W))
            keep_hosts = getattr(worker, "durable_hosts", True)
            capture_classify, capture_finish = \
                self._capture_state(aggregator)

            def _on_result(res: TaskResult) -> None:
                node = dag.nodes[res.id]
                metrics = (capture_finish(node, res) if capture_finish
                           else None)
                self.db.record(res.id, res.status, res.runtime,
                               combo=node.combo, error=res.error,
                               attempts=res.attempts, slot=res.slot,
                               host=res.host, metrics=metrics)
                if res.status == "ok":
                    completed.add(res.id)
                    host = res.host if keep_hosts else None
                    if host:
                        host_map[res.id] = host
                    self.journal.mark_complete(res.id, host=host)
                if ctrl is not None:
                    ctrl.on_record()      # sigkill seam: crash-by-plan
                if on_result is not None:
                    on_result(res)

            # remote pools derive their capacity from hosts/nnodes ×
            # ppnode; the scheduler must drive every dispatch lane the
            # pool offers (for batch pools that is the allocation
            # count, not the group size — one dispatch already hosts a
            # whole group)
            slots = max(slots,
                        getattr(worker, "dispatch_slots", slots) or slots)
            if tel is not None:
                tel.slots = max(1, slots)   # post-lift: the ETA divisor
            sched = Scheduler(slots=slots, max_retries=max_retries,
                              speculate=speculate,
                              straggler_quantile=straggler_quantile,
                              retry_policy=retry)
            # high-rate parallel backends shard the completion streams
            # so group commits never serialize on one buffered handle;
            # the compaction below folds every segment back to the base
            shards = self._auto_shards(worker)
            self.journal.set_shards(shards)
            self.db.set_shards(shards)
            # durability order: a journal entry must never become
            # durable before the provenance record it refers to — a
            # crash may lose a completion (resume re-runs it) but never
            # strand a journaled completion without its record
            self.journal.set_pre_flush(self.db.flush)
            self._run_base_env = dict(os.environ)  # one snapshot per run
            with self.journal.group_commit(self.flush_count,
                                           self.flush_interval), \
                    self.db.group_commit(self.flush_count,
                                         self.flush_interval):
                results = sched.execute(dag, run_fn, completed=completed,
                                        on_result=_on_result, pool=worker,
                                        keep_results=keep_results,
                                        classify=capture_classify)
        finally:
            chaos_mod.install(_prev_chaos)
            telemetry_mod.install(_prev_tel)
            self.journal.set_pre_flush(None)
            if owned and worker is not None:
                worker.shutdown()
        # compact the journal: fold the append log back into the base
        self.journal.save(instances, completed, {"name": self.name},
                          hosts=host_map)
        if tel is not None:
            self._finalize_telemetry(tel)
        self.journal.set_shards(1)
        self.db.set_shards(1)
        self.last_run_stats = {
            "peak_live_nodes": sched.peak_live_nodes,
            "n_instances": len(instances),
        }
        self.last_run_stats.update(self._finalize_run_health(worker, ctrl))
        return results

    def _run_windowed(
        self,
        window: int | str,
        slots: int,
        resume: bool,
        runner: Callable[[TaskNode], Any] | None,
        gang: GangExecutor | None,
        max_retries: int,
        pool: str | WorkerPool,
        speculate: bool,
        hosts: Sequence[str] | None,
        ppnode: int | None,
        nnodes: int | None,
        transport: Any,
        submitter: Any,
        on_result: Callable[[TaskResult], None] | None = None,
        keep_results: bool = True,
        aggregator: Any = None,
        straggler_quantile: float | None = None,
        retry: Any = None,
        chaos: Any = None,
        trace: Any = None,
    ) -> dict[str, TaskResult]:
        """Streaming execution: windowed admission + journal v2."""
        ctrl = self._resolve_chaos(chaos)
        tel = self._resolve_trace(trace)
        space = self.space()
        shash = space.space_hash()
        n_instances = space.sample_count()
        if space.size():
            # every instance shares one task topology — validate it once
            # on a template sub-DAG instead of per admission
            template = TaskDAG()
            for node in self._instance_nodes(space.combo_at(0)):
                template.add(node)
            template.validate()

        completed_idx: dict[str, set[int]] = {}
        host_map: dict[str, str] = {}
        if resume and self.journal.exists():
            state = self.journal.load_state()
            if state.version == 2:
                if state.space_hash and state.space_hash != shash:
                    raise ValueError(
                        f"cannot resume: journal was written for space "
                        f"{state.space_hash} but this study declares "
                        f"{shash}")
                completed_idx = {t: set(ix) for t, ix
                                 in (state.completed_indices or {}).items()}
            else:
                completed_idx = self._indices_from_v1(
                    space, state.instances or [], state.completed)
            host_map.update(state.hosts)

        self.db.write_meta({
            "name": self.name,
            "n_instances": n_instances,
            "n_tasks": len(self.spec.tasks),
            "n_nodes": n_instances * len(self.spec.tasks),
            "space": shash,
            "window": window,
            "started": time.time(),
        })
        self.journal.save_indexed(shash, n_instances, completed_idx,
                                  {"name": self.name}, hosts=host_map)

        source = InstanceWindow(self, space=space, completed=completed_idx)
        dag = TaskDAG()
        run_fn = runner or self._default_runner

        # see the eager path: arm chaos + telemetry for the backend's
        # lifetime
        _prev_chaos = chaos_mod.current()
        chaos_mod.install(ctrl)
        _prev_tel = telemetry_mod.current()
        telemetry_mod.install(tel)
        if tel is not None:
            done_nodes = sum(len(v) for v in completed_idx.values())
            tel.begin_run(
                total=max(0, n_instances * len(self.spec.tasks)
                          - done_nodes),
                slots=slots)
        worker: WorkerPool | None = None
        owned = False
        try:
            worker, owned = self._make_worker(pool, gang, slots, hosts,
                                              ppnode, nnodes, transport,
                                              submitter)
            # see the eager path: transient lane labels never enter the
            # journal host map — streaming journals stay O(completed
            # ranges)
            keep_hosts = getattr(worker, "durable_hosts", True)
            capture_classify, capture_finish = \
                self._capture_state(aggregator)

            def _on_result(res: TaskResult) -> None:
                # fires before the scheduler retires the node, so the
                # lookup below sees the live TaskNode
                node = dag.nodes[res.id]
                idx = node.payload.get("index")
                metrics = (capture_finish(node, res) if capture_finish
                           else None)
                self.db.record(res.id, res.status, res.runtime,
                               combo=node.combo, error=res.error,
                               attempts=res.attempts, slot=res.slot,
                               host=res.host, index=idx, metrics=metrics)
                if res.status == "ok":
                    host = res.host if keep_hosts else None
                    if host:
                        host_map[res.id] = host
                    if idx is not None:
                        completed_idx.setdefault(node.task,
                                                 set()).add(idx)
                    self.journal.mark_complete(res.id, host=host,
                                               index=idx, task=node.task)
                if ctrl is not None:
                    ctrl.on_record()      # sigkill seam: crash-by-plan
                if on_result is not None:
                    on_result(res)

            slots = max(slots,
                        getattr(worker, "dispatch_slots", slots) or slots)
            if tel is not None:
                tel.slots = max(1, slots)   # post-lift: the ETA divisor
            # "auto": size the admission window from the observed
            # completion rate (~half a second of throughput), floored
            # at the slot count
            win: int | AdaptiveWindow = (AdaptiveWindow(slots=slots)
                                         if window == "auto" else window)
            sched = Scheduler(slots=slots, max_retries=max_retries,
                              speculate=speculate,
                              straggler_quantile=straggler_quantile,
                              retry_policy=retry)
            # see the eager path: shard the completion streams; couple
            # journal durability to the DB's (records first, always)
            shards = self._auto_shards(worker)
            self.journal.set_shards(shards)
            self.db.set_shards(shards)
            self.journal.set_pre_flush(self.db.flush)
            self._run_base_env = dict(os.environ)  # one snapshot per run
            with self.journal.group_commit(self.flush_count,
                                           self.flush_interval), \
                    self.db.group_commit(self.flush_count,
                                         self.flush_interval):
                results = sched.execute(dag, run_fn, on_result=_on_result,
                                        pool=worker, source=source,
                                        window=win,
                                        keep_results=keep_results,
                                        classify=capture_classify)
        finally:
            chaos_mod.install(_prev_chaos)
            telemetry_mod.install(_prev_tel)
            self.journal.set_pre_flush(None)
            if owned and worker is not None:
                worker.shutdown()
        # compact: fold the append log back into a fresh v2 base
        self.journal.save_indexed(shash, n_instances, completed_idx,
                                  {"name": self.name}, hosts=host_map)
        if tel is not None:
            self._finalize_telemetry(tel)
        self.journal.set_shards(1)
        self.db.set_shards(1)
        self.last_run_stats = {
            "peak_live_nodes": sched.peak_live_nodes,
            "n_instances": n_instances,
            "admitted_instances": source.admitted,
            "skipped_complete": source.skipped,
            "slots": slots,     # post-lift: the admission bound's slots
            "window": win.current if isinstance(win, AdaptiveWindow)
            else window,
        }
        self.last_run_stats.update(self._finalize_run_health(worker, ctrl))
        return results


class InstanceWindow:
    """Lazy instance source for streaming execution (``run(window=N)``).

    Iterates the space's sampled *indices* and stamps out one instance's
    self-contained task sub-DAG per ``next_subdag()`` call — nothing is
    enumerated ahead of the scheduler's admission window.  ``completed``
    (task name → completed space indices, e.g. from a v2 journal) makes
    resume free: an instance whose every task is complete is skipped
    without ever being admitted; a partially complete instance admits
    with its done node ids declared, so only the remainder runs.
    """

    def __init__(
        self,
        study: ParameterStudy,
        space: ParameterSpace | None = None,
        completed: Mapping[str, set[int]] | None = None,
    ) -> None:
        self.study = study
        self.space = space if space is not None else study.space()
        # snapshot: completions recorded *during* the run must not make
        # the source skip instances it still owes the scheduler
        self._completed = {t: frozenset(ix)
                           for t, ix in (completed or {}).items()}
        self._indices = self.space.iter_sample()
        self.admitted = 0           # instances handed to the scheduler
        self.skipped = 0            # instances already fully complete

    def next_subdag(self) -> tuple[list[TaskNode], set[str]] | None:
        """The next not-fully-complete instance's ``(nodes, done node
        ids)`` — or ``None`` when the sampled index stream is dry."""
        tasks = self.study.spec.tasks
        for i in self._indices:
            done = {t for t, ix in self._completed.items() if i in ix}
            if len(done) == len(tasks):
                self.skipped += 1
                continue
            nodes = self.study._instance_nodes(self.space.combo_at(i),
                                               index=i)
            self.admitted += 1
            return nodes, {n.id for n in nodes if n.task in done}
        return None


def load_study(
    *paths: str | Path,
    registry: TaskRegistry | None = None,
    root: str | Path = ".papas",
    name: str | None = None,
) -> ParameterStudy:
    """Parse one or more parameter files into a runnable study."""
    from .wdl import merge

    specs = [parse_file(p) for p in paths]
    spec = specs[0] if len(specs) == 1 else merge(*specs)
    return ParameterStudy(spec, registry=registry, root=root, name=name)
