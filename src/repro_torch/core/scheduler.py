"""The unified execution engine (paper §4.2/§4.3).

One slot-occupancy event loop drives every execution mode.  The loop
keeps a sorted ready queue over the task DAG, dispatches batches onto
numbered slots claimed from a ``WorkerPool`` backend, then blocks on the
pool's completion stream — handling retries, failure closure, per-task
timeouts, and speculative straggler duplicates as events arrive in *any*
order.  The three historical code paths are now configurations of this
single loop:

* **execute** — live runs on a pluggable backend (``InlinePool`` for
  determinism, ``ThreadWorkerPool``/``ProcessWorkerPool`` for real
  parallelism, ``GangPool`` for batched dispatch).  ``TaskResult.slot``
  is the real slot the task occupied; ``started``/``finished`` are true
  per-slot occupancy times measured by the backend.
* **simulate** — the same loop over a ``VirtualPool`` event source that
  advances an injected virtual clock instead of waiting, reproducing the
  paper's Fig. 1 regimes (*optimal*, *serial*, *common*, *grouped*) and
  the Fig. 3/4 grouping comparison with zero wall-clock cost.
* **gang** — ``ParameterStudy.run(gang=...)`` routes through the same
  loop with a ``GangPool``, so batched dispatch shares the retry,
  closure, and journal machinery.

Concurrency-relevant semantics:

* a node failing after ``max_retries`` re-dispatches marks its whole
  transitive successor closure ``skipped`` (fault isolation, §4.1);
* a per-node ``timeout`` (from the WDL ``timeout`` keyword, carried in
  ``node.payload``) bounds each attempt; a gang batch gets the *sum* of
  its members' timeouts as its wall-clock budget (one launch hosting N
  tasks earns N tasks' allowance).  Overdue dispatches are failed and
  their late completions discarded — the slot stays occupied until the
  zombie worker actually finishes, so queued work never times out
  behind it;
* with ``speculate=True``, a running task whose elapsed time exceeds
  ``straggler_factor ×`` the median completed runtime gets a duplicate
  dispatch; the first finisher wins (``TaskResult.speculative`` marks a
  duplicate win) and the loser is abandoned.

Streaming admission: ``execute(..., source=…, window=N)`` turns the
whole-DAG loop into a bounded frontier.  ``source.next_subdag()`` yields
one *self-contained* instance sub-DAG at a time (all deps internal to
the batch); the loop admits a sub-DAG only when it fits within the
``slots + window`` live-node budget, and retires each node's
``TaskNode`` the moment it resolves — so live graph state stays
O(slots + window) no matter how many combinations the study spans.
Retries, failure closure, timeouts, and speculation all apply unchanged;
the eager path (``source=None``) is byte-for-byte the old behavior.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
import random
import time
from typing import Any, Callable, Mapping

from . import telemetry
from .dag import DAGError, TaskDAG, TaskNode
from .executors import CompletionEvent, InlinePool, WorkerPool
from .stats import StreamingMedian as _StreamingMedian  # noqa: F401 (back-compat)
from .stats import StreamingQuantile


@dataclasses.dataclass
class TaskResult:
    id: str
    status: str                 # ok | failed | skipped
    runtime: float
    started: float
    finished: float
    attempts: int = 1
    value: Any = None
    error: str | None = None
    slot: int = -1              # real slot occupied (execute and simulate)
    speculative: bool = False   # won by a speculative duplicate dispatch
    host: str | None = None     # executing host / allocation (remote pools)
    metrics: dict[str, Any] | None = None   # captured metrics (results layer)


@dataclasses.dataclass
class ScheduleEvent:
    """One simulated execution record (for Fig. 1/3/4 reproductions)."""

    id: str
    slot: int
    start: float
    stop: float


#: failure kinds a retry policy can match (WDL ``retry_on:``)
RETRY_KINDS = ("nonzero", "timeout", "host", "error")


def classify_failure(error: str | None) -> str:
    """Map an attempt's error string onto a retry-policy failure kind:
    ``timeout`` (deadline or budget expiry), ``nonzero`` (exit status),
    ``host`` (infrastructure — unreachable host, dead lane, drained
    pool), ``error`` (anything else: runner exceptions, classification
    failures)."""
    e = error or ""
    if e.startswith("timeout"):
        return "timeout"
    if e.startswith("nonzero exit"):
        return "nonzero"
    if (e.startswith("host ") or e.startswith("no live hosts")
            or "lane worker" in e or "unreachable" in e):
        return "host"
    return "error"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How failed attempts re-enter the ready queue (WDL ``retry:``).

    ``max`` of None defers to the scheduler's ``max_retries``.  The
    delay before re-dispatching after failed attempt *k* is ``base``
    (``backoff: fixed``) or ``base * 2**(k-1)`` (``backoff:
    exponential``), capped at ``max_delay`` and spread by ±``jitter``
    (a fraction, derived deterministically from the node id so runs
    stay reproducible).  Only failures whose ``classify_failure`` kind
    is in ``retry_on`` are retried at all; the rest fail immediately
    with their successor closure.

    The default policy retries every kind with a 50 ms exponential
    backoff — the smallest delay that still breaks the instant-retry
    storm (a node failing deterministically in under a millisecond used
    to burn its whole retry budget inside one loop iteration)."""

    max: int | None = None
    backoff: str = "exponential"
    base: float = 0.05
    jitter: float = 0.0
    max_delay: float = 30.0
    retry_on: frozenset = frozenset(RETRY_KINDS)

    @classmethod
    def from_any(cls, spec: Any = None) -> "RetryPolicy":
        """Build from a WDL ``retry:`` mapping (or pass a policy
        through; None → the default policy)."""
        if spec is None:
            return cls()
        if isinstance(spec, RetryPolicy):
            return spec
        known = {f.name for f in dataclasses.fields(cls)}
        bad = sorted(set(spec) - known)
        if bad:
            raise ValueError(f"unknown retry key(s): {', '.join(bad)}")
        kw: dict[str, Any] = {}
        if spec.get("max") is not None:
            kw["max"] = int(spec["max"])
            if kw["max"] < 0:
                raise ValueError("retry max must be >= 0")
        if spec.get("backoff") is not None:
            b = str(spec["backoff"]).strip().lower()
            if b not in ("exponential", "fixed"):
                raise ValueError(
                    f"retry backoff must be 'exponential' or 'fixed', "
                    f"got {b!r}")
            kw["backoff"] = b
        for k in ("base", "jitter", "max_delay"):
            if spec.get(k) is not None:
                kw[k] = float(spec[k])
                if kw[k] < 0:
                    raise ValueError(f"retry {k} must be >= 0")
        if spec.get("retry_on") is not None:
            kinds = spec["retry_on"]
            if isinstance(kinds, str):
                kinds = [kinds]
            norm = frozenset(str(k).strip().lower() for k in kinds)
            bad_kinds = sorted(norm - set(RETRY_KINDS))
            if bad_kinds:
                raise ValueError(
                    f"unknown retry_on kind(s): {', '.join(bad_kinds)} "
                    f"(valid: {', '.join(RETRY_KINDS)})")
            kw["retry_on"] = norm
        return cls(**kw)

    def retries(self, default: int) -> int:
        return default if self.max is None else self.max

    def should_retry(self, error: str | None) -> bool:
        return classify_failure(error) in self.retry_on

    def delay(self, attempt: int, key: str = "") -> float:
        """Backoff before re-dispatching after failed attempt
        ``attempt`` (1-based)."""
        if self.backoff == "fixed":
            d = self.base
        else:
            d = self.base * (2.0 ** max(0, attempt - 1))
        d = min(d, self.max_delay)
        if self.jitter:
            u = random.Random(f"{key}#{attempt}").random()
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return max(0.0, d)

    def ceiling(self, default_retries: int = 1) -> float:
        """Worst-case single backoff the policy can impose — what lint
        W701 compares against the task timeout."""
        n = self.retries(default_retries)
        if n < 1:
            return 0.0
        if self.backoff == "fixed":
            d = self.base
        else:
            d = self.base * (2.0 ** max(0, n - 1))
        return min(d, self.max_delay) * (1.0 + self.jitter)


class VirtualClock:
    """Injectable event-time source for wall-clock-free simulation."""

    def __init__(self, start: float = 0.0) -> None:
        self.now = start

    def __call__(self) -> float:
        return self.now


class VirtualPool(WorkerPool):
    """Virtual-time backend: completions come from a duration table (or
    ``fn(node_id, n_prior_dispatches)``) ordered on a min-heap, and
    ``next_event`` advances the injected clock to each finish time.
    With ``call_runner=True`` the runner still executes (instantly in
    virtual time) so tests can exercise real failure paths under a
    deterministic fake clock."""

    kind = "virtual"

    def __init__(
        self,
        durations: Mapping[str, float] | Callable[[str, int], float],
        clock: VirtualClock,
        delay_fn: Callable[[], float] | None = None,
        call_runner: bool = False,
    ) -> None:
        self.durations = durations
        self.clock = clock
        self.delay_fn = delay_fn
        self.call_runner = call_runner
        self._heap: list[tuple[float, int, int, float, Any, str | None]] = []
        self._seq = 0
        self._dispatched: dict[str, int] = {}

    def _duration(self, nid: str) -> float:
        k = self._dispatched.get(nid, 0)
        self._dispatched[nid] = k + 1
        if callable(self.durations):
            return float(self.durations(nid, k))
        return float(self.durations[nid])

    def submit(self, token: int, runner: Any,
               nodes: list[TaskNode]) -> None:
        (node,) = nodes   # virtual dispatch is per-node
        start = self.clock.now + (self.delay_fn() if self.delay_fn else 0.0)
        stop = start + self._duration(node.id)
        value, error = None, None
        if self.call_runner and runner is not None:
            try:
                value = runner(node)
            except Exception as e:  # noqa: BLE001
                error = f"{type(e).__name__}: {e}"
        heapq.heappush(self._heap,
                       (stop, self._seq, token, start, value, error))
        self._seq += 1

    def next_event(self, timeout: float | None = None) -> CompletionEvent | None:
        if not self._heap:
            return None
        if timeout is not None and self._heap[0][0] > self.clock.now + timeout:
            self.clock.now += timeout   # sleep through a quiet interval
            return None
        stop, _, token, start, value, error = heapq.heappop(self._heap)
        if stop > self.clock.now:
            self.clock.now = stop
        return CompletionEvent(token, [value], [error], start, stop)


class AdaptiveWindow:
    """Completion-rate-driven streaming window (``run(window="auto")``).

    The window bounds live nodes at ``slots + current``.  Instead of a
    hand-tuned constant, the controller measures the resolution rate
    over short intervals and sizes the window to hold roughly
    ``horizon`` seconds of work: fast no-op sweeps grow toward
    ``max_window`` (admission never starves the pool), slow studies
    shrink toward ``slots`` (live state stays tiny).  Moves are smoothed
    50/50 toward the target so one noisy interval cannot thrash the
    admission bound."""

    def __init__(self, slots: int = 1, min_window: int | None = None,
                 max_window: int = 4096, horizon: float = 0.5) -> None:
        self.min = max(1, min_window if min_window is not None else slots)
        self.max = max(self.min, max_window)
        self.horizon = horizon
        #: current window size (live bound is ``slots + current``)
        self.current = self.min
        self._t0: float | None = None
        self._n0 = 0

    def observe(self, now: float, n_resolved: int) -> None:
        """Feed the controller the loop's clock + resolution counter."""
        if self._t0 is None:
            self._t0, self._n0 = now, n_resolved
            return
        dt = now - self._t0
        if dt < self.horizon / 4:
            return
        rate = (n_resolved - self._n0) / dt
        target = int(rate * self.horizon)
        self.current = max(self.min,
                           min(self.max, (self.current + target + 1) // 2))
        self._t0, self._n0 = now, n_resolved


@dataclasses.dataclass
class _Dispatch:
    """One in-flight batch occupying a slot."""

    token: int
    nids: list[str]
    slot: int
    dispatched: float           # engine clock at submit
    budget: float | None        # wall-clock allowance for the whole batch
    deadline: float | None      # dispatched + budget
    speculative: bool


class Scheduler:
    """Slot-occupancy event loop over a TaskDAG."""

    def __init__(
        self,
        slots: int = 1,
        max_retries: int = 1,
        straggler_factor: float = 3.0,
        clock: Callable[[], float] = time.monotonic,
        order: str = "breadth",
        speculate: bool = False,
        straggler_quantile: float | None = None,
        retry_policy: Any = None,
    ) -> None:
        """``order``: "breadth" finishes each task level across all
        workflow instances first; "depth" completes one instance's whole
        task chain before starting the next (paper §9 future work).
        ``speculate``: launch a duplicate of any running task slower than
        the straggler cutoff (≥ 5 samples) when a slot is idle; only
        enable for idempotent runners.  The cutoff is
        ``straggler_factor ×`` the median runtime, or — when
        ``straggler_quantile`` is set (e.g. 0.9 for p90, the WDL
        ``straggler_quantile:`` keyword) — the running q-quantile of
        completed runtimes directly, no factor applied.
        ``retry_policy``: a ``RetryPolicy`` (or WDL ``retry:``-shaped
        mapping) governing when and after what backoff failed attempts
        re-dispatch; a per-node ``retry`` payload entry overrides it."""
        if slots < 1:
            raise ValueError("slots must be >= 1")
        if order not in ("breadth", "depth"):
            raise ValueError(f"unknown order {order!r}")
        if straggler_quantile is not None \
                and not 0.0 < straggler_quantile < 1.0:
            raise ValueError(
                f"straggler_quantile must be in (0, 1), "
                f"got {straggler_quantile!r}")
        self.slots = slots
        self.max_retries = max_retries
        self.straggler_factor = straggler_factor
        self.straggler_quantile = straggler_quantile
        self.clock = clock
        self.order = order
        self.speculate = speculate
        self.retry_policy = RetryPolicy.from_any(retry_policy)
        self._retry_cache: dict[str, RetryPolicy] = {}
        #: observability seam, captured once (None when disarmed — the
        #: loop then pays one identity check per event and nothing else)
        self._telemetry = telemetry.current()
        #: live-node high-water mark of the last run (streaming admission
        #: bounds it near ``slots + window``; eager runs see the full DAG)
        self.peak_live_nodes = 0

    # ------------------------------------------------------------------
    def _order_key(self, nid: str) -> tuple[str, ...]:
        if self.order == "depth":
            # instance-major: ids are "<task>@<combo>" — sort by combo
            # first so one workflow finishes before the next
            return (nid.split("@")[-1], nid)
        return (nid,)

    def _sort_ready(self, ready: list[str]) -> None:
        ready.sort(key=self._order_key)

    @staticmethod
    def _payload(node: TaskNode) -> Mapping[str, Any]:
        return node.payload if isinstance(node.payload, Mapping) else {}

    @classmethod
    def _classify(cls, node: TaskNode, value: Any) -> str | None:
        """Post-completion failure classification: a ShellResult-like
        value with a nonzero returncode fails the attempt unless the task
        sets ``allow_nonzero``."""
        rc = getattr(value, "returncode", None)
        if isinstance(rc, int) and rc != 0:
            if not cls._payload(node).get("allow_nonzero"):
                stderr = (getattr(value, "stderr", "") or "")[-2000:]
                return f"nonzero exit {rc}: {stderr}"
        return None

    def _node_retry_policy(self, node: TaskNode) -> RetryPolicy:
        """The effective retry policy for a node: its WDL ``retry:``
        payload entry if present (parsed once per task section),
        otherwise the scheduler-wide policy."""
        spec = self._payload(node).get("retry")
        if not spec:
            return self.retry_policy
        if isinstance(spec, RetryPolicy):
            return spec
        pol = self._retry_cache.get(node.task)
        if pol is None:
            pol = self._retry_cache[node.task] = RetryPolicy.from_any(spec)
        return pol

    def _wait_until(self, t: float) -> None:
        """Advance to time ``t`` when nothing is in flight: virtual
        clocks jump (``.now`` duck-typing, the ``VirtualClock``
        contract), wall clocks nap in bounded slices so the loop stays
        responsive to completions and interrupts."""
        clk = self.clock
        now_attr = getattr(clk, "now", None)
        if now_attr is not None:
            clk.now = max(now_attr, t)
        else:
            time.sleep(max(0.0, min(t - clk(), 0.05)))

    # ------------------------------------------------------------------
    def execute(
        self,
        dag: TaskDAG,
        runner: Callable[[TaskNode], Any] | None,
        completed: set[str] | None = None,
        on_result: Callable[[TaskResult], None] | None = None,
        pool: WorkerPool | None = None,
        source: Any = None,
        window: int | AdaptiveWindow | None = None,
        keep_results: bool = True,
        classify: Callable[[TaskNode, Any], str | None] | None = None,
    ) -> dict[str, TaskResult]:
        """Run every node once its deps are satisfied.

        ``completed`` marks nodes already finished (checkpoint restart):
        they are skipped and treated as satisfied dependencies.  Failed
        attempts are retried up to ``max_retries`` times; nodes failing
        for good have their transitive successors marked ``skipped``
        rather than aborting the study (fault isolation, paper §4.1).
        ``pool`` selects the backend (default: a fresh ``InlinePool``);
        ``on_result`` fires on the event-loop thread as nodes resolve.

        ``source`` + ``window`` enable streaming admission: ``source``
        must expose ``next_subdag() -> (nodes, done_ids) | None``
        yielding one self-contained instance sub-DAG per call (every dep
        internal to the batch or listed in ``done_ids``), and the loop
        keeps at most ``slots + window`` unresolved nodes live — a
        fetched sub-DAG that would overflow the budget waits until
        resolved nodes retire.  (Sole exception: when one sub-DAG is
        bigger than the whole budget it is still admitted, whole, once
        nothing else is live — progress beats the bound.)  ``on_result``
        fires before its node is retired, so callbacks may still read
        ``dag.nodes[res.id]``.  ``self.peak_live_nodes`` records the
        high-water mark after a run.

        ``keep_results=False`` turns the run into a pure result stream:
        ``on_result`` still fires per resolution, but ``TaskResult``\\ s
        are not accumulated and the returned dict is empty — combined
        with streaming admission, engine memory stays O(slots + window)
        end to end instead of O(N_W).

        ``classify`` is an extra post-completion classifier applied
        after the built-in nonzero-exit check: given ``(node, value)``
        it returns an error string to fail the attempt (retries and
        failure closure apply, exactly like a nonzero exit) or ``None``
        to accept it — the seam the results layer uses to fail attempts
        whose *required* captured metrics are missing.  A raising
        classifier fails the attempt rather than the study.
        """
        if (source is None) != (window is None):
            raise ValueError("source and window must be passed together")
        if window is not None and not isinstance(window, AdaptiveWindow) \
                and window < 1:
            raise ValueError("window must be >= 1")
        dag.validate()
        completed = set(completed or ())
        own_pool = pool is None
        if pool is None:
            pool = InlinePool()
        try:
            return self._event_loop(dag, runner, completed, on_result, pool,
                                    source, window, keep_results, classify)
        finally:
            if own_pool:
                pool.shutdown()

    # ------------------------------------------------------------------
    def _event_loop(
        self,
        dag: TaskDAG,
        runner: Callable[[TaskNode], Any] | None,
        completed: set[str],
        on_result: Callable[[TaskResult], None] | None,
        pool: WorkerPool,
        source: Any = None,
        window: int | AdaptiveWindow | None = None,
        keep_results: bool = True,
        classify: Callable[[TaskNode, Any], str | None] | None = None,
    ) -> dict[str, TaskResult]:
        streaming = source is not None
        win_ctrl = window if isinstance(window, AdaptiveWindow) else None
        tel = self._telemetry
        if tel is not None:
            # resolve series handles once: armed steady-state cost is a
            # lock + add per event, never a registry lookup
            mtr = tel.metrics
            m_admitted = mtr.counter("papas_nodes_admitted_total")
            m_dispatched = mtr.counter("papas_tasks_dispatched_total")
            m_completed = mtr.counter("papas_tasks_completed_total")
            m_failed = mtr.counter("papas_tasks_failed_total")
            m_skipped = mtr.counter("papas_tasks_skipped_total")
            m_abandoned = mtr.counter("papas_dispatches_abandoned_total")
            m_expired = mtr.counter("papas_dispatches_expired_total")
            g_running = mtr.gauge("papas_tasks_running")
            g_retrying = mtr.gauge("papas_tasks_retrying")
            g_ready = mtr.gauge("papas_ready_depth")
            g_slots = mtr.gauge("papas_slots_busy")
            h_runtime = mtr.histogram("papas_task_runtime_seconds")
        succ = dag.successors()
        indeg = {nid: sum(1 for d in n.deps if d not in completed)
                 for nid, n in dag.nodes.items()}
        results: dict[str, TaskResult] = {}
        resolved_ids: set[str] = set()      # live membership (see _retire)
        n_resolved = 0
        for nid in sorted(dag.nodes):
            if nid in completed:
                resolved_ids.add(nid)
                n_resolved += 1
                if keep_results:
                    results[nid] = TaskResult(
                        id=nid, status="ok", runtime=0.0, started=0.0,
                        finished=0.0, attempts=0, value=None)

        ready = [nid for nid in dag.nodes
                 if nid not in completed and indeg[nid] == 0]
        self._sort_ready(ready)

        #: every admitted node eventually resolves exactly once
        expected = len(dag.nodes)
        exhausted = not streaming
        self.peak_live_nodes = len(dag.nodes)

        failed_closure: set[str] = set()
        attempts: dict[str, int] = {}
        first_started: dict[str, float] = {}
        runtimes = StreamingQuantile(self.straggler_quantile
                                     if self.straggler_quantile is not None
                                     else 0.5)
        free: list[int] = list(range(self.slots))
        heapq.heapify(free)
        running: dict[int, _Dispatch] = {}
        live_tokens: dict[str, set[int]] = {}   # node id → in-flight tokens
        abandoned: dict[int, int] = {}          # zombie token → held slot
        tokens = itertools.count()
        # incremental deadline/straggler tracking: min-heaps with lazy
        # invalidation (an entry whose token left ``running`` is stale),
        # replacing per-event O(running) scans
        deadline_heap: list[tuple[float, int]] = []   # (deadline, token)
        strag_heap: list[tuple[float, int]] = []      # (dispatched, token)
        retry_heap: list[tuple[float, str]] = []      # (due, node id)

        def _mark_failed_closure(root: str) -> None:
            stack = [root]
            while stack:
                cur = stack.pop()
                for s in succ[cur]:
                    if s not in failed_closure:
                        failed_closure.add(s)
                        stack.append(s)

        def _retire(nid: str) -> None:
            # streaming only: a resolved node's TaskNode leaves the live
            # graph so admission can refill the freed window capacity
            if not streaming:
                return
            dag.nodes.pop(nid, None)
            succ.pop(nid, None)
            indeg.pop(nid, None)
            if not keep_results:
                # a retired node can never resolve again (late events die
                # in the ``abandoned`` branch), so its membership record
                # is droppable too — state stays O(slots + window)
                resolved_ids.discard(nid)

        def _resolve(res: TaskResult) -> None:
            nonlocal n_resolved
            resolved_ids.add(res.id)
            n_resolved += 1
            if keep_results:
                results[res.id] = res
            if res.status == "ok":
                runtimes.add(res.runtime)
            if tel is not None:
                if res.status == "ok":
                    m_completed.inc()
                    h_runtime.observe(res.runtime)
                elif res.status == "failed":
                    m_failed.inc()
                else:
                    m_skipped.inc()
            if on_result:
                on_result(res)      # node still live: dag.nodes[res.id] ok
            for s in succ[res.id]:
                indeg[s] -= 1
                if indeg[s] == 0 and s not in resolved_ids:
                    bisect.insort(ready, s, key=self._order_key)
            _retire(res.id)

        pending: list[Any] = []     # fetched sub-DAG awaiting window room

        def _admit(force: bool = False) -> bool:
            """Pull instance sub-DAGs from the source while they fit in
            the ``slots + window`` live-node budget; a fetched sub-DAG
            that does not fit waits in ``pending`` so the bound stays
            strict.  ``force`` admits one batch regardless (progress
            guarantee when the whole budget is smaller than one
            instance).  Returns True when anything was admitted."""
            nonlocal expected, exhausted, n_resolved
            admitted_any = False
            while not (exhausted and not pending):
                if not pending:
                    item = source.next_subdag()
                    if item is None:
                        exhausted = True
                        break
                    pending.append(item)
                nodes, done_ids = pending[0]
                live_after = len(dag.nodes) + sum(
                    1 for n in nodes if n.id not in done_ids)
                wsize = win_ctrl.current if win_ctrl is not None else window
                if live_after > self.slots + wsize and not (
                        force and not admitted_any):
                    break
                pending.pop(0)
                for node in nodes:
                    dag.add(node)
                    succ[node.id] = []
                for node in nodes:
                    for d in node.deps:
                        if d not in succ:
                            raise DAGError(
                                f"streamed node {node.id!r}: dependency "
                                f"{d!r} is outside its instance sub-DAG")
                        succ[d].append(node.id)
                    indeg[node.id] = sum(
                        1 for d in node.deps
                        if d not in done_ids and d not in completed)
                expected += len(nodes)
                admitted_any = True
                if tel is not None:
                    m_admitted.inc(len(nodes))
                for node in nodes:
                    if node.id in done_ids:
                        # already complete (resume): resolved silently,
                        # exactly like eager pre-completed nodes
                        resolved_ids.add(node.id)
                        n_resolved += 1
                        if keep_results:
                            results[node.id] = TaskResult(
                                id=node.id, status="ok", runtime=0.0,
                                started=0.0, finished=0.0, attempts=0)
                        _retire(node.id)
                    elif indeg[node.id] == 0:
                        bisect.insort(ready, node.id, key=self._order_key)
                self.peak_live_nodes = max(self.peak_live_nodes,
                                           len(dag.nodes))
            return admitted_any

        def _abandon(token: int) -> None:
            # The worker may still be busy: the slot stays occupied until
            # the abandoned dispatch's completion event actually arrives,
            # so later work never queues behind a zombie and times out.
            # ``pool.cancel`` lets remote backends kill the dispatch so
            # the *host* resource is released too, not just the slot.
            d = running.pop(token, None)
            if d is None:
                return
            abandoned[token] = d.slot
            if tel is not None:
                m_abandoned.inc()
                g_running.add(-len(d.nids))
                tel.trace.end(f"slot{d.slot}", self.clock(), cat="dispatch",
                              args={"outcome": "abandoned"})
            for nid in d.nids:
                live_tokens.get(nid, set()).discard(token)
            pool.cancel(token)

        def _skip(nid: str) -> None:
            now = self.clock()
            _resolve(TaskResult(
                id=nid, status="skipped", runtime=0.0, started=now,
                finished=now, error="dependency failed"))

        def _dispatch(nids: list[str], speculative: bool) -> None:
            nodes = [dag.nodes[n] for n in nids]
            token = next(tokens)
            slot = heapq.heappop(free)
            now = self.clock()
            # the batch budget is the sum of member timeouts: a gang
            # launch hosting N tasks gets N tasks' worth of wall clock.
            # A member without a timeout leaves the batch unbounded.
            tmos = [self._payload(n).get("timeout") for n in nodes]
            budget = (sum(float(t) for t in tmos)
                      if tmos and all(t for t in tmos) else None)
            deadline = now + budget if budget else None
            if not speculative:
                for nid in nids:
                    attempts[nid] = attempts.get(nid, 0) + 1
            for nid in nids:
                live_tokens.setdefault(nid, set()).add(token)
            running[token] = _Dispatch(token, nids, slot, now, budget,
                                       deadline, speculative)
            if tel is not None:
                m_dispatched.inc(len(nids))
                g_running.add(len(nids))
                g_slots.set(self.slots - len(free))
                g_ready.set(len(ready))
                label = (nids[0] if len(nids) == 1
                         else f"{nodes[0].task} x{len(nids)}")
                tel.trace.begin(
                    f"slot{slot}", label, now, cat="dispatch",
                    args={"tasks": len(nids), "speculative": speculative,
                          "attempt": attempts.get(nids[0], 0)})
            if deadline is not None:
                heapq.heappush(deadline_heap, (deadline, token))
                # lazy-invalidated entries can pile up below a long-lived
                # top; compact when mostly stale so streaming runs keep
                # their O(slots + window) state bound
                if len(deadline_heap) > 2 * len(running) + 16:
                    deadline_heap[:] = [e for e in deadline_heap
                                        if e[1] in running]
                    heapq.heapify(deadline_heap)
            if self.speculate and not speculative and len(nids) == 1:
                heapq.heappush(strag_heap, (now, token))
                if len(strag_heap) > 2 * len(running) + 16:
                    strag_heap[:] = [e for e in strag_heap
                                     if e[1] in running]
                    heapq.heapify(strag_heap)
            pool.submit(token, runner, nodes)

        def _handle_outcome(d: _Dispatch, nid: str, value: Any,
                            error: str | None, started: float,
                            finished: float, host: str | None = None) -> None:
            live_tokens.get(nid, set()).discard(d.token)
            if nid in resolved_ids:     # duplicate copy lost the race
                return
            node = dag.nodes[nid]
            if (error is None and d.budget
                    and (finished - started) > d.budget):
                error = (f"timeout: attempt ran {finished - started:.3f}s, "
                         f"budget {d.budget}s")
            if error is None:
                error = self._classify(node, value)
            if error is None and classify is not None:
                # user-level classifier (e.g. required-capture checks):
                # a crash in it fails the attempt, not the study
                try:
                    error = classify(node, value)
                except Exception as e:  # noqa: BLE001 — fault isolation
                    error = f"classification error: {type(e).__name__}: {e}"
            if error is not None and d.speculative:
                # failed duplicate: the primary still runs — make it a
                # straggler candidate again (its heap entry was consumed
                # when this duplicate launched)
                for t in live_tokens.get(nid, ()):
                    pd = running.get(t)
                    if pd is not None and not pd.speculative \
                            and len(pd.nids) == 1:
                        heapq.heappush(strag_heap, (pd.dispatched, t))
                return
            fs = first_started.setdefault(nid, started)
            if error is not None:
                policy = self._node_retry_policy(node)
                n_attempt = attempts.get(nid, 0)
                if (n_attempt <= policy.retries(self.max_retries)
                        and policy.should_retry(error)):
                    # backoff instead of instant re-insort: a
                    # deterministic sub-millisecond failure must not
                    # burn its whole retry budget in one loop iteration
                    delay = policy.delay(n_attempt, key=nid)
                    if tel is not None:
                        tel.metrics.counter(
                            "papas_retries_total",
                            kind=classify_failure(error)).inc()
                    if delay > 0.0:
                        now_r = self.clock()
                        heapq.heappush(retry_heap, (now_r + delay, nid))
                        if tel is not None:
                            g_retrying.add(1)
                            tel.trace.async_begin(
                                "retry-wait", nid, f"{nid}#{n_attempt}",
                                now_r, args={"delay": delay,
                                             "attempt": n_attempt})
                    else:
                        bisect.insort(ready, nid, key=self._order_key)
                    return
            for t in list(live_tokens.get(nid, ())):
                _abandon(t)         # first finisher wins; drop other copies
            if error is not None:
                _mark_failed_closure(nid)
                _resolve(TaskResult(
                    id=nid, status="failed", runtime=finished - fs,
                    started=fs, finished=finished,
                    attempts=attempts.get(nid, 1), error=error, slot=d.slot,
                    host=host))
            else:
                _resolve(TaskResult(
                    id=nid, status="ok", runtime=finished - fs, started=fs,
                    finished=finished, attempts=attempts.get(nid, 1),
                    value=value, slot=d.slot, speculative=d.speculative,
                    host=host))

        def _expire(d: _Dispatch, now: float) -> None:
            if tel is not None:
                m_expired.inc()
            _abandon(d.token)
            limit = (d.deadline or now) - d.dispatched
            for nid in d.nids:
                _handle_outcome(d, nid, None,
                                f"timeout: no completion within {limit:.3f}s",
                                d.dispatched, now)

        def _strag_elapsed() -> float | None:
            """Elapsed-time cutoff past which a running task counts as a
            straggler: ``straggler_factor × median``, or the tracked
            runtime quantile directly in ``straggler_quantile`` mode."""
            if len(runtimes) < 5:
                return None
            v = runtimes.quantile()
            if v <= 0:
                return None
            if self.straggler_quantile is not None:
                return v
            return self.straggler_factor * v

        while True:
            if win_ctrl is not None:
                win_ctrl.observe(self.clock(), n_resolved)
            _admit()
            if retry_heap:
                # re-queue nodes whose backoff has elapsed
                now = self.clock()
                while retry_heap and retry_heap[0][0] <= now:
                    _, rnid = heapq.heappop(retry_heap)
                    if tel is not None:
                        g_retrying.add(-1)
                        tel.trace.async_end(
                            "retry-wait", rnid,
                            f"{rnid}#{attempts.get(rnid, 0)}", now)
                    if rnid not in resolved_ids:
                        bisect.insort(ready, rnid, key=self._order_key)
            if exhausted and not pending and n_resolved >= expected:
                break
            # resolve failure-closure nodes without occupying slots.
            # Skipped entirely on clean runs: the O(ready) rescan per
            # event was the single largest engine cost at 10^4 tasks.
            if failed_closure:
                while True:
                    doomed = [nid for nid in ready if nid in failed_closure]
                    ready[:] = [nid for nid in ready
                                if nid not in failed_closure
                                and nid not in resolved_ids]
                    if not doomed:
                        break
                    for nid in doomed:
                        if nid not in resolved_ids:
                            _skip(nid)

            while free and ready:
                batch = pool.take(ready, dag)
                if not batch:
                    break
                # a retried node can resolve via a speculative duplicate
                # while its retry entry still sits in ``ready`` — filter
                # at take time instead of rescanning the whole queue
                batch = [nid for nid in batch if nid not in resolved_ids]
                if not batch:
                    continue
                _dispatch(batch, speculative=False)

            # speculative straggler duplicates on leftover slots: pop the
            # earliest-dispatched candidates past the cutoff (entries are
            # lazily invalidated; a consumed-but-still-running primary is
            # re-pushed if its duplicate fails)
            limit = _strag_elapsed() if self.speculate else None
            if limit is not None and free and strag_heap:
                now = self.clock()
                cutoff = now - limit
                while free and strag_heap and strag_heap[0][0] <= cutoff:
                    _, tok = heapq.heappop(strag_heap)
                    d = running.get(tok)
                    if d is None or d.speculative or len(d.nids) != 1:
                        continue    # stale entry
                    nid = d.nids[0]
                    if nid in resolved_ids \
                            or len(live_tokens.get(nid, ())) > 1:
                        continue    # resolved or already duplicated
                    _dispatch([nid], speculative=True)

            if not running and not abandoned:
                if ready:
                    continue
                if retry_heap:
                    # every live node is backing off: advance to the
                    # earliest retry instead of declaring deadlock
                    self._wait_until(retry_heap[0][0])
                    continue
                if _admit(force=True):
                    continue        # window was full of doomed/blocked work
                # nothing running, ready, or admittable → remaining deps
                # unsatisfiable
                for nid in sorted(set(dag.nodes) - resolved_ids):
                    if nid not in resolved_ids:
                        _skip(nid)
                break

            # expire overdue dispatches before (and instead of) waiting —
            # earliest-deadline-first off the heap, not an O(running) scan
            now = self.clock()
            expired_any = False
            while deadline_heap and deadline_heap[0][0] <= now:
                _, tok = heapq.heappop(deadline_heap)
                d = running.get(tok)
                if d is not None:
                    _expire(d, now)
                    expired_any = True
            if expired_any:
                continue

            wait: float | None = None
            horizons = []
            while deadline_heap and deadline_heap[0][1] not in running:
                heapq.heappop(deadline_heap)    # stale: dispatch finished
            if deadline_heap:
                horizons.append(deadline_heap[0][0])
            if retry_heap:
                horizons.append(retry_heap[0][0])
            if limit is not None:
                # earliest still-eligible straggler candidate bounds the
                # next speculation horizon
                while strag_heap:
                    t0s, tok = strag_heap[0]
                    d = running.get(tok)
                    if (d is None or d.speculative or len(d.nids) != 1
                            or len(live_tokens.get(d.nids[0], ())) != 1):
                        heapq.heappop(strag_heap)
                        continue
                    horizons.append(t0s + limit)
                    break
            future = [h for h in horizons if h > now]
            if future:
                wait = max(1e-4, min(future) - now)

            ev = pool.next_event(wait)
            if ev is None:
                continue            # re-check deadlines / stragglers
            if ev.token in abandoned:
                # late completion of a loser/expired copy: the worker is
                # finally idle, so its slot returns to service only now
                heapq.heappush(free, abandoned.pop(ev.token))
                continue
            d = running.pop(ev.token)
            heapq.heappush(free, d.slot)
            if tel is not None:
                g_running.add(-len(d.nids))
                g_slots.set(self.slots - len(free))
                tel.trace.end(f"slot{d.slot}", self.clock(), cat="dispatch",
                              args={"host": ev.host or ""})
            for nid, value, error in zip(d.nids, ev.values, ev.errors):
                _handle_outcome(d, nid, value, error, ev.started, ev.finished,
                                host=ev.host)

        if tel is not None:
            # close any slices a breakout left open (deadlock skip with
            # dispatches still in flight) so every B has its E
            now = self.clock()
            for d in running.values():
                tel.trace.end(f"slot{d.slot}", now, cat="dispatch",
                              args={"outcome": "unresolved"})
            for _, rnid in retry_heap:
                # stale backoff entries (node resolved by a duplicate)
                tel.trace.async_end("retry-wait", rnid,
                                    f"{rnid}#{attempts.get(rnid, 0)}", now)
            g_running.set(0)
            g_slots.set(0)
            g_ready.set(0)
        return results

    # ------------------------------------------------------------------
    def simulate(
        self,
        dag: TaskDAG,
        durations: Mapping[str, float],
        policy: str = "optimal",
        seed: int = 0,
        queue_delay: float = 0.0,
    ) -> list[ScheduleEvent]:
        """Virtual-clock run of the paper's Fig. 1 regimes on the same
        event loop as ``execute`` (a ``VirtualPool`` replaces the live
        backend, so policy orderings carry over to real runs).

        * ``optimal`` — as many slots as jobs; all start at t=0.
        * ``serial``  — one slot, back-to-back.
        * ``common``  — ``self.slots`` slots, random per-dispatch delays
          (models multi-tenant scheduler jitter + queueing).
        * ``grouped`` — ``self.slots`` slots, no dispatch delay (PaPaS
          batched dispatch: one cluster job hosts all tasks).
        """
        dag.validate()
        nslots = {
            "optimal": max(1, len(dag.nodes)),
            "serial": 1,
            "common": self.slots,
            "grouped": self.slots,
        }.get(policy)
        if nslots is None:
            raise ValueError(f"unknown policy {policy!r}")
        rng = random.Random(seed)
        delay_fn = None
        if policy == "common":
            # scheduler interaction cost per dispatch + jitter
            delay_fn = lambda: queue_delay + rng.expovariate(1.0) * queue_delay  # noqa: E731
        clock = VirtualClock()
        pool = VirtualPool(durations, clock, delay_fn=delay_fn)
        engine = Scheduler(slots=nslots, max_retries=0, clock=clock,
                           order="breadth")
        results = engine.execute(dag, runner=None, pool=pool)
        events = [ScheduleEvent(id=r.id, slot=r.slot, start=r.started,
                                stop=r.finished)
                  for r in results.values()]
        events.sort(key=lambda e: (e.start, e.id))
        return events


def makespan(events: list[ScheduleEvent]) -> float:
    return max((e.stop for e in events), default=0.0)


def dispatch_count(events: list[ScheduleEvent]) -> int:
    """Scheduler interactions = one start/stop pair per event."""
    return len(events)
