"""Worker pools — the execution backends behind the unified engine.

The scheduler (``repro_torch.core.scheduler``) is a single slot-occupancy event
loop; everything backend-specific lives here behind the ``WorkerPool``
interface.  A pool decides *which* ready nodes to claim (``take``), runs
them (``submit``), and reports completions (``next_event``) — the paper's
"cluster engine" (§4.3) reduced to three methods.  Backends:

* ``InlinePool``   — runs each task synchronously at dispatch time.
  Fully deterministic; the default for tests and small studies.
* ``ThreadWorkerPool``  — ``concurrent.futures`` thread pool; real wall-
  clock parallelism for I/O- and subprocess-bound tasks.
* ``ProcessWorkerPool`` — process pool for CPU-bound Python tasks
  (runner and nodes must be picklable).
* ``GangPool``     — batched dispatch: claims a whole stackability group
  from the ready queue and launches it as ONE program (the paper's
  single-cluster-job technique, §4.3).  Wraps a ``GangExecutor``.
* ``LaneWorkerPool`` — the short-task throughput path: one long-lived
  ``sh`` worker per slot, fed rendered commands over a pipe protocol.
  Process spawn is amortized across thousands of tasks (a shell builtin
  like ``true`` never forks at all), ``take`` claims gang-style chunks
  so one pipe write carries a whole batch, and per-task environment
  overlays ride the command line — no per-task ``os.environ`` copy.
  Its ``run_gang`` method is a drop-in ``GangRunner``, so a
  ``GangExecutor``/``GangPool`` can fuse its batches onto the lanes.

``run_subprocess`` runs black-box shell tasks and always returns a
``ShellResult`` — a nonzero exit is *data*, classified by the scheduler's
retry/failure-closure logic (respecting the task's ``allow_nonzero``
keyword), not an exception.  ``merged_env`` accepts a pre-snapshotted
base environment so a pool or run copies ``os.environ`` once, not once
per task.
"""
from __future__ import annotations

import dataclasses
import itertools
import locale
import os
import queue
import re
import select
import selectors
import shlex
import shutil
import signal
import subprocess
import tempfile
import threading
import time
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Hashable, Mapping, Sequence, TYPE_CHECKING

from . import chaos
from . import telemetry
from .dag import TaskNode
from .locklint import make_lock

if TYPE_CHECKING:  # pragma: no cover
    from .dag import TaskDAG


@dataclasses.dataclass
class ShellResult:
    returncode: int
    stdout: str
    stderr: str
    runtime: float

    @property
    def ok(self) -> bool:
        return self.returncode == 0


def merged_env(env: Mapping[str, str] | None,
               base: Mapping[str, str] | None = None) -> dict[str, str]:
    """The task environment: the ambient process env overlaid with the
    instance's rendered variables (paper §5 ``environ``).

    ``base`` is an optional pre-snapshotted ambient environment — pools
    and runs capture ``dict(os.environ)`` once and pass it here, so the
    per-task cost is one small dict copy instead of a full environ walk.
    """
    full_env = dict(base) if base is not None else dict(os.environ)
    if env:
        full_env.update({k: str(v) for k, v in env.items()})
    return full_env


#: whether the vfork-based fast spawn path is available on this platform
_HAS_POSIX_SPAWN = hasattr(os, "posix_spawnp") and hasattr(os, "pipe")


def _decode_text(data: bytes) -> str:
    """Match ``subprocess.run(text=True)``: locale decode + universal
    newline translation."""
    text = data.decode(locale.getpreferredencoding(False))
    return text.replace("\r\n", "\n").replace("\r", "\n")


def _posix_spawn_capture(argv: list[str], env: dict[str, str],
                         timeout: float | None) -> ShellResult:
    """The spawn-elimination fast path: ``os.posix_spawnp`` (vfork-based
    on glibc — no page-table copy of the Python interpreter) with two
    capture pipes drained by a ``select`` loop.  Raises
    ``FileNotFoundError`` for a missing binary and
    ``subprocess.TimeoutExpired`` on expiry, matching
    ``subprocess.run``."""
    r_out, w_out = os.pipe()
    r_err, w_err = os.pipe()
    t0 = time.monotonic()
    try:
        pid = os.posix_spawnp(argv[0], argv, env, file_actions=[
            (os.POSIX_SPAWN_DUP2, w_out, 1),
            (os.POSIX_SPAWN_DUP2, w_err, 2),
            (os.POSIX_SPAWN_CLOSE, r_out),
            (os.POSIX_SPAWN_CLOSE, r_err),
        ])
    except BaseException:
        for fd in (r_out, r_err, w_out, w_err):
            os.close(fd)
        raise
    os.close(w_out)
    os.close(w_err)
    bufs = {r_out: bytearray(), r_err: bytearray()}
    open_fds = [r_out, r_err]
    deadline = t0 + timeout if timeout else None
    try:
        while open_fds:
            if deadline is not None:
                wait = deadline - time.monotonic()
                rlist = (select.select(open_fds, [], [], wait)[0]
                         if wait > 0 else [])
                if not rlist:
                    try:
                        os.kill(pid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
                    os.waitpid(pid, 0)
                    raise subprocess.TimeoutExpired(
                        argv, timeout, output=bytes(bufs[r_out]),
                        stderr=bytes(bufs[r_err]))
            else:
                rlist = select.select(open_fds, [], [])[0]
            for fd in rlist:
                chunk = os.read(fd, 65536)
                if chunk:
                    bufs[fd] += chunk
                else:
                    open_fds.remove(fd)
                    os.close(fd)
    finally:
        for fd in open_fds:
            os.close(fd)
    _, status = os.waitpid(pid, 0)
    rc = os.waitstatus_to_exitcode(status)
    t1 = time.monotonic()
    return ShellResult(rc, _decode_text(bytes(bufs[r_out])),
                       _decode_text(bytes(bufs[r_err])), t1 - t0)


def run_subprocess(
    command: str,
    env: Mapping[str, str] | None = None,
    timeout: float | None = None,
    cwd: str | None = None,
    shell: bool = False,
    base_env: Mapping[str, str] | None = None,
    spawn: str = "auto",
) -> ShellResult:
    """Run one black-box task; measures runtime (the paper's task
    profiler: "the application is not mandated to have an internal
    timer").

    Always returns a ``ShellResult`` — including on nonzero exit.  The
    scheduler classifies the returncode (see ``Scheduler._classify``),
    so retries and failure closure apply uniformly to shell tasks.  A
    ``timeout`` bounds the attempt; expiry raises
    ``subprocess.TimeoutExpired``, which the scheduler records as a
    failed attempt.  ``shell=True`` runs the command through ``sh -c``
    (pipes/redirects honored) instead of splitting it into argv.
    ``base_env`` is the run-level ambient environment snapshot forwarded
    to ``merged_env`` (None: snapshot ``os.environ`` per call).

    ``spawn`` selects the process-creation path: ``"auto"`` (default)
    uses ``os.posix_spawnp`` — vfork-based, no fork of the Python
    interpreter's address space — whenever the platform has it and no
    ``cwd`` is requested (``posix_spawn`` has no portable chdir file
    action), falling back to ``subprocess.run`` otherwise; ``"posix"``
    and ``"popen"`` force one path (benchmarks measure them against
    each other)."""
    argv = ["sh", "-c", command] if shell else shlex.split(command)
    if (spawn != "popen" and _HAS_POSIX_SPAWN and cwd is None and argv):
        return _posix_spawn_capture(argv, merged_env(env, base_env), timeout)
    if spawn == "posix":
        raise RuntimeError("posix spawn path unavailable "
                           "(no posix_spawnp, empty argv, or cwd set)")
    t0 = time.monotonic()
    proc = subprocess.run(
        argv,
        capture_output=True,
        text=True,
        env=merged_env(env, base_env),
        timeout=timeout,
        cwd=cwd,
        check=False,
    )
    t1 = time.monotonic()
    return ShellResult(proc.returncode, proc.stdout, proc.stderr, t1 - t0)


# ---------------------------------------------------------------------------
# Worker pools
# ---------------------------------------------------------------------------

#: runner signature shared by every pool: one node in, one value out.
Runner = Callable[[TaskNode], Any]


@dataclasses.dataclass
class CompletionEvent:
    """One finished dispatch: per-node outcomes plus true start/stop."""

    token: int
    values: list[Any]             # aligned with the dispatched nodes
    errors: list[str | None]      # non-None marks that node's attempt failed
    started: float
    finished: float
    host: str | None = None       # executing host / allocation (remote pools)


def _run_nodes(runner: Runner, nodes: Sequence[TaskNode]
               ) -> tuple[list[Any], list[str | None], float, float]:
    """Worker-side body: run each node, capture per-node exceptions, and
    measure true occupancy with a clock local to the worker."""
    t0 = time.monotonic()
    values: list[Any] = []
    errors: list[str | None] = []
    for node in nodes:
        try:
            values.append(runner(node))
            errors.append(None)
        except Exception as e:  # noqa: BLE001 — fault isolation
            values.append(None)
            errors.append(f"{type(e).__name__}: {e}")
    t1 = time.monotonic()
    return values, errors, t0, t1


class WorkerPool:
    """Backend interface for the scheduler's event loop."""

    kind = "base"

    #: whether ``CompletionEvent.host`` names a durable location worth
    #: folding into the journal's per-task host map (remote pools: yes).
    #: Pools whose hosts are transient local labels (worker lanes) keep
    #: host provenance in the per-attempt records only — a 10^5-task
    #: windowed run must not grow an O(N_W) journal host map out of
    #: lane indices.
    durable_hosts = True

    @property
    def dispatch_slots(self) -> int:
        """How many concurrent dispatches the scheduler should drive.
        Defaults to the pool's slot count (one task per dispatch);
        grouped backends (batch allocations) override this — each
        dispatch already hosts a whole group, so driving ``slots``
        dispatches would over-subscribe the declared capacity."""
        return int(getattr(self, "slots", 1) or 1)

    def take(self, ready: list[str], dag: "TaskDAG") -> list[str]:
        """Claim the next batch of node ids from the (sorted) ready
        queue, removing them.  Default: one node per dispatch."""
        return [ready.pop(0)]

    def submit(self, token: int, runner: Runner | None,
               nodes: Sequence[TaskNode]) -> None:
        raise NotImplementedError

    def next_event(self, timeout: float | None = None) -> CompletionEvent | None:
        """Block for the next completion; ``None`` signals the timeout
        elapsed (the loop then checks deadlines and stragglers)."""
        raise NotImplementedError

    def cancel(self, token: int) -> None:
        """Release backend resources held by an abandoned dispatch (a
        speculative duplicate that lost the race, or an expired
        attempt).  The pool must still deliver a completion event for
        the token so the scheduler can return its slot to service.
        Default: no-op — local pools just let the worker finish."""

    def shutdown(self) -> None:
        pass

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.shutdown()


class _SyncPool(WorkerPool):
    """Base for synchronous backends: ``submit`` runs the batch in place
    and queues its event, so completions arrive in dispatch order."""

    def __init__(self) -> None:
        self._events: deque[CompletionEvent] = deque()

    def _run_batch(self, runner: Runner | None, nodes: Sequence[TaskNode]
                   ) -> tuple[list[Any], list[str | None], float, float]:
        raise NotImplementedError

    def submit(self, token: int, runner: Runner | None,
               nodes: Sequence[TaskNode]) -> None:
        values, errors, t0, t1 = self._run_batch(runner, nodes)
        self._events.append(CompletionEvent(token, values, errors, t0, t1))

    def next_event(self, timeout: float | None = None) -> CompletionEvent | None:
        return self._events.popleft() if self._events else None


class InlinePool(_SyncPool):
    """Synchronous per-node backend — deterministic; the default."""

    kind = "inline"

    def _run_batch(self, runner: Runner | None, nodes: Sequence[TaskNode]):
        return _run_nodes(runner, nodes)


class _FuturePool(WorkerPool):
    """Shared machinery for executor-backed pools: completions funnel
    through a queue fed by done-callbacks."""

    def __init__(self, slots: int) -> None:
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.slots = slots
        self._q: "queue.Queue[CompletionEvent]" = queue.Queue()
        self._ex = self._make_executor(slots)

    def _make_executor(self, slots: int):  # pragma: no cover - abstract
        raise NotImplementedError

    def submit(self, token: int, runner: Runner | None,
               nodes: Sequence[TaskNode]) -> None:
        fut = self._ex.submit(_run_nodes, runner, list(nodes))
        n = len(nodes)
        fut.add_done_callback(lambda f, t=token, k=n: self._collect(t, k, f))

    def _collect(self, token: int, n: int, fut: Any) -> None:
        if fut.cancelled():
            return      # shutdown cancelled it before it ever ran
        exc = fut.exception()
        if exc is not None:
            now = time.monotonic()
            msg = f"{type(exc).__name__}: {exc}"
            ev = CompletionEvent(token, [None] * n, [msg] * n, now, now)
        else:
            values, errors, t0, t1 = fut.result()
            ev = CompletionEvent(token, values, errors, t0, t1)
        self._q.put(ev)

    def next_event(self, timeout: float | None = None) -> CompletionEvent | None:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def shutdown(self) -> None:
        self._ex.shutdown(wait=False, cancel_futures=True)


class ThreadWorkerPool(_FuturePool):
    """Thread-pool backend: true wall-clock overlap for subprocess- and
    I/O-bound tasks (and anything releasing the GIL)."""

    kind = "thread"

    def _make_executor(self, slots: int) -> ThreadPoolExecutor:
        return ThreadPoolExecutor(max_workers=slots,
                                  thread_name_prefix="papas-slot")


class ProcessWorkerPool(_FuturePool):
    """Process-pool backend for CPU-bound Python tasks.  The runner and
    every node (including payloads) must be picklable."""

    kind = "process"

    def _make_executor(self, slots: int) -> ProcessPoolExecutor:
        return ProcessPoolExecutor(max_workers=slots)


# ---------------------------------------------------------------------------
# Persistent worker lanes (short-task throughput path)
# ---------------------------------------------------------------------------

#: renders one node to its shell form: ``node -> (command | None, env)``.
LaneRenderFn = Callable[[TaskNode], "tuple[str | None, Mapping[str, Any]]"]

_ENV_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _sq(s: str) -> str:
    """POSIX single-quote."""
    return "'" + s.replace("'", "'\\''") + "'"


class _LaneJob:
    """One claimed chunk in flight on a lane (mux-internal)."""

    __slots__ = ("token", "nodes", "values", "errors", "stanzas", "spools",
                 "pending", "t0", "stalls", "cycle_len", "ends",
                 "head_started", "head_deadline")

    def __init__(self, token: int, nodes: list[TaskNode]) -> None:
        self.token = token
        self.nodes = nodes
        n = len(nodes)
        self.values: list[Any] = [None] * n
        self.errors: list[str | None] = ["lane batch aborted"] * n
        self.stanzas: dict[int, tuple[str, float | None]] = {}
        self.spools: dict[int, Path] = {}
        self.pending: list[int] = []
        self.t0 = 0.0
        self.stalls = 0
        self.cycle_len = 0
        #: absolute per-lane flush offsets marking each stanza's end —
        #: a head deadline arms only once its stanza fully left the pipe
        self.ends: dict[int, int] = {}
        self.head_started = 0.0
        self.head_deadline: float | None = None


class _Lane:
    """One persistent worker shell multiplexed by the mux thread."""

    __slots__ = ("idx", "proc", "buf", "outbox", "job", "dying",
                 "death_msg", "want_write", "flushed", "enqueued",
                 "err_path", "err_file")

    def __init__(self, idx: int) -> None:
        self.idx = idx
        self.proc: subprocess.Popen | None = None
        self.buf = bytearray()          # incremental stdout frame buffer
        self.outbox = bytearray()       # unflushed stdin bytes
        self.job: _LaneJob | None = None
        self.dying = False              # killed; waiting for stdout EOF
        self.death_msg = "lane worker died"
        self.want_write = False         # stdin registered for EVENT_WRITE
        self.flushed = 0                # bytes written since (re)spawn
        self.enqueued = 0               # bytes ever queued since (re)spawn
        self.err_path: Path | None = None
        self.err_file: Any = None       # reused O_APPEND stderr spool


@dataclasses.dataclass
class LaneStats:
    """Dispatch accounting for the lane pool (mirrors ``GangStats``)."""

    tasks: int = 0
    dispatches: int = 0     # one per pipe-fed batch
    respawns: int = 0       # worker shells restarted (timeout/cancel/crash)

    @property
    def batching_factor(self) -> float:
        return self.tasks / max(1, self.dispatches)


class LaneWorkerPool(WorkerPool):
    """Persistent worker lanes: one long-lived ``sh`` process per slot,
    multiplexed by a single selector-based front-end thread.

    Where ``ThreadWorkerPool`` + ``run_subprocess`` pays a fresh process
    spawn, a full environment copy, and executor/future bookkeeping per
    task, a lane pays them once per *worker*: each task is one stanza
    down the worker's stdin (``VAR=… command eval '<cmd>'`` followed by
    an rc sentinel), so a shell builtin runs with zero forks and a real
    command forks from a tiny ``sh`` instead of the Python interpreter.

    The mux thread owns every lane pipe through one
    ``selectors.DefaultSelector``: it drains all lane stdouts as they
    become readable, parses rc-sentinel frames *incrementally* per lane
    (a sentinel split across pipe reads is just a partial buffer — no
    frame is ever mis-framed), trickles outgoing stanza bytes through
    non-blocking stdins, and arms per-head-node deadlines that bound the
    ``select`` timeout.  One thread for N lanes replaces the old
    thread-per-lane readers, which convoyed on the GIL past ~8 lanes.

    ``take`` claims a same-task chunk of the ready queue.  With
    ``batch="auto"`` (default) the chunk size adapts: a streaming
    median/p90 of observed per-frame durations grows batches while tasks
    are much cheaper than dispatch overhead and shrinks them under
    straggler pressure, clamped so one batch stays under ~0.25 s of
    per-lane latency.  An explicit integer pins the old static size.

    Task stdout flows back inline over the pipe, framed by a per-pool
    random sentinel.  stderr spools to a file read back only when the
    command exits nonzero: with ``capture_stderr=False`` every command
    on a lane shares one preallocated ``O_APPEND`` spool fd inherited at
    spawn (zero per-command opens; truncated between batches), while
    ``capture_stderr=True`` keeps per-batch-index spool files so each
    task's stderr reads back exactly.

    ``render`` maps a node to ``(command, env)`` — usually
    ``ParameterStudy.render_node``.  Without a render fn the node's
    payload ``command`` key is used; a node with neither fails its
    attempt (in-process registry callables cannot be piped to a shell).
    Per-task env vars are scoped to the single command (``VAR=v command
    eval …`` does not persist in the lane), layered over the environment
    snapshot taken once when the lane spawns.

    ``cancel`` kills the lane hosting the abandoned dispatch (releasing
    a stuck command) and the lane respawns for the next batch, so
    scheduler-driven timeouts compose.  A timeout or dead lane fails the
    node at the read head, harvests any later frames still sitting in
    the dying pipe, respawns the worker, and resends only the commands
    that never ran.  ``run_gang`` runs one fused node batch across all
    lanes synchronously — signature-compatible with ``GangRunner``, so
    ``GangExecutor(stackable_key, lanes.run_gang)`` dispatches gang
    groups through the persistent workers.
    """

    kind = "lane"
    durable_hosts = False   # lane ids are transient labels, not hosts

    #: adaptive batching bounds: warm up at the old static size, grow so
    #: one batch stays under ~BATCH_LATENCY seconds of per-lane latency
    WARMUP_BATCH = 8
    MAX_BATCH = 256
    BATCH_LATENCY = 0.25

    def __init__(
        self,
        slots: int,
        render: LaneRenderFn | None = None,
        batch: int | str = "auto",
        cwd: str | None = None,
        capture_stderr: bool = False,
        reuse_spool: bool | None = None,
    ) -> None:
        """``capture_stderr=True`` reads the per-task stderr spool back
        even on success — required when a ``capture:`` extractor sources
        stderr (the results layer asks for it via the study's pool
        wiring); the default keeps the success path's
        two-fewer-file-round-trips economy.  ``batch`` is ``"auto"``
        (duration-adaptive chunk sizing) or a pinned integer.
        ``reuse_spool`` toggles the preallocated per-lane stderr fd
        (default: on exactly when ``capture_stderr`` is off)."""
        if slots < 1:
            raise ValueError("slots must be >= 1")
        if batch != "auto":
            if not isinstance(batch, int) or isinstance(batch, bool) \
                    or batch < 1:
                raise ValueError("batch must be >= 1 or 'auto'")
        self.slots = slots
        self.render = render
        self.batch = batch
        self.cwd = cwd
        self.capture_stderr = capture_stderr
        self.reuse_spool = (not capture_stderr if reuse_spool is None
                            else reuse_spool)
        self.stats = LaneStats()
        # chaos/telemetry capture at construction (the make_lock
        # pattern): when nothing is armed these are None and the frame
        # hot path pays one identity check each
        self._chaos = chaos.current()
        self._telemetry = telemetry.current()
        self._base_env = dict(os.environ)   # snapshot once per pool
        # per-pool random rc sentinel: task stdout flows back inline over
        # the lane pipe, framed by a marker real output cannot guess
        self._sent = f"__papas_{os.urandom(8).hex()}_rc="
        self._marker = b"\n" + self._sent.encode()
        self._spool = Path(tempfile.mkdtemp(prefix="papas-lanes-"))
        self._workq: deque[tuple[int, list[TaskNode]]] = deque()
        self._events: "queue.Queue[CompletionEvent]" = queue.Queue()
        self._lock = make_lock("lane.pool")
        self._cancelled: set[int] = set()
        self._active: dict[int, subprocess.Popen] = {}  # token → lane shell
        self._gang_tokens = itertools.count(-1, -1)     # never collide with
        self._gang_out: dict[int, tuple[list, list]] = {}  # scheduler tokens
        self._gang_cv = threading.Condition(self._lock)
        self._shutdown = False
        # streaming per-frame duration stats feeding the batch controller
        from .stats import StreamingQuantile
        self._dur_med = StreamingQuantile(0.5)
        self._dur_p90 = StreamingQuantile(0.9)
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        os.set_blocking(self._wake_w, False)
        self._mux_thread = threading.Thread(
            target=self._mux, name="papas-lane-mux", daemon=True)
        self._mux_thread.start()

    # -- scheduler interface -------------------------------------------
    def _batch_now(self) -> int:
        """Current batch cap: duration-adaptive unless pinned."""
        if self.batch != "auto":
            return self.batch
        with self._lock:
            n = len(self._dur_med)
            if n < 2 * self.WARMUP_BATCH:
                return self.WARMUP_BATCH
            med = self._dur_med.quantile()
            p90 = self._dur_p90.quantile()
        if med <= 0:
            return self.MAX_BATCH
        target = self.BATCH_LATENCY / med
        if p90 > 4 * med:
            # straggler pressure: bound worst-case batch latency too
            target = min(target, max(1.0, self.BATCH_LATENCY / p90))
        return max(1, min(self.MAX_BATCH, int(target)))

    def take(self, ready: list[str], dag: "TaskDAG") -> list[str]:
        """Gang-style chunk claim: the longest same-task prefix of the
        ready queue, capped at the (possibly adaptive) batch size — one
        pipe write per chunk.  The cap also adapts to queue depth
        (``len(ready) / slots``) so a shallow queue spreads across every
        lane instead of serializing full chunks on a few; deep sweeps
        still get full batches."""
        k = min(self._batch_now(), len(ready),
                max(1, len(ready) // self.slots))
        if k > 1:
            task0 = dag.nodes[ready[0]].task
            j = 1
            while j < k and dag.nodes[ready[j]].task == task0:
                j += 1
            k = j
        out = ready[:k]
        del ready[:k]
        if self._telemetry is not None and out:
            self._telemetry.metrics.histogram(
                "papas_lane_batch_size").observe(len(out))
        return out

    def submit(self, token: int, runner: Runner | None,
               nodes: Sequence[TaskNode]) -> None:
        with self._lock:
            self._workq.append((token, list(nodes)))
        self._wake()

    def next_event(self, timeout: float | None = None) -> CompletionEvent | None:
        try:
            return self._events.get(timeout=timeout)
        except queue.Empty:
            return None

    def cancel(self, token: int) -> None:
        """Kill the lane hosting an abandoned dispatch so a stuck command
        releases its slot promptly; the lane respawns for the next
        batch."""
        with self._lock:
            self._cancelled.add(token)
            proc = self._active.get(token)
        if proc is not None:
            self._kill(proc)
        self._wake()

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            procs = list(self._active.values())
            self._gang_cv.notify_all()
        for p in procs:
            self._kill(p)
        self._wake()
        self._mux_thread.join(timeout=5.0)
        for fd in (self._wake_r, self._wake_w):
            try:
                os.close(fd)
            except OSError:
                pass
        shutil.rmtree(self._spool, ignore_errors=True)

    def _wake(self) -> None:
        try:
            os.write(self._wake_w, b"x")
        except (BlockingIOError, OSError):
            pass    # wake pipe full or closed: the mux is waking anyway

    # -- gang integration ----------------------------------------------
    def run_gang(self, nodes: Sequence[TaskNode]) -> list[Any]:
        """Run one fused batch across every lane and return per-node
        values in order — a ``GangRunner``, so gang studies dispatch
        their groups through the persistent workers.  A lane-level
        failure raises (gang semantics: the whole group's attempt
        fails); per-command nonzero exits stay data in the returned
        ``ShellResult``\\ s."""
        nodes = list(nodes)
        if not nodes:
            return []
        per = -(-len(nodes) // self.slots)      # ceil
        chunks = [nodes[i:i + per] for i in range(0, len(nodes), per)]
        toks: list[int] = []
        with self._lock:
            for _ in chunks:
                toks.append(next(self._gang_tokens))
        with self._lock:
            for tok, chunk in zip(toks, chunks):
                self._workq.append((tok, chunk))
        self._wake()
        with self._gang_cv:
            while any(t not in self._gang_out for t in toks):
                if self._shutdown:
                    raise RuntimeError("lane pool shut down mid-gang")
                self._gang_cv.wait(timeout=0.5)
            outs = [self._gang_out.pop(t) for t in toks]
        values: list[Any] = []
        for chunk, (vals, errs) in zip(chunks, outs):
            bad = [e for e in errs if e is not None]
            if bad:
                raise RuntimeError(
                    f"lane gang batch failed: {bad[0]}"
                    + (f" (+{len(bad) - 1} more)" if len(bad) > 1 else ""))
            values.extend(vals)
        return values

    # -- mux machinery -------------------------------------------------
    @staticmethod
    def _kill(proc: subprocess.Popen) -> None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    def _node_command(self, node: TaskNode
                      ) -> tuple[str | None, Mapping[str, Any]]:
        if self.render is not None:
            return self.render(node)
        payload = node.payload if isinstance(node.payload, Mapping) else {}
        return payload.get("command"), payload.get("env") or {}

    @staticmethod
    def _slurp(path: Path | None) -> str:
        if path is None:
            return ""
        try:
            return path.read_text(errors="replace")
        except FileNotFoundError:
            return ""

    def _render_line(self, node: TaskNode, err_p: Path | None
                     ) -> tuple[str, float | None]:
        """One node's protocol stanza: env overlay + eval + rc sentinel.
        Task stdout flows back inline over the pipe; stderr spools to a
        per-batch-index file (``err_p``) or, when the lane reuses one
        preallocated spool fd, is simply inherited from the shell."""
        cmd, env = self._node_command(node)
        if cmd is None:
            raise RuntimeError(
                f"task {node.task!r} has no shell command; lane workers "
                "cannot run in-process registry callables")
        prefix = ""
        for k, v in (env or {}).items():
            if not _ENV_NAME_RE.match(str(k)):
                raise RuntimeError(f"invalid environment name {k!r}")
            prefix += f"{k}={_sq(str(v))} "
        timeout = payload_timeout(node)
        redir = "" if err_p is None else f"2>{_sq(str(err_p))} "
        # stdin dups from fd 3 (/dev/null, opened once per shell) so a
        # command never eats the protocol stream — one dup2 instead of a
        # per-command open of /dev/null
        line = (f"{prefix}command eval {_sq(cmd)} {redir}<&3\n"
                f"printf '\\n{self._sent}%d\\n' $?\n")
        return line, float(timeout) if timeout else None

    def _observe(self, runtime: float) -> None:
        with self._lock:
            self._dur_med.add(runtime)
            self._dur_p90.add(runtime)
        if self._telemetry is not None:
            self._telemetry.metrics.histogram(
                "papas_lane_frame_seconds").observe(runtime)

    # -- mux event loop ------------------------------------------------
    def _mux(self) -> None:
        """The single front-end thread: multiplexes every lane pipe
        through one selector, parses frames incrementally, arms per-head
        deadlines, and handles respawn/harvest on lane death."""
        sel = selectors.DefaultSelector()
        sel.register(self._wake_r, selectors.EVENT_READ, ("wake", None))
        lanes = [_Lane(i) for i in range(self.slots)]
        idle: deque[_Lane] = deque(lanes)
        try:
            while True:
                with self._lock:
                    if self._shutdown:
                        break
                self._assign_work(sel, idle)
                timeout = None
                now = time.monotonic()
                for lane in lanes:
                    job = lane.job
                    if job is not None and job.head_deadline is not None:
                        t = max(0.0, job.head_deadline - now)
                        timeout = t if timeout is None else min(timeout, t)
                events = sel.select(timeout)
                now = time.monotonic()
                for key, _mask in events:
                    kind, lane = key.data
                    if kind == "wake":
                        try:
                            while os.read(self._wake_r, 4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                    elif kind == "out":
                        self._on_readable(sel, lane, idle, now, key.fileobj)
                    else:   # "in": lane stdin drained some outbox room
                        self._on_writable(sel, lane, now, key.fileobj)
                now = time.monotonic()
                for lane in lanes:
                    job = lane.job
                    if (job is not None and job.head_deadline is not None
                            and now >= job.head_deadline):
                        if lane.dying:
                            # EOF grace expired (e.g. a detached grand-
                            # child still holds the pipe): force the
                            # death path without waiting for EOF
                            self._on_lane_dead(sel, lane, idle, now)
                        else:
                            self._timeout_head(lane, now)
        finally:
            self._teardown(sel, lanes)

    def _assign_work(self, sel: selectors.BaseSelector,
                     idle: "deque[_Lane]") -> None:
        while idle:
            with self._lock:
                if not self._workq:
                    return
                token, nodes = self._workq.popleft()
                cancelled = token in self._cancelled or self._shutdown
            lane = idle[0]
            job = _LaneJob(token, nodes)
            job.t0 = time.monotonic()
            for i, node in enumerate(nodes):
                err_p = None
                if not self.reuse_spool:
                    err_p = self._spool / f"lane{lane.idx}.{i}.err"
                    job.spools[i] = err_p
                try:
                    job.stanzas[i] = self._render_line(node, err_p)
                except Exception as e:  # noqa: BLE001 — per-node isolation
                    job.errors[i] = f"{type(e).__name__}: {e}"
            job.pending = [i for i in range(len(nodes)) if i in job.stanzas]
            if cancelled or not job.pending:
                for i in job.pending:
                    job.errors[i] = "cancelled: dispatch abandoned"
                job.pending = []
                self._account_and_emit(job, lane.idx, time.monotonic())
                continue
            idle.popleft()
            lane.job = job
            self._ensure_proc(sel, lane)
            with self._lock:
                self._active[job.token] = lane.proc
            self._send_pending(sel, lane, time.monotonic())

    def _ensure_proc(self, sel: selectors.BaseSelector, lane: _Lane) -> None:
        if lane.proc is not None and lane.proc.poll() is None:
            return
        self._spawn_lane(sel, lane)

    def _spawn_lane(self, sel: selectors.BaseSelector, lane: _Lane) -> None:
        if lane.proc is not None:
            self._close_proc(sel, lane)
        stderr_target: Any = subprocess.DEVNULL
        if self.reuse_spool:
            if lane.err_file is None:
                # one preallocated O_APPEND spool per lane, inherited by
                # the shell at spawn: child writes always land at EOF, so
                # truncating between batches is race-free and no command
                # ever pays a per-task open
                lane.err_path = self._spool / f"lane{lane.idx}.err"
                lane.err_file = open(lane.err_path, "ab", buffering=0)
            stderr_target = lane.err_file
        proc = subprocess.Popen(
            ["sh"], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=stderr_target, cwd=self.cwd, env=self._base_env,
            start_new_session=True)
        os.set_blocking(proc.stdout.fileno(), False)
        os.set_blocking(proc.stdin.fileno(), False)
        lane.proc = proc
        lane.buf = bytearray()
        lane.outbox = bytearray(b"exec 3</dev/null\n")
        lane.enqueued = len(lane.outbox)
        lane.flushed = 0
        lane.dying = False
        lane.death_msg = "lane worker exited"
        lane.want_write = False
        sel.register(proc.stdout, selectors.EVENT_READ, ("out", lane))
        self.stats.respawns += 1
        if self._telemetry is not None:
            self._telemetry.metrics.counter(
                "papas_lane_respawns_total").inc()

    def _close_proc(self, sel: selectors.BaseSelector, lane: _Lane) -> None:
        proc = lane.proc
        if proc is None:
            return
        self._kill(proc)
        try:
            sel.unregister(proc.stdout)
        except (KeyError, ValueError):
            pass
        if lane.want_write:
            try:
                sel.unregister(proc.stdin)
            except (KeyError, ValueError):
                pass
            lane.want_write = False
        for f in (proc.stdout, proc.stdin):
            try:
                f.close()
            except (BrokenPipeError, OSError):
                pass
        proc.wait()
        lane.proc = None
        lane.buf = bytearray()
        lane.outbox = bytearray()

    def _send_pending(self, sel: selectors.BaseSelector, lane: _Lane,
                      now: float) -> None:
        """Queue every pending stanza for the lane in one enqueue; bytes
        trickle out through the non-blocking stdin as the pipe drains."""
        job = lane.job
        pos = lane.enqueued
        parts = []
        for i in job.pending:
            b = job.stanzas[i][0].encode()
            parts.append(b)
            pos += len(b)
            job.ends[i] = pos
        lane.outbox += b"".join(parts)
        lane.enqueued = pos
        job.cycle_len = len(job.pending)
        job.head_started = now
        job.head_deadline = None
        self._flush_out(sel, lane, now)

    def _flush_out(self, sel: selectors.BaseSelector, lane: _Lane,
                   now: float) -> None:
        proc = lane.proc
        if proc is None:
            return
        while lane.outbox:
            try:
                n = os.write(proc.stdin.fileno(), lane.outbox)
            except BlockingIOError:
                break
            except (BrokenPipeError, OSError) as e:
                lane.death_msg = str(e) or "lane worker died"
                lane.outbox.clear()
                self._kill(proc)    # stdout EOF follows; death path runs
                break
            del lane.outbox[:n]
            lane.flushed += n
        if lane.outbox and not lane.want_write:
            sel.register(proc.stdin, selectors.EVENT_WRITE, ("in", lane))
            lane.want_write = True
        elif not lane.outbox and lane.want_write:
            try:
                sel.unregister(proc.stdin)
            except (KeyError, ValueError):
                pass
            lane.want_write = False
        self._arm_deadline(lane, now)

    def _arm_deadline(self, lane: _Lane, now: float) -> None:
        """Arm the head node's timeout once its stanza fully left the
        pipe (a deadline for a command the shell cannot have started yet
        would fire spuriously)."""
        job = lane.job
        if job is None or lane.dying or not job.pending:
            return
        if job.head_deadline is not None:
            return
        head = job.pending[0]
        t = job.stanzas[head][1]
        if t is not None and lane.flushed >= job.ends.get(head, 0):
            job.head_deadline = now + t

    def _on_writable(self, sel: selectors.BaseSelector, lane: _Lane,
                     now: float, fileobj: Any) -> None:
        if lane.proc is None or fileobj is not lane.proc.stdin:
            return      # stale event for a respawned lane
        self._flush_out(sel, lane, now)

    def _on_readable(self, sel: selectors.BaseSelector, lane: _Lane,
                     idle: "deque[_Lane]", now: float, fileobj: Any) -> None:
        if lane.proc is None or fileobj is not lane.proc.stdout:
            return      # stale event for a respawned lane
        fd = lane.proc.stdout.fileno()
        eof = False
        while True:
            try:
                chunk = os.read(fd, 65536)
            except BlockingIOError:
                break
            except OSError:
                eof = True
                break
            if not chunk:
                eof = True
                break
            lane.buf += chunk
            if len(chunk) < 65536:
                break
        self._pump(sel, lane, idle, now)
        if eof:
            self._on_lane_dead(sel, lane, idle, now)

    def _pump(self, sel: selectors.BaseSelector, lane: _Lane,
              idle: "deque[_Lane]", now: float) -> None:
        """Parse complete rc-sentinel frames out of the lane's incremental
        buffer.  A sentinel split across pipe reads is simply an
        incomplete buffer — parsing resumes when the rest arrives, so
        frames survive arbitrary read fragmentation (including on a
        dying pipe during harvest)."""
        job = lane.job
        if job is None:
            lane.buf.clear()    # stray output with no active batch
            return
        marker = self._marker
        while job.pending:
            pos = lane.buf.find(marker)
            if pos < 0:
                break
            end = lane.buf.find(b"\n", pos + len(marker))
            if end < 0:
                break           # rc digits still in flight
            rc = int(lane.buf[pos + len(marker):end])
            out = bytes(lane.buf[:pos])
            del lane.buf[:end + 1]
            i = job.pending.pop(0)
            runtime = 0.0 if lane.dying else now - job.head_started
            stderr = ""
            if rc != 0 or self.capture_stderr:
                stderr = self._slurp(job.spools.get(i, lane.err_path))
            job.values[i] = ShellResult(rc, out.decode(errors="replace"),
                                        stderr, runtime)
            job.errors[i] = None
            if not lane.dying:
                self._observe(runtime)
                job.head_started = now
                job.head_deadline = None
                if self._chaos is not None \
                        and self._chaos.lane_frame(lane.idx) \
                        and lane.proc is not None:
                    # injected lane death: SIGKILL the worker mid-batch
                    # and let the existing death path (_on_lane_dead)
                    # harvest flushed frames, charge the read head, and
                    # respawn — the exact recovery a real crash takes
                    lane.death_msg = "lane worker died"
                    self._kill(lane.proc)
                    break
                self._arm_deadline(lane, now)
        if not job.pending and not lane.dying:
            self._finish_lane_job(sel, lane, idle, now)

    def _timeout_head(self, lane: _Lane, now: float) -> None:
        """Per-node timeout at the read head: charge the head, kill the
        worker, and let the death path harvest any later frames still
        sitting in the dying pipe."""
        job = lane.job
        head = job.pending.pop(0)
        job.errors[head] = (f"timeout: lane command exceeded "
                            f"{job.stanzas[head][1]}s")
        job.values[head] = None
        lane.dying = True
        lane.death_msg = "lane worker died"
        # grace period for the pipe EOF after SIGKILL; a detached
        # grandchild holding the write end cannot wedge the lane
        job.head_deadline = now + 1.0
        if lane.proc is not None:
            self._kill(lane.proc)

    def _on_lane_dead(self, sel: selectors.BaseSelector, lane: _Lane,
                      idle: "deque[_Lane]", now: float) -> None:
        """Lane shell died (timeout kill, cancel kill, or crash): close
        it out, charge the read head if its command had been sent,
        respawn, and resend only the survivors that never ran."""
        was_dying = lane.dying
        flushed = lane.flushed
        self._close_proc(sel, lane)
        job = lane.job
        if job is None:
            return              # idle lane's shell died: respawn lazily
        job.head_deadline = None
        lane.dying = False
        with self._lock:
            cancelled = job.token in self._cancelled or self._shutdown
        if cancelled:
            for i in job.pending:
                job.errors[i] = "cancelled: dispatch abandoned"
            job.pending = []
            self._finish_lane_job(sel, lane, idle, now)
            return
        msg = lane.death_msg
        if not was_dying and job.pending:
            head = job.pending[0]
            if flushed >= job.ends.get(head, float("inf")):
                job.pending.pop(0)
                job.errors[head] = msg
                job.values[head] = None
        survivors = job.pending
        progress = len(survivors) < job.cycle_len
        job.stalls = 0 if progress else job.stalls + 1
        if not survivors:
            self._finish_lane_job(sel, lane, idle, now)
        elif job.stalls >= 3:   # lane keeps dying without progress
            for i in survivors:
                job.errors[i] = msg
                job.values[i] = None
            job.pending = []
            self._finish_lane_job(sel, lane, idle, now)
        else:
            self._spawn_lane(sel, lane)
            with self._lock:
                self._active[job.token] = lane.proc
            self._send_pending(sel, lane, now)

    def _finish_lane_job(self, sel: selectors.BaseSelector, lane: _Lane,
                         idle: "deque[_Lane]", now: float) -> None:
        job = lane.job
        lane.job = None
        lane.dying = False
        with self._lock:
            self._active.pop(job.token, None)
        self._account_and_emit(job, lane.idx, now)
        if self.reuse_spool and lane.err_file is not None:
            try:
                os.ftruncate(lane.err_file.fileno(), 0)
            except OSError:
                pass
        idle.append(lane)

    def _account_and_emit(self, job: _LaneJob, idx: int, t1: float) -> None:
        self.stats.dispatches += 1
        self.stats.tasks += len(job.nodes)
        tel = self._telemetry
        if tel is not None:
            # retroactive frame slice: both ends known, one lane track
            # per index (the tid survives respawns — keyed by name)
            tel.trace.complete(
                f"lane{idx}", f"{job.nodes[0].task} x{len(job.nodes)}",
                job.t0, t1, cat="lane", args={"tasks": len(job.nodes)})
        self._emit(job.token, job.values, job.errors, job.t0, t1,
                   f"lane{idx}")

    def _teardown(self, sel: selectors.BaseSelector,
                  lanes: list[_Lane]) -> None:
        now = time.monotonic()
        for lane in lanes:
            if lane.job is not None:
                job = lane.job
                lane.job = None
                for i in job.pending:
                    job.errors[i] = "cancelled: dispatch abandoned"
                job.pending = []
                with self._lock:
                    self._active.pop(job.token, None)
                self._account_and_emit(job, lane.idx, now)
        while True:
            with self._lock:
                if not self._workq:
                    break
                token, nodes = self._workq.popleft()
            job = _LaneJob(token, nodes)
            job.t0 = now
            job.errors = ["cancelled: dispatch abandoned"] * len(nodes)
            self._account_and_emit(job, 0, now)
        for lane in lanes:
            if lane.proc is not None:
                self._close_proc(sel, lane)
            if lane.err_file is not None:
                try:
                    lane.err_file.close()
                except OSError:
                    pass
        try:
            sel.unregister(self._wake_r)
        except (KeyError, ValueError):
            pass
        sel.close()

    def _emit(self, token: int, values: list[Any],
              errors: list[str | None], t0: float, t1: float,
              host: str) -> None:
        if token < 0:       # run_gang internal dispatch
            with self._gang_cv:
                self._gang_out[token] = (values, errors)
                self._gang_cv.notify_all()
            return
        self._events.put(
            CompletionEvent(token, values, errors, t0, t1, host=host))


def payload_timeout(node: TaskNode) -> Any:
    """A node's WDL ``timeout`` keyword, if any."""
    payload = node.payload if isinstance(node.payload, Mapping) else {}
    return payload.get("timeout")


#: every kind ``make_pool`` accepts (remote kinds live in ``remote.py``).
VALID_POOL_KINDS = ("inline", "thread", "process", "lane", "ssh", "slurm",
                    "pbs")


def make_pool(kind: str, slots: int = 1, **remote_kwargs: Any) -> WorkerPool:
    """Construct a pool by name.

    Local kinds: ``inline``, ``thread``, ``process`` (``slots``
    workers), and ``lane`` (``slots`` persistent shell workers; optional
    ``render``, ``batch``, ``cwd`` — the short-task throughput path).
    Remote kinds: ``ssh`` (requires ``hosts``; optional ``ppnode``,
    ``transport``, ``render``) and ``slurm`` / ``pbs`` (optional
    ``nnodes``, ``ppnode``, ``submitter``, ``render``, ``spool_root``)
    — their slot count is ``hosts × ppnode`` / ``nnodes × ppnode``, not
    ``slots``.  An unknown kind raises a ``ValueError`` naming every
    valid kind.
    """
    if kind == "inline":
        return InlinePool()
    if kind == "thread":
        return ThreadWorkerPool(slots)
    if kind == "process":
        return ProcessWorkerPool(slots)
    if kind == "lane":
        for k in ("hosts", "nnodes", "ppnode", "transport", "submitter",
                  "spool_root"):
            remote_kwargs.pop(k, None)
        return LaneWorkerPool(slots, **remote_kwargs)
    if kind == "ssh":
        from .remote import SSHWorkerPool

        hosts = remote_kwargs.pop("hosts", None)
        if not hosts:
            raise ValueError(
                "pool kind 'ssh' requires a non-empty host list "
                "(WDL 'hosts:' keyword or --hosts)")
        remote_kwargs.pop("nnodes", None)
        remote_kwargs.pop("submitter", None)
        remote_kwargs.pop("spool_root", None)
        return SSHWorkerPool(
            hosts, ppnode=remote_kwargs.pop("ppnode", None) or 1,
            **remote_kwargs)
    if kind in ("slurm", "pbs"):
        from .remote import BatchWorkerPool

        remote_kwargs.pop("hosts", None)
        remote_kwargs.pop("transport", None)
        return BatchWorkerPool(
            batch=kind,
            nnodes=remote_kwargs.pop("nnodes", None) or 1,
            ppnode=remote_kwargs.pop("ppnode", None) or 1,
            **remote_kwargs)
    raise ValueError(
        f"unknown pool kind {kind!r}; valid kinds: "
        + ", ".join(VALID_POOL_KINDS))


# ---------------------------------------------------------------------------
# Gang packing
# ---------------------------------------------------------------------------

GroupKeyFn = Callable[[TaskNode], Hashable]
GangRunner = Callable[[Sequence[TaskNode]], Sequence[Any]]


@dataclasses.dataclass
class GangStats:
    """Dispatch accounting — the quantity the paper's Figs. 3/4 compare."""

    groups: int = 0
    tasks: int = 0
    dispatches: int = 0  # one per compiled-program launch

    @property
    def batching_factor(self) -> float:
        return self.tasks / max(1, self.dispatches)


class GangExecutor:
    """Group task instances by a stackability key and dispatch each group
    once.  One dispatch per group is the TPU analogue of "grouping
    intra/inter-workflow tasks as a single batch job" (paper §4.3)."""

    def __init__(self, group_key: GroupKeyFn, gang_runner: GangRunner,
                 max_group: int | None = None) -> None:
        self.group_key = group_key
        self.gang_runner = gang_runner
        self.max_group = max_group
        self.stats = GangStats()

    def run_group(self, chunk: Sequence[TaskNode]) -> list[Any]:
        """Dispatch one stackable chunk as a single program launch."""
        values = list(self.gang_runner(chunk))
        if len(values) != len(chunk):
            raise RuntimeError(
                f"gang runner returned {len(values)} results for "
                f"{len(chunk)} tasks")
        self.stats.groups += 1
        self.stats.dispatches += 1
        self.stats.tasks += len(chunk)
        return values

    def run(self, nodes: Sequence[TaskNode]) -> dict[str, Any]:
        """Group and dispatch a node set directly (no scheduler)."""
        groups: dict[Hashable, list[TaskNode]] = {}
        for n in nodes:
            groups.setdefault(self.group_key(n), []).append(n)
        results: dict[str, Any] = {}
        for _, members in sorted(groups.items(), key=lambda kv: str(kv[0])):
            chunks = (
                [members[i:i + self.max_group]
                 for i in range(0, len(members), self.max_group)]
                if self.max_group else [members]
            )
            for chunk in chunks:
                for node, value in zip(chunk, self.run_group(chunk)):
                    results[node.id] = value
        return results


class GangPool(_SyncPool):
    """Gang dispatch as a pool policy: ``take`` claims an entire
    stackability group from the ready queue and ``submit`` launches it as
    one program.  Replaces the old separate level-synchronous loop — gang
    studies now share the scheduler's retry/closure/journal machinery."""

    kind = "gang"

    def __init__(self, gang: GangExecutor) -> None:
        super().__init__()
        self.gang = gang

    def take(self, ready: list[str], dag: "TaskDAG") -> list[str]:
        groups: dict[str, list[str]] = {}
        for nid in ready:
            groups.setdefault(str(self.gang.group_key(dag.nodes[nid])),
                              []).append(nid)
        members = groups[sorted(groups)[0]]
        if self.gang.max_group:
            members = members[: self.gang.max_group]
        for nid in members:
            ready.remove(nid)
        return members

    def _run_batch(self, runner: Runner | None, nodes: Sequence[TaskNode]):
        t0 = time.monotonic()
        try:
            values = self.gang.run_group(nodes)
            errors: list[str | None] = [None] * len(nodes)
        except Exception as e:  # noqa: BLE001 — whole-batch failure
            msg = f"{type(e).__name__}: {e}"
            values = [None] * len(nodes)
            errors = [msg] * len(nodes)
        t1 = time.monotonic()
        return values, errors, t0, t1


def stackable_key(node: TaskNode) -> Hashable:
    """Default stackability: nodes of the same task whose combos share
    the same *keys* (values may differ — they become per-member arrays).
    Shape-affecting parameters must be embedded in the task name by the
    study author (or use mesh-slice instead)."""
    return (node.task, tuple(sorted(node.combo.keys())))
