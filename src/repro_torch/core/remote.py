"""Remote execution backends — the paper's distributed parallelization
(§4.3, §9: "using SSH, batch systems, and C++ MPI") behind the same
three-method ``WorkerPool`` interface the scheduler already drives.

Two backends, zero scheduler changes:

* ``SSHWorkerPool`` — maps the WDL ``hosts:`` list × ``ppnode`` to
  execution slots (one worker thread per host lane) and dispatches each
  task's *rendered shell command* to its host through a pluggable
  ``Transport``.  ``SSHTransport`` shells out to real ``ssh``;
  ``LocalTransport`` is the in-process fake used by tests and CI — it
  runs commands on the local machine while preserving per-"host" slot
  accounting, injected host failures, and scripted results, so the
  remote path is exercised without any network.  A host whose transport
  fails (connection refused, ssh exit 255, injected fault) is
  quarantined *on probation*: its lanes back off (exponentially in the
  strike count) and re-probe instead of dying outright, so a transient
  outage heals; only a host failing its ``max_probes`` probes too is
  quarantined permanently, its lanes retire, and the scheduler's normal
  retry re-dispatches the failed attempts onto a surviving host.  When
  every host goes down, queued work fails with a structured
  ``AllHostsQuarantinedError`` carrying each host's last failure cause.
* ``BatchWorkerPool`` — the paper's single-cluster-job technique:
  ``take`` claims up to ``nnodes × ppnode`` ready tasks as one group,
  renders a SLURM/PBS submission script that runs the whole group
  inside ONE allocation (each member writes ``<i>.rc``/``<i>.out``/
  ``<i>.err`` to a spool directory), submits it through a pluggable
  submitter (``SchedulerSubmitter`` → real ``sbatch``/``qsub``;
  ``LocalSubmitter`` → runs the script with ``sh`` locally), and polls
  the spool for completion, surfacing one ``CompletionEvent`` per
  group.

Both pools implement ``cancel(token)`` (called by the scheduler when a
speculative duplicate loses the race or a dispatch expires), killing
the remote process / batch job so the *backend* resource is released,
not just the scheduler slot.

Failure taxonomy: a task's nonzero exit is data (a ``ShellResult``
classified by the scheduler, same as local pools); ``TransportError``
is a *host-level* fault (host unreachable / allocation lost) that
fails the attempt and quarantines the host.
"""
from __future__ import annotations

import dataclasses
import queue
import re
import shlex
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Callable, Mapping, Sequence, TYPE_CHECKING

from . import chaos as _chaos
from . import telemetry as _telemetry
from .dag import TaskNode
from .locklint import make_lock
from .executors import (
    CompletionEvent, Runner, ShellResult, WorkerPool, merged_env,
    run_subprocess,
)

if TYPE_CHECKING:  # pragma: no cover
    from .dag import TaskDAG

#: renders one node to its shell form: ``node -> (command | None, env)``.
RenderFn = Callable[[TaskNode], "tuple[str | None, dict[str, str]]"]

_CANCELLED = "cancelled: dispatch abandoned by scheduler"


class TransportError(RuntimeError):
    """Host-level failure (unreachable, ssh refused, allocation lost) —
    distinct from a task's own nonzero exit, which is data."""


class AllHostsQuarantinedError(TransportError):
    """Every host in an ``SSHWorkerPool`` is permanently quarantined.

    Carries ``causes`` — host → the last transport failure that killed
    it — so callers (and the degraded-run report) see *why* the pool
    died, not just that it did.  ``str()`` keeps the historical
    ``no live hosts (all N quarantined)`` prefix."""

    def __init__(self, causes: Mapping[str, str]) -> None:
        self.causes = dict(causes)
        detail = "; ".join(f"{h}: {c}"
                           for h, c in sorted(self.causes.items()))
        super().__init__(
            f"no live hosts (all {len(self.causes)} quarantined)"
            + (f" — {detail}" if detail else ""))


def parse_hosts(hosts: "str | Sequence[str]") -> list[str]:
    """Normalize a host list: comma-separated string or sequence."""
    if isinstance(hosts, str):
        hosts = hosts.split(",")
    out = [str(h).strip() for h in hosts if str(h).strip()]
    if not out:
        raise ValueError("empty host list")
    return out


def node_command(render: RenderFn | None, node: TaskNode
                 ) -> tuple[str | None, dict[str, str]]:
    """A node's shell form: the study's render fn when provided, else
    the ``command``/``environ`` keys of the node payload."""
    if render is not None:
        return render(node)
    payload = node.payload if isinstance(node.payload, Mapping) else {}
    cmd = payload.get("command")
    env = payload.get("environ") or {}
    return (str(cmd) if cmd else None), {k: str(v) for k, v in env.items()}


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------


class RemoteProcess:
    """One in-flight remote command: ``wait`` returns its ShellResult;
    ``kill`` releases the underlying resource early (cancellation)."""

    def wait(self, timeout: float | None = None) -> ShellResult:
        raise NotImplementedError

    def kill(self) -> None:  # pragma: no cover - interface default
        pass


class _PopenProcess(RemoteProcess):
    def __init__(self, popen: subprocess.Popen, t0: float,
                 ssh: bool = False, host: str = "") -> None:
        self._popen = popen
        self._t0 = t0
        self._ssh = ssh
        self._host = host

    def wait(self, timeout: float | None = None) -> ShellResult:
        try:
            out, err = self._popen.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            out, err = self._popen.communicate()
            raise
        rc = self._popen.returncode
        runtime = time.monotonic() - self._t0
        # ssh reserves exit 255 for its own (connection-level) failures
        if self._ssh and rc == 255:
            raise TransportError(
                f"ssh to {self._host} failed: {(err or '').strip()[-500:]}")
        return ShellResult(rc, out or "", err or "", runtime)

    def kill(self) -> None:
        try:
            self._popen.kill()
        except OSError:  # pragma: no cover - already gone
            pass


class _HookProcess(RemoteProcess):
    """Runs a test hook in the waiting worker thread."""

    def __init__(self, hook: Callable[[], ShellResult], t0: float) -> None:
        self._hook = hook
        self._t0 = t0
        self.killed = threading.Event()

    def wait(self, timeout: float | None = None) -> ShellResult:
        res = self._hook()
        return dataclasses.replace(res, runtime=time.monotonic() - self._t0)

    def kill(self) -> None:
        self.killed.set()


class Transport:
    """Starts one command on one host.  ``start`` is called from the
    worker thread owning the host lane; it may block."""

    def start(self, host: str, command: str,
              env: Mapping[str, str] | None = None,
              cwd: str | None = None) -> RemoteProcess:
        raise NotImplementedError


class SSHTransport(Transport):
    """Real ``ssh`` subprocess transport.  Environment and cwd are
    inlined into the remote command (``export K=V; cd D && cmd``) so no
    server-side agent is required — the paper's portability constraint.
    """

    def __init__(self, ssh_command: Sequence[str] = ("ssh",),
                 options: Sequence[str] = ("-oBatchMode=yes",
                                           "-oStrictHostKeyChecking=accept-new")
                 ) -> None:
        self.ssh_command = list(ssh_command)
        self.options = list(options)

    @staticmethod
    def remote_command(command: str, env: Mapping[str, str] | None,
                       cwd: str | None) -> str:
        parts = [f"export {k}={shlex.quote(str(v))};"
                 for k, v in (env or {}).items()]
        if cwd:
            parts.append(f"cd {shlex.quote(cwd)} &&")
        parts.append(command)
        return " ".join(parts)

    def start(self, host: str, command: str,
              env: Mapping[str, str] | None = None,
              cwd: str | None = None) -> RemoteProcess:
        argv = [*self.ssh_command, *self.options, host,
                self.remote_command(command, env, cwd)]
        t0 = time.monotonic()
        try:
            popen = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        except OSError as e:  # ssh binary missing / unspawnable
            raise TransportError(f"cannot spawn ssh for {host}: {e}") from e
        return _PopenProcess(popen, t0, ssh=True, host=host)


class LocalTransport(Transport):
    """In-process fake transport: "hosts" are labels; commands run on
    the local machine via ``sh -c``.  Tests and CI exercise the full
    remote code path (slot accounting, host identity, quarantine,
    cancellation) with zero network dependency.

    Knobs for tests:

    * ``fail_hosts`` — hosts that raise ``TransportError`` on dispatch
      (connection-refused simulation; may be mutated while running).
    * ``hook(host, command) -> ShellResult | None`` — when it returns a
      result, no subprocess is spawned; the hook runs *in the worker
      thread*, so it may sleep/block to script completion order.
    """

    def __init__(self, fail_hosts: Sequence[str] = (),
                 hook: Callable[[str, str], "ShellResult | None"] | None = None
                 ) -> None:
        self.fail_hosts = set(fail_hosts)
        self.hook = hook

    def start(self, host: str, command: str,
              env: Mapping[str, str] | None = None,
              cwd: str | None = None) -> RemoteProcess:
        ctrl = _chaos.current()
        if ctrl is not None:
            act = ctrl.host_action(host)
            if act is not None:
                kind, delay = act
                if kind == "hang_host":
                    # stall the dispatch (trips task timeouts); runs on
                    # the worker thread, never the event loop
                    time.sleep(delay)
                else:
                    raise TransportError(
                        f"host {host} unreachable (chaos)")
        if host in self.fail_hosts:
            raise TransportError(f"host {host} unreachable (injected)")
        t0 = time.monotonic()
        if self.hook is not None:
            hook, h, c = self.hook, host, command

            def run() -> ShellResult:
                res = hook(h, c)
                if res is not None:
                    return res
                return _local_shell(c, env, cwd)

            return _HookProcess(run, t0)
        popen = subprocess.Popen(["sh", "-c", command],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True,
                                 env=merged_env(env), cwd=cwd)
        return _PopenProcess(popen, t0)


def _local_shell(command: str, env: Mapping[str, str] | None,
                 cwd: str | None) -> ShellResult:
    return run_subprocess(command, env=env, cwd=cwd, shell=True)


# ---------------------------------------------------------------------------
# SSH pool
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _RemoteDispatch:
    token: int
    runner: Runner | None
    nodes: list[TaskNode]


class SSHWorkerPool(WorkerPool):
    """``hosts × ppnode`` execution slots, one worker thread per host
    lane, dispatching rendered shell commands over a ``Transport``.

    ``render`` maps a node to ``(command, env)`` — usually
    ``ParameterStudy.render_node``.  Without a render fn the node's
    payload ``command`` key is used; a node with neither fails its
    attempt with a clear error (registry callables cannot be shipped
    over ssh).

    Quarantine is probational: a host's first transport failure parks
    it for ``probation`` seconds (doubling per strike); the next
    dispatch after the backoff is its probe, and a success clears the
    strikes.  A host failing ``max_probes`` probes beyond the first
    strike joins ``dead_hosts`` permanently.  ``probation=0`` restores
    the legacy die-on-first-failure behavior.
    """

    kind = "ssh"

    def __init__(
        self,
        hosts: "str | Sequence[str]",
        ppnode: int = 1,
        transport: Transport | None = None,
        render: RenderFn | None = None,
        cwd: str | None = None,
        probation: float = 0.25,
        max_probes: int = 2,
    ) -> None:
        self.hosts = parse_hosts(hosts)
        if ppnode < 1:
            raise ValueError("ppnode must be >= 1")
        self.ppnode = ppnode
        self.slots = len(self.hosts) * ppnode
        self.transport = transport or SSHTransport()
        self.render = render
        self.cwd = cwd
        self.probation = max(0.0, float(probation))
        self.max_probes = max(0, int(max_probes))
        self._pending: "queue.Queue[_RemoteDispatch | None]" = queue.Queue()
        self._events: "queue.Queue[CompletionEvent]" = queue.Queue()
        self._lock = make_lock("ssh.pool")
        self._procs: dict[int, RemoteProcess] = {}
        self._cancelled: set[int] = set()
        self.dead_hosts: set[str] = set()
        #: host → probation expiry (monotonic); absent = not quarantined
        self.quarantine: dict[str, float] = {}
        #: host → last transport failure message (feeds the structured
        #: ``AllHostsQuarantinedError`` and the degraded-run report)
        self.host_causes: dict[str, str] = {}
        self._strikes: dict[str, int] = {}
        #: set when the pool drained with every host dead
        self.all_quarantined: AllHostsQuarantinedError | None = None
        self._live = self.slots
        self._shutdown = False
        # observability seam, captured before the lanes start (None
        # when disarmed — one identity check per dispatch)
        self._telemetry = _telemetry.current()
        self._threads = [
            threading.Thread(target=self._worker, args=(host, lane),
                             name=f"papas-ssh-{host}-{lane}", daemon=True)
            for host in self.hosts for lane in range(ppnode)
        ]
        for t in self._threads:
            t.start()

    # -- scheduler interface -------------------------------------------
    def submit(self, token: int, runner: Runner | None,
               nodes: Sequence[TaskNode]) -> None:
        self._pending.put(_RemoteDispatch(token, runner, list(nodes)))

    def next_event(self, timeout: float | None = None) -> CompletionEvent | None:
        with self._lock:
            no_workers = self._live == 0
        if no_workers:
            self._drain_pending()
        try:
            return self._events.get(timeout=timeout)
        except queue.Empty:
            return None

    def cancel(self, token: int) -> None:
        """Release the host slot held by an abandoned dispatch: kill its
        remote process so the owning lane frees up promptly."""
        with self._lock:
            self._cancelled.add(token)
            proc = self._procs.get(token)
        if proc is not None:
            proc.kill()

    def shutdown(self) -> None:
        self._shutdown = True
        for _ in self._threads:
            self._pending.put(None)
        with self._lock:
            procs = list(self._procs.values())
        for p in procs:
            p.kill()

    # -- worker machinery ----------------------------------------------
    def _run_node(self, token: int, host: str, node: TaskNode) -> Any:
        cmd, env = node_command(self.render, node)
        if cmd is None:
            raise RuntimeError(
                f"task {node.task!r} has no shell command; remote pools "
                "cannot ship in-process registry callables")
        payload = node.payload if isinstance(node.payload, Mapping) else {}
        timeout = payload.get("timeout")
        proc = self.transport.start(host, cmd, env=env, cwd=self.cwd)
        with self._lock:
            self._procs[token] = proc
        try:
            return proc.wait(float(timeout) if timeout else None)
        finally:
            with self._lock:
                self._procs.pop(token, None)

    def _worker(self, host: str, lane: int) -> None:
        try:
            while True:
                item = self._pending.get()
                if item is None:
                    return
                with self._lock:
                    host_dead = host in self.dead_hosts
                    until = self.quarantine.get(host)
                if host_dead:
                    self._pending.put(item)  # hand off to a live lane
                    return
                if until is not None:
                    now = time.monotonic()
                    if now < until:
                        # quarantined: hand the work back rather than
                        # dispatch into a known-bad host, and wait out
                        # the probation backoff in bounded naps so
                        # shutdown stays responsive
                        self._pending.put(item)
                        if self._shutdown:
                            return
                        time.sleep(min(until - now, 0.05))
                        continue
                    # backoff elapsed: this dispatch is the probe
                if item.token in self._cancelled:
                    self._emit(item, [None] * len(item.nodes),
                               [_CANCELLED] * len(item.nodes), host)
                    continue
                cause = self._run_dispatch(item, host, lane)
                if cause is not None and self._host_struck(host, cause):
                    return
        finally:
            with self._lock:
                self._live -= 1
                last = self._live == 0
            if last and not self._shutdown:
                self._drain_pending()

    def _host_struck(self, host: str, cause: str) -> bool:
        """Record one transport failure on ``host``.  Under probation
        the host backs off ``probation × 2**(strikes-1)`` seconds and
        is re-probed, up to ``max_probes`` probes; past that (or with
        probation disabled) it dies permanently.  True → this lane
        should retire."""
        with self._lock:
            strikes = self._strikes.get(host, 0) + 1
            self._strikes[host] = strikes
            self.host_causes[host] = cause
            retire = not (self.probation > 0 and strikes <= self.max_probes)
            if retire:
                self.quarantine.pop(host, None)
                self.dead_hosts.add(host)
            else:
                self.quarantine[host] = (
                    time.monotonic()
                    + self.probation * (2 ** min(strikes - 1, 16)))
        tel = self._telemetry
        if tel is not None:
            tel.metrics.counter("papas_host_strikes_total", host=host).inc()
            if retire:
                tel.metrics.counter("papas_hosts_dead_total").inc()
            else:
                tel.metrics.counter("papas_host_probes_total",
                                    host=host).inc()
        return retire

    def _host_recovered(self, host: str) -> None:
        """A successful dispatch on a previously-striking host: the
        probe passed, so quarantine and strikes clear."""
        recovered = False
        with self._lock:
            if host in self._strikes:
                self._strikes.pop(host, None)
                self.quarantine.pop(host, None)
                recovered = True
        if recovered and self._telemetry is not None:
            self._telemetry.metrics.counter(
                "papas_host_recoveries_total", host=host).inc()

    def _run_dispatch(self, item: _RemoteDispatch, host: str,
                      lane: int = 0) -> "str | None":
        """Run one dispatch on ``host``; a non-None return is the
        transport failure that means the host failed."""
        t0 = time.monotonic()
        values: list[Any] = []
        errors: list[str | None] = []
        cause: "str | None" = None
        ran_any = False
        for node in item.nodes:
            if cause is not None or item.token in self._cancelled:
                values.append(None)
                errors.append(_CANCELLED if cause is None
                              else f"host {host} failed earlier in batch")
                continue
            try:
                values.append(self._run_node(item.token, host, node))
                errors.append(None)
                ran_any = True
            except TransportError as e:
                values.append(None)
                errors.append(f"host {host} failed: {e}")
                cause = str(e)
            except Exception as e:  # noqa: BLE001 — fault isolation
                values.append(None)
                if item.token in self._cancelled:
                    errors.append(_CANCELLED)
                else:
                    errors.append(f"{type(e).__name__}: {e}")
                    ran_any = True
        if cause is None and ran_any:
            self._host_recovered(host)
        tel = self._telemetry
        if tel is not None:
            # one track per host lane: dispatches on a lane are
            # sequential, so the retroactive slice pair nests cleanly
            tel.trace.complete(
                f"host:{host}/{lane}",
                f"{item.nodes[0].task} x{len(item.nodes)}",
                t0, time.monotonic(), cat="host",
                args={"tasks": len(item.nodes),
                      "transport_failure": cause or ""})
        self._emit(item, values, errors, host, t0)
        return cause

    def _emit(self, item: _RemoteDispatch, values: list[Any],
              errors: list[str | None], host: str,
              t0: float | None = None) -> None:
        t1 = time.monotonic()
        self._events.put(CompletionEvent(
            item.token, values, errors, t0 if t0 is not None else t1, t1,
            host=host))

    def _drain_pending(self) -> None:
        """No live lanes remain: fail queued dispatches instead of
        leaving the scheduler blocked on events that can never come.
        The error is the structured ``AllHostsQuarantinedError`` —
        per-host causes included — stashed on ``all_quarantined`` for
        callers that want more than the message."""
        with self._lock:
            causes = {h: self.host_causes.get(h, "quarantined")
                      for h in self.hosts}
            exc = self.all_quarantined
            if exc is None:
                exc = self.all_quarantined = AllHostsQuarantinedError(
                    causes)
        msg = str(exc)
        while True:
            try:
                item = self._pending.get_nowait()
            except queue.Empty:
                return
            if item is None:
                continue
            n = len(item.nodes)
            now = time.monotonic()
            self._events.put(CompletionEvent(
                item.token, [None] * n, [msg] * n, now, now, host=None))


# ---------------------------------------------------------------------------
# Batch-scheduler pool (SLURM / PBS)
# ---------------------------------------------------------------------------

BATCH_KINDS = ("slurm", "pbs")


def render_batch_script(
    batch: str,
    *,
    job_name: str,
    nnodes: int,
    ppnode: int,
    entries: Sequence[tuple[str, "Mapping[str, str] | None"]],
    spool: "str | Path",
) -> str:
    """Render one submission script hosting a whole task group — the
    paper's "grouping intra/inter-workflow tasks as a single batch job".

    ``entries`` is the ordered ``(command, env)`` list; member *i*
    writes ``<spool>/<i>.out``/``.err`` and its exit code to
    ``<spool>/<i>.rc``.  The body is plain POSIX sh, so the same script
    runs under ``sbatch``, ``qsub``, or a bare ``sh`` (the test/CI fake
    submitter).
    """
    if batch not in BATCH_KINDS:
        raise ValueError(
            f"unknown batch kind {batch!r}; valid kinds: "
            + ", ".join(BATCH_KINDS))
    spool = str(spool)
    lines = ["#!/bin/sh"]
    if batch == "slurm":
        lines += [
            f"#SBATCH --job-name={job_name}",
            f"#SBATCH --nodes={nnodes}",
            f"#SBATCH --ntasks-per-node={ppnode}",
            f"#SBATCH --output={spool}/job.out",
            f"#SBATCH --error={spool}/job.err",
        ]
    else:
        lines += [
            f"#PBS -N {job_name}",
            f"#PBS -l nodes={nnodes}:ppn={ppnode}",
            f"#PBS -o {spool}/job.out",
            f"#PBS -e {spool}/job.err",
        ]
    lines += [
        "",
        f"# {len(entries)} tasks inside one {batch} allocation "
        f"({nnodes} nodes x {ppnode} procs)",
    ]
    for i, (command, env) in enumerate(entries):
        exports = " ".join(
            f"export {k}={shlex.quote(str(v))};" for k, v in (env or {}).items())
        body = f"{exports} {command}" if exports else command
        # outer subshell so the whole run-then-record unit backgrounds
        # (members of one allocation execute concurrently); the rc file
        # is written to a temp name then mv'd so the poller never reads
        # a created-but-not-yet-written file (NFS visibility races)
        lines.append(
            f"( ( {body} ) > {spool}/{i}.out 2> {spool}/{i}.err; "
            f"printf '%s' \"$?\" > {spool}/{i}.rc.tmp && "
            f"mv {spool}/{i}.rc.tmp {spool}/{i}.rc ) &")
    lines += ["wait", ""]
    return "\n".join(lines)


class Submitter:
    """Hands a rendered script to a queueing system."""

    def submit(self, script: Path) -> str:
        """Submit; returns the job id.  Raises TransportError on a
        submission-level failure."""
        raise NotImplementedError

    def cancel(self, job_id: str) -> None:  # pragma: no cover - default
        pass


class SchedulerSubmitter(Submitter):
    """Real ``sbatch`` / ``qsub`` submission."""

    _SPECS = {
        "slurm": (("sbatch",), ("scancel",), re.compile(r"(\d+)\s*$")),
        "pbs": (("qsub",), ("qdel",), re.compile(r"^\s*(\S+)")),
    }

    def __init__(self, batch: str = "slurm") -> None:
        if batch not in self._SPECS:
            raise ValueError(f"unknown batch kind {batch!r}")
        self.batch = batch
        self.submit_cmd, self.cancel_cmd, self.id_re = self._SPECS[batch]

    def submit(self, script: Path) -> str:
        try:
            proc = subprocess.run([*self.submit_cmd, str(script)],
                                  capture_output=True, text=True, check=False)
        except OSError as e:
            raise TransportError(
                f"cannot spawn {self.submit_cmd[0]}: {e}") from e
        if proc.returncode != 0:
            raise TransportError(
                f"{self.submit_cmd[0]} failed ({proc.returncode}): "
                f"{proc.stderr.strip()[-500:]}")
        m = self.id_re.search(proc.stdout.strip())
        if not m:
            raise TransportError(
                f"cannot parse job id from {proc.stdout.strip()!r}")
        return m.group(1)

    def cancel(self, job_id: str) -> None:
        subprocess.run([*self.cancel_cmd, job_id], capture_output=True,
                       check=False)


class LocalSubmitter(Submitter):
    """Fake submitter: runs the script with ``sh`` on this machine in
    the background — same spool protocol, no scheduler binary.

    Chaos seam: an armed plan's ``lose_job`` event makes ``submit``
    accept the script but never spawn it (the queue "lost" the job —
    its ``.rc`` files never appear and the batch deadline fires);
    ``dup_job`` spawns the script twice (a requeue raced the original
    — completion handling must stay idempotent)."""

    def __init__(self) -> None:
        self._procs: dict[str, subprocess.Popen] = {}
        self._dups: list[subprocess.Popen] = []
        self._n = 0

    def submit(self, script: Path) -> str:
        ctrl = _chaos.current()
        act = ctrl.job_action() if ctrl is not None else None
        self._n += 1
        if act == "lose_job":
            return f"local{self._n}.lost"
        popen = subprocess.Popen(["sh", str(script)],
                                 stdout=subprocess.DEVNULL,
                                 stderr=subprocess.DEVNULL)
        if act == "dup_job":
            self._dups.append(subprocess.Popen(
                ["sh", str(script)], stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL))
        job_id = f"local{self._n}.{popen.pid}"
        self._procs[job_id] = popen
        return job_id

    def cancel(self, job_id: str) -> None:
        popen = self._procs.get(job_id)
        if popen is not None and popen.poll() is None:
            popen.kill()


@dataclasses.dataclass
class _BatchJob:
    token: int
    job_id: str
    spool: Path
    nodes: list[TaskNode]
    submitted: float


class BatchWorkerPool(WorkerPool):
    """Grouped-allocation backend: one submitted job hosts up to
    ``nnodes × ppnode`` tasks (the group ``take`` claims), completion
    detected by polling the spool's per-task ``.rc`` files — which only
    needs the shared filesystem every batch cluster already has.

    A dispatch here is a whole allocation, so the scheduler drives
    ``max_allocations`` dispatch lanes (default 1 — the paper's single
    cluster job), NOT ``slots`` of them: that would submit
    ``nnodes × ppnode`` simultaneous jobs each requesting the full node
    budget."""

    kind = "batch"

    def __init__(
        self,
        batch: str = "slurm",
        nnodes: int = 1,
        ppnode: int = 1,
        render: RenderFn | None = None,
        submitter: Submitter | None = None,
        spool_root: "str | Path | None" = None,
        job_name: str = "papas",
        poll_interval: float = 0.05,
        max_allocations: int = 1,
    ) -> None:
        if batch not in BATCH_KINDS:
            raise ValueError(
                f"unknown batch kind {batch!r}; valid kinds: "
                + ", ".join(BATCH_KINDS))
        if nnodes < 1 or ppnode < 1 or max_allocations < 1:
            raise ValueError(
                "nnodes, ppnode, and max_allocations must be >= 1")
        self.batch = batch
        self.nnodes = nnodes
        self.ppnode = ppnode
        self.slots = nnodes * ppnode      # tasks per allocation (group size)
        self.max_allocations = max_allocations
        self.render = render
        self.submitter = submitter or SchedulerSubmitter(batch)
        if spool_root is None:
            import tempfile

            spool_root = tempfile.mkdtemp(prefix="papas-batch-")
        self.spool_root = Path(spool_root)
        self.job_name = job_name
        self.poll_interval = poll_interval
        self._jobs: dict[int, _BatchJob] = {}
        self._events: "queue.Queue[CompletionEvent]" = queue.Queue()

    @property
    def dispatch_slots(self) -> int:
        return self.max_allocations

    # -- scheduler interface -------------------------------------------
    def take(self, ready: list[str], dag: "TaskDAG") -> list[str]:
        group = ready[: self.slots]
        del ready[: len(group)]
        return group

    def submit(self, token: int, runner: Runner | None,
               nodes: Sequence[TaskNode]) -> None:
        nodes = list(nodes)
        spool = self.spool_root / f"job{token:05d}"
        spool.mkdir(parents=True, exist_ok=True)
        entries: list[tuple[str, Mapping[str, str] | None]] = []
        try:
            for node in nodes:
                cmd, env = node_command(self.render, node)
                if cmd is None:
                    raise RuntimeError(
                        f"task {node.task!r} has no shell command; batch "
                        "pools cannot ship in-process registry callables")
                entries.append((cmd, env))
            script = render_batch_script(
                self.batch, job_name=f"{self.job_name}-{token}",
                nnodes=self.nnodes, ppnode=self.ppnode, entries=entries,
                spool=spool)
            path = spool / "job.sh"
            path.write_text(script)
            path.chmod(0o755)
            job_id = self.submitter.submit(path)
        except Exception as e:  # noqa: BLE001 — submission failure = attempt failure
            now = time.monotonic()
            msg = f"{type(e).__name__}: {e}"
            self._events.put(CompletionEvent(
                token, [None] * len(nodes), [msg] * len(nodes), now, now,
                host=None))
            return
        self._jobs[token] = _BatchJob(token, job_id, spool, nodes,
                                      time.monotonic())

    def next_event(self, timeout: float | None = None) -> CompletionEvent | None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return self._events.get_nowait()
            except queue.Empty:
                pass
            ev = self._poll_jobs()
            if ev is not None:
                return ev
            if not self._jobs and deadline is None:
                return None     # nothing submitted: don't block forever
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(self.poll_interval)

    def cancel(self, token: int) -> None:
        """Cancel the whole allocation and synthesize its completion so
        the scheduler's slot bookkeeping resolves immediately."""
        job = self._jobs.pop(token, None)
        if job is None:
            return
        self.submitter.cancel(job.job_id)
        now = time.monotonic()
        n = len(job.nodes)
        self._events.put(CompletionEvent(
            token, [None] * n, [_CANCELLED] * n, job.submitted, now,
            host=f"{self.batch}:{job.job_id}"))

    def shutdown(self) -> None:
        for token in list(self._jobs):
            job = self._jobs.pop(token)
            self.submitter.cancel(job.job_id)

    # -- internals ------------------------------------------------------
    def _poll_jobs(self) -> CompletionEvent | None:
        for token, job in list(self._jobs.items()):
            rcs = [job.spool / f"{i}.rc" for i in range(len(job.nodes))]
            if not all(p.exists() for p in rcs):
                continue
            del self._jobs[token]
            finished = time.monotonic()
            elapsed = finished - job.submitted
            values: list[Any] = []
            errors: list[str | None] = []
            for i, rc_path in enumerate(rcs):
                try:
                    rc = int(rc_path.read_text().strip() or "1")
                except ValueError:
                    rc = 1
                out = _read_or_empty(job.spool / f"{i}.out")
                err = _read_or_empty(job.spool / f"{i}.err")
                values.append(ShellResult(rc, out, err, elapsed))
                errors.append(None)     # scheduler classifies the rc
            return CompletionEvent(
                token, values, errors, job.submitted, finished,
                host=f"{self.batch}:{job.job_id}")
        return None


def _read_or_empty(path: Path) -> str:
    try:
        return path.read_text()
    except OSError:
        return ""
