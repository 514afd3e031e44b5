"""Lock-order auditor for the engine's concurrent hot path.

The scheduler event loop itself is single-threaded, but the code around
it is not: the lane-mux front-end thread, per-host SSH worker threads,
gang waiters on a ``Condition``, and the journal/provenance group-commit
writers all synchronize on a handful of named locks.  A deadlock there
is a *lock-order* bug — two threads acquiring the same pair of locks in
opposite orders — and exactly the class of defect that only surfaces
under production load, never in a quick local run.

This module applies the same rule-engine discipline ``repro_torch.core.lint``
applies to studies to the engine itself:

* ``make_lock(name)`` is the factory every engine lock goes through.
  By default it returns a plain ``threading.Lock`` — zero overhead on
  the dispatch hot path.  With ``PAPAS_LOCKLINT=1`` in the environment
  (checked at lock *creation* time) it returns an
  :class:`InstrumentedLock` that reports every acquisition to the
  process-wide :class:`LockOrderAuditor`.
* The auditor maintains the **acquisition-order graph**: a directed
  edge ``A → B`` means some thread acquired ``B`` while holding ``A``.
  A cycle in that graph is a potential deadlock (threads could
  interleave the two orders); ``cycles()`` reports them and
  ``assert_no_cycles()`` raises :class:`LockOrderError`.
* With ``PAPAS_LOCKLINT_OUT=<path>`` the report is additionally written
  as JSON at interpreter exit — the CI concurrency smoke runs the
  lane-mux and group-commit suites under both variables and fails the
  gate on any cycle (see ``scripts/ci.sh``).

``InstrumentedLock`` is duck-type compatible with ``threading.Lock``
including use as the lock of a ``threading.Condition`` (the gang
coordination path): ``Condition`` only needs ``acquire``/``release``,
and the default ``_is_owned`` probe's try-acquire shows up as a
balanced acquire/release pair in the trace.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
from typing import Any

__all__ = [
    "InstrumentedLock",
    "LockOrderAuditor",
    "LockOrderError",
    "enabled",
    "get_auditor",
    "make_lock",
]


class LockOrderError(RuntimeError):
    """Raised by ``assert_no_cycles`` when the acquisition-order graph
    contains a cycle (a potential deadlock)."""


class LockOrderAuditor:
    """Process-wide acquisition-order recorder.

    State is tiny — a set of lock names and a set of ordered name pairs
    with occurrence counts — so auditing a 10^4-task run costs one dict
    update per acquisition.  The per-thread held stack lives in
    thread-local storage; the auditor's own mutex is a *plain* lock and
    is always a leaf (nothing is acquired under it), so the auditor can
    never introduce the deadlocks it hunts.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._tls = threading.local()
        #: (held name, acquired name) → times observed
        self.edges: dict[tuple[str, str], int] = {}
        self.locks: set[str] = set()
        self.n_acquisitions = 0

    # -- per-thread held stack -----------------------------------------
    def _held(self) -> list[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    # -- instrumentation callbacks -------------------------------------
    def note_acquire(self, name: str) -> None:
        held = self._held()
        with self._mu:
            self.locks.add(name)
            self.n_acquisitions += 1
            for h in held:
                if h != name:
                    edge = (h, name)
                    self.edges[edge] = self.edges.get(edge, 0) + 1
        held.append(name)

    def note_release(self, name: str) -> None:
        held = self._held()
        # release order need not be LIFO (Condition.wait, hand-over-hand)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break

    # -- analysis -------------------------------------------------------
    def cycles(self) -> list[list[str]]:
        """Every elementary cycle root found by DFS over the name graph
        (each reported once, rotated to start at its smallest name)."""
        adj: dict[str, list[str]] = {}
        for a, b in self.edges:
            adj.setdefault(a, []).append(b)
        seen_cycles: set[tuple[str, ...]] = set()
        out: list[list[str]] = []
        visited: set[str] = set()

        def dfs(node: str, stack: list[str], on_stack: set[str]) -> None:
            visited.add(node)
            stack.append(node)
            on_stack.add(node)
            for nxt in adj.get(node, ()):
                if nxt in on_stack:
                    cyc = stack[stack.index(nxt):]
                    k = min(range(len(cyc)), key=lambda i: cyc[i])
                    canon = tuple(cyc[k:] + cyc[:k])
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        out.append(list(canon))
                elif nxt not in visited:
                    dfs(nxt, stack, on_stack)
            stack.pop()
            on_stack.discard(node)

        for root in sorted(adj):
            if root not in visited:
                dfs(root, [], set())
        return out

    def report(self) -> dict[str, Any]:
        """The acquisition-order graph as a JSON-friendly document."""
        with self._mu:
            edges = sorted(self.edges.items())
            locks = sorted(self.locks)
            n = self.n_acquisitions
        return {
            "locks": locks,
            "n_acquisitions": n,
            "edges": [{"from": a, "to": b, "count": c}
                      for (a, b), c in edges],
            "cycles": self.cycles(),
        }

    def assert_no_cycles(self) -> None:
        cycles = self.cycles()
        if cycles:
            raise LockOrderError(
                f"lock acquisition-order cycle(s) detected — potential "
                f"deadlock: {[' -> '.join(c + [c[0]]) for c in cycles]}")

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self.locks.clear()
            self.n_acquisitions = 0


_AUDITOR = LockOrderAuditor()


def get_auditor() -> LockOrderAuditor:
    """The process-wide auditor (shared by every instrumented lock)."""
    return _AUDITOR


def enabled() -> bool:
    """True when ``PAPAS_LOCKLINT`` asks for instrumented locks."""
    return os.environ.get("PAPAS_LOCKLINT", "") not in ("", "0")


class InstrumentedLock:
    """A ``threading.Lock`` wrapper reporting to the auditor.

    Compatible wherever the engine uses a plain lock: ``with`` blocks,
    explicit ``acquire``/``release``, and as the backing lock of a
    ``threading.Condition``.
    """

    __slots__ = ("name", "_lock", "_auditor")

    def __init__(self, name: str,
                 auditor: LockOrderAuditor | None = None) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._auditor = auditor if auditor is not None else _AUDITOR

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._auditor.note_acquire(self.name)
        return ok

    def release(self) -> None:
        self._auditor.note_release(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:    # pragma: no cover - debugging aid
        state = "locked" if self._lock.locked() else "unlocked"
        return f"<InstrumentedLock {self.name!r} {state}>"


_atexit_registered = False


def _write_report_atexit() -> None:    # pragma: no cover - exit hook
    out = os.environ.get("PAPAS_LOCKLINT_OUT")
    if not out:
        return
    try:
        with open(out, "w") as f:
            json.dump(_AUDITOR.report(), f, indent=2, sort_keys=True)
    except OSError:
        pass


def make_lock(name: str) -> "threading.Lock | InstrumentedLock":
    """The engine's lock factory: a plain ``threading.Lock`` normally,
    an :class:`InstrumentedLock` reporting to the process auditor when
    ``PAPAS_LOCKLINT=1`` (checked now, at creation time — a pool or
    journal built after flipping the variable is instrumented, existing
    locks are not)."""
    global _atexit_registered
    if not enabled():
        return threading.Lock()
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(_write_report_atexit)
    return InstrumentedLock(name, _AUDITOR)
