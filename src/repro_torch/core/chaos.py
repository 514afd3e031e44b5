"""Deterministic, seeded fault injection over the engine's backend seams.

A study that only ever runs on a quiet laptop never exercises the
recovery paths the paper promises for multi-tenant clusters (§4.3, §9):
scheduler retries, SSH host quarantine + probation, lane respawn,
journal-v2 crash resume.  This module makes those paths *drivable*: a
``FaultPlan`` is an ordered list of addressable ``FaultEvent``\\ s, each
naming a seam, a trigger count, and a firing budget, and a
``ChaosController`` built from the plan answers the seams' questions
("should this lane die now?", "is this host reachable?") fully
deterministically — same plan, same study, same faults, every run.

Seams (all pre-existing; chaos only *answers*, never reaches in):

========= =============================================================
kind      injection point
========= =============================================================
``kill_lane``        ``executors.LaneWorkerPool._pump`` — SIGKILL the
                     lane's shell after *after* completed frames; the
                     pool's own death path harvests, respawns, and the
                     scheduler retries the charged head.
``fail_host``        ``remote.LocalTransport.start`` — raise
                     ``TransportError`` for the named host, feeding
                     ``SSHWorkerPool`` quarantine + probation.
``hang_host``        ``remote.LocalTransport.start`` — sleep ``delay``
                     seconds before dispatch, tripping task timeouts.
``lose_job``         ``remote.LocalSubmitter.submit`` — accept the
                     script but never spawn it; the batch deadline
                     expires and the scheduler retries.
``dup_job``          ``remote.LocalSubmitter.submit`` — spawn the
                     rendered script twice; completion handling must
                     stay idempotent.
``sigkill``          ``study._on_result`` — SIGKILL *this* process
                     after *after* recorded completions; resume must
                     replay to the exact pre-crash record set.
``truncate_segment`` applied to files (not a live seam): tear the tail
                     of a sharded ``*.s<k>`` append segment, the shape
                     a crash mid-``write()`` leaves behind.
========= =============================================================

Zero overhead when disabled — the same contract as ``locklint``'s
``make_lock``: pools capture ``chaos.current()`` at construction (one
``None`` attribute), transports consult it per dispatch (never the hot
frame path).  With no plan armed, ``current()`` is ``None`` and every
seam costs one identity check.

Arming: pass ``run(chaos=plan_or_path)``, ``--chaos plan.yaml`` on the
launchers, or set ``PAPAS_CHAOS=plan.yaml`` in the environment (checked
once, lazily).  Every fired fault lands in the controller's
``FaultLedger``; ``ParameterStudy`` attaches it to ``study.json`` so a
degraded run carries its own forensics.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Iterable, Iterator, Mapping

from . import telemetry as _telemetry

__all__ = ["FAULT_KINDS", "FaultEvent", "FaultPlan", "FaultLedger",
           "ChaosController", "current", "install", "activated",
           "truncate_tail", "record_fingerprint"]

FAULT_KINDS = ("kill_lane", "fail_host", "hang_host", "lose_job",
               "dup_job", "sigkill", "truncate_segment")


@dataclasses.dataclass
class FaultEvent:
    """One addressable fault: fire ``times`` times once the seam's
    trigger counter passes ``after``.

    ``after`` counts seam-specific units: completed frames per lane
    (``kill_lane``), dispatches per host (``fail_host``/``hang_host``),
    submitted jobs (``lose_job``/``dup_job``), recorded completions
    (``sigkill``).  ``lane``/``host`` of ``None`` match any target.
    A bounded ``times`` is what makes probation observable: a host that
    fails twice and then answers its probe has recovered."""

    kind: str
    after: int = 0
    times: int = 1
    lane: int | None = None
    host: str | None = None
    delay: float = 0.25          # hang_host: seconds to stall dispatch
    glob: str = "*.s*"           # truncate_segment: file pattern
    nbytes: int | None = None    # truncate_segment: bytes to tear off

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} "
                f"(valid: {', '.join(FAULT_KINDS)})")
        if self.after < 0 or self.times < 1:
            raise ValueError(
                f"fault {self.kind}: after must be >= 0 and times >= 1")

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"kind": self.kind}
        for f in dataclasses.fields(self):
            if f.name == "kind":
                continue
            v = getattr(self, f.name)
            if v != f.default:
                out[f.name] = v
        return out


class FaultLedger:
    """Thread-safe record of every fault actually fired — the run's
    forensics, attached to ``study.json`` when the study degrades."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: list[dict[str, Any]] = []

    def record(self, kind: str, target: str, at: int) -> None:
        with self._lock:
            self._entries.append(
                {"n": len(self._entries) + 1, "fault": kind,
                 "target": target, "at": at})
        tel = _telemetry.current()
        if tel is not None:
            # chaos firings surface in the trace as instant events on a
            # dedicated track, and as a labeled counter family
            tel.trace.instant("chaos", f"{kind}:{target}",
                              time.monotonic(), cat="chaos",
                              args={"at": at})
            tel.metrics.counter("papas_faults_total", kind=kind).inc()

    def as_list(self) -> list[dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._entries]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


@dataclasses.dataclass
class FaultPlan:
    """A seeded, ordered set of fault events.

    Load one from YAML (``--chaos plan.yaml``)::

        name: lane-kill
        seed: 7
        events:
          - kind: kill_lane
            lane: 0
            after: 3
            times: 2

    or build one in code and pass it to ``ParameterStudy.run(chaos=…)``.
    ``seed`` drives nothing at injection time (events are exhaustively
    deterministic); it names the plan for ``generate()`` and the ledger.
    """

    events: list[FaultEvent] = dataclasses.field(default_factory=list)
    seed: int = 0
    name: str = ""

    @classmethod
    def from_dict(cls, doc: Any) -> "FaultPlan":
        if isinstance(doc, list):
            doc = {"events": doc}
        if not isinstance(doc, Mapping):
            raise ValueError("fault plan must be a mapping or a list "
                             "of events")
        events = []
        for i, ev in enumerate(doc.get("events") or []):
            if not isinstance(ev, Mapping):
                raise ValueError(f"fault plan event #{i + 1}: expected "
                                 f"a mapping, got {type(ev).__name__}")
            known = {f.name for f in dataclasses.fields(FaultEvent)}
            bad = sorted(set(ev) - known)
            if bad:
                raise ValueError(f"fault plan event #{i + 1}: unknown "
                                 f"key(s) {', '.join(bad)}")
            events.append(FaultEvent(**dict(ev)))
        return cls(events=events, seed=int(doc.get("seed", 0)),
                   name=str(doc.get("name", "")))

    @classmethod
    def load(cls, path: str | Path) -> "FaultPlan":
        from .wdl import load_yaml
        doc = load_yaml(Path(path).read_text(), filename=str(path))
        plan = cls.from_dict(doc)
        if not plan.name:
            plan.name = Path(path).stem
        return plan

    @classmethod
    def generate(cls, seed: int, lanes: int = 2,
                 hosts: Iterable[str] = (),
                 max_events: int = 3) -> "FaultPlan":
        """A random-but-reproducible plan for property tests: any two
        calls with the same arguments yield the identical plan."""
        rng = random.Random(seed)
        hosts = list(hosts)
        kinds = ["kill_lane"] if lanes else []
        if hosts:
            kinds += ["fail_host", "hang_host"]
        events = []
        for _ in range(rng.randint(1, max(1, max_events))):
            kind = rng.choice(kinds)
            if kind == "kill_lane":
                events.append(FaultEvent(
                    "kill_lane", lane=rng.randrange(lanes),
                    after=rng.randint(1, 5), times=rng.randint(1, 2)))
            elif kind == "fail_host":
                events.append(FaultEvent(
                    "fail_host", host=rng.choice(hosts),
                    after=rng.randint(0, 4), times=rng.randint(1, 2)))
            else:
                events.append(FaultEvent(
                    "hang_host", host=rng.choice(hosts),
                    after=rng.randint(0, 4), delay=0.02))
        return cls(events=events, seed=seed, name=f"generated-{seed}")

    def to_dict(self) -> dict[str, Any]:
        return {"name": self.name, "seed": self.seed,
                "events": [e.to_dict() for e in self.events]}

    def controller(self) -> "ChaosController":
        return ChaosController(self)


class ChaosController:
    """Answers the seams' questions for one plan, counting triggers and
    firing each event at most ``times`` times.  All seam methods are
    thread-safe (the lane mux, SSH worker threads, and the event loop
    all consult the same controller)."""

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self.ledger = FaultLedger()
        self._lock = threading.Lock()
        self._fired = [0] * len(plan.events)
        self._frames: dict[int, int] = {}      # lane idx → frames seen
        self._dispatches: dict[str, int] = {}  # host → dispatches seen
        self._jobs = 0                         # batch submissions seen
        self._records = 0                      # completions recorded

    def _match(self, kinds: tuple[str, ...], count: int,
               field: str | None = None,
               target: Any = None) -> FaultEvent | None:
        """First unexhausted event of a kind in ``kinds`` whose address
        matches ``target`` and whose trigger ``after`` has passed."""
        for i, ev in enumerate(self.plan.events):
            if ev.kind not in kinds or self._fired[i] >= ev.times:
                continue
            if field is not None:
                addr = getattr(ev, field)
                if addr is not None and addr != target:
                    continue
            if count > ev.after:
                self._fired[i] += 1
                return ev
        return None

    # -- seams -------------------------------------------------------------
    def lane_frame(self, lane: int) -> bool:
        """LaneWorkerPool._pump: one completed frame on ``lane``.
        True → kill this lane's worker now."""
        with self._lock:
            n = self._frames.get(lane, 0) + 1
            self._frames[lane] = n
            ev = self._match(("kill_lane",), n, "lane", lane)
            if ev is not None:
                self.ledger.record("kill_lane", f"lane{lane}", n)
                return True
        return False

    def host_action(self, host: str) -> tuple[str, float] | None:
        """LocalTransport.start: one dispatch bound for ``host``.
        Returns ``("fail_host", 0)`` (raise TransportError),
        ``("hang_host", delay)`` (stall), or None."""
        with self._lock:
            n = self._dispatches.get(host, 0) + 1
            self._dispatches[host] = n
            ev = self._match(("fail_host", "hang_host"), n, "host", host)
            if ev is not None:
                self.ledger.record(ev.kind, host, n)
                return (ev.kind, ev.delay)
        return None

    def job_action(self) -> str | None:
        """LocalSubmitter.submit: one batch submission.  Returns
        ``"lose_job"`` (never spawn), ``"dup_job"`` (spawn twice), or
        None."""
        with self._lock:
            self._jobs += 1
            ev = self._match(("lose_job", "dup_job"), self._jobs)
            if ev is not None:
                self.ledger.record(ev.kind, f"job{self._jobs}",
                                   self._jobs)
                return ev.kind
        return None

    def on_record(self) -> None:
        """study._on_result: one completion recorded.  A matching
        ``sigkill`` event kills this process dead — no cleanup, no
        flush — exactly the crash journal resume must survive."""
        with self._lock:
            self._records += 1
            ev = self._match(("sigkill",), self._records)
        if ev is not None:
            os.kill(os.getpid(), signal.SIGKILL)

    def apply_file_faults(self, root: str | Path) -> list[Path]:
        """Fire every pending ``truncate_segment`` event against files
        under ``root`` (deterministic pick among glob matches).  Called
        by the harness after a crash, before resume — a live process
        never tears its own files."""
        root = Path(root)
        torn: list[Path] = []
        with self._lock:
            for i, ev in enumerate(self.plan.events):
                if (ev.kind != "truncate_segment"
                        or self._fired[i] >= ev.times):
                    continue
                matches = sorted(p for p in root.rglob(ev.glob)
                                 if p.is_file() and p.stat().st_size)
                if not matches:
                    continue
                rng = random.Random(f"{self.plan.seed}#{i}")
                for _ in range(ev.times - self._fired[i]):
                    p = matches[rng.randrange(len(matches))]
                    if truncate_tail(p, ev.nbytes):
                        self._fired[i] += 1
                        torn.append(p)
                        self.ledger.record("truncate_segment", str(p),
                                           p.stat().st_size)
        return torn


def truncate_tail(path: str | Path, nbytes: int | None = None) -> bool:
    """Tear the file's tail the way a crash mid-``write()`` does: drop
    the trailing newline plus ``nbytes`` bytes (default: half of the
    final line), leaving a syntactically torn last record."""
    path = Path(path)
    data = path.read_bytes()
    body = data.rstrip(b"\n")
    if not body:
        return False
    last_line_len = len(body) - (body.rfind(b"\n") + 1)
    cut = nbytes if nbytes is not None else max(1, last_line_len // 2)
    cut = min(cut, len(body))
    path.write_bytes(body[:-cut] if cut else body)
    return True


def record_fingerprint(records: Iterable[Mapping[str, Any]]) -> list[str]:
    """Canonical latest-ok-wins projection of a record stream: one
    sorted ``task_id|combo-json`` line per succeeded task.  Volatile
    fields (timestamps, runtimes, hosts, attempt counts) are excluded,
    so a chaos run and its fault-free twin compare byte-for-byte."""
    latest: dict[str, str] = {}
    for r in records:
        if r.get("status") == "ok":
            latest[str(r.get("task_id"))] = json.dumps(
                r.get("combo"), sort_keys=True, separators=(",", ":"))
    return sorted(f"{tid}|{combo}" for tid, combo in latest.items())


# -- module arming (the make_lock pattern) --------------------------------
_controller: ChaosController | None = None
_env_checked = False


def current() -> ChaosController | None:
    """The armed controller, or None.  ``PAPAS_CHAOS=plan.yaml`` in the
    environment arms one lazily (checked once); otherwise only
    ``install``/``activated`` arm.  Pools capture this at construction,
    so a disabled run pays one attribute load per seam — nothing on the
    frame hot path."""
    global _controller, _env_checked
    if _controller is None and not _env_checked:
        _env_checked = True
        path = os.environ.get("PAPAS_CHAOS")
        if path:
            _controller = FaultPlan.load(path).controller()
    return _controller


def install(ctrl: ChaosController | None) -> None:
    """Arm (or disarm, with None) the process-wide controller."""
    global _controller
    _controller = ctrl


@contextmanager
def activated(ctrl: ChaosController) -> Iterator[ChaosController]:
    """Arm ``ctrl`` for the duration of the block, restoring whatever
    was armed before."""
    prev = _controller
    install(ctrl)
    try:
        yield ctrl
    finally:
        install(prev)
