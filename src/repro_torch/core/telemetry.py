"""Zero-cost-when-disarmed observability: spans, metrics, live status.

The engine is fast enough (10^4 tasks/s) that *observing* it becomes
the interesting problem: where does slot time go, how does the adaptive
batch ramp, when does a retry storm start?  This module answers with
three pillars, all riding the seam pattern the chaos harness
established — components capture :func:`current` once at construction,
and that seam is ``None`` unless the run was armed, so the disarmed
engine pays one identity check per seam and nothing else.

* **Task-lifecycle spans** (:class:`TraceCollector`) — the scheduler
  emits a slice per dispatch on a per-slot track (retry and speculative
  attempts are further slices on the same track, flagged in ``args``),
  the lane pool a slice per frame on a per-lane track, the SSH pool a
  slice per remote batch on a per-``host/lane`` track, and the
  group-commit writers a slice per flush.  Retry backoff waits are
  async slices; chaos ``FaultLedger`` firings are instant events.
  ``trace.json`` serializes the run in Chrome trace-event format —
  open it at https://ui.perfetto.dev or ``chrome://tracing``.  Track
  ids are assigned per track *name*, so a respawned lane keeps its tid.

* **Metrics** (:class:`MetricsRegistry`) — O(1) streaming counters,
  gauges, and histograms (quantiles via
  :class:`~repro_torch.core.stats.StreamingQuantile`): dispatches, slot
  occupancy, ready-queue depth, adaptive batch size, retry classes
  from ``classify_failure``, quarantine strikes/probes, group-commit
  appends/flushes per shard, lane respawns.  The end-of-run snapshot
  lands in ``study.json`` under ``telemetry``;
  :meth:`MetricsRegistry.prometheus` renders text exposition format.

* **Live status** (:meth:`Telemetry.status` / :meth:`Telemetry.serve`)
  — an in-place TTY progress line (``sweep.py --status``) with tasks/s
  and an ETA from the streaming median runtime, and a stdlib
  ``http.server`` thread (``sweep.py --metrics-port N``) serving
  ``/metrics`` (Prometheus) and ``/status`` (JSON) — the seam a
  future study service grows into.

Arm a run with ``ParameterStudy.run(trace=...)``, ``sweep.py
--trace``, or ``PAPAS_TRACE=1`` (or ``PAPAS_TRACE=/path/trace.json``)
in the environment.  Emission uses explicit caller-supplied timestamps
(the scheduler passes its own ``clock()`` readings), so traces from
``VirtualClock`` runs carry exact virtual timings.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Iterator, TextIO

from .stats import StreamingQuantile

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Telemetry",
    "TraceCollector",
    "activated",
    "current",
    "install",
]


# ---------------------------------------------------------------------------
# metrics registry


def _full_name(name: str, labels: dict[str, Any]) -> str:
    """Prometheus-style series name: ``name{k="v",...}`` (sorted keys)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter.  ``inc`` is O(1) under the registry lock."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.Lock) -> None:
        self.name = name
        self.value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-value gauge with relative updates for incremental tracking."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.Lock) -> None:
        self.name = name
        self.value = 0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def add(self, delta: float) -> None:
        with self._lock:
            self.value += delta


class Histogram:
    """Streaming histogram: count/sum/min/max plus p50/p90 via
    :class:`StreamingQuantile` — O(1) memory regardless of sample count."""

    __slots__ = ("name", "count", "total", "min", "max", "_p50", "_p90",
                 "_lock")

    def __init__(self, name: str, lock: threading.Lock) -> None:
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._p50 = StreamingQuantile(0.5)
        self._p90 = StreamingQuantile(0.9)
        self._lock = lock

    def observe(self, x: float) -> None:
        with self._lock:
            self.count += 1
            self.total += x
            if x < self.min:
                self.min = x
            if x > self.max:
                self.max = x
            self._p50.add(x)
            self._p90.add(x)

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            if not self.count:
                return {"count": 0, "sum": 0.0}
            return {"count": self.count, "sum": round(self.total, 6),
                    "min": round(self.min, 6), "max": round(self.max, 6),
                    "p50": round(self._p50.quantile(), 6),
                    "p90": round(self._p90.quantile(), 6)}


class MetricsRegistry:
    """Name → metric map with get-or-create accessors.

    One lock serializes creation and every update; hot paths resolve
    their metric objects once (outside the loop) so steady-state cost
    is a single lock + add per event.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, Any] = {}

    def _get(self, cls: type, name: str, labels: dict[str, Any]) -> Any:
        key = _full_name(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(key, self._lock)
            elif type(m) is not cls:
                raise TypeError(
                    f"metric {key!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels: Any) -> Histogram:
        return self._get(Histogram, name, labels)

    def value(self, name: str, **labels: Any) -> Any:
        """Current value of a series (0 when never touched)."""
        with self._lock:
            m = self._metrics.get(_full_name(name, labels))
        if m is None:
            return 0
        if isinstance(m, Histogram):
            return m.snapshot()
        return m.value

    def sum_values(self, prefix: str) -> float:
        """Sum every counter/gauge whose series name starts with
        ``prefix`` — aggregates a labeled family, e.g. all retry kinds."""
        with self._lock:
            series = list(self._metrics.values())
        return sum(m.value for m in series
                   if not isinstance(m, Histogram)
                   and m.name.startswith(prefix))

    def snapshot(self) -> dict[str, Any]:
        """JSON-serializable dump of every series (study.json payload)."""
        with self._lock:
            series = list(self._metrics.items())
        out: dict[str, Any] = {}
        for key, m in series:
            out[key] = m.snapshot() if isinstance(m, Histogram) else m.value
        return out

    def prometheus(self) -> str:
        """Text exposition format; histograms render as summaries."""
        with self._lock:
            series = list(self._metrics.items())
        lines: list[str] = []
        typed: set[str] = set()
        for key, m in series:
            base = key.split("{", 1)[0]
            if isinstance(m, Histogram):
                if base not in typed:
                    typed.add(base)
                    lines.append(f"# TYPE {base} summary")
                snap = m.snapshot()
                for q, field in (("0.5", "p50"), ("0.9", "p90")):
                    if field in snap:
                        lines.append(
                            f"{_label_merge(key, 'quantile', q)} "
                            f"{snap[field]}")
                lines.append(f"{_suffix(key, '_count')} {snap['count']}")
                lines.append(f"{_suffix(key, '_sum')} {snap['sum']}")
                continue
            kind = "counter" if isinstance(m, Counter) else "gauge"
            if base not in typed:
                typed.add(base)
                lines.append(f"# TYPE {base} {kind}")
            lines.append(f"{key} {m.value}")
        return "\n".join(lines) + "\n"


def _label_merge(key: str, label: str, value: str) -> str:
    """Insert one more label into a possibly-labeled series name."""
    if key.endswith("}"):
        return f'{key[:-1]},{label}="{value}"}}'
    return f'{key}{{{label}="{value}"}}'


def _suffix(key: str, suffix: str) -> str:
    """Append ``_count``/``_sum`` to the metric name, keeping labels."""
    if "{" in key:
        base, rest = key.split("{", 1)
        return f"{base}{suffix}{{{rest}"
    return key + suffix


# ---------------------------------------------------------------------------
# trace collector (Chrome trace-event format)


class TraceCollector:
    """Accumulates Chrome trace events with explicit timestamps.

    Timestamps are caller-supplied seconds (the emitting component's
    own clock — ``time.monotonic`` or a ``VirtualClock``); only their
    differences are meaningful, which is all a trace viewer needs.
    Track ids (``tid``) are assigned per track *name* string, so the
    same logical track ("lane3", "host:h0/1") keeps a stable tid even
    when the OS thread behind it is respawned.
    """

    PID = 1

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: list[dict[str, Any]] = []
        self._tids: dict[str, int] = {}

    def _tid(self, track: str) -> int:
        # caller holds self._lock
        tid = self._tids.get(track)
        if tid is None:
            tid = self._tids[track] = len(self._tids) + 1
            self._events.append(
                {"ph": "M", "name": "thread_name", "pid": self.PID,
                 "tid": tid, "args": {"name": track}})
        return tid

    def _emit(self, ph: str, track: str, name: str | None, ts: float,
              cat: str, args: dict[str, Any] | None,
              **extra: Any) -> None:
        ev: dict[str, Any] = {"ph": ph, "pid": self.PID, "ts": ts * 1e6,
                              "cat": cat}
        if name is not None:
            ev["name"] = name
        if args:
            ev["args"] = dict(args)
        ev.update(extra)
        with self._lock:
            ev["tid"] = self._tid(track)
            self._events.append(ev)

    def begin(self, track: str, name: str, ts: float, cat: str = "task",
              args: dict[str, Any] | None = None) -> None:
        """Open a duration slice (``B``) on ``track`` at ``ts`` seconds."""
        self._emit("B", track, name, ts, cat, args)

    def end(self, track: str, ts: float, cat: str = "task",
            args: dict[str, Any] | None = None) -> None:
        """Close the innermost open slice (``E``) on ``track``."""
        self._emit("E", track, None, ts, cat, args)

    def complete(self, track: str, name: str, t0: float, t1: float,
                 cat: str = "task",
                 args: dict[str, Any] | None = None) -> None:
        """Emit a retroactive ``B``/``E`` pair (both ends known)."""
        self._emit("B", track, name, t0, cat, args)
        self._emit("E", track, None, t1, cat, None)

    def instant(self, track: str, name: str, ts: float,
                cat: str = "mark",
                args: dict[str, Any] | None = None) -> None:
        """Thread-scoped instant event (``i``) — e.g. a chaos firing."""
        self._emit("i", track, name, ts, cat, args, s="t")

    def async_begin(self, track: str, name: str, id_: str, ts: float,
                    cat: str = "wait",
                    args: dict[str, Any] | None = None) -> None:
        """Open an async slice — for waits that overlap on one track
        (retry backoffs), where ``B``/``E`` stack discipline won't hold."""
        self._emit("b", track, name, ts, cat, args, id=id_)

    def async_end(self, track: str, name: str, id_: str, ts: float,
                  cat: str = "wait") -> None:
        self._emit("e", track, name, ts, cat, None, id=id_)

    def events(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def write(self, path: str | Path) -> Path:
        """Serialize as ``{"traceEvents": [...]}`` (Perfetto-loadable)."""
        path = Path(path)
        doc = {"traceEvents": self.events(), "displayTimeUnit": "ms"}
        path.write_text(json.dumps(doc) + "\n")
        return path


# ---------------------------------------------------------------------------
# controller: metrics + trace + status + HTTP surface


class _TelemetryHandler(BaseHTTPRequestHandler):
    """``/metrics`` (Prometheus text) + ``/status`` (JSON) endpoints."""

    telemetry: "Telemetry"

    def do_GET(self) -> None:      # noqa: N802 (stdlib handler API)
        if self.path == "/metrics":
            body = self.telemetry.metrics.prometheus().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif self.path in ("/", "/status"):
            body = (json.dumps(self.telemetry.status(), default=str)
                    + "\n").encode()
            ctype = "application/json"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args: Any) -> None:
        pass    # keep the TTY clean: no per-request access log


class Telemetry:
    """One armed run's worth of observability state.

    Bundles a :class:`TraceCollector` and a :class:`MetricsRegistry`,
    tracks run shape (total/slots) for the status line, and can serve
    both over HTTP.  Install one with :func:`install`/:func:`activated`
    or pass it to ``ParameterStudy.run(trace=...)``.
    """

    def __init__(self, path: str | Path | None = None) -> None:
        self.trace = TraceCollector()
        self.metrics = MetricsRegistry()
        #: trace.json destination; ``None`` → ``<study dir>/trace.json``
        self.path: str | None = str(path) if path else None
        self.total = 0
        self.slots = 1
        self.server: ThreadingHTTPServer | None = None
        self.port: int | None = None
        self._status_stream: TextIO | None = None
        self._next_tick = 0.0
        self._last_len = 0
        self._t0 = time.monotonic()
        self._rate_t = self._t0
        self._rate_n = 0
        self._rate = 0.0

    # -- run shape ---------------------------------------------------------

    def begin_run(self, total: int, slots: int) -> None:
        """Called by the study at dispatch start: run size for ETA math."""
        self.total = int(total)
        self.slots = max(1, int(slots))
        self._t0 = time.monotonic()
        self._rate_t = self._t0
        self._rate_n = 0
        self._rate = 0.0

    # -- live status -------------------------------------------------------

    def status(self) -> dict[str, Any]:
        """Point-in-time progress snapshot (the ``/status`` payload)."""
        m = self.metrics
        done = m.value("papas_tasks_completed_total")
        failed = m.value("papas_tasks_failed_total")
        skipped = m.value("papas_tasks_skipped_total")
        running = m.value("papas_tasks_running")
        retrying = m.value("papas_tasks_retrying")
        finished = done + failed + skipped
        now = time.monotonic()
        dt = now - self._rate_t
        if dt >= 0.5:
            self._rate = (finished - self._rate_n) / dt
            self._rate_t = now
            self._rate_n = finished
        elif not self._rate and now > self._t0:
            self._rate = finished / (now - self._t0)
        eta = None
        remaining = max(0, self.total - finished) if self.total else 0
        runtime = m.value("papas_task_runtime_seconds")
        if remaining and isinstance(runtime, dict) and runtime.get("count"):
            eta = remaining * runtime["p50"] / self.slots
        return {"total": self.total, "done": done, "failed": failed,
                "skipped": skipped, "running": running,
                "retrying": retrying, "tasks_per_sec": round(self._rate, 1),
                "eta_s": None if eta is None else round(eta, 1),
                "elapsed_s": round(now - self._t0, 1)}

    def status_line(self) -> str:
        s = self.status()
        eta = "?" if s["eta_s"] is None else f"{s['eta_s']:.0f}s"
        total = s["total"] or "?"
        return (f"[papas] {s['done']}/{total} done · "
                f"{s['running']:.0f} running · {s['failed']} failed · "
                f"{s['retrying']:.0f} retrying · "
                f"{s['tasks_per_sec']:.0f} tasks/s · eta {eta}")

    def attach_status(self, stream: TextIO | None = None) -> None:
        """Arm the in-place TTY progress line (``sweep.py --status``)."""
        self._status_stream = stream if stream is not None else sys.stderr
        self._next_tick = 0.0

    def tick(self, force: bool = False) -> None:
        """Redraw the status line, throttled to ~4 Hz; call from any
        per-completion hook — cheap no-op when not due."""
        out = self._status_stream
        if out is None:
            return
        now = time.monotonic()
        if not force and now < self._next_tick:
            return
        self._next_tick = now + 0.25
        line = self.status_line()
        pad = " " * max(0, self._last_len - len(line))
        self._last_len = len(line)
        out.write("\r" + line + pad)
        out.flush()

    def finish_status(self) -> None:
        """Final redraw + newline so the shell prompt lands clean."""
        if self._status_stream is None:
            return
        self.tick(force=True)
        self._status_stream.write("\n")
        self._status_stream.flush()
        self._status_stream = None

    # -- HTTP surface ------------------------------------------------------

    def serve(self, port: int = 0) -> int:
        """Start the daemon metrics server; returns the bound port
        (pass 0 for an ephemeral one)."""
        handler = type("_BoundHandler", (_TelemetryHandler,),
                       {"telemetry": self})
        self.server = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self.port = int(self.server.server_address[1])
        threading.Thread(target=self.server.serve_forever,
                         name="papas-metrics", daemon=True).start()
        return self.port

    def close(self) -> None:
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.server = None


# ---------------------------------------------------------------------------
# arming — the same seam pattern as repro_torch.core.chaos

_controller: Telemetry | None = None
_env_checked = False


def current() -> Telemetry | None:
    """The armed telemetry controller, or ``None`` (the common case).

    Components capture this once at construction; the disarmed cost is
    a single identity check at each seam.  First call lazily honors
    ``PAPAS_TRACE`` (``1`` to arm, or a path for ``trace.json``).
    """
    global _controller, _env_checked
    if _controller is None and not _env_checked:
        _env_checked = True
        val = os.environ.get("PAPAS_TRACE", "")
        if val and val.lower() not in ("0", "false", "no"):
            path = None if val.lower() in ("1", "true", "yes") else val
            _controller = Telemetry(path=path)
    return _controller


def install(tel: Telemetry | None) -> None:
    """Install (or clear, with ``None``) the process-wide controller."""
    global _controller, _env_checked
    _controller = tel
    _env_checked = True


@contextmanager
def activated(tel: Telemetry) -> Iterator[Telemetry]:
    """Scoped arming: install ``tel``, restore the previous controller
    on exit — how ``run(trace=...)`` and the tests arm a single run."""
    prev = current()
    install(tel)
    try:
        yield tel
    finally:
        install(prev)
