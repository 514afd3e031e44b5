"""Group-commit append writers shared by the journal and provenance DB.

``GroupCommitWriter`` is one buffered writer over one long-lived append
handle: entries accumulate in memory and flush as a group every
``flush_count`` appends or ``flush_interval`` seconds (checked at append
time), dropping bookkeeping cost from one open+flush per record to
amortized O(1/flush_count).  The default policy (1, None) is
durable-per-append.

``ShardedGroupCommit`` spreads that stream over K per-shard append
*segments* (shard 0 is the legacy path itself; shard k is
``<path>.s<k>``) so concurrent completion streams — worker lanes, a
process pool — never serialize on one buffered handle's flush.  Readers
union the segments (``segment_paths()`` globs whatever exists on disk,
including stale segments from a previous run with more shards), so the
merged view is identical to the single-handle world.

Both writers are deliberately lock-free: ``StudyJournal`` and
``StudyDB`` call them under their own locks, which also guard the
surrounding document state.  Readers get buffered-entry visibility
through ``pending()``.

Crash semantics: ``pre_flush`` is a hook fired before a non-empty
batch physically writes — the study engine points the *journal's* hook
at the provenance DB's flush, so a journal entry can never become
durable before the record it refers to (a crash may lose a completion,
which resume simply re-runs, but never a record for a completion the
journal kept).  On the read side, ``iter_jsonl`` is the
corruption-tolerant segment reader every loader shares: a SIGKILL
mid-``write()`` legitimately leaves a torn final line, and a resume
that refuses to load over one torn record would turn a survivable
crash into data loss.
"""
from __future__ import annotations

import json
import re
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Iterator

from . import telemetry as _telemetry

_SEG_RE = re.compile(r"\.s(\d+)$")


def iter_jsonl(path: Path, label: str = "record") -> Iterator[Any]:
    """Stream JSON values from a line-oriented segment, tolerating
    corruption: a line that does not parse (torn tail from a crash
    mid-write, truncated segment) is dropped with a ``RuntimeWarning``
    instead of refusing the whole load."""
    with Path(path).open() as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except ValueError:
                warnings.warn(
                    f"{label} {Path(path).name}:{lineno}: dropping "
                    f"corrupt/truncated entry ({line[:60]!r})",
                    RuntimeWarning, stacklevel=2)


class GroupCommitWriter:
    """Buffered line appender with a group-commit flush policy."""

    def __init__(self, path: Path, flush_count: int = 1,
                 flush_interval: float | None = None) -> None:
        self.path = Path(path)
        self.flush_count = max(1, int(flush_count))
        self.flush_interval = flush_interval
        self.n_appends = 0          # lines handed to append()
        self.n_flushes = 0          # group flushes actually performed
        #: fired before a non-empty batch physically writes — the
        #: durability-ordering seam (see module docstring)
        self.pre_flush: Callable[[], None] | None = None
        self._buf: list[str] = []
        self._file: Any = None      # single long-lived append handle
        self._last_flush = time.monotonic()

    # writers ride along when a bound runner is pickled to a process
    # pool; the open handle and unflushed buffer are process-local state
    # (the parent keeps — and flushes — the buffer)
    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        state["_file"] = None
        state["_buf"] = []
        state["pre_flush"] = None
        return state

    def append(self, line: str, force: bool = False) -> None:
        """Buffer one line (must be newline-terminated); flush when
        ``force`` is set or the count/interval policy says so."""
        self._buf.append(line)
        self.n_appends += 1
        if (force
                or len(self._buf) >= self.flush_count
                or (self.flush_interval is not None
                    and time.monotonic() - self._last_flush
                    >= self.flush_interval)):
            self.flush()

    def pending(self) -> list[str]:
        """Buffered-but-unflushed lines (read-through for readers)."""
        return list(self._buf)

    def flush(self) -> None:
        if not self._buf:
            return
        if self.pre_flush is not None:
            self.pre_flush()
        # telemetry consulted per *flush*, not per append, so the cost
        # rides the already-amortized path (writers outlive any single
        # armed run, so a construction-time capture would go stale)
        tel = _telemetry.current()
        t0 = time.monotonic() if tel is not None else 0.0
        n = len(self._buf)
        if self._file is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._file = self.path.open("a")
        self._file.write("".join(self._buf))
        self._file.flush()
        self._buf.clear()
        self.n_flushes += 1
        self._last_flush = time.monotonic()
        if tel is not None:
            tel.metrics.counter("papas_groupcommit_flushes_total",
                                segment=self.path.name).inc()
            tel.metrics.counter("papas_groupcommit_lines_total",
                                segment=self.path.name).inc(n)
            tel.trace.complete(f"commit:{self.path.name}", f"flush x{n}",
                               t0, self._last_flush, cat="commit",
                               args={"lines": n})

    def close(self) -> None:
        """Flush and release the long-lived handle."""
        self.flush()
        if self._file is not None:
            self._file.close()
            self._file = None

    def drop_buffered(self) -> None:
        """Discard the buffer and release the handle without writing —
        for compaction, when the caller has folded every buffered entry
        into a fresh base document."""
        self._buf.clear()
        self.close()

    def set_policy(self, flush_count: int,
                   flush_interval: float | None) -> tuple[int, float | None]:
        """Swap the flush policy, returning the previous one."""
        prev = (self.flush_count, self.flush_interval)
        self.flush_count = max(1, int(flush_count))
        self.flush_interval = flush_interval
        return prev


class ShardedGroupCommit:
    """K ``GroupCommitWriter``\\ s over per-shard append segments.

    Drop-in for a single ``GroupCommitWriter`` (same append/flush/policy
    surface; counters aggregate), plus ``set_shards`` to re-split the
    stream and ``segment_paths`` for readers.  Appends round-robin
    across shards, so each shard's flush covers ~1/K of the entries and
    no single handle becomes the serialization point.  The default —
    one shard — *is* the legacy single-handle writer, byte-for-byte."""

    def __init__(self, path: Path, flush_count: int = 1,
                 flush_interval: float | None = None,
                 shards: int = 1) -> None:
        self.path = Path(path)
        self._writers = [
            GroupCommitWriter(self._shard_path(k), flush_count,
                              flush_interval)
            for k in range(max(1, int(shards)))]
        self._rr = 0
        # counters carried over from writers dropped by set_shards, so
        # n_appends/n_flushes stay whole-stream totals across re-splits
        self._retired_appends = 0
        self._retired_flushes = 0

    def _shard_path(self, k: int) -> Path:
        return (self.path if k == 0
                else self.path.with_name(self.path.name + f".s{k}"))

    @property
    def shards(self) -> int:
        return len(self._writers)

    def set_shards(self, shards: int) -> None:
        """Re-split the stream over ``shards`` segments.  A no-op when
        the count already matches; dropped writers flush and close
        first, so re-splitting never loses buffered entries."""
        shards = max(1, int(shards))
        if shards == len(self._writers):
            return
        for w in self._writers[shards:]:
            w.close()
            self._retired_appends += w.n_appends
            self._retired_flushes += w.n_flushes
        del self._writers[shards:]
        fc = self._writers[0].flush_count
        fi = self._writers[0].flush_interval
        pf = self._writers[0].pre_flush
        while len(self._writers) < shards:
            w = GroupCommitWriter(self._shard_path(len(self._writers)),
                                  fc, fi)
            w.pre_flush = pf
            self._writers.append(w)
        self._rr = 0

    def segment_paths(self) -> list[Path]:
        """Every on-disk segment, base first then ``.s<k>`` ascending —
        globbed, not enumerated from the current writers, so a resume
        with fewer shards still reads every segment a previous run
        wrote."""
        out = [self.path] if self.path.exists() else []
        extra = []
        for p in self.path.parent.glob(self.path.name + ".s*"):
            m = _SEG_RE.search(p.name)
            if m and p.name[:-len(m.group(0))] == self.path.name:
                extra.append((int(m.group(1)), p))
        out.extend(p for _, p in sorted(extra))
        return out

    def shard_counters(self) -> list[dict[str, Any]]:
        """Per-segment append/flush counters — the telemetry snapshot's
        ``group-commit per shard`` payload.  Totals retired by
        ``set_shards`` re-splits are reported on a synthetic entry so
        the sum always matches ``n_appends``/``n_flushes``."""
        out = [{"segment": w.path.name, "appends": w.n_appends,
                "flushes": w.n_flushes} for w in self._writers]
        if self._retired_appends or self._retired_flushes:
            out.append({"segment": "(retired)",
                        "appends": self._retired_appends,
                        "flushes": self._retired_flushes})
        return out

    def unlink_segments(self) -> None:
        """Remove every on-disk segment (compaction folded them into a
        fresh base document)."""
        for p in self.segment_paths():
            try:
                p.unlink()
            except FileNotFoundError:
                pass

    # -- GroupCommitWriter surface ----------------------------------------
    @property
    def flush_count(self) -> int:
        return self._writers[0].flush_count

    @property
    def flush_interval(self) -> float | None:
        return self._writers[0].flush_interval

    @property
    def n_appends(self) -> int:
        return self._retired_appends + sum(w.n_appends
                                           for w in self._writers)

    @property
    def n_flushes(self) -> int:
        return self._retired_flushes + sum(w.n_flushes
                                           for w in self._writers)

    def append(self, line: str, force: bool = False) -> None:
        w = self._writers[self._rr]
        self._rr = (self._rr + 1) % len(self._writers)
        w.append(line, force)

    def pending(self) -> list[str]:
        return [line for w in self._writers for line in w.pending()]

    def flush(self) -> None:
        for w in self._writers:
            w.flush()

    def close(self) -> None:
        for w in self._writers:
            w.close()

    def drop_buffered(self) -> None:
        for w in self._writers:
            w.drop_buffered()

    def set_policy(self, flush_count: int,
                   flush_interval: float | None) -> tuple[int, float | None]:
        prev: tuple[int, float | None] | None = None
        for w in self._writers:
            p = w.set_policy(flush_count, flush_interval)
            if prev is None:
                prev = p
        return prev if prev is not None else (flush_count, flush_interval)

    def set_pre_flush(self, fn: Callable[[], None] | None) -> None:
        """Install (or clear) the pre-flush hook on every shard —
        future shards created by ``set_shards`` inherit it."""
        for w in self._writers:
            w.pre_flush = fn
