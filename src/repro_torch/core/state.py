"""Study checkpoint/restart journal (paper §4.1) — now streaming-aware.

"PaPaS provides checkpoint-restart functionality in case of fault or a
deliberate pause/stop operation.  A parameter study's state can be saved
in a workflow file and reloaded at a later time."

Two on-disk formats share one append-only design:

* **v1 (legacy, eager)** — the base document stores the study's fully
  expanded instance list plus the completed node ids known when it was
  written.  O(N_W) bytes per compaction; still written by the eager
  (non-windowed) execution path and always readable.
* **v2 (compact, streaming)** — the base document stores the *space
  hash* (pairing the journal with its declared parameter space), the
  instance count, and per-task completed instance **indices**
  range-compressed to ``[[start, end], ...]`` spans.  A long sweep that
  completed instances 0..99999 journals as one two-integer range, not
  10^5 combos — O(completed ranges), never O(N_W).

Either way, recording one completion is an O(1) locked append to a
sidecar log — not a rewrite of the base — so journaling stays cheap for
long sweeps and safe when results arrive from a concurrent engine (base
writes stay atomic via tmp + rename).  ``load_state()`` folds the log
back into the base and understands both versions, so a v1 journal
resumes transparently under the streaming engine and vice versa.

**Group commit.**  By default every ``mark_complete`` opens the sidecar
log, appends, and flushes — one durable write per task, the right
default for standalone journal use.  For short-task sweeps that is two
syscall-heavy operations per completion, so the journal also supports a
*batched writer*: entries accumulate in memory against a single
long-lived file handle and flush as a group every ``flush_count``
entries or ``flush_interval`` seconds, dropping the bookkeeping cost to
amortized O(1/flush_count) opens+flushes per task.  The engine enables
it for the duration of a run via the ``group_commit()`` context manager,
which guarantees the buffer is flushed when the run returns *or raises*
— a crash mid-study loses nothing already handed to ``mark_complete``
at the last flush boundary, and nothing at all once ``run()`` exits.
Readers (``load_state``/``hosts``) see buffered entries immediately:
the log view is file contents plus the in-memory tail.

**Sharding.**  Under a many-lane or multi-process backend the single
buffered log handle becomes the completion stream's serialization
point, so the sidecar log can split into per-shard append segments
(``<name>.log`` plus ``<name>.log.s1`` …): ``mark_complete`` round-
robins across K independent group-commit writers and readers union
every segment on disk.  Compaction (``save``/``save_indexed``) folds
all segments into the base document and removes them, and
``load_state()`` globs segments rather than trusting the current shard
count — a crash mid-run with any shard layout resumes to the same
merged state as the single-handle world.  The engine picks a shard
count from the pool's parallelism (``run()``); standalone journals
default to one shard, which *is* the legacy layout.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Iterable, Iterator, Mapping

from .groupcommit import ShardedGroupCommit, iter_jsonl
from .locklint import make_lock


def compress_ranges(indices: Iterable[int]) -> list[list[int]]:
    """Fold an index set into sorted inclusive ``[start, end]`` spans."""
    out: list[list[int]] = []
    for i in sorted(set(indices)):
        if out and i == out[-1][1] + 1:
            out[-1][1] = i
        else:
            out.append([i, i])
    return out


def expand_ranges(ranges: Iterable[Iterable[int]]) -> Iterator[int]:
    """Inverse of ``compress_ranges``: yield every covered index."""
    for start, end in ranges:
        yield from range(int(start), int(end) + 1)


@dataclasses.dataclass
class JournalState:
    """Everything a resume needs, folded from base document + log."""

    version: int
    completed: set[str]                 # completed node ids (both versions)
    meta: dict[str, Any]
    hosts: dict[str, str]
    instances: list[dict[str, Any]] | None = None   # v1 base only
    completed_indices: dict[str, set[int]] | None = None  # v2: task → indices
    space_hash: str | None = None       # v2 only
    n_instances: int | None = None      # v2 only


class StudyJournal:
    def __init__(self, path: str | Path, flush_count: int = 1,
                 flush_interval: float | None = None,
                 shards: int = 1) -> None:
        """``flush_count``/``flush_interval`` configure the batched
        writer: buffered appends flush every N entries or T seconds,
        whichever comes first.  The default (1, None) keeps the legacy
        one-durable-write-per-completion behavior.  ``shards`` splits
        the sidecar log into per-shard append segments (see
        ``set_shards``); readers union them, so 1 — the default — is
        the legacy single-log layout."""
        self.path = Path(path)
        self.log_path = self.path.with_name(self.path.name + ".log")
        self._writer = ShardedGroupCommit(self.log_path, flush_count,
                                          flush_interval, shards)
        self._base_known = False    # base existence verified (skip stats)
        self._lock = make_lock("journal")

    def set_shards(self, shards: int) -> None:
        """Split (or re-merge) the sidecar log across ``shards`` append
        segments so a many-lane or multi-process run never serializes
        its completion stream on one buffered handle.  Safe mid-life:
        dropped segments flush first, and ``load_state()`` unions every
        segment on disk regardless of the current count."""
        with self._lock:
            self._writer.set_shards(shards)

    def exists(self) -> bool:
        return self.path.exists()

    # journals ride along when a bound runner is pickled to a process
    # pool; the lock is process-local state (the writer drops its own
    # handle and buffer — the parent keeps, and flushes, the originals)
    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._lock = make_lock("journal")

    # -- group-commit machinery ------------------------------------------
    @property
    def n_appends(self) -> int:
        """Completions handed to ``mark_complete``."""
        return self._writer.n_appends

    @property
    def n_flushes(self) -> int:
        """Group flushes actually performed."""
        return self._writer.n_flushes

    def flush(self) -> None:
        """Force buffered completions to the sidecar log now."""
        with self._lock:
            self._writer.flush()

    def shard_counters(self) -> list[dict[str, Any]]:
        """Per-segment group-commit counters (telemetry snapshot)."""
        return self._writer.shard_counters()

    def close(self) -> None:
        """Flush and release the long-lived log handle."""
        with self._lock:
            self._writer.close()

    @contextmanager
    def group_commit(self, flush_count: int = 64,
                     flush_interval: float | None = 0.2):
        """Batch appends for the enclosed block.  On exit — normal or
        exceptional — the buffer is flushed, the handle closed, and the
        previous flush policy restored, so completions recorded before a
        crash are durable before the exception propagates."""
        with self._lock:
            prev = self._writer.set_policy(flush_count, flush_interval)
        try:
            yield self
        finally:
            with self._lock:
                self._writer.set_policy(*prev)
                self._writer.close()

    # -- base documents --------------------------------------------------
    def _replace_base(self, doc: Mapping[str, Any]) -> None:
        # buffered entries are folded into the base by the caller (the
        # completed sets passed in already include them) — drop them with
        # the log they would have landed in
        self._writer.drop_buffered()
        tmp = self.path.with_suffix(".tmp")
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp.write_text(json.dumps(doc, default=str,
                                  separators=(",", ":")))
        os.replace(tmp, self.path)
        self._base_known = True
        # every log segment's entries are folded into the base just wrote
        self._writer.unlink_segments()

    def _write_base(
        self,
        instances: list[dict[str, Any]],
        completed: set[str],
        meta: Mapping[str, Any] | None,
        hosts: Mapping[str, str] | None = None,
    ) -> None:
        self._replace_base({
            "version": 1,
            "instances": instances,
            "completed": sorted(completed),
            "meta": dict(meta or {}),
            "hosts": dict(hosts or {}),
        })

    def save(
        self,
        instances: list[dict[str, Any]],
        completed: set[str],
        meta: Mapping[str, Any] | None = None,
        hosts: Mapping[str, str] | None = None,
    ) -> None:
        """Write (compact) the full eager study state atomically as a v1
        document.  ``hosts`` maps task id → executing host."""
        with self._lock:
            self._write_base(instances, completed, meta, hosts)

    def save_indexed(
        self,
        space_hash: str,
        n_instances: int,
        completed: Mapping[str, Iterable[int]],
        meta: Mapping[str, Any] | None = None,
        hosts: Mapping[str, str] | None = None,
    ) -> None:
        """Write (compact) a v2 document: the space hash plus per-task
        completed instance indices, range-compressed — O(completed
        ranges) bytes, independent of N_W."""
        with self._lock:
            self._replace_base({
                "version": 2,
                "space": space_hash,
                "n_instances": int(n_instances),
                "completed": {task: compress_ranges(ix)
                              for task, ix in sorted(completed.items())},
                "meta": dict(meta or {}),
                "hosts": dict(hosts or {}),
            })

    # -- incremental appends ---------------------------------------------
    def mark_complete(self, task_id: str, host: str | None = None,
                      index: int | None = None,
                      task: str | None = None) -> None:
        """Incrementally record one completion: a locked append to the
        sidecar log, never a rewrite of the base document.  ``host``
        records where the task ran (remote provenance); ``index`` +
        ``task`` record the instance's space index for journal v2 (range
        compression happens at the next compaction).  Under the default
        flush policy the entry is durable on return; under group commit
        it is buffered and flushed with its batch."""
        entry: dict[str, Any] = {"completed": task_id}
        if host:
            entry["host"] = host
        if index is not None:
            entry["index"] = int(index)
        if task is not None:
            entry["task"] = task
        with self._lock:
            if not self._base_known:
                if not self.path.exists():
                    self._write_base([], set(), {})
                self._base_known = True
            self._writer.append(
                json.dumps(entry, separators=(",", ":")) + "\n")

    def set_pre_flush(self, fn: Any) -> None:
        """Durability-ordering hook: ``fn`` runs before any journal
        batch physically writes.  The study engine points it at the
        provenance DB's flush so a completion can never be durable in
        the journal before its record is durable in the DB — a crash
        may lose a completion (resume re-runs it) but never strand a
        journal entry whose record is gone."""
        with self._lock:
            self._writer.set_pre_flush(fn)

    # -- readers ----------------------------------------------------------
    def _log_entries(self) -> Iterator[dict[str, Any]]:
        # every on-disk segment first (union over shards — including
        # segments a previous run wrote with a different shard count),
        # then the unflushed in-memory tail — a reader holding the lock
        # sees every recorded completion.  Segments read through the
        # corruption-tolerant iterator: a torn tail (crash mid-write)
        # warns and drops that entry instead of refusing resume.
        for seg in self._writer.segment_paths():
            yield from iter_jsonl(seg, "journal")
        for line in self._writer.pending():
            yield json.loads(line)

    def load_state(self) -> JournalState:
        """Fold base document + sidecar log into a ``JournalState``,
        accepting either journal version (v1 read-compat)."""
        with self._lock:
            doc = json.loads(self.path.read_text())
            version = doc.get("version")
            if version not in (1, 2):
                raise ValueError(
                    f"unsupported journal version {version!r}")
            hosts: dict[str, str] = dict(doc.get("hosts") or {})
            if version == 1:
                state = JournalState(
                    version=1,
                    completed=set(doc["completed"]),
                    meta=doc.get("meta", {}),
                    hosts=hosts,
                    instances=doc["instances"],
                )
            else:
                state = JournalState(
                    version=2,
                    completed=set(),
                    meta=doc.get("meta", {}),
                    hosts=hosts,
                    completed_indices={
                        task: set(expand_ranges(ranges))
                        for task, ranges in (doc.get("completed") or {}).items()},
                    space_hash=doc.get("space"),
                    n_instances=doc.get("n_instances"),
                )
            for entry in self._log_entries():
                state.completed.add(entry["completed"])
                if entry.get("host"):
                    state.hosts[entry["completed"]] = entry["host"]
                if (state.completed_indices is not None
                        and entry.get("task") is not None
                        and entry.get("index") is not None):
                    state.completed_indices.setdefault(
                        entry["task"], set()).add(int(entry["index"]))
            return state

    def load(self) -> tuple[list[dict[str, Any]], set[str], dict[str, Any]]:
        """Legacy v1 reader: ``(instances, completed ids, meta)``.  A v2
        journal has no instance list — use ``load_state()`` (which also
        reads v1) anywhere a streaming journal may appear."""
        state = self.load_state()
        if state.version != 1:
            raise ValueError(
                "journal is v2 (indexed); use load_state() to read it")
        return state.instances or [], state.completed, state.meta

    def hosts(self) -> dict[str, str]:
        """Task id → executing host, folded from the base document and
        the sidecar log (remote-backend provenance)."""
        with self._lock:
            hosts: dict[str, str] = {}
            if self.path.exists():
                doc = json.loads(self.path.read_text())
                hosts.update(doc.get("hosts") or {})
            for entry in self._log_entries():
                if entry.get("host"):
                    hosts[entry["completed"]] = entry["host"]
            return hosts
