"""Per-study provenance database (paper §4.1/§4.2).

A study directory holds: the expanded configuration, one JSONL record per
task attempt (status, runtime, metrics), and the study journal used for
checkpoint/restart.  Plain files — no external DB — keeping the framework
portable and user-space, as the paper requires.  The ``metrics`` field
carries the results subsystem's captured values (WDL ``capture:``, see
``repro_torch.core.results``); ``repro_torch.launch.report`` rebuilds any live
aggregation table offline from this stream.

Like the journal, the record stream supports *group commit*: by default
every ``record`` is an open+write+close (durable per attempt); under the
``group_commit()`` context manager records buffer against one long-lived
handle and flush per batch (``flush_count`` entries / ``flush_interval``
seconds), with two hard guarantees — a non-``ok`` record flushes its
batch immediately (failure forensics never wait), and exiting the
context (normally or via an exception) flushes everything.

For high-rate dispatch the stream can additionally *shard*
(``set_shards``): records round-robin over per-shard append segments
(``records.jsonl`` + ``records.jsonl.s<k>``) so no single buffered
handle serializes completions, and ``records()`` k-way-merges the
segments by timestamp back into one ordered stream.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import json
import os
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Iterator, Mapping

from .groupcommit import ShardedGroupCommit, iter_jsonl
from .locklint import make_lock


def config_hash(obj: Any) -> str:
    blob = json.dumps(obj, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class StudyDB:
    """Append-only provenance store for one parameter study."""

    def __init__(self, root: str | Path, study: str, flush_count: int = 1,
                 flush_interval: float | None = None,
                 shards: int = 1) -> None:
        self.dir = Path(root) / study
        self.dir.mkdir(parents=True, exist_ok=True)
        self.records_path = self.dir / "records.jsonl"
        self.meta_path = self.dir / "study.json"
        self._writer = ShardedGroupCommit(self.records_path, flush_count,
                                          flush_interval, shards)
        self._lock = make_lock("studydb")

    def set_shards(self, shards: int) -> None:
        """Split (or re-merge) the record stream across ``shards``
        append segments (``records.jsonl`` + ``records.jsonl.s<k>``) so
        high-rate dispatch never serializes on one buffered handle.
        ``records()`` merges segments by timestamp, so readers see the
        same stream order as the single-handle world."""
        with self._lock:
            self._writer.set_shards(shards)

    # the DB rides along when a bound runner is pickled to a process
    # pool; the lock is process-local state (the writer drops its own
    # handle and buffer — the parent keeps, and flushes, the originals)
    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._lock = make_lock("studydb")

    # -- group-commit machinery ------------------------------------------
    @property
    def n_appends(self) -> int:
        """Records handed to ``record()``."""
        return self._writer.n_appends

    @property
    def n_flushes(self) -> int:
        """Group flushes actually performed."""
        return self._writer.n_flushes

    def flush(self) -> None:
        """Force buffered records to disk now."""
        with self._lock:
            self._writer.flush()

    def close(self) -> None:
        """Flush and release the long-lived record handle."""
        with self._lock:
            self._writer.close()

    @contextmanager
    def group_commit(self, flush_count: int = 64,
                     flush_interval: float | None = 0.2):
        """Batch records for the enclosed block; flush-on-exit holds for
        normal returns and raised exceptions alike."""
        with self._lock:
            prev = self._writer.set_policy(flush_count, flush_interval)
        try:
            yield self
        finally:
            with self._lock:
                self._writer.set_policy(*prev)
                self._writer.close()

    # -- study-level metadata -------------------------------------------
    def write_meta(self, meta: Mapping[str, Any]) -> None:
        tmp = self.meta_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(dict(meta), indent=2, default=str))
        os.replace(tmp, self.meta_path)

    def read_meta(self) -> dict[str, Any]:
        if not self.meta_path.exists():
            return {}
        return json.loads(self.meta_path.read_text())

    # -- task records ----------------------------------------------------
    def record(
        self,
        task_id: str,
        status: str,
        runtime: float,
        combo: Mapping[str, Any] | None = None,
        metrics: Mapping[str, Any] | None = None,
        index: int | None = None,
        **extra: Any,
    ) -> None:
        """Append one attempt record.  ``index`` is the instance's space
        index (streaming runs) — it lets downstream tooling address the
        combination without re-expanding the space."""
        rec = {
            "task_id": task_id,
            "status": status,
            "runtime": runtime,
            "combo": dict(combo) if combo else None,
            "metrics": dict(metrics) if metrics else None,
            "timestamp": time.time(),
            **extra,
        }
        if index is not None:
            rec["index"] = int(index)
        line = json.dumps(rec, default=str, separators=(",", ":")) + "\n"
        with self._lock:
            # a failed attempt flushes its whole batch immediately:
            # post-mortems must never wait on a group-commit window
            self._writer.append(line, force=status != "ok")

    def records(self) -> Iterator[dict[str, Any]]:
        self.flush()
        paths = self._writer.segment_paths()
        if not paths:
            return iter(())

        def _it(path: Path) -> Iterator[dict[str, Any]]:
            # corruption-tolerant: a torn tail (crash mid-write) warns
            # and drops that record instead of refusing the whole DB
            yield from iter_jsonl(path, "provenance")
        if len(paths) == 1:
            return _it(paths[0])
        # per-segment streams are timestamp-ordered (appends are
        # monotonic within a shard), so a k-way merge restores the
        # global stream order of the single-handle world — later
        # attempts still shadow earlier ones for every reader
        return heapq.merge(*(_it(p) for p in paths),
                           key=lambda r: r.get("timestamp") or 0.0)

    def completed_ids(self) -> set[str]:
        return {r["task_id"] for r in self.records() if r["status"] == "ok"}

    def completed_indices(self) -> dict[str, set[int]]:
        """Task name → completed instance space indices (streaming runs
        record the index per attempt; eager records carry none)."""
        out: dict[str, set[int]] = {}
        for r in self.records():
            if r["status"] == "ok" and r.get("index") is not None:
                task = r["task_id"].partition("@")[0]
                out.setdefault(task, set()).add(int(r["index"]))
        return out

    def shard_counters(self) -> list[dict[str, Any]]:
        """Per-segment group-commit counters (telemetry snapshot)."""
        return self._writer.shard_counters()

    # -- profiler summary --------------------------------------------------
    def runtime_summary(self, by: str | None = None) -> dict[str, Any]:
        """Runtime statistics over the ok records.

        ``by=None`` (default) returns one whole-study summary dict;
        ``by="task"`` / ``by="host"`` returns ``{group: summary}`` —
        the per-task / per-host table ``launch/report.py`` renders.
        """
        if by is None:
            return _times_summary(
                [r["runtime"] for r in self.records()
                 if r["status"] == "ok"])
        if by not in ("task", "host"):
            raise ValueError(f"runtime_summary by must be 'task' or "
                             f"'host', got {by!r}")
        groups: dict[str, list[float]] = {}
        for r in self.records():
            if r["status"] != "ok":
                continue
            key = (r["task_id"].partition("@")[0] if by == "task"
                   else str(r.get("host") or "local"))
            groups.setdefault(key, []).append(r["runtime"])
        return {k: _times_summary(v) for k, v in sorted(groups.items())}


def _times_summary(times: list[float]) -> dict[str, Any]:
    if not times:
        return {"count": 0}
    times.sort()
    return {
        "count": len(times),
        "total": sum(times),
        "min": times[0],
        "median": times[len(times) // 2],
        "max": times[-1],
    }
