"""Task DAG construction (paper §4.2: the task generator builds a DAG
whose nodes are indivisible tasks; ``after`` declares prerequisites)."""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Iterable, Iterator, Mapping


class DAGError(ValueError):
    pass


@dataclasses.dataclass
class TaskNode:
    """One schedulable node: a task instance for one parameter combo."""

    id: str
    task: str                      # task (section) name in the study
    combo: dict[str, Any]          # parameter combination
    deps: list[str] = dataclasses.field(default_factory=list)
    payload: Any = None            # executor-specific callable / command


class TaskDAG:
    """Directed acyclic graph of task instances."""

    def __init__(self) -> None:
        self.nodes: dict[str, TaskNode] = {}

    def add(self, node: TaskNode) -> None:
        if node.id in self.nodes:
            raise DAGError(f"duplicate node id {node.id!r}")
        self.nodes[node.id] = node

    def validate(self) -> None:
        for n in self.nodes.values():
            for d in n.deps:
                if d not in self.nodes:
                    raise DAGError(f"node {n.id!r}: missing dependency {d!r}")
        list(self.topological())  # raises on cycles

    def successors(self) -> dict[str, list[str]]:
        succ: dict[str, list[str]] = {nid: [] for nid in self.nodes}
        for n in self.nodes.values():
            for d in n.deps:
                succ[d].append(n.id)
        return succ

    def topological(self) -> Iterator[TaskNode]:
        """Kahn's algorithm over a min-heap ready queue (smallest id
        first, so the order matches a sorted list at O(V log V) instead
        of re-sorting per pop); raises DAGError on a cycle."""
        indeg = {nid: len(n.deps) for nid, n in self.nodes.items()}
        succ = self.successors()
        ready = [nid for nid, d in indeg.items() if d == 0]
        heapq.heapify(ready)
        emitted = 0
        while ready:
            nid = heapq.heappop(ready)
            emitted += 1
            yield self.nodes[nid]
            for s in succ[nid]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(ready, s)
        if emitted != len(self.nodes):
            cyclic = [nid for nid, d in indeg.items() if d > 0]
            raise DAGError(f"cycle detected among {sorted(cyclic)[:8]}")

    def levels(self) -> list[list[str]]:
        """Nodes grouped by DAG depth (for gang-packing within a level)."""
        depth: dict[str, int] = {}
        for node in self.topological():
            depth[node.id] = 1 + max((depth[d] for d in node.deps), default=-1)
        out: list[list[str]] = []
        for nid, lvl in depth.items():
            while len(out) <= lvl:
                out.append([])
            out[lvl].append(nid)
        return out
