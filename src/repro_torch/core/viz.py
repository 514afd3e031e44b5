"""Visualization engine (paper §4.4): DAG → DOT / ASCII.

The paper wraps PyGraphviz; we emit DOT text directly (no system
dependency — keeps the framework lightweight and user-space) plus an
ASCII rendering for terminals.  State coloring mirrors the paper's
"current state of the processing" view.
"""
from __future__ import annotations

from typing import Mapping

from .dag import TaskDAG

_STATE_COLOR = {
    "pending": "gray",
    "running": "gold",
    "ok": "palegreen",
    "failed": "tomato",
    "skipped": "lightblue",
}


def _esc(s: str) -> str:
    """Escape a string for a double-quoted DOT id or label: backslashes
    first, then quotes — a task named ``a"b`` or ``a\\b`` must not break
    out of (or corrupt) the quoted token."""
    return str(s).replace("\\", "\\\\").replace('"', '\\"')


def to_dot(dag: TaskDAG, states: Mapping[str, str] | None = None,
           title: str = "papas_study") -> str:
    states = states or {}
    lines = [f'digraph "{_esc(title)}" {{', "  rankdir=LR;",
             '  node [shape=box, style=filled, fillcolor=white];']
    for nid, node in sorted(dag.nodes.items()):
        state = states.get(nid, "pending")
        color = _STATE_COLOR.get(state, "white")
        label = f"{_esc(node.task)}\\n{_esc(nid)}"
        lines.append(f'  "{_esc(nid)}" [label="{label}", fillcolor={color}];')
    for nid, node in sorted(dag.nodes.items()):
        for dep in node.deps:
            lines.append(f'  "{_esc(dep)}" -> "{_esc(nid)}";')
    lines.append("}")
    return "\n".join(lines)


def to_ascii(dag: TaskDAG, states: Mapping[str, str] | None = None) -> str:
    """Level-ordered text rendering of the study DAG."""
    states = states or {}
    out = []
    for depth, level in enumerate(dag.levels()):
        out.append(f"level {depth}:")
        for nid in sorted(level):
            node = dag.nodes[nid]
            mark = {"ok": "x", "failed": "!", "running": ">",
                    "skipped": "-"}.get(states.get(nid, "pending"), " ")
            deps = f"  <- {', '.join(node.deps)}" if node.deps else ""
            out.append(f"  [{mark}] {nid} ({node.task}){deps}")
    return "\n".join(out)
