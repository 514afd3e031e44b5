"""The one registry of what a cost counter hears: each kernel wrapper's
call (:mod:`repro_torch.kernels.costs`) and each collective
(:mod:`repro_torch.distributed.context`), reported as an event whose first
argument says which.  :class:`repro_torch.launch.costs.Counter` listens.

Nothing is worked out or called while nothing listens: a reporter asks
:func:`active` first.

A CUDA graph's capture runs nothing, and its replays run no host code, so
no reporter speaks at a replay.  :func:`recording` keeps a capture's
events from every listener; the capture's owner reports them again at
each replay (:func:`replay`), to the listeners of that moment.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

#: ``(KERNEL, name, flops, nbytes)``: one kernel call
KERNEL = "kernel"
#: ``(COLLECTIVE, kind, axis, nbytes)``: one collective, the result's bytes
COLLECTIVE = "collective"

#: listeners of :func:`counting`: each is called (event, *details)
_LISTENERS: list = []
#: the events of the :func:`recording` block running, or None
_RECORD: list | None = None


@contextlib.contextmanager
def counting(listener) -> Iterator[None]:
    """Report every event to ``listener(event, *details)`` inside the
    ``with`` block."""
    _LISTENERS.append(listener)
    try:
        yield
    finally:
        _LISTENERS.remove(listener)


@contextlib.contextmanager
def recording() -> Iterator[list[tuple]]:
    """Every event inside the ``with`` block kept, as ``(event, *details)``,
    in the list it yields, and reported to no listener."""
    global _RECORD
    saved, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = saved


def active() -> bool:
    """Whether anything listens (or records)."""
    return bool(_LISTENERS) or _RECORD is not None


def report(event: str, *details) -> None:
    """One event to every listener (inside :func:`recording`, to the
    record alone)."""
    if _RECORD is not None:
        _RECORD.append((event, *details))
        return
    for listener in list(_LISTENERS):
        listener(event, *details)


def replay(recorded: list[tuple]) -> None:
    """Events a :func:`recording` kept, reported again in their order."""
    if active():
        for event in recorded:
            report(*event)
