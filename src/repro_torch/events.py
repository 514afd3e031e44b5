"""The one registry of what a cost counter hears: each kernel wrapper's
call (:mod:`repro_torch.kernels.costs`) and each collective
(:mod:`repro_torch.distributed.context`), reported as an event whose first
argument says which.  :class:`repro_torch.launch.costs.Counter` listens.

Nothing is worked out or called while nothing listens: a reporter asks
:func:`active` first.
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


@contextlib.contextmanager
def counting(listener) -> Iterator[None]:
    """Report every event to ``listener(event, *details)`` inside the
    ``with`` block."""
    _LISTENERS.append(listener)
    try:
        yield
    finally:
        _LISTENERS.remove(listener)


def active() -> bool:
    """Whether anything listens."""
    return bool(_LISTENERS)


def report(event: str, *details) -> None:
    """One event to every listener."""
    for listener in list(_LISTENERS):
        listener(event, *details)
