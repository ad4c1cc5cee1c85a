"""Named host ranges inside the program, on while a torch profiler runs.

``span(name)`` is a context manager. While no ``torch.profiler`` (or
``torch.autograd.profiler``) profile is running it is a shared no-op: one
read of the profiler's process-wide flag, no object made, no dispatcher
call. While one runs it is a ``record_function(name)``, so the range lands
in the trace on the trace's own clock, on every thread the profiler
follows, and a Chrome trace of ``TrainerConfig.profile_dir`` shows it.
There is no other switch.

A span entered while the profiler was off stays a no-op when the profiler
starts inside it; a span entered while it was on is closed by the
profiler at its stop, and its exit after that is harmless.

Names are dotted, the layer first: ``sampler.step`` (one per step of every
sampler loop), ``train.data`` and ``train.wait`` (``Trainer.fit``: the
batch's fetch and move, and the host's blocking read of the step's loss
and gradient norm; the step's enqueue lies between them).
``GenerationService`` keeps its own timeline in ``stats`` instead: its
worker thread starts before any profiler and is not followed by one.
"""
from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler
from torch.autograd.profiler import record_function

__all__ = ["span", "profiling"]

_OFF = contextlib.nullcontext()


def profiling() -> bool:
    """True while a torch profiler runs in this process."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A ``record_function(name)`` while a profiler runs, else a no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return record_function(name)
