"""Profiling helpers.

Counterpart of ``tensorflowraytrace_tpu/utils/profiling.py``:
:func:`profile_trace` captures a trace of the enclosed block with
``torch.profiler`` (the JAX module's ``jax.profiler`` trace), and
:class:`StepTimer` keeps wall-clock times of a step loop.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def profile_trace(logdir="/tmp/tfrt_torch_profile", enabled=True):
    """Capture a trace of the enclosed block into ``logdir``::

        with profile_trace("build/prof"):
            run_step(...)
        # open build/prof/*.pt.trace.json in Perfetto (ui.perfetto.dev) or
        # chrome://tracing, or: tensorboard --logdir build/prof

    It records the CPU, and the card's kernels where the process has
    initialised CUDA.  The trace is written as Chrome trace JSON when the
    block ends; ``enabled=False`` records and writes nothing.  Yields the
    ``torch.profiler.profile`` (``None`` when disabled), whose
    ``key_averages()`` sums the recorded time by name.
    """
    if not enabled:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     logdir)) as prof:
        yield prof


class StepTimer:
    """Rolling wall-clock stats for step loops (the reference's ad-hoc
    ``time.time()`` bracketing, optimizer.py:388-442).

    It reads the host clock: the card runs asynchronously, so a caller
    timing work on the card calls ``torch.cuda.synchronize()`` at the end
    of each timed block, as the JAX caller blocks on its result."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    @property
    def mean(self):
        return sum(self.times) / max(len(self.times), 1)

    @property
    def total(self):
        return sum(self.times)

    def report(self, label="step"):
        n = len(self.times)
        return (f"{n} {label}s in {self.total:.3f}s "
                f"({1e3 * self.mean:.2f} ms/{label})")
