"""Tracing / profiling helpers (SURVEY.md §5 observability).

The reference has only google-benchmark micro-benchmarks compiled into its
tests; the rebuild exposes:
  * ``stage(name)`` — a jax named-scope + profiler annotation so each
    pipeline stage shows up in device traces;
  * ``Timer`` — wall-clock stage timing with forced host sync (results are
    device arrays; remote execution environments can report async dispatch
    as instant, so we sync through a transfer);
  * ``trace_to(dir)`` — context manager around jax.profiler.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import jax
import numpy as np


@contextlib.contextmanager
def stage(name: str):
    """Annotate a pipeline stage for profiler traces."""
    with jax.named_scope(name):
        with jax.profiler.TraceAnnotation(name):
            yield


class Timer:
    """Accumulates per-stage wall times; ``sync`` forces completion."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def measure(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        yield
        if sync_value is not None:
            jax.tree_util.tree_map(
                lambda x: np.asarray(x) if hasattr(x, "device") else x,
                sync_value)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        return {k: min(v) for k, v in self.times.items()}


@contextlib.contextmanager
def trace_to(log_dir: str):
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
