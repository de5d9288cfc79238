"""Structured tracing: jax.profiler device traces + named host annotations.

The reference's observability is tictoc prints at stage boundaries
(SURVEY.md §5 "Tracing/profiling"; e.g. PCR/src/LoamRegister.cpp:110-111).
The device equivalent is a real profiler: ``trace(out_dir)`` captures an XLA
device trace viewable in TensorBoard/Perfetto, and ``annotate(name)`` wraps
host-side stages in ``jax.profiler.TraceAnnotation`` so pipeline stages show
up on the trace timeline alongside the kernels they launch.

Both are no-ops in cost when unused — nothing here sits on the hot path
unless a trace is active.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(out_dir: Optional[str]) -> Iterator[None]:
    """Capture a jax.profiler trace into ``out_dir`` (no-op if falsy)."""
    if not out_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(out_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Context manager naming a host-side stage on the profiler timeline."""
    import jax

    return jax.profiler.TraceAnnotation(name)
