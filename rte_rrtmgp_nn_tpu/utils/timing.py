"""Profiling and throughput instrumentation.

Reference parity: the GPTL region timers compiled in with ``-DUSE_TIMING``
(build/Makefile:53-62; instrumentation points across the solver and
gas-optics phases, e.g. mo_rte_solver_kernels.F90:167-168) and the always-on
``system_clock`` wall timing with per-run reports
(rrtmgp_rfmip_lw.F90:354-472).

Equivalents here: named trace annotations that show up in
jax.profiler / Perfetto traces, a lightweight wall-clock region timer with
a GPTL-style hierarchical report, and a columns/s throughput helper.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Iterator

import jax


class RegionTimers:
    """GPTL-style named region timers (wall clock, call counts)."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def region(self, name: str, annotate: bool = True) -> Iterator[None]:
        """Time a region; also emits a named annotation into profiler
        traces so device activity is attributable."""
        t0 = time.perf_counter()
        if annotate:
            with jax.profiler.TraceAnnotation(name):
                yield
        else:
            yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        """Text report (the analogue of gptlpr_file output)."""
        lines = [f"{'region':40s} {'calls':>8s} {'total_s':>10s} {'per_call_ms':>12s}"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:40s} {n:8d} {tot:10.4f} {1e3 * tot / n:12.4f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


timers = RegionTimers()


@contextlib.contextmanager
def trace(name: str):
    """Bare named scope for profiler traces (no wall-clock bookkeeping)."""
    with jax.profiler.TraceAnnotation(name):
        yield


def columns_per_second(ncol: int, fn, *args, n_iter: int = 10, warmup: int = 1) -> float:
    """Steady-state throughput of a jitted column-batch function."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = fn(*args)
    jax.block_until_ready(out)
    return ncol * n_iter / (time.perf_counter() - t0)


def start_trace(logdir: str) -> None:
    """Begin a jax.profiler trace capture (view with TensorBoard/Perfetto)."""
    jax.profiler.start_trace(logdir)


def stop_trace() -> None:
    jax.profiler.stop_trace()
