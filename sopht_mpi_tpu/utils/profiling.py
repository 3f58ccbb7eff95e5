"""Profiling / benchmarking helpers.

The reference ships no tracing or profiling hooks (SURVEY.md section 5.1);
these are new utilities: JAX's async dispatch means naive ``time.time()``
around a call measures dispatch latency, not device time, so everything
here blocks on results and (for per-op costs) amortizes over an on-device
``lax.scan``.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def block_timer(label: str = "", results: dict | None = None, echo=print):
    """Context manager timing a block, blocking on all live jax arrays the
    block yields through ``results`` (mapping name -> array)."""
    t0 = time.perf_counter()
    yield
    if results:
        jax.block_until_ready(tuple(results.values()))
    elapsed = time.perf_counter() - t0
    if echo is not None:
        echo(f"{label or 'block'}: {elapsed * 1e3:.2f} ms")
    if results is not None:
        results["elapsed_s"] = elapsed


def measure_op_time(fn, example_arg, *, iters: int = 10, repeats: int = 2):
    """Per-call device time of ``fn`` (a shape-preserving pure function of
    one pytree) amortized over an on-device ``lax.scan`` of ``iters``
    applications - neutralizing per-dispatch latency.

    :returns: best-of-``repeats`` seconds per call.
    """
    stepped = jax.jit(
        lambda x: jax.lax.scan(lambda c, _: (fn(c), None), x, None,
                               length=iters)[0]
    )

    out = jax.block_until_ready(stepped(example_arg))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(stepped(out))
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def trace_to(log_dir: str):
    """Context manager wrapping ``jax.profiler.trace`` (XPlane traces for
    TensorBoard / xprof)."""
    return jax.profiler.trace(log_dir)
