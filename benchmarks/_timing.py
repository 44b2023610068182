"""Shared timing helpers for the benchmark harnesses.

Synced by fetching one leaf of the result to the host; one warmup call,
then n timed calls with a single end sync.
"""

import time

import jax


def sync_leaf(tree):
    return jax.device_get(jax.tree.leaves(tree)[0])


def time_compiled(compiled, args, sync=sync_leaf, n=5):
    """Mean seconds per call of an AOT-compiled function."""
    out = compiled(*args)
    sync(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = compiled(*args)
    sync(out)
    return (time.perf_counter() - t0) / n


def time_compiled_chain(compiled, arg, sync=sync_leaf, n=5):
    """Mean seconds per call of ``arg = compiled(arg)`` chained — the
    steady-state training-loop shape. Required when the program donates its
    input buffers (the original ``arg`` is dead after the first call).
    Returns ``(dt, last_out)`` so callers can keep the surviving state."""
    out = compiled(arg)
    sync(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = compiled(out)
    sync(out)
    return (time.perf_counter() - t0) / n, out
