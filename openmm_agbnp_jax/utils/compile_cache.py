"""Compilation plumbing shared by the entry points.

enable_compile_cache places JAX's persistent XLA compilation cache: in
JAX_COMPILATION_CACHE_DIR when that is set, otherwise in one fixed
directory inside the checkout (listed in .gitignore) — the path is part of
the cache key, so a cache that moves never hits.  run_concurrently runs
independent jobs (compiles, above all) in threads.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory.  Call before the first compilation."""
    import jax

    path = os.environ.get(ENV_VAR) or DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def run_concurrently(jobs: dict) -> dict:
    """Run the callables of `jobs` ({name: fn}) in one thread each and
    return {name: (result, seconds)}.  XLA compiles with the interpreter
    lock released, so independent programs compile in parallel; a job
    that raises re-raises here after every job has finished."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
        futures = {name: pool.submit(timed, fn) for name, fn in jobs.items()}
    return {name: f.result() for name, f in futures.items()}
