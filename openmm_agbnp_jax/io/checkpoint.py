"""Exact-resume MD checkpoints.

The reference ecosystem persists state only through the .dms file format
(benchmark scripts copy the SQLite file and write final positions and
velocities back, reference example/trpcage_benchmark.py:9-43 — mirrored by
io/dms.py::save_dms).  That restart is *statistical*: the Langevin RNG
stream is lost, so a restarted trajectory diverges from the uninterrupted
one.  This module adds what a functional RNG makes cheap on this stack:
the JAX PRNG key is ordinary data, so saving (step, positions, velocities,
key) at a segment boundary lets `Simulation.run_md` resume and reproduce
the uninterrupted trajectory (same compiled executable, same key stream):
bitwise where the reductions are deterministic (the CPU); on the GPU the
scatter-add atomics change summation order from run to run, so two runs
agree only to that spread.

Format: a single .npz written atomically (tmp file + os.replace), so a
crash mid-write never corrupts the previous checkpoint.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

_FORMAT_VERSION = 1


def save_checkpoint(path: str, step: int, positions, velocities, key,
                    meta: dict | None = None) -> None:
    """Atomically write an MD checkpoint.

    step is the number of completed MD steps; positions/velocities are
    [N, 3]; key is the JAX PRNG key *as of that boundary* (any dtype /
    typed-key layout — it is round-tripped through jax.random.key_data).
    meta is an optional JSON-serializable dict (dt, temperature, ...).
    """
    import jax

    keydata = np.asarray(jax.random.key_data(key)
                         if jax.dtypes.issubdtype(np.asarray(key).dtype,
                                                  jax.dtypes.prng_key)
                         else key)
    payload = dict(
        format_version=np.int64(_FORMAT_VERSION),
        step=np.int64(step),
        positions=np.asarray(positions),
        velocities=np.asarray(velocities),
        key=keydata,
        meta=np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8),
    )
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> dict:
    """Read a checkpoint written by save_checkpoint.

    Returns dict(step, positions, velocities, key, meta); key is a raw
    uint32 key-data array accepted directly by run_md(key=...).
    """
    with np.load(path) as z:
        version = int(z["format_version"])
        if version > _FORMAT_VERSION:
            raise ValueError(f"checkpoint format {version} is newer than "
                             f"this library supports ({_FORMAT_VERSION})")
        return dict(
            step=int(z["step"]),
            positions=z["positions"],
            velocities=z["velocities"],
            key=z["key"],
            meta=json.loads(bytes(z["meta"]).decode() or "{}"),
        )
