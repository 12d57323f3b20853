"""Profiling and observability helpers.

The reference's observability is verbose_level couts of per-term energies
and per-section iteration counts (reference ReferenceAGBNPKernels.cpp:328-352,
OpenCLAGBNPKernels.cpp:3649-3665).  The equivalents here:
  * energy_breakdown: per-term energies from the pipeline's details dict
  * tree_stats: per-level occupancy vs capacity (the NIterations analogue)
  * trace: jax.profiler wrapper writing a TensorBoard trace
"""

from __future__ import annotations

import contextlib

import numpy as np


def energy_breakdown(details: dict) -> dict:
    """Scalar energy terms from an energy_forces(details=True) output."""
    out = {}
    for key in ("e_vol1", "e_vol2", "e_cav", "gb_self", "gb_pair", "e_vdw"):
        if key in details:
            out[key] = float(details[key])
    return out


def tree_stats(diag) -> dict:
    """Per-level occupancy diagnostics (overlap counts vs capacities)."""
    counts = np.asarray(diag["counts"])
    caps = np.asarray(diag["caps"])
    return dict(counts=counts, caps=caps,
                occupancy=counts / np.maximum(caps, 1),
                max_siblings=np.asarray(diag["max_siblings"]))


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block with jax.profiler (view in TensorBoard/XProf)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
