"""GPU test lane: the golden anchor, the large-system build paths and an MD
smoke run compiled for the card.

Run on a machine with an NVIDIA GPU:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py -q

Everywhere else the suite validates the compute path on the CPU (f64);
these tests skip there.  Whether a card is present is decided inside the
`gpu` fixture, so every pytest worker collects the same tests.
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip(f"needs a GPU; default device is "
                    f"{jax.devices()[0].platform}")
    return jax


def test_golden_anchor_on_gpu(gpu, gaussvol_system):
    """AGBNP1 golden energy (-2476.66) from the fused f32 pipeline compiled
    for the card (reference golden fixture printouts); 0.5 absolute is the
    spread of reordered f32 pair sums."""
    from openmm_agbnp_jax.models.agbnp_jax import AGBNPModel

    params, pos = gaussvol_system
    m = AGBNPModel(params, version=1, dtype=np.float32,
                   positions=np.asarray(pos))
    e, f = m.energy_forces(pos)
    assert float(e) == pytest.approx(-2476.66, abs=0.5)
    assert np.isfinite(np.asarray(f)).all()


def test_chunked_build_and_cell_grid_on_gpu(gpu, gaussvol_system,
                                            monkeypatch):
    """The memory-bounded chunked sibling build and the O(N) cell-grid
    neighbor path, forced on at fixture scale through the budget
    attributes, must reproduce the one-shot results on the card."""
    import jax.numpy as jnp

    from openmm_agbnp_jax.models.agbnp_jax import AGBNPModel
    from openmm_agbnp_jax.ops import tree as T
    from openmm_agbnp_jax.ops.neighbors import (
        CellGrid, cell_neighbor_pairs, half_neighbor_pairs,
        tree_pair_cutoff)

    params, pos = gaussvol_system
    kw = dict(version=1, dtype=np.float32, positions=np.asarray(pos),
              cutoff=1.0, descreen_horizon="cutoff")
    e0, f0 = AGBNPModel(params, **kw).energy_forces(pos)

    monkeypatch.setattr(T, "_SLICE_BUILD_TOTAL", 1)
    monkeypatch.setattr(T, "_CHUNK_LEVEL_MIN", 1)
    monkeypatch.setattr(T, "_CHUNK_ROWS", 1 << 10)
    e1, f1 = AGBNPModel(params, **kw).energy_forces(pos)
    f0a, f1a = np.asarray(f0), np.asarray(f1)
    assert abs(float(e1) - float(e0)) <= 1e-6 * abs(float(e0))
    assert np.abs(f1a - f0a).max() <= 1e-5 * max(1.0, np.abs(f0a).max())

    heavy = np.asarray(params.ishydrogen) == 0
    rcut = tree_pair_cutoff(params.radii_large) + 0.05
    grid = CellGrid(np.asarray(pos), rcut, heavy_mask=heavy)
    q = jnp.asarray(pos, np.float32)
    hm = jnp.asarray(heavy)
    pi_g, pj_g, pv_g, _ = cell_neighbor_pairs(q, hm, rcut, 64, grid=grid)
    pi_h, pj_h, pv_h, _ = half_neighbor_pairs(q, hm, rcut, 64)
    set_g = {tuple(sorted((int(a), int(b)))) for a, b, v in
             zip(np.asarray(pi_g), np.asarray(pj_g), np.asarray(pv_g)) if v}
    set_h = {tuple(sorted((int(a), int(b)))) for a, b, v in
             zip(np.asarray(pi_h), np.asarray(pj_h), np.asarray(pv_h)) if v}
    assert set_g == set_h


def test_md_smoke_on_gpu(gpu):
    """A short trp-cage MD run on the card: finite energies, no overflow."""
    from openmm_agbnp_jax.io.dms import load_dms
    from openmm_agbnp_jax.md.simulation import Simulation

    data = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "data")
    dms = load_dms(os.path.join(data, "trpcage_agbnp1.dms"))
    sim = Simulation(dms, version=1, cutoff=1.0, dtype=np.float32,
                     descreen_horizon="cutoff")
    res = sim.run_md(50, neighbor_every=10)
    assert np.isfinite(res["energies"]).all()
    assert not res["overflow"]
