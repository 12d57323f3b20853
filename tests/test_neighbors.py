"""Cell-grid neighbor build vs the dense O(N^2) reference build."""

import jax.numpy as jnp
import numpy as np
import pytest

from openmm_agbnp_jax.ops.neighbors import (
    CellGrid,
    cell_neighbor_pairs,
    half_neighbor_pairs,
)


def _pair_set(pi, pj, pv):
    pi, pj, pv = np.asarray(pi), np.asarray(pj), np.asarray(pv)
    return set(zip(pi[pv].tolist(), pj[pv].tolist()))


def _random_blob(n, seed=0, spread=None):
    rng = np.random.default_rng(seed)
    spread = spread if spread is not None else (n / 40.0) ** (1 / 3)
    pos = rng.uniform(0, spread, size=(n, 3))
    heavy = rng.uniform(size=n) < 0.6
    return pos, heavy


@pytest.mark.parametrize("n,seed", [(200, 0), (500, 1), (1000, 2)])
def test_cell_list_matches_dense(n, seed):
    pos, heavy = _random_blob(n, seed)
    rcut = 0.75
    kmax = 128
    grid = CellGrid(pos, rcut, heavy_mask=heavy)
    posj, hj = jnp.asarray(pos), jnp.asarray(heavy)
    ref = half_neighbor_pairs(posj, hj, rcut, kmax)
    got = cell_neighbor_pairs(posj, hj, rcut, kmax, grid)
    assert _pair_set(*got[:3]) == _pair_set(*ref[:3])
    assert int(got[3]) == int(ref[3])


def test_cell_list_drifted_positions():
    """Atoms that drift outside the initial grid clamp to edge cells and
    still find all their neighbors (no false negatives)."""
    pos, heavy = _random_blob(400, 3)
    grid = CellGrid(pos, 0.75, heavy_mask=heavy)
    drifted = pos + np.array([2.5, -1.5, 3.0])  # fully outside the grid
    posj, hj = jnp.asarray(drifted), jnp.asarray(heavy)
    ref = half_neighbor_pairs(posj, hj, 0.75, 128)
    got = cell_neighbor_pairs(posj, hj, 0.75, 128, grid)
    assert _pair_set(*got[:3]) == _pair_set(*ref[:3])


def test_cell_overflow_detected():
    pos, heavy = _random_blob(300, 4)
    grid = CellGrid(pos, 0.75, ccap=8, heavy_mask=heavy)
    # collapse many atoms into one cell to blow the capacity
    pos2 = pos.copy()
    pos2[:40] = pos2[0] + 0.01 * np.arange(40)[:, None]
    heavy2 = heavy.copy()
    heavy2[:40] = True
    kmax = 128
    got = cell_neighbor_pairs(jnp.asarray(pos2), jnp.asarray(heavy2),
                              0.75, kmax, grid)
    assert int(got[3]) > kmax or int(got[3]) >= 39
    # regrown grid has doubled capacity
    assert grid.grown().ccap == 2 * grid.ccap


def test_trpcage_cell_list_matches(fixture_dir):
    import os

    from openmm_agbnp_jax.io.dms import load_dms
    from openmm_agbnp_jax.ops.neighbors import tree_pair_cutoff

    dms = load_dms(os.path.join(os.path.dirname(fixture_dir), "..",
                                "benchmarks", "data", "trpcage_agbnp1.dms"))
    heavy = dms.ishydrogen == 0
    rcut = tree_pair_cutoff(dms.agbnp_radius + 0.05) + 0.15
    grid = CellGrid(dms.positions, rcut, heavy_mask=heavy)
    posj, hj = jnp.asarray(dms.positions), jnp.asarray(heavy)
    ref = half_neighbor_pairs(posj, hj, rcut, 160)
    got = cell_neighbor_pairs(posj, hj, rcut, 160, grid)
    assert _pair_set(*got[:3]) == _pair_set(*ref[:3])
