"""Compacted vdW-channel tree passes (ops/tree.py::compact_topology).

The vdW-parameterization tree passes — E_vol2 + self-volumes
(ReferenceAGBNPKernels.cpp:358-384) and the WU self-volume-gradient force
pass (the two gamma rescans of ReferenceAGBNPKernels.cpp:713-747) — run on
the vdW parameterization of the build topology, where only ~13-19% of rows
carry nonzero switched volume; the compacted passes keep the ancestor
closure of those rows and must reproduce the full passes exactly at the
compaction point (dropped subtrees are all-dead and contribute exact 0.0
to every reduction channel).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openmm_agbnp_jax.models.constants import VOLMINA
from openmm_agbnp_jax.ops import tree as T

DATA = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "data")


def _tiny_lattice_system():
    """Dense 64-atom jittered lattice: multi-level tree, mixed live/dead
    vdW rows, seconds to build on one CPU core (the 264-atom fixture takes
    ~a minute and runs as the slow parametrization below)."""
    from openmm_agbnp_jax.models.oracle import AGBNPParams

    rng = np.random.default_rng(11)
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    pos = 0.28 * g + 0.03 * rng.standard_normal((64, 3))
    ish = (np.arange(64) % 3 == 2).astype(np.int64)
    radius = np.where(ish > 0, 0.12, 0.16)
    gamma = np.where(ish > 0, 0.0, 48.9528)
    alpha = np.where(ish > 0, -20.0, -60.0)
    charge = rng.uniform(-0.3, 0.3, size=64)
    return AGBNPParams(radius=radius, gamma=gamma, alpha=alpha,
                       charge=charge, ishydrogen=ish), pos


@pytest.fixture(scope="module",
                params=["tiny64",
                        pytest.param("gaussvol264",
                                     marks=pytest.mark.slow)])
def built_vdw(request):
    """Full build + vdW rescan levels (tiny lattice by default; the
    264-atom reference fixture in the slow run)."""
    from openmm_agbnp_jax.models.agbnp_jax import prepare_arrays

    if request.param == "tiny64":
        params, pos = _tiny_lattice_system()
    else:
        params, pos = request.getfixturevalue("gaussvol_system")
    a = prepare_arrays(params)
    pos = jnp.asarray(pos, jnp.float64)
    caps = T.TreeCaps.for_natoms(params.n, boost=1.5)

    @jax.jit
    def build(pos):
        gdr = jnp.asarray(a["gamma"] / params.roffset)
        ish = jnp.asarray(a["ishydrogen"])
        lvl1 = T.make_level1(pos, jnp.asarray(a["radii_large"]),
                             jnp.asarray(a["vol_large"]), gdr, ish)
        levels, _ = T.build_tree(lvl1, jnp.asarray(a["pairs_i"]),
                                 jnp.asarray(a["pairs_j"]), caps)
        lvl1_vdw = T.make_level1(pos, jnp.asarray(a["radii_vdw"]),
                                 jnp.asarray(a["vol_vdw"]), -gdr, ish)
        return lvl1_vdw, T.rescan_volumes(levels, lvl1_vdw)

    lvl1_vdw, levels_vdw = build(pos)
    return a, params, pos, lvl1_vdw, levels_vdw


def test_compact_counts_match_numpy(built_vdw):
    """compact_topology's kept counts equal a NumPy restatement of
    live-rows-plus-ancestor-closure."""
    a, params, pos, lvl1_vdw, levels_vdw = built_vdw
    caps = [l["valid"].shape[0] for l in levels_vdw]
    topo_c, counts = jax.jit(
        lambda ls: T.compact_topology(ls, caps, relax=0.5))(levels_vdw)

    keep = []
    for l in levels_vdw:
        keep.append(np.asarray(l["valid"])
                    & (np.asarray(l["gv"]) > VOLMINA * 0.5))
    for li in range(len(keep) - 1, 0, -1):
        up = np.zeros(len(keep[li - 1]), bool)
        np.maximum.at(up, np.asarray(levels_vdw[li]["parent"])[keep[li]],
                      keep[li][keep[li]])
        keep[li - 1] |= up & np.asarray(levels_vdw[li - 1]["valid"])
    expect = np.array([k.sum() for k in keep])
    assert (np.asarray(counts) == expect).all()
    assert expect.sum() > 0
    # the fixture must actually exercise dropping: strictly fewer kept rows
    # than valid rows, else the compaction-exactness tests are vacuous
    total_valid = sum(int(np.asarray(l["valid"]).sum()) for l in levels_vdw)
    assert expect.sum() < total_valid, (expect.sum(), total_valid)
    # the compacted valid counts agree (no truncation at these caps)
    got = np.array([int(np.asarray(t["valid"]).sum()) for t in topo_c])
    assert (got == expect).all()
    # remapped parent ids are in-range and monotone over the valid prefix
    for li, t in enumerate(topo_c):
        v = np.asarray(t["valid"])
        par = np.asarray(t["parent"])[v]
        pmono = np.asarray(t["bnd"]["pmono"])
        assert (np.diff(pmono) >= 0).all()
        if li > 0:
            assert (par >= 0).all() and (par < expect[li - 1]).all()


def test_compact_wu_reduce_exact(built_vdw):
    """The compacted WU pass reproduces the full pass's forces exactly
    (float64): dropped rows contribute exact zeros."""
    a, params, pos, lvl1_vdw, levels_vdw = built_vdw
    rng = np.random.default_rng(7)
    gamma_WU = jnp.asarray(rng.normal(size=params.n))

    caps = [l["valid"].shape[0] for l in levels_vdw]

    @jax.jit
    def both(gamma_WU):
        # full-topology pass as in models/agbnp_jax.py::energy_forces
        lvl1_full = {**lvl1_vdw, "gamma1i": gamma_WU}
        red_full = T.reduce_tree(T.rescan_gammas(levels_vdw, lvl1_full),
                                 lvl1_full, with_selfvol=False)
        topo_c, _ = T.compact_topology(levels_vdw, caps, relax=0.5)
        lvl1_WU = T.make_level1(pos, jnp.asarray(a["radii_vdw"]),
                                jnp.asarray(a["vol_vdw"]), gamma_WU,
                                jnp.asarray(a["ishydrogen"]))
        red_c = T.reduce_tree(T.rescan_volumes(topo_c, lvl1_WU), lvl1_WU,
                              with_selfvol=False)
        return red_full, red_c

    red_full, red_c = both(gamma_WU)

    np.testing.assert_allclose(np.asarray(red_c["dr"]),
                               np.asarray(red_full["dr"]),
                               rtol=1e-12, atol=1e-14)


def test_compact_truncation_detected(built_vdw):
    """Kept counts past the compact capacity are reported (counts hold the
    pre-truncation value) so the PanicButton regrow can fire."""
    a, params, pos, lvl1_vdw, levels_vdw = built_vdw
    tiny = [8] * 7
    topo_c, counts = T.compact_topology(levels_vdw, tiny, relax=0.5)
    counts = np.asarray(counts)
    assert counts[0] > 8  # level 2 live rows exceed the tiny cap
    for t in topo_c:
        assert int(np.asarray(t["valid"]).sum()) <= 8


def test_energy_forces_compact_exact(built_vdw):
    """energy_forces with vdw_topology reproduces the full fixed-topology
    evaluation at the compaction point: identical energy and forces to
    float64 roundoff (the compacted pass only reroutes the WU force term,
    whose dropped rows contribute exact zeros)."""
    from openmm_agbnp_jax.models.agbnp_jax import energy_forces

    a, params, pos, lvl1_vdw, levels_vdw = built_vdw
    topo = T.tree_topology(levels_vdw)
    caps_full = [l["valid"].shape[0] for l in levels_vdw]
    topo_c, _ = jax.jit(
        lambda ls: T.compact_topology(ls, caps_full, relax=0.5))(levels_vdw)

    caps = T.TreeCaps.for_natoms(params.n, boost=1.5)
    ntj = int(np.max(np.asarray(a["type_j"])) + 1)
    from functools import partial
    ef = jax.jit(partial(energy_forces, caps=caps, version=1,
                         roffset=params.roffset, ntypes_j=ntj))
    full = ef(a, pos, topology=topo)
    comp = ef(a, pos, topology=topo, vdw_topology=topo_c)

    np.testing.assert_allclose(float(comp["energy"]), float(full["energy"]),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(comp["force"]),
                               np.asarray(full["force"]),
                               rtol=1e-9, atol=1e-10)


@pytest.mark.slow
def test_md_vdw_compact_matches_full(tmp_path):
    """Short MD windows: the compacted-WU trajectory matches the
    full-WU-pass trajectory (dropped rows stay dead over a short window)."""
    from openmm_agbnp_jax.io.dms import load_dms
    from openmm_agbnp_jax.md.simulation import Simulation

    dms = load_dms(os.path.join(DATA, "trpcage_agbnp1.dms"))
    sim = Simulation(dms, version=1, dtype=np.float64)
    key = jax.random.PRNGKey(3)

    run_full = sim.make_langevin_runner(neighbor_every=10, vdw_compact=False)
    p1, v1, _, e1, d1 = run_full(sim.positions, sim.velocities, key, 20)
    run_c = sim.make_langevin_runner(neighbor_every=10, vdw_compact=True)
    p2, v2, _, e2, (counts, nbmax, sibs, wu) = run_c(
        sim.positions, sim.velocities, key, 20)

    assert not sim._check_overflow(np.asarray(counts), nbmax, sibs,
                                   np.asarray(wu))
    np.testing.assert_allclose(np.asarray(p2), np.asarray(p1),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.asarray(e2), np.asarray(e1),
                               rtol=1e-10, atol=1e-8)
    # the compacted row counts really are a small fraction of the build's
    assert np.asarray(wu).sum() < 0.5 * np.asarray(counts).sum()


def test_wu_regrow_updates_caps(tmp_path):
    """_check_overflow flags WU truncation and _regrow grows the caps."""
    from openmm_agbnp_jax.io.dms import load_dms
    from openmm_agbnp_jax.md.simulation import Simulation

    dms = load_dms(os.path.join(DATA, "trpcage_agbnp1.dms"))
    sim = Simulation(dms, version=1, dtype=np.float64)
    sim._vdw_caps = (0.5, (8,) * 7)
    counts = np.zeros(7, np.int32)
    sibs = np.zeros(7, np.int32)
    wu = np.array([100, 50, 8, 8, 8, 8, 8], np.int32)
    assert sim._check_overflow(counts, 0, sibs, wu)
    sim._regrow(counts, 0, sibs, wu=wu)
    new = sim._vdw_caps[1]
    assert new[0] >= 104 and new[1] >= 56 and new[2] >= 8
    assert not sim._check_overflow(counts, 0, sibs, wu)
