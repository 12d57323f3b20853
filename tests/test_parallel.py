"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openmm_agbnp_jax.parallel.sharding import (
    atom_mesh,
    replica_mesh,
    sharded_pair_phases,
)


@pytest.fixture(scope="module")
def tiny_sim(fixture_dir):
    import os

    from openmm_agbnp_jax.io.dms import load_dms
    from openmm_agbnp_jax.md.simulation import Simulation

    dms = load_dms(os.path.join(os.path.dirname(fixture_dir), "..",
                                "benchmarks", "data", "trpcage_agbnp1.dms"))
    return Simulation(dms, version=1, dtype=np.float64)


def test_eight_devices_present():
    assert len(jax.devices()) == 8


@pytest.mark.slow
def test_sharded_pair_phases_match_dense(gaussvol_system):
    """AGBNP1 energy + forces with the pair phases row-sharded over an
    8-device atoms mesh equal the single-device dense path to f64 roundoff
    on the 264-atom reference fixture."""
    from functools import partial

    from openmm_agbnp_jax.models.agbnp_jax import (
        energy_forces, prepare_arrays)
    from openmm_agbnp_jax.ops.tree import TreeCaps

    params, pos = gaussvol_system
    arrays = prepare_arrays(params, dtype=np.float64)
    caps = TreeCaps.for_natoms(params.n)
    ntypes_j = int(np.max(np.asarray(arrays["type_j"])) + 1)

    kw = dict(caps=caps, version=1, roffset=params.roffset,
              ntypes_j=ntypes_j)
    ref = jax.jit(partial(energy_forces, **kw))(arrays, jnp.asarray(pos))

    mesh = atom_mesh(8)
    shard = sharded_pair_phases(mesh, arrays, ntypes_j)
    out = jax.jit(partial(energy_forces, pair_shard=shard, **kw))(
        arrays, jnp.asarray(pos))

    np.testing.assert_allclose(float(out["energy"]), float(ref["energy"]),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(out["force"]),
                               np.asarray(ref["force"]),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(out["details"]["born_radius"]),
        np.asarray(ref["details"]["born_radius"]), rtol=1e-12)


@pytest.mark.slow
def test_sharded_tree_and_pair_pipeline_match_dense(gaussvol_system):
    """The FULL fixed-topology AGBNP1 pipeline — cavity tree passes, pair
    phases, and the W/U gamma-rescan force pass — sharded over an 8-device
    atoms mesh (sharded_energy_forces: tree level rows in blocks with
    all_gather/psum_scatter collectives) equals the single-device path on
    the same topology to f64 roundoff on the 264-atom reference fixture."""
    from functools import partial

    from openmm_agbnp_jax.models.agbnp_jax import (
        energy_forces, prepare_arrays)
    from openmm_agbnp_jax.ops import tree as T
    from openmm_agbnp_jax.parallel.sharding import (
        sharded_energy_forces)

    params, pos = gaussvol_system
    arrays = prepare_arrays(params, dtype=np.float64)
    caps = T.TreeCaps.for_natoms(params.n)
    ntypes_j = int(np.max(np.asarray(arrays["type_j"])) + 1)
    pos = jnp.asarray(pos)

    # build the overlap-tree topology once (replicated, as in MD rebuilds)
    gamma_dr = jnp.asarray(arrays["gamma"]) / params.roffset
    lvl1_large = T.make_level1(pos, jnp.asarray(arrays["radii_large"]),
                               jnp.asarray(arrays["vol_large"]), gamma_dr,
                               jnp.asarray(arrays["ishydrogen"]))
    levels, _ = jax.jit(lambda: T.build_tree(
        lvl1_large, arrays["pairs_i"], arrays["pairs_j"], caps,
        pairs_valid=arrays["pairs_valid"]))()
    topo = T.tree_topology(levels)

    kw = dict(caps=caps, version=1, roffset=params.roffset,
              ntypes_j=ntypes_j)
    ref = jax.jit(partial(energy_forces, topology=topo, **kw))(arrays, pos)

    mesh = atom_mesh(8)
    fn = jax.jit(sharded_energy_forces(mesh, arrays, params.roffset,
                                       ntypes_j))
    out = fn(pos, topo)

    np.testing.assert_allclose(float(out["energy"]), float(ref["energy"]),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(out["force"]),
                               np.asarray(ref["force"]),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(out["born_radius"]),
        np.asarray(ref["details"]["born_radius"]), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(out["self_volume"]),
        np.asarray(ref["details"]["self_volume"]), rtol=1e-10)


@pytest.mark.slow
def test_replica_ensemble_md(tiny_sim):
    """8 replicas sharded over 8 CPU devices; energies diverge per replica
    (independent noise) and stay finite."""
    from openmm_agbnp_jax.parallel.ensemble import ReplicaEnsemble

    ens = ReplicaEnsemble(tiny_sim, n_replicas=8)
    # nsteps NOT a multiple of the rebuild window: 5 = 2 windows of 2 + a
    # remainder window of 1 (the runner splits it, no API restriction)
    run = ens.make_runner(dt=0.001, neighbor_every=2)
    states = ens.initial_states(jitter=1e-4)
    states, (energies, counts, nbmax, sibs, *vdwc) = run(states, 5)
    energies = np.asarray(energies)
    assert energies.shape == (8, 5)
    assert np.isfinite(energies).all()
    # different PRNG streams -> trajectories diverge
    assert len(np.unique(energies[:, -1])) > 1
    # overflow diagnostics ride the run: no replica overflowed here
    assert not tiny_sim._check_overflow(
        np.asarray(counts).max(axis=0), int(np.asarray(nbmax).max()),
        np.asarray(sibs).max(axis=0),
        np.asarray(vdwc[0]).max(axis=0) if vdwc else None)


@pytest.mark.slow
def test_sharded_md_runner_matches_plain(tiny_sim):
    """Multi-chip MD: make_langevin_runner(mesh=...) runs every step's
    AGBNP pair + tree passes sharded over the 8-device atoms mesh and must
    reproduce the single-device runner's trajectory (same PRNG stream) to
    f64 roundoff."""
    from openmm_agbnp_jax.parallel.sharding import atom_mesh

    mesh = atom_mesh(8)
    run_s = tiny_sim.make_langevin_runner(dt=0.001, neighbor_every=6,
                                          mesh=mesh)
    run_p = tiny_sim.make_langevin_runner(dt=0.001, neighbor_every=6)
    key = jax.random.PRNGKey(7)
    ps, _, _, es, _ = run_s(tiny_sim.positions, tiny_sim.velocities, key, 12)
    pp, _, _, ep, _ = run_p(tiny_sim.positions, tiny_sim.velocities, key, 12)
    np.testing.assert_allclose(np.asarray(es), np.asarray(ep),
                               rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(np.asarray(ps), np.asarray(pp),
                               rtol=0, atol=1e-12)
