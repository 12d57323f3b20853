"""SHAKE/RATTLE constraint tests on the trp-cage benchmark system.

The reference applies the Desmond constraint_ah* X-H constraints through
DesmondDMSFile.createSystem (reference example/trpcage_benchmark.py:11); here
md/constraints.py solves the same tables inside the jitted MD loop.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest


@pytest.fixture(scope="module")
def trpcage_dms(fixture_dir):
    from openmm_agbnp_jax.io.dms import load_dms

    return load_dms(os.path.join(os.path.dirname(fixture_dir), "..",
                                 "benchmarks", "data", "trpcage_agbnp1.dms"))


def _bond_err(cons, pos):
    return float(cons.max_violation(jnp.asarray(pos)))


def test_constraint_tables_loaded(trpcage_dms):
    # trpcage: 48 ah1 + 2*31 ah2 + 3*6 ah3 = 128 X-H constraints
    assert trpcage_dms.constraint_idx.shape == (128, 2)
    # every constrained light atom is a hydrogen
    assert (trpcage_dms.anum[trpcage_dms.constraint_idx[:, 1]] == 1).all()
    assert (trpcage_dms.constraint_d > 0.05).all()
    assert (trpcage_dms.constraint_d < 0.2).all()


def test_shake_projects_and_rattle_orthogonal(trpcage_dms):
    from openmm_agbnp_jax.md.constraints import Constraints

    cons = Constraints.from_dms(trpcage_dms)
    pos = jnp.asarray(trpcage_dms.positions)
    rng = np.random.default_rng(0)
    noisy = pos + 0.002 * jnp.asarray(rng.normal(size=pos.shape))
    fixed = cons.positions(noisy, pos)
    assert _bond_err(cons, fixed) < 1e-7
    # the projection is mass-weighted-minimal: heavy atoms barely move
    assert float(jnp.abs(fixed - noisy).max()) < 0.01

    vel = jnp.asarray(rng.normal(size=pos.shape))
    velc = cons.velocities(fixed, vel)
    r = fixed[cons.a] - fixed[cons.b]
    rate = jnp.abs(jnp.sum(r * (velc[cons.a] - velc[cons.b]), axis=-1))
    assert float(jnp.max(rate / (cons.d ** 2))) < 1e-7


@pytest.mark.slow
def test_constrained_langevin_2fs(trpcage_dms):
    """Constrained MD holds X-H bond lengths at a 2 fs step — the step size
    the unconstrained setup cannot take (X-H stretch period ~10 fs)."""
    from openmm_agbnp_jax.md.simulation import Simulation

    sim = Simulation(trpcage_dms, version=1, dtype=np.float64,
                     constraints=True)
    assert sim.constraints is not None
    run = sim.make_langevin_runner(dt=0.002, neighbor_every=10)
    pos, vel, key, energies, _ = run(sim.positions, sim.velocities,
                                     jax.random.PRNGKey(0), 20)
    assert np.isfinite(np.asarray(energies)).all()
    assert _bond_err(sim.constraints, pos) < 1e-7


def test_block_solver_matches_jacobi(trpcage_dms):
    """The star-cluster 3x3 block solver and the global Jacobi iteration
    project onto the same constraint manifold (both are mass-weighted
    least-norm corrections, so the converged answers coincide)."""
    from openmm_agbnp_jax.md.constraints import Constraints

    cons = Constraints.from_dms(trpcage_dms, tol=1e-12)
    assert cons.clusters is not None  # trpcage's tables are a star forest
    jac = Constraints.from_dms(trpcage_dms, tol=1e-12)
    jac.clusters = None  # force the fallback path

    pos = jnp.asarray(trpcage_dms.positions, jnp.float64)
    rng = np.random.default_rng(7)
    noisy = pos + 0.003 * jnp.asarray(rng.normal(size=pos.shape))
    xb = cons.positions(noisy, pos)
    xj = jac.positions(noisy, pos)
    assert float(jnp.abs(xb - xj).max()) < 1e-9

    vel = jnp.asarray(rng.normal(size=pos.shape))
    vb = cons.velocities(xb, vel)
    vj = jac.velocities(xb, vel)
    assert float(jnp.abs(vb - vj).max()) < 1e-9


def test_non_star_tables_fall_back_to_jacobi():
    """A constraint chain (0-1, 1-2 with atom 1 on both sides) is not a
    star forest; the solver must fall back to Jacobi and still converge."""
    from openmm_agbnp_jax.md.constraints import Constraints

    idx = np.array([[0, 1], [1, 2]])
    d = np.array([0.1, 0.1])
    masses = np.array([12.0, 12.0, 1.0])
    cons = Constraints(idx, d, masses, tol=1e-10)
    assert cons.clusters is None
    x = jnp.asarray([[0.0, 0.0, 0.0], [0.11, 0.0, 0.0], [0.11, 0.105, 0.0]],
                    jnp.float64)
    ref = jnp.asarray([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [0.1, 0.1, 0.0]],
                      jnp.float64)
    fixed = cons.positions(x, ref)
    assert float(cons.max_violation(fixed)) < 1e-8


@pytest.mark.slow
def test_constrained_verlet_energy(trpcage_dms):
    """SHAKE/RATTLE Verlet conserves energy at 1 fs with constraints on."""
    from openmm_agbnp_jax.md.integrators import kinetic_energy
    from openmm_agbnp_jax.md.simulation import Simulation

    sim = Simulation(trpcage_dms, version=1, dtype=np.float64,
                     constraints=True)
    # short equilibration to take the strain out of the initial state
    run = sim.make_langevin_runner(dt=0.001, neighbor_every=10)
    pos, vel, key, _, _ = run(sim.positions, sim.velocities,
                              jax.random.PRNGKey(1), 50)
    vrun = sim.make_verlet_runner(dt=0.001)
    pos2, vel2, pe, ke = vrun(pos, vel, 200)
    etot = np.asarray(pe) + np.asarray(ke)
    drift = abs(etot[-1] - etot[0])
    assert drift < 2.0, f"energy drift {drift} kJ/mol over 0.2 ps"
    assert _bond_err(sim.constraints, pos2) < 1e-7
