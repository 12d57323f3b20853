"""Temperature replica-exchange MD (parallel/remd.py).

The exchange move is unit-tested against a NumPy reimplementation (exact
decisions, both parities), and the full on-device REMD loop is validated
by equivalence: with all rung temperatures equal, every swap is accepted
but the dynamics must be untouched, so the REMD trajectory equals the
plain replica-ensemble trajectory exactly (same keys, same window
structure).  The reference plugin has no REMD (exchanges live in external
host schedulers); this subsystem is native to this implementation.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openmm_agbnp_jax.md.integrators import KB
from openmm_agbnp_jax.parallel.remd import (
    TemperatureREMD,
    attempt_swaps,
    geometric_ladder,
)


def _numpy_attempt_swaps(u, rung, U, betas, parity):
    """Literal NumPy restatement of the even/odd Metropolis sweep."""
    R = len(rung)
    ror = np.empty(R, dtype=int)
    ror[rung] = np.arange(R)
    U_rung = U[ror]
    new_of_rung = np.arange(R)
    accept = np.zeros(R, dtype=bool)
    for q in range(parity, R - 1, 2):
        p = q + 1
        delta = (betas[q] - betas[p]) * (U_rung[q] - U_rung[p])
        if u[q] < min(1.0, np.exp(min(delta, 0.0))):
            new_of_rung[q], new_of_rung[p] = p, q
            accept[q] = accept[p] = True
    return new_of_rung[rung], accept


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("R", [2, 5, 8])
def test_attempt_swaps_matches_numpy(parity, R):
    rng = np.random.default_rng(R * 10 + parity)
    U = jnp.asarray(rng.normal(scale=50.0, size=R))
    rung = jnp.asarray(rng.permutation(R).astype(np.int32))
    betas = jnp.asarray(1.0 / (KB * geometric_ladder(300.0, 600.0, R)))
    key = jax.random.PRNGKey(R + parity)
    new_rung, accept = jax.jit(attempt_swaps, static_argnames=())(
        key, rung, U, betas, parity)
    u = np.asarray(jax.random.uniform(key, (R,), dtype=U.dtype))
    ref_rung, ref_accept = _numpy_attempt_swaps(
        u, np.asarray(rung), np.asarray(U), np.asarray(betas), parity)
    np.testing.assert_array_equal(np.asarray(new_rung), ref_rung)
    np.testing.assert_array_equal(np.asarray(accept), ref_accept)
    # rungs remain a permutation
    assert sorted(np.asarray(new_rung).tolist()) == list(range(R))


def test_attempt_swaps_equal_temps_accept_all():
    """Equal temperatures: delta == 0, so every valid pair swaps."""
    R = 6
    betas = jnp.full(R, 1.0 / (KB * 300.0))
    rung = jnp.arange(R, dtype=jnp.int32)
    U = jnp.asarray(np.random.default_rng(0).normal(size=R))
    for parity in (0, 1):
        new_rung, accept = attempt_swaps(jax.random.PRNGKey(parity), rung,
                                         U, betas, parity)
        acc = np.asarray(accept)
        expected = np.zeros(R, dtype=bool)
        for q in range(parity, R - 1, 2):
            expected[q] = expected[q + 1] = True
        np.testing.assert_array_equal(acc, expected)
        assert sorted(np.asarray(new_rung).tolist()) == list(range(R))


def test_geometric_ladder():
    t = geometric_ladder(300.0, 600.0, 5)
    assert t[0] == pytest.approx(300.0) and t[-1] == pytest.approx(600.0)
    r = t[1:] / t[:-1]
    np.testing.assert_allclose(r, r[0], rtol=1e-12)
    assert geometric_ladder(300.0, 600.0, 1).shape == (1,)


@pytest.fixture(scope="module")
def trp_sim():
    from openmm_agbnp_jax.io.dms import load_dms
    from openmm_agbnp_jax.md.simulation import Simulation

    path = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "data", "trpcage_agbnp1.dms")
    return Simulation(load_dms(path), version=1, dtype=np.float64)


@pytest.mark.slow
def test_remd_equal_temps_matches_ensemble(trp_sim):
    """With an all-equal ladder every exchange is accepted, but the
    velocity rescale is 1 and the per-replica temperature never changes —
    so REMD must reproduce the plain ReplicaEnsemble trajectory exactly
    (identical keys and stale-topology window structure)."""
    from openmm_agbnp_jax.parallel.ensemble import ReplicaEnsemble

    R, ne, ncycles = 2, 5, 2
    remd = TemperatureREMD(trp_sim, [300.0] * R)
    states, xkey = remd.initial_states(jitter=1e-3, seed=3)
    pos0, vel0, keys0, rung0 = states

    run = remd.make_runner(dt=0.001, steps_per_cycle=ne, neighbor_every=ne)
    (pos, vel, keys, rung), xkey, out = run(states, xkey, ncycles)

    # every attempted pair accepted ((0,1) attempted on even cycles only)
    accept = np.asarray(out["accept"])
    assert accept[0].all() and not accept[1].any()

    ens = ReplicaEnsemble(trp_sim, R, mesh=remd.mesh)
    erun = ens.make_runner(dt=0.001, neighbor_every=ne)
    estate, eout = erun((pos0, vel0, keys0), ncycles * ne)

    np.testing.assert_allclose(np.asarray(pos), np.asarray(estate[0]),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(vel), np.asarray(estate[1]),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out["energies"]),
                               np.asarray(eout[0]), rtol=1e-12)


@pytest.mark.slow
def test_remd_ladder_runs_and_mixes(trp_sim):
    """4-rung ladder on the 8-device mesh: runs end-to-end, rung traces
    stay permutations, exchange bookkeeping is self-consistent."""
    remd = TemperatureREMD(trp_sim, geometric_ladder(300.0, 450.0, 4))
    res = remd.sample(ncycles=4, steps_per_cycle=5, neighbor_every=5,
                      jitter=1e-3, seed=11)
    rungs = res["rung"]  # [C, R]
    for c in range(rungs.shape[0]):
        assert sorted(rungs[c].tolist()) == [0, 1, 2, 3]
    assert np.isfinite(res["U"]).all()
    assert np.isfinite(res["energies"]).all()
    rates = res["pair_acceptance"]
    assert rates.shape == (3,)
    assert ((rates >= 0) & (rates <= 1)).all()
