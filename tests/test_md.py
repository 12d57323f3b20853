"""MD-layer tests: MM forces, integrators, conservation, vsites, minimizer."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow

DATA = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "data")


@pytest.fixture(scope="module")
def trpcage_sim():
    from openmm_agbnp_jax.io.dms import load_dms
    from openmm_agbnp_jax.md.simulation import Simulation

    dms = load_dms(os.path.join(DATA, "trpcage_agbnp1.dms"))
    return Simulation(dms, version=1, dtype=np.float64)


def test_mm_forces_fd(trpcage_sim):
    sim = trpcage_sim
    pos = sim.positions
    g = jax.grad(sim.mm.energy)(pos)
    rng = np.random.default_rng(0)
    for _ in range(2):
        d = jnp.asarray(rng.uniform(-1e-5, 1e-5, size=pos.shape))
        de = sim.mm.energy(pos + d) - sim.mm.energy(pos - d)
        assert float(de) == pytest.approx(float(2 * jnp.sum(g * d)), rel=1e-4)


def test_langevin_runs_and_reports_no_overflow(trpcage_sim):
    res = trpcage_sim.benchmark_langevin(nsteps=20, dt=0.001,
                                         neighbor_every=10, warmup=False)
    assert np.isfinite(res["energies"]).all()
    assert not res["overflow"]
    assert res["tree_counts_max"].shape == (7,)


def test_verlet_energy_conservation(trpcage_sim):
    run = trpcage_sim.make_verlet_runner(dt=0.0005)
    pos, vel, pe, ke = run(trpcage_sim.positions, trpcage_sim.velocities, 100)
    tot = np.asarray(pe) + np.asarray(ke)
    drift = abs(tot[-1] - tot[0])
    assert drift < 0.05 * abs(tot[0]) + 5.0


def test_fire_minimizer(trpcage_sim):
    from openmm_agbnp_jax.md.minimize import fire_minimize

    fn = trpcage_sim.force_fn()
    pos, energies = fire_minimize(fn, trpcage_sim.positions, maxiter=50)
    assert float(energies[-1]) < float(energies[0])


def test_virtual_sites_project_and_spread():
    from openmm_agbnp_jax.api.hydration import HydrationSites
    from openmm_agbnp_jax.md.vsites import (
        project_positions,
        spread_forces,
    )

    hs = HydrationSites()
    hs.add_hydrogen_bonding_site(3, heavy=0, hydrogen=1, distance=0.03)
    vs = hs.virtual_sites().arrays(np.float64)

    pos = jnp.asarray(np.array([[0.0, 0, 0], [0.1, 0, 0],
                                [5.0, 5, 5], [9.0, 9, 9]]))
    pos2 = project_positions(pos, vs)
    np.testing.assert_allclose(np.asarray(pos2[3]), [0.03, 0.0, 0.0],
                               atol=1e-12)

    force = jnp.zeros((4, 3)).at[3].set(jnp.array([1.0, 2.0, 3.0]))
    f2 = spread_forces(force, vs)
    np.testing.assert_allclose(np.asarray(f2[3]), 0.0)
    np.testing.assert_allclose(np.asarray(f2[0]), 0.7 * np.array([1.0, 2, 3]))
    np.testing.assert_allclose(np.asarray(f2[1]), 0.3 * np.array([1.0, 2, 3]))
    # total force conserved
    np.testing.assert_allclose(np.asarray(f2).sum(0),
                               np.asarray(force).sum(0))


def test_hashtable_parity():
    from openmm_agbnp_jax.utils.hashtable import AGBNPHtable

    t = AGBNPHtable(10)
    assert t.size() == 16
    slots = [t.h_enter(v) for v in (5, 21, 37, 8)]  # 5,21,37 collide mod 16
    assert len(set(slots)) == 4
    for v in (5, 21, 37, 8):
        assert t.values[t.h_find(v)] == v
    assert t.h_find(99) == -1


def test_dms_save_roundtrip(tmp_path):
    from openmm_agbnp_jax.io.dms import load_dms, save_dms

    src = os.path.join(DATA, "trpcage_agbnp1.dms")
    dst = str(tmp_path / "out.dms")
    dms = load_dms(src)
    newpos = dms.positions + 0.123
    newvel = dms.velocities + 0.456
    save_dms(src, dst, newpos, newvel)
    dms2 = load_dms(dst)
    np.testing.assert_allclose(dms2.positions, newpos, atol=1e-12)
    np.testing.assert_allclose(dms2.velocities, newvel, atol=1e-12)


def test_run_md_panic_button_regrow():
    """run_md with deliberately undersized tree capacities must detect the
    overflow, regrow, retry the segment, and land on the exact same
    trajectory as a well-sized run (capacities never change values, only
    whether they fit)."""
    import jax
    import numpy as np

    from openmm_agbnp_jax.io.dms import load_dms
    from openmm_agbnp_jax.md.simulation import Simulation
    from openmm_agbnp_jax.ops.tree import TreeCaps

    here = os.path.dirname(os.path.abspath(__file__))
    dms = load_dms(os.path.join(here, "..", "benchmarks", "data",
                                "trpcage_agbnp1.dms"))

    ok_sim = Simulation(dms, version=1, dtype=np.float64)
    ref = ok_sim.run_md(40, dt=0.001, neighbor_every=20, seed=3)
    assert ref["regrows"] == 0

    tiny = TreeCaps(caps=(256, 256, 256, 256, 128, 128, 128),
                    offs=(8, 8, 8, 8, 4, 4))
    small_sim = Simulation(dms, version=1, dtype=np.float64, caps=tiny)
    out = small_sim.run_md(40, dt=0.001, neighbor_every=20, seed=3)
    assert out["regrows"] >= 1
    np.testing.assert_allclose(np.asarray(out["final_pos"]),
                               np.asarray(ref["final_pos"]), atol=1e-12)
    np.testing.assert_allclose(out["energies"], ref["energies"], atol=1e-9)


def test_mts_inner1_matches_plain_langevin(trpcage_sim):
    """MTS (r-RESPA) with inner=1 applies the same net kick at the same
    positions with the same noise stream as the plain middle scheme, so the
    trajectories must agree to accumulation roundoff
    (md/integrators.py::mts_langevin_step)."""
    sim = trpcage_sim
    key = jax.random.PRNGKey(7)
    run0 = sim.make_langevin_runner(dt=0.001, neighbor_every=5)
    run1 = sim.make_langevin_runner(dt=0.001, neighbor_every=5, mts_inner=1)
    p0, v0, _, e0, _ = run0(sim.positions, sim.velocities, key, 10)
    p1, v1, _, e1, _ = run1(sim.positions, sim.velocities, key, 10)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p0), atol=1e-12)
    np.testing.assert_allclose(np.asarray(e1), np.asarray(e0), atol=1e-7)


def test_mts_langevin_stable_2fs(trpcage_sim):
    """2 fs outer / 1 fs bonded substeps: finite energies, sane
    temperature, no tree overflow over a short run."""
    from openmm_agbnp_jax.md.integrators import temperature

    sim = trpcage_sim
    key = jax.random.PRNGKey(1)
    run = sim.make_langevin_runner(dt=0.002, neighbor_every=5, mts_inner=2)
    pos, vel, _, e, (counts, nbmax, sibs, *_wu) = run(
        sim.positions, sim.velocities, key, 50)
    assert np.isfinite(np.asarray(e)).all()
    assert not sim._check_overflow(np.asarray(counts), nbmax, sibs)
    assert 0.0 < float(temperature(vel, sim.masses)) < 1500.0


def test_mts_verlet_energy_conservation(trpcage_sim):
    """Symmetric r-RESPA Verlet at 1 fs outer / 2 bonded substeps conserves
    total energy comparably to plain Verlet (the NVE analogue of the
    reference's install-test drift check, reference
    example/test_agbnp.py:58-64)."""
    from functools import partial

    from openmm_agbnp_jax.md.integrators import mts_verlet_step

    sim = trpcage_sim
    slow, fast = sim.force_fn(split=True)
    step = mts_verlet_step(slow, fast, sim.masses, dt=0.0005, inner=2)

    @partial(jax.jit, static_argnames=("nsteps",))
    def run(pos, vel, nsteps: int):
        _, f_slow, _ = slow(pos)
        _, f_fast = fast(pos)
        state = (pos, vel, f_slow, f_fast)
        state, (pe, ke, _) = jax.lax.scan(step, state, length=nsteps)
        return pe, ke

    pe, ke = run(sim.positions, sim.velocities, 100)
    tot = np.asarray(pe) + np.asarray(ke)
    drift = abs(tot[-1] - tot[0])
    assert np.isfinite(tot).all()
    assert drift < 0.05 * abs(tot[0]) + 5.0


def test_run_md_checkpoint_exact_resume(trpcage_sim, tmp_path):
    """Exact-resume checkpointing: a run interrupted at a segment boundary
    and resumed from the checkpoint (positions + velocities + PRNG key)
    reproduces the uninterrupted trajectory bitwise — beyond the
    reference's statistical .dms restart (example/trpcage_benchmark.py:
    9-43), which loses the RNG stream."""
    from openmm_agbnp_jax.io.checkpoint import load_checkpoint

    sim = trpcage_sim
    kw = dict(dt=0.001, neighbor_every=3, segment=6, seed=3)
    full = sim.run_md(12, **kw)

    ck_path = str(tmp_path / "md.ckpt.npz")
    part = sim.run_md(6, checkpoint_path=ck_path, **kw)
    ck = load_checkpoint(ck_path)
    assert ck["step"] == 6
    assert ck["meta"]["dt"] == 0.001
    np.testing.assert_array_equal(np.asarray(part["final_pos"]),
                                  ck["positions"])

    rest = sim.run_md(6, pos=ck["positions"], vel=ck["velocities"],
                      key=ck["key"], **kw)
    np.testing.assert_array_equal(np.asarray(rest["final_pos"]),
                                  np.asarray(full["final_pos"]))
    np.testing.assert_array_equal(np.asarray(rest["final_vel"]),
                                  np.asarray(full["final_vel"]))
    np.testing.assert_array_equal(rest["energies"], full["energies"][6:])


@pytest.mark.slow
def test_wu_impulse_mts(trpcage_sim):
    """mts_wu (the WU gamma-rescan force pass as an r-RESPA impulse every
    wu_every steps, integrators.py::wu_impulse_langevin_block):
    wu_every=1 must reproduce the plain runner bit-for-bit (same kick,
    same noise stream), and wu_every=4 must stay within the stale-window
    tolerance class over a short run, including the non-dividing
    remainder-block path."""
    import jax

    sim = trpcage_sim
    key = jax.random.PRNGKey(7)
    run0 = sim.make_langevin_runner(dt=0.001, neighbor_every=6)
    p0, v0, _, e0, _ = run0(sim.positions, sim.velocities, key, 12)
    run1 = sim.make_langevin_runner(dt=0.001, neighbor_every=6, wu_every=1)
    p1, v1, _, e1, _ = run1(sim.positions, sim.velocities, key, 12)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p0))
    np.testing.assert_array_equal(np.asarray(e1), np.asarray(e0))

    run4 = sim.make_langevin_runner(dt=0.001, neighbor_every=6, wu_every=4)
    p4, _, _, e4, _ = run4(sim.positions, sim.velocities, key, 12)
    assert np.isfinite(np.asarray(e4)).all()
    assert np.asarray(e4).shape == (12,)
    # smooth slow class at 4 fs: small trajectory deviation over 12 steps
    assert np.abs(np.asarray(p4) - np.asarray(p0)).max() < 5e-4
    assert np.abs((np.asarray(e4) - np.asarray(e0))
                  / np.asarray(e0)).max() < 5e-4

    # remainder path: wu_every=5 does not divide the 6-step windows
    run5 = sim.make_langevin_runner(dt=0.001, neighbor_every=6, wu_every=5)
    _, _, _, e5, _ = run5(sim.positions, sim.velocities, key, 12)
    assert np.asarray(e5).shape == (12,)
    assert np.isfinite(np.asarray(e5)).all()
