"""AGBNP2 (version 2) oracle validation.

No golden outputs exist for AGBNP2 (the reference marks it work-in-progress
and ships none), so validation follows the reference's own compiled-out
strategy: finite-difference checks of the analytic forces
(reference ReferenceAGBNPKernels.cpp:943-1010, 1143-1216) plus structural
sanity of the MS-particle stage.
"""

import os

import numpy as np
import pytest

from openmm_agbnp_jax.models.oracle import AGBNPParams
from openmm_agbnp_jax.models.oracle_agbnp2 import (
    _make_ms_particles,
    agbnp2_energy_forces,
)


@pytest.fixture(scope="module")
def small_system(gaussvol_system):
    params, pos = gaussvol_system
    nsub = 40
    return AGBNPParams(radius=params.radius[:nsub], gamma=params.gamma[:nsub],
                       alpha=params.alpha[:nsub], charge=params.charge[:nsub],
                       ishydrogen=params.ishydrogen[:nsub]), pos[:nsub]


def test_ms_particles_created(small_system):
    params, pos = small_system
    from openmm_agbnp_jax.models.constants import AGBNP2_RADIUS_INCREMENT

    p2 = AGBNPParams(radius=params.radius, gamma=params.gamma,
                     alpha=params.alpha, charge=params.charge,
                     ishydrogen=params.ishydrogen,
                     roffset=AGBNP2_RADIUS_INCREMENT)
    msps = _make_ms_particles(p2, pos)
    assert len(msps) > 0
    for m in msps[:5]:
        assert params.ishydrogen[m.parent1] == 0
        assert params.ishydrogen[m.parent2] == 0
        assert m.vol0 > 0


def test_agbnp2_energy_finite(small_system):
    params, pos = small_system
    e, f, det = agbnp2_energy_forces(params, pos, return_details=True)
    assert np.isfinite(e)
    assert np.isfinite(f).all()
    assert det["num_ms"] > 0
    # the MS term must actually contribute
    assert det["e_ms1"] != 0.0


# In-repo golden anchors for AGBNP2 (the reference ships none — its v2 is
# WIP with no .reference files).  Recorded from this repo's float64 v2
# oracle on the first 40 atoms of the reference gaussvol.dat fixture; any
# drift in the v2 physics breaks these the way 872.514 / -2476.66 guard
# v0/v1 (reference platforms/reference/tests/v{0,1}.reference).
V2_GOLDEN = dict(
    energy=-505.76495633268286,
    e_vol1=1296.819385880833,
    e_vol2=-1148.76359737392,
    e_ms1=27.57599932202746,
    e_vdw=-279.30181003341033,
    gb_pair=1114.5651675110894,
    gb_self=-1476.1241599496998,
    num_ms=28,
)
V2_GOLDEN_FORCES = {
    0: (2.7244478045, -22.2829483825, -34.7403199228),
    17: (-116.3420644047, 8.9736090847, -130.7872966600),
    39: (12.2302176390, 25.9733147403, -30.5733421377),
}


def test_agbnp2_oracle_golden(small_system):
    """v2 regression anchors: energy, per-term breakdown, selected forces."""
    params, pos = small_system
    e, f, det = agbnp2_energy_forces(params, pos, return_details=True)
    assert e == pytest.approx(V2_GOLDEN["energy"], rel=1e-10)
    for k in ("e_vol1", "e_vol2", "e_ms1", "e_vdw", "gb_pair", "gb_self"):
        assert det[k] == pytest.approx(V2_GOLDEN[k], rel=1e-9), k
    assert det["num_ms"] == V2_GOLDEN["num_ms"]
    for i, ref in V2_GOLDEN_FORCES.items():
        np.testing.assert_allclose(f[i], ref, rtol=1e-8)


@pytest.mark.slow
def test_agbnp2_jax_golden(small_system):
    """The JAX v2 path reproduces the oracle anchors end-to-end (value
    assertion, not just finiteness)."""
    from openmm_agbnp_jax.models.agbnp2_jax import AGBNP2Model

    params, pos = small_system
    m = AGBNP2Model(params, dtype=np.float64, positions=pos)
    e, f = m.energy_forces(pos)
    assert float(e) == pytest.approx(V2_GOLDEN["energy"], abs=1e-8)


@pytest.mark.slow
def test_agbnp2_neighbor_bounded_free_volumes(small_system):
    """The neighbor-bounded MS free-volume subtraction (ms_sub_k > 0,
    [cap_ms, k] lists at the static horizon) matches the dense [cap_ms, N]
    form: every excluded overlap sits below the VOLMINA switch, so energy
    and autodiff forces agree to summation-order noise."""
    from openmm_agbnp_jax.models.agbnp2_jax import (
        AGBNP2Model, ms_subtraction_horizon)

    params, pos = small_system
    hz = ms_subtraction_horizon(params.radii_vdw, params.radii_large)
    assert 0.2 < hz < 1.0  # sane static horizon

    m_dense = AGBNP2Model(params, dtype=np.float64, positions=pos,
                          ms_sub_k=0)
    # auto mode falls back to the dense form on small systems (the k-wide
    # gathers only pay when the horizon prunes hard — round-5 gate), so
    # request the neighbor-bounded mode explicitly for the parity check
    nheavy = int((params.ishydrogen == 0).sum())
    m_nbr = AGBNP2Model(params, dtype=np.float64, positions=pos,
                        ms_sub_k=nheavy)
    assert m_nbr.ms_sub_k > 0
    e_d, f_d = m_dense.energy_forces(pos)
    e_n, f_n = m_nbr.energy_forces(pos)
    assert float(e_n) == pytest.approx(float(e_d), rel=1e-12)
    np.testing.assert_allclose(np.asarray(f_n), np.asarray(f_d),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.slow
def test_agbnp2_force_fd_global(small_system):
    """Global dE vs -F.dx.  The reference's v2 force chain is knowingly
    incomplete (WIP; its FD checks are compiled out); this oracle carries
    two corrections beyond it (the complete MS U/W gamma assignment and the
    free-volume/MS-position Newton leg) and is validated here to the few-
    percent-of-dE level.  Machine-exact v2 forces come from the JAX energy +
    autodiff path."""
    params, pos = small_system
    e0, force = agbnp2_energy_forces(params, pos)
    rng = np.random.default_rng(5)
    d = rng.uniform(-5e-5, 5e-5, size=pos.shape)
    ep, _ = agbnp2_energy_forces(params, pos + d)
    em, _ = agbnp2_energy_forces(params, pos - d)
    de = ep - em
    pred = -2.0 * np.sum(force * d)
    assert de == pytest.approx(pred, rel=5e-2, abs=5e-3)


@pytest.mark.slow
def test_agbnp2_jax_matches_oracle(small_system):
    """The JAX v2 energy equals the oracle; autodiff forces pass a tight FD
    check (the reference's hand chain cannot)."""
    import jax

    from openmm_agbnp_jax.models.agbnp2_jax import AGBNP2Model

    params, pos = small_system
    e_o, _ = agbnp2_energy_forces(params, pos)
    m = AGBNP2Model(params, dtype=np.float64, positions=pos)
    e, f = m.energy_forces(pos)
    assert float(e) == pytest.approx(e_o, abs=1e-9)

    rng = np.random.default_rng(5)
    d = rng.uniform(-5e-5, 5e-5, size=pos.shape)
    ep = float(m.energy_forces(pos + d)[0])
    em = float(m.energy_forces(pos - d)[0])
    pred = -2.0 * np.sum(np.asarray(f) * d)
    assert (ep - em) == pytest.approx(pred, rel=1e-4)


@pytest.mark.slow
def test_agbnp2_md_smoke(gaussvol_system):
    """AGBNP2 MD: Simulation(version=2) runs a few Langevin steps with
    finite energies, and its force at the initial configuration matches the
    one-shot AGBNP2Model evaluation (same energy function)."""
    import jax
    import numpy as np

    from openmm_agbnp_jax.io.dms import load_dms
    from openmm_agbnp_jax.md.simulation import Simulation

    here = os.path.dirname(os.path.abspath(__file__))
    dms = load_dms(os.path.join(here, "..", "benchmarks", "data",
                                "trpcage_agbnp1.dms"))
    sim = Simulation(dms, version=2, dtype=np.float64)
    e, f, counts = jax.jit(sim.force_fn())(sim.positions)
    e2, f2 = sim.agbnp2.energy_forces(np.asarray(sim.positions))
    if sim.mm is not None:
        e_mm, g_mm = jax.value_and_grad(sim.mm.energy)(sim.positions)
        e2 = e2 + e_mm
        f2 = f2 - g_mm
    assert abs(float(e - e2)) < 1e-6
    np.testing.assert_allclose(np.asarray(f), np.asarray(f2), atol=1e-8)

    res = sim.benchmark_langevin(nsteps=4, dt=0.0005, warmup=False,
                                 neighbor_every=0)
    assert np.isfinite(res["energies"]).all()


@pytest.mark.slow
def test_agbnp2_topology_rescan_matches_build(small_system):
    """v2 stale-topology windows: at the build positions, the fixed-
    topology rescan path (frozen MS compaction + both tree topologies)
    reproduces the direct-build energy and autodiff forces; at displaced
    positions its own gradient still passes a tight FD check."""
    import jax
    import jax.numpy as jnp

    from openmm_agbnp_jax.models.agbnp2_jax import (
        AGBNP2Model, agbnp2_energy)

    params, pos = small_system
    m = AGBNP2Model(params, dtype=np.float64, positions=pos)
    a2 = {k: jnp.asarray(v) for k, v in m.arrays.items()}
    q = jnp.asarray(pos)
    kw = dict(caps=m.caps, caps_ms=m.caps_ms, roffset=m.params.roffset,
              ntypes_j=m.ntypes_j, ms_pi=m.ms_pi, ms_pj=m.ms_pj,
              ms_pv=m.ms_pv, cap_ms=m.cap_ms, ms_kmax=m.ms_kmax,
              common_gamma=m.common_gamma, cutoff=m.cutoff)

    def e_build(q):
        return agbnp2_energy(a2, q, **kw)[0]

    _, _, _, topo = agbnp2_energy(a2, q, with_topology=True, **kw)

    def e_topo(q):
        return agbnp2_energy(a2, q, topology=topo, **kw)[0]

    e0, g0 = jax.jit(jax.value_and_grad(e_build))(q)
    e1, g1 = jax.jit(jax.value_and_grad(e_topo))(q)
    assert float(e1) == pytest.approx(float(e0), abs=1e-9)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g0), atol=1e-9)

    # displaced positions: the rescan energy's autodiff gradient is exact
    # for the (stale-topology) energy function it evaluates
    rng = np.random.default_rng(7)
    qd = q + jnp.asarray(rng.uniform(-2e-4, 2e-4, size=pos.shape))
    d = jnp.asarray(rng.uniform(-5e-5, 5e-5, size=pos.shape))
    _, gd = jax.jit(jax.value_and_grad(e_topo))(qd)
    de = float(e_topo(qd + d)) - float(e_topo(qd - d))
    assert de == pytest.approx(2.0 * float(jnp.sum(gd * d)), rel=1e-6)


@pytest.mark.slow
def test_agbnp2_windowed_md(gaussvol_system):
    """Simulation(version=2) with rebuild windows (the new default): the
    first window's energies match the strict per-step-rebuild path (the
    build and the rescan evaluate the same function at the build point),
    and a multi-window run stays finite with no overflow."""
    from openmm_agbnp_jax.io.dms import load_dms
    from openmm_agbnp_jax.md.simulation import Simulation

    here = os.path.dirname(os.path.abspath(__file__))
    dms = load_dms(os.path.join(here, "..", "benchmarks", "data",
                                "trpcage_agbnp1.dms"))
    sim = Simulation(dms, version=2, dtype=np.float64)
    res_w = sim.run_md(6, dt=0.0005, neighbor_every=3)
    assert np.isfinite(res_w["energies"]).all()
    assert not res_w["overflow"] and res_w["regrows"] == 0

    res_s = sim.run_md(1, dt=0.0005, neighbor_every=0)
    # step 1 evaluates at the same positions in both paths; the windowed
    # energy comes through the rescan, the strict one through the build
    assert res_w["energies"][0] == pytest.approx(
        float(res_s["energies"][0]), abs=1e-8)
