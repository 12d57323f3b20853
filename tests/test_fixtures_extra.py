"""The reference's two secondary fixtures as parity cases.

gaussvol.xyz (136 atoms, ALL heavy) and agbnpGBSA.dat (the same molecule's
heavy atoms with pre-inflated radii) ship with the reference's test suite
(reference platforms/reference/tests/) but are unused by its committed
test program (TestReferenceAGBNPForce.cpp:45-71 reads the gaussvol.dat
format from stdin).  Here they buy regression breadth the 264-atom fixture
cannot: a system with NO hydrogens exercises every H-masking path (gamma
zeroing, screener packing, heavy-only neighbor candidates) from the other
side.
"""

import os

import numpy as np
import pytest

from openmm_agbnp_jax.io.gaussvol_dat import (
    load_agbnp_gbsa_dat,
    load_gaussvol_dat,
    load_gaussvol_xyz,
)
from openmm_agbnp_jax.models.constants import AGBNP_RADIUS_INCREMENT
from openmm_agbnp_jax.models.oracle import (
    AGBNPParams,
    agbnp1_energy_forces,
    gvolsa_energy_forces,
)


def _converged(model, pos):
    """energy_forces with the PanicButton capacity loop: the heavy-only
    molecule has the SAME overlap tree as the full fixture but a smaller
    atom count, so the heuristic (positions-free) caps undersize and the
    first evaluations overflow — exactly the path the regrow protocol
    exists for."""
    for _ in range(8):
        e, f, out = model.energy_forces(pos, with_details=True)
        if not model.check_and_grow(out["diag"]):
            return e, f
    raise RuntimeError("capacities failed to converge")


@pytest.fixture(scope="module")
def xyz_system(fixture_dir):
    elements, pos, radius, charge, gamma, alpha, ish = load_gaussvol_xyz(
        os.path.join(fixture_dir, "gaussvol.xyz"))
    params = AGBNPParams(radius=radius, gamma=gamma, alpha=alpha,
                         charge=charge, ishydrogen=ish)
    return elements, params, pos


def test_gaussvol_xyz_loader(xyz_system):
    elements, params, pos = xyz_system
    assert params.n == 136
    # the file is heavy-atom-only: the H-masking paths must all be no-ops
    assert (params.ishydrogen == 0).all()
    assert set(elements) <= {"C", "N", "O", "S"}
    # same conversion as the stdin reader: Angstrom -> nm, kcal -> kJ
    assert pos.max() < 3.0 and params.radius.max() < 0.25


def test_gaussvol_xyz_oracle_vs_pipeline(xyz_system):
    """f64 oracle == vectorized pipeline on the heavy-only fixture, both
    GVolSA (v0) and full AGBNP1 (v1), plus analytic forces vs jax.grad —
    the same parity gates the 264-atom fixture passes, with every atom a
    screener and every gamma live."""
    import jax

    from openmm_agbnp_jax.models.agbnp_jax import AGBNPModel

    _, params, pos = xyz_system
    e0_o, f0_o, (e1_pass, e2_pass) = gvolsa_energy_forces(params, pos)
    # with hydrogens carrying zero gamma AND zero volume (reference
    # ReferenceAGBNPKernels.cpp:293-305), the heavy-only molecule's cavity
    # energy must equal the full 264-atom golden: 872.514
    assert e0_o == pytest.approx(872.514, abs=1e-3)
    m0 = AGBNPModel(params, version=0)
    e0, f0 = _converged(m0, pos)
    assert float(e0) == pytest.approx(e0_o, abs=1e-8)
    np.testing.assert_allclose(np.asarray(f0), f0_o, atol=1e-9)

    e1_o, f1_o = agbnp1_energy_forces(params, pos)
    m1 = AGBNPModel(params, version=1)
    e1, f1 = _converged(m1, pos)
    assert float(e1) == pytest.approx(e1_o, abs=1e-7)
    np.testing.assert_allclose(np.asarray(f1), f1_o, atol=1e-8)

    # finite-difference spot check of the analytic forces on this topology
    rng = np.random.default_rng(3)
    atom = int(rng.integers(params.n))
    d = rng.uniform(-2e-4, 2e-4, size=3)
    pos2 = pos.copy()
    pos2[atom] += d
    e2, _ = m1.energy_forces(pos2)
    assert float(e2) - float(e1) == pytest.approx(
        -np.dot(np.asarray(f1)[atom], d), rel=0.05, abs=1e-6)


def test_agbnp_gbsa_matches_dat_heavy_subset(fixture_dir):
    """agbnpGBSA.dat is the heavy-atom slice of gaussvol.dat with radii
    pre-inflated by the 0.5 A AGBNP radius increment (AGBNPForce.h:17);
    its ids index gaussvol.dat rows.  Verify the correspondence and run
    GaussVol v0 on that heavy subset — the fixture-supplied inflated radii
    reproduce exactly the large-radii pass the pipeline derives itself."""
    ids, pos_g, radius_large, charge, gamma, probe = load_agbnp_gbsa_dat(
        os.path.join(fixture_dir, "agbnpGBSA.dat"))
    pos_d, radius_d, charge_d, gamma_d, alpha_d, ish_d = load_gaussvol_dat(
        os.path.join(fixture_dir, "gaussvol.dat"))
    assert len(ids) == 136
    # every referenced atom is heavy, and every coordinate matches
    assert (ish_d[ids] == 0).all()
    np.testing.assert_allclose(pos_g, pos_d[ids], atol=1e-9)
    # radius column = gaussvol.dat radius + the AGBNP increment (0.05 nm)
    np.testing.assert_allclose(radius_large,
                               radius_d[ids] + AGBNP_RADIUS_INCREMENT,
                               atol=1e-6)
    # integer formal charges, magnitude-offset by 0.001 away from zero
    assert set(np.round(charge, 3)) <= {-1.001, 0.001, 1.001}

    # GaussVol v0 on the heavy subset: oracle vs pipeline
    from openmm_agbnp_jax.models.agbnp_jax import AGBNPModel

    params = AGBNPParams(radius=radius_d[ids], gamma=gamma_d[ids],
                         alpha=alpha_d[ids], charge=charge_d[ids],
                         ishydrogen=ish_d[ids])
    e_o, f_o, _ = gvolsa_energy_forces(params, pos_g)
    assert e_o == pytest.approx(872.514, abs=1e-3)  # H-null invariance
    m = AGBNPModel(params, version=0)
    e, f = _converged(m, pos_g)
    assert float(e) == pytest.approx(e_o, abs=1e-8)
    np.testing.assert_allclose(np.asarray(f), f_o, atol=1e-9)
