"""Oracle regression tests against the reference's golden outputs.

Golden values from reference platforms/reference/tests/v0.reference and
v1.reference, computed by the OpenMM Reference platform in float64 on the
264-atom gaussvol.dat fixture.
"""

import numpy as np
import pytest

from openmm_agbnp_jax.models.oracle import (
    agbnp1_energy_forces,
    gvolsa_energy_forces,
)


def test_gvolsa_golden(gaussvol_system):
    params, pos = gaussvol_system
    e, force, (e1, e2) = gvolsa_energy_forces(params, pos)
    # v0.reference:2-7
    assert e1 == pytest.approx(2287.78, abs=0.01)
    assert e2 == pytest.approx(-1415.27, abs=0.01)
    assert e == pytest.approx(872.514, abs=0.001)


def test_gvolsa_force_fd(gaussvol_system):
    """Finite-difference check of the analytic cavity forces."""
    params, pos = gaussvol_system
    e0, force, _ = gvolsa_energy_forces(params, pos)
    rng = np.random.default_rng(0)
    heavy = np.flatnonzero(params.ishydrogen == 0)
    for atom in rng.choice(heavy, size=3, replace=False):
        d = rng.uniform(-2e-4, 2e-4, size=3)
        pos2 = pos.copy()
        pos2[atom] += d
        e1, _, _ = gvolsa_energy_forces(params, pos2)
        pred = -np.dot(force[atom], d)
        assert e1 - e0 == pytest.approx(pred, rel=0.05, abs=1e-6)


def test_agbnp1_golden(gaussvol_system):
    params, pos = gaussvol_system
    e, force = agbnp1_energy_forces(params, pos)
    # v1.reference:2
    assert e == pytest.approx(-2476.66, abs=0.01)


def test_agbnp1_displacement_golden(gaussvol_system):
    """The reference's recorded displacement check: atom 121, +0.002 nm in y
    gives dE = 0.0874992 and gradient prediction 0.0886249
    (v1.reference:4-5, TestReferenceAGBNPForce.cpp:118-128)."""
    params, pos = gaussvol_system
    e1, force = agbnp1_energy_forces(params, pos)
    pos2 = pos.copy()
    pos2[121, 1] += 0.002
    e2, _ = agbnp1_energy_forces(params, pos2)
    assert e2 == pytest.approx(-2476.58, abs=0.01)
    assert e2 - e1 == pytest.approx(0.0874992, abs=1e-6)
    assert -force[121, 1] * 0.002 == pytest.approx(0.0886249, abs=1e-6)
