"""Reference-parity tests of the public AGBNPForce/Context API surface."""

import warnings

import numpy as np
import pytest

from openmm_agbnp_jax import AGBNPForce, Context, NonbondedMethod


def _build_force(params, pos, version=1):
    force = AGBNPForce()
    force.setVersion(version)
    for i in range(params.n):
        force.addParticle(params.radius[i], params.gamma[i], params.alpha[i],
                          params.charge[i], bool(params.ishydrogen[i]))
    return force


def test_defaults():
    f = AGBNPForce()
    assert f.getVersion() == 1
    assert f.getNonbondedMethod() == NonbondedMethod.NoCutoff
    assert f.getCutoffDistance() == 1.0


def test_version_validation():
    f = AGBNPForce()
    with pytest.raises(ValueError):
        f.setVersion(3)
    f.setVersion(0)
    f.setVersion(2)


def test_common_gamma_validation():
    f = AGBNPForce()
    f.addParticle(0.16, 40.0, -60.0, 0.0, False)
    f.addParticle(0.16, 41.0, -60.0, 0.0, False)
    with pytest.raises(ValueError, match="multiple gamma"):
        f.to_params()
    # hydrogens may carry any gamma; it is zeroed
    f2 = AGBNPForce()
    f2.addParticle(0.16, 40.0, -60.0, 0.0, False)
    f2.addParticle(0.12, 99.0, -20.0, 0.0, True)
    p = f2.to_params()
    assert p.gamma[1] == 0.0


def test_particle_roundtrip():
    f = AGBNPForce()
    i = f.addParticle(0.165, 48.95, -73.4, 0.25, False)
    assert i == 0
    assert f.getNumParticles() == 1
    r, g, a, q, h = f.getParticleParameters(0)
    assert (r, g, a, q, h) == (0.165, 48.95, -73.4, 0.25, False)
    f.setParticleParameters(0, 0.17, 48.95, -70.0, 0.1, False)
    assert f.getParticleParameters(0)[0] == 0.17


def test_context_energy_golden(gaussvol_system):
    """End-to-end through the public API, float64: the v1 golden anchor."""
    params, pos = gaussvol_system
    force = _build_force(params, pos, version=1)
    ctx = Context(force, dtype=np.float64)
    ctx.setPositions(pos)
    e, f = ctx.getEnergyForces()
    assert float(e) == pytest.approx(-2476.66, abs=0.01)


@pytest.mark.slow
def test_context_v2_golden(gaussvol_system):
    """Version 2 through the public API reproduces the in-repo v2 golden
    anchor (tests/test_agbnp2.py::V2_GOLDEN) on the 40-atom fixture subset
    (the reference marks AGBNP2 work-in-progress and ships no goldens of
    its own; see models/oracle_agbnp2.py)."""
    from test_agbnp2 import V2_GOLDEN

    params, pos = gaussvol_system
    f2 = AGBNPForce()
    f2.setVersion(2)
    for i in range(40):
        f2.addParticle(params.radius[i], params.gamma[i], params.alpha[i],
                       params.charge[i], bool(params.ishydrogen[i]))
    ctx = Context(f2, dtype=np.float64)
    ctx.setPositions(pos[:40])
    e, f = ctx.getEnergyForces()
    assert float(e) == pytest.approx(V2_GOLDEN["energy"], abs=1e-8)
    assert np.isfinite(np.asarray(f)).all()


def test_force_group_roundtrip():
    f = AGBNPForce()
    assert f.getForceGroup() == 0
    f.setForceGroup(5)
    assert f.getForceGroup() == 5
    with pytest.raises(ValueError):
        f.setForceGroup(32)
    with pytest.raises(ValueError):
        f.setForceGroup(-1)


def test_calc_forces_and_energy_flags(gaussvol_system):
    """Flagged evaluation semantics of AGBNPForceImpl::calcForcesAndEnergy
    (reference openmmapi/src/AGBNPForceImpl.cpp:32-36): the group mask gates
    the whole evaluation; includeEnergy/includeForces gate the outputs; the
    energy-only path (which skips the WU force pass) returns exactly the
    full evaluation's energy."""
    params, pos = gaussvol_system
    force = _build_force(params, pos, version=1)
    force.setForceGroup(3)
    ctx = Context(force, dtype=np.float64)
    ctx.setPositions(pos)
    e_full, f_full = ctx.getEnergyForces()

    # group excluded from mask: no contribution at all
    e, f = ctx.calcForcesAndEnergy(groups=1 << 2)
    assert e == 0.0 and not np.any(f)

    # group included: full value
    e, f = ctx.calcForcesAndEnergy(groups=1 << 3)
    assert float(e) == pytest.approx(float(e_full), rel=1e-14)
    np.testing.assert_allclose(f, np.asarray(f_full), rtol=1e-14)
    e, f = ctx.calcForcesAndEnergy()  # default mask -1 includes every group
    assert float(e) == pytest.approx(float(e_full), rel=1e-14)

    # energy-only: identical energy (the WU pass carries force only)
    e, f = ctx.calcForcesAndEnergy(includeForces=False)
    assert float(e) == pytest.approx(float(e_full), rel=1e-12)
    assert not np.any(f)
    assert float(ctx.getEnergy()) == pytest.approx(float(e_full), rel=1e-12)

    # forces-only: zero energy, full forces
    e, f = ctx.calcForcesAndEnergy(includeEnergy=False)
    assert e == 0.0
    np.testing.assert_allclose(f, np.asarray(f_full), rtol=1e-14)
    np.testing.assert_allclose(ctx.getForces(), np.asarray(f_full),
                               rtol=1e-14)

    e, f = ctx.calcForcesAndEnergy(includeForces=False, includeEnergy=False)
    assert e == 0.0 and not np.any(f)


@pytest.mark.slow
def test_update_parameters_in_context(gaussvol_system):
    """updateParametersInContext (AGBNPForce.cpp:76-78): edited particle
    parameters propagate into a live Context WITHOUT recompiling when shapes
    are unchanged (the reference re-uploads device arrays)."""
    params, pos = gaussvol_system
    force = _build_force(params, pos, version=1)
    ctx = Context(force, dtype=np.float64)
    ctx.setPositions(pos)
    e0, f0 = ctx.getEnergyForces()
    model = ctx._model
    jitted = model._jit_ef
    assert jitted._cache_size() == 1

    # scale every charge: GB terms change, cavity term does not
    for i in range(params.n):
        r, g, a, q, h = force.getParticleParameters(i)
        force.setParticleParameters(i, r, g, a, 0.5 * q, h)
    force.updateParametersInContext(ctx)
    assert ctx._model is model, "model was rebuilt for a param-only update"
    assert ctx._model._jit_ef is jitted
    e1, f1 = ctx.getEnergyForces()
    assert abs(float(e1) - float(e0)) > 1.0
    assert jitted._cache_size() == 1, "param-only update recompiled"

    # restoring the parameters restores the energy exactly
    for i in range(params.n):
        r, g, a, q, h = force.getParticleParameters(i)
        force.setParticleParameters(i, r, g, a, 2.0 * q, h)
    force.updateParametersInContext(ctx)
    e2, f2 = ctx.getEnergyForces()
    assert float(e2) == pytest.approx(float(e0), rel=1e-12)
    np.testing.assert_allclose(np.asarray(f2), np.asarray(f0), rtol=1e-12)

    # changing gamma flows through the cavity/rescan chain too
    for i in range(params.n):
        r, g, a, q, h = force.getParticleParameters(i)
        force.setParticleParameters(i, r, 1.1 * g, a, q, h)
    force.updateParametersInContext(ctx)
    e3, _ = ctx.getEnergyForces()
    assert abs(float(e3) - float(e0)) > 1.0
    assert jitted._cache_size() == 1


@pytest.mark.slow
def test_cutoff_periodic_large_box_matches_nonperiodic(gaussvol_system):
    """With a box much larger than the system, CutoffPeriodic == CutoffNonPeriodic."""
    params, pos = gaussvol_system
    force = _build_force(params, pos, version=1)
    force.setNonbondedMethod(NonbondedMethod.CutoffNonPeriodic)
    force.setCutoffDistance(1.2)
    ctx = Context(force, dtype=np.float64)
    ctx.setPositions(pos)
    e_np, f_np = ctx.getEnergyForces()

    force.setNonbondedMethod(NonbondedMethod.CutoffPeriodic)
    ctx2 = Context(force, dtype=np.float64,
                   box=((50.0, 0, 0), (0, 50.0, 0), (0, 0, 50.0)))
    ctx2.setPositions(pos)
    e_p, f_p = ctx2.getEnergyForces()
    assert float(e_p) == pytest.approx(float(e_np), rel=1e-12)
    np.testing.assert_allclose(np.asarray(f_p), np.asarray(f_np), rtol=1e-12)


def test_cutoff_periodic_requires_box(gaussvol_system):
    params, pos = gaussvol_system
    force = _build_force(params, pos, version=1)
    force.setNonbondedMethod(NonbondedMethod.CutoffPeriodic)
    with pytest.raises(ValueError, match="box"):
        Context(force, dtype=np.float64)
    # a is not (ax, 0, 0): not in reduced form
    with pytest.raises(ValueError, match="reduced form"):
        Context(force, dtype=np.float64,
                box=((5.0, 0.1, 0), (0, 5.0, 0), (0, 0, 5.0)))
    # tilt exceeding the ax/2 reduction bound
    with pytest.raises(ValueError, match="reduced form"):
        Context(force, dtype=np.float64,
                box=((5.0, 0, 0), (3.0, 5.0, 0), (0, 0, 5.0)))


def test_min_image_triclinic_matches_image_search():
    """The sequential c/b/a wrap equals brute-force 27-image minimum
    distances for random reduced triclinic cells (within the half-width
    validity bound)."""
    from openmm_agbnp_jax.ops.born import min_image

    rng = np.random.default_rng(11)
    box = np.array([[4.0, 0.0, 0.0],
                    [1.7, 3.6, 0.0],
                    [-1.9, 1.5, 3.3]])
    pts = rng.uniform(-6.0, 6.0, size=(40, 3))
    delta = pts[None, :, :] - pts[:, None, :]
    wrapped = np.asarray(min_image(delta, box))
    d_wrap = np.linalg.norm(wrapped, axis=-1)
    shifts = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)], dtype=np.float64) @ box
    d_img = np.min(np.linalg.norm(
        delta[:, :, None, :] + shifts[None, None, :, :], axis=-1), axis=-1)
    # the sequential wrap is exact below half the reduced widths; compare
    # there (the pair phases only consume distances below the cutoff/
    # horizon, far inside that bound)
    half = 0.5 * min(box[0, 0], box[1, 1], box[2, 2])
    m = d_img < half
    np.testing.assert_allclose(d_wrap[m], d_img[m], atol=1e-12)


@pytest.mark.slow
def test_cutoff_periodic_triclinic_lattice_invariance():
    """Translating an isolated atom by a TRICLINIC lattice vector leaves
    the periodic energy and forces unchanged — the general periodic-box
    semantics the reference inherits from OpenMM (AGBNPForce.h:55)."""
    rng = np.random.default_rng(5)
    cluster = 0.30 * rng.standard_normal((6, 3))
    lone = np.array([[1.4, 0.4, 0.3]])
    pos = np.vstack([cluster, lone])
    n = pos.shape[0]
    box = ((3.2, 0.0, 0.0), (0.9, 3.1, 0.0), (-0.8, 1.1, 3.4))

    def make_ctx():
        f = AGBNPForce()
        f.setVersion(1)
        for i in range(n):
            f.addParticle(0.165, 48.9528, -60.0, (-1.0) ** i * 0.2, False)
        f.setNonbondedMethod(NonbondedMethod.CutoffPeriodic)
        f.setCutoffDistance(1.2)
        return Context(f, dtype=np.float64, box=box)

    ctx = make_ctx()
    ctx.setPositions(pos)
    e0, f0 = ctx.getEnergyForces()
    for vec in np.asarray(box):
        pos_shift = pos.copy()
        pos_shift[-1] += vec
        ctx.setPositions(pos_shift)
        e1, f1 = ctx.getEnergyForces()
        assert float(e1) == pytest.approx(float(e0), rel=1e-12)
        np.testing.assert_allclose(np.asarray(f1), np.asarray(f0),
                                   rtol=1e-10)


def test_cutoff_periodic_warns_on_straddling_extent(gaussvol_system):
    """Coordinates whose extent approaches the box (i.e. likely wrapped)
    trigger the cavity-term guard warning; well-contained ones don't."""
    params, pos = gaussvol_system
    force = _build_force(params, pos, version=1)
    force.setNonbondedMethod(NonbondedMethod.CutoffPeriodic)
    force.setCutoffDistance(1.0)
    extent = float((pos.max(axis=0) - pos.min(axis=0)).max())
    tight = extent / 0.8  # extent = 0.8 * box > 0.75 * box on one axis
    ctx = Context(force, dtype=np.float64,
                  box=((tight, 0, 0), (0, tight, 0), (0, 0, tight)))
    with pytest.warns(RuntimeWarning, match="wrapped"):
        ctx.setPositions(pos)

    roomy = 4.0 * extent
    ctx2 = Context(force, dtype=np.float64,
                   box=((roomy, 0, 0), (0, roomy, 0), (0, 0, roomy)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ctx2.setPositions(pos)


@pytest.mark.slow
def test_cutoff_periodic_min_image_invariance():
    """Translating an isolated atom by a lattice vector leaves the periodic
    energy unchanged (the nearest-image semantics of AGBNPForce.h:55), while
    the non-periodic energy changes."""
    rng = np.random.default_rng(3)
    cluster = 0.30 * rng.standard_normal((6, 3))
    lone = np.array([[2.0, 0.0, 0.0]])
    pos = np.vstack([cluster, lone])
    n = pos.shape[0]

    def make_ctx(box=None):
        f = AGBNPForce()
        f.setVersion(1)
        for i in range(n):
            f.addParticle(0.165, 48.9528, -60.0, (-1.0) ** i * 0.2, False)
        if box is None:
            f.setNonbondedMethod(NonbondedMethod.CutoffNonPeriodic)
            f.setCutoffDistance(1.2)
            return Context(f, dtype=np.float64)
        f.setNonbondedMethod(NonbondedMethod.CutoffPeriodic)
        f.setCutoffDistance(1.2)
        return Context(f, dtype=np.float64, box=box)

    box = ((3.0, 0, 0), (0, 3.0, 0), (0, 0, 3.0))
    pos_shift = pos.copy()
    pos_shift[-1, 0] += 3.0  # one lattice vector; raw distance now 5 nm

    ctx = make_ctx(box)
    ctx.setPositions(pos)
    e0, f0 = ctx.getEnergyForces()
    ctx.setPositions(pos_shift)
    e1, f1 = ctx.getEnergyForces()
    assert float(e1) == pytest.approx(float(e0), rel=1e-12)
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f0), rtol=1e-10)

    # sanity: without the box the shift decouples the lone atom
    ctx_np = make_ctx(None)
    ctx_np.setPositions(pos)
    e_np0, _ = ctx_np.getEnergyForces()
    ctx_np.setPositions(pos_shift)
    e_np1, _ = ctx_np.getEnergyForces()
    assert abs(float(e_np1) - float(e_np0)) > 1e-6
    # and the periodic energy actually sees the wrapped 1 nm image
    assert abs(float(e0) - float(e_np0)) > 1e-6
