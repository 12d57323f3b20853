"""Batched conformer-rescoring API (api/scoring.py).

Per-conformer semantics must equal the single-evaluation Context path (the
reference's one-pose-per-call evaluation, AGBNPForceImpl.cpp:32-36); the
batch, mesh-sharded batch, and capacity-regrow variants must all agree.
"""

import numpy as np
import pytest

from openmm_agbnp_jax import AGBNPForce, Context, NonbondedMethod
from openmm_agbnp_jax.api.scoring import ConformerScorer


def _build_force(params, version=1):
    force = AGBNPForce()
    force.setVersion(version)
    for i in range(params.n):
        force.addParticle(params.radius[i], params.gamma[i], params.alpha[i],
                          params.charge[i], bool(params.ishydrogen[i]))
    return force


def _conformers(pos, nb=4, scale=0.01, seed=7):
    """Perturbed copies of one conformation (a pose ensemble stand-in)."""
    rng = np.random.default_rng(seed)
    return pos[None] + scale * rng.standard_normal((nb, *pos.shape))


@pytest.fixture(scope="module")
def small_system(fixture_dir):
    """First 64 atoms of the reference fixture: fast, still tree-rich."""
    import os

    from openmm_agbnp_jax.io.gaussvol_dat import load_gaussvol_dat
    from openmm_agbnp_jax.models.oracle import AGBNPParams

    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(
        os.path.join(fixture_dir, "gaussvol.dat"))
    n = 64
    params = AGBNPParams(radius=radius[:n], gamma=gamma[:n], alpha=alpha[:n],
                         charge=charge[:n], ishydrogen=ish[:n])
    return params, pos[:n]


@pytest.mark.slow
@pytest.mark.parametrize("version", [0, 1])
def test_batch_matches_context(small_system, version):
    params, pos = small_system
    force = _build_force(params, version=version)
    batch = _conformers(pos, nb=4)

    scorer = ConformerScorer(force, pos, dtype=np.float64)
    res = scorer.score(batch, forces=True, details=True)
    assert res["energy"].shape == (4,)
    assert res["force"].shape == (4, params.n, 3)

    for b in range(4):
        ctx = Context(force, dtype=np.float64)
        ctx.setPositions(batch[b])
        e, f = ctx.getEnergyForces()
        np.testing.assert_allclose(res["energy"][b], float(e), rtol=1e-10)
        np.testing.assert_allclose(res["force"][b], np.asarray(f),
                                   rtol=1e-8, atol=1e-10)
    if version == 1:
        total = res["e_cav"] + res["gb_self"] + res["gb_pair"] + res["e_vdw"]
        np.testing.assert_allclose(total, res["energy"], rtol=1e-12)


@pytest.mark.slow
def test_batch_v2_matches_model(small_system):
    """AGBNP2 batch scoring equals the one-shot AGBNP2Model evaluation per
    conformer (energy and autodiff forces)."""
    from openmm_agbnp_jax.models.agbnp2_jax import AGBNP2Model

    params, pos = small_system
    n = 40
    from openmm_agbnp_jax.models.oracle import AGBNPParams
    p40 = AGBNPParams(radius=params.radius[:n], gamma=params.gamma[:n],
                      alpha=params.alpha[:n], charge=params.charge[:n],
                      ishydrogen=params.ishydrogen[:n])
    pos = pos[:n]
    force = _build_force(p40, version=2)
    batch = _conformers(pos, nb=3, scale=0.005)

    scorer = ConformerScorer(force, pos, dtype=np.float64)
    res = scorer.score(batch, forces=True, details=True)
    assert res["energy"].shape == (3,)
    assert "e_ms_vdw" in res

    for b in range(3):
        m = AGBNP2Model(p40, dtype=np.float64, positions=batch[b])
        e, f = m.energy_forces(batch[b])
        np.testing.assert_allclose(res["energy"][b], float(e), rtol=1e-8)
        np.testing.assert_allclose(res["force"][b], np.asarray(f),
                                   rtol=1e-6, atol=1e-8)

    with pytest.raises(ValueError, match="refine"):
        scorer.refine(batch)


def test_single_conformer_and_shapes(small_system):
    params, pos = small_system
    force = _build_force(params)
    scorer = ConformerScorer(force, pos, dtype=np.float64)
    res = scorer.score(pos)  # [N, 3] treated as B=1
    assert res["energy"].shape == (1,)
    with pytest.raises(ValueError, match="expected positions"):
        scorer.score(pos[:, :2])


@pytest.mark.slow
def test_regrow_from_tiny_caps(small_system):
    """Deliberately undersized capacities: the PanicButton loop regrows from
    the worst conformer in the batch and still matches the healthy scorer."""
    from openmm_agbnp_jax.ops.tree import TreeCaps

    params, pos = small_system
    force = _build_force(params)
    batch = _conformers(pos, nb=3)
    tiny = TreeCaps(caps=(128,) * 7, offs=(4, 4, 4, 4, 4, 4))
    scorer = ConformerScorer(force, pos, dtype=np.float64, caps=tiny)
    ok = ConformerScorer(force, pos, dtype=np.float64)
    np.testing.assert_allclose(scorer.score(batch)["energy"],
                               ok.score(batch)["energy"], rtol=1e-10)


@pytest.mark.slow
def test_mesh_sharded_batch(small_system):
    """Batch axis sharded over the 8-device CPU mesh; non-multiple batch
    size exercises the padding path."""
    from openmm_agbnp_jax.parallel.sharding import replica_mesh

    params, pos = small_system
    force = _build_force(params)
    batch = _conformers(pos, nb=11)
    plain = ConformerScorer(force, pos, dtype=np.float64)
    sharded = ConformerScorer(force, pos, dtype=np.float64,
                              mesh=replica_mesh(8))
    np.testing.assert_allclose(sharded.score(batch)["energy"],
                               plain.score(batch)["energy"], rtol=1e-10)


@pytest.mark.slow
def test_update_parameters_batch(small_system):
    """updateParametersInContext semantics on the batched scorer: a gamma
    change propagates without rebuilding the scorer."""
    params, pos = small_system
    force = _build_force(params)
    batch = _conformers(pos, nb=2)
    scorer = ConformerScorer(force, pos, dtype=np.float64)
    e0 = scorer.score(batch)["energy"]
    for i in range(params.n):
        r, g, a, q, h = force.getParticleParameters(i)
        force.setParticleParameters(i, r, g * 1.5, a, q, h)
    scorer.updateParametersInContext(force)
    e1 = scorer.score(batch)["energy"]
    assert not np.allclose(e0, e1)
    fresh = ConformerScorer(force, pos, dtype=np.float64)
    np.testing.assert_allclose(e1, fresh.score(batch)["energy"], rtol=1e-10)


@pytest.mark.slow
def test_update_parameters_batch_v2(small_system):
    """The v2 scorer's cached vmapped jit closes over model config; a
    parameter update must rebuild it (and a later capacity regrow must use
    the UPDATED force), or scores silently come from the old parameters."""
    params, pos = small_system
    n = 40
    from openmm_agbnp_jax.models.oracle import AGBNPParams
    p40 = AGBNPParams(radius=params.radius[:n], gamma=params.gamma[:n],
                      alpha=params.alpha[:n], charge=params.charge[:n],
                      ishydrogen=params.ishydrogen[:n])
    pos = pos[:n]
    force = _build_force(p40, version=2)
    batch = _conformers(pos, nb=2, scale=0.005)
    scorer = ConformerScorer(force, pos, dtype=np.float64)
    e0 = scorer.score(batch)["energy"]
    for i in range(n):
        r, g, a, q, h = force.getParticleParameters(i)
        force.setParticleParameters(i, r, g * 2.0, a, q, h)
    scorer.updateParametersInContext(force)
    e1 = scorer.score(batch)["energy"]
    assert not np.allclose(e0, e1)
    fresh = ConformerScorer(force, pos, dtype=np.float64)
    np.testing.assert_allclose(e1, fresh.score(batch)["energy"], rtol=1e-10)
    # regrow after the update must rebuild from the NEW parameters
    bump = np.array([int(scorer.model.caps.caps[0]) + 1] + [0] * 17)
    assert scorer._regrow_v2(bump) is True
    e2 = scorer.score(batch)["energy"]
    np.testing.assert_allclose(e2, e1, rtol=1e-10)


@pytest.mark.slow
def test_refine_lowers_energy(small_system):
    """Batched FIRE refinement: every pose's energy drops, and the refined
    scores equal a fresh scoring of the refined coordinates."""
    params, pos = small_system
    force = _build_force(params)
    batch = _conformers(pos, nb=2, scale=0.02)
    scorer = ConformerScorer(force, pos, dtype=np.float64)
    e0 = scorer.score(batch)["energy"]
    res = scorer.refine(batch, maxiter=40)
    assert res["positions"].shape == batch.shape
    assert res["energy_trace"].shape == (2, 40)
    assert (res["energy"] < e0).all()
    np.testing.assert_allclose(
        res["energy"], scorer.score(res["positions"])["energy"], rtol=1e-12)


def test_version2_accepted_periodic_rejected(small_system):
    """Version 2 is now a supported scoring path (batched AGBNP2); only
    CutoffPeriodic remains out of scope for pose scoring."""
    params, pos = small_system
    force = _build_force(params, version=2)
    scorer = ConformerScorer(force, pos, dtype=np.float64)
    assert scorer._is_v2

    force1 = _build_force(params, version=1)
    force1.setNonbondedMethod(NonbondedMethod.CutoffPeriodic)
    with pytest.raises(ValueError, match="CutoffPeriodic"):
        ConformerScorer(force1, pos)
