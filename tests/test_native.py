"""Native (C++) GaussVol runtime vs the Python float64 oracle.

The native engine plays the role of the reference's CPU GaussVol sizing
pre-pass (reference OpenCLAGBNPKernels.cpp:566-655): it must build the same
tree (node counts), produce the same energy/forces, and yield capacity
bounds that cover the measured build.
"""

import numpy as np
import pytest

from openmm_agbnp_jax.runtime import native


def test_native_available():
    """The in-tree Makefile + g++ must produce a loadable library; a silent
    fallback here would leave the sizing pre-pass untested forever."""
    assert native.available()


@pytest.fixture(scope="module")
def oracle_run(gaussvol_system):
    from openmm_agbnp_jax.models.constants import sphere_volume
    from openmm_agbnp_jax.models.oracle import GaussVol

    params, pos = gaussvol_system
    radii = np.asarray(params.radii_large)
    volumes = np.where(params.ishydrogen > 0, 0.0, sphere_volume(radii))
    gammas = np.asarray(params.gamma / params.roffset)
    gv = GaussVol(params.n, params.ishydrogen)
    gv.set_radii(radii)
    gv.set_volumes(volumes)
    gv.set_gammas(gammas)
    gv.compute_tree(pos)
    out = gv.compute_volume(pos)
    return params, pos, radii, volumes, gammas, gv, out


def test_native_tree_matches_oracle(oracle_run):
    params, pos, radii, volumes, gammas, gv, oracle_out = oracle_run
    ng = native.NativeGaussVol(params.n, params.ishydrogen)
    ng.compute_tree(pos, radii, volumes, gammas)
    energy, volume, force, dv, fv, sv = ng.compute_volume()

    v_o, e_o, f_o, dv_o, fv_o, sv_o = oracle_out
    np.testing.assert_allclose(energy, e_o, rtol=1e-12)
    np.testing.assert_allclose(volume, v_o, rtol=1e-12)
    np.testing.assert_allclose(force, f_o, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(sv, sv_o, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(fv, fv_o, rtol=1e-9, atol=1e-12)

    # identical node counts level by level
    counts, _sibs = ng.level_stats()
    from collections import Counter

    lev = Counter(node.level for node in gv.tree.nodes[1:])
    for k in range(2, 9):
        assert counts[k] == lev.get(k, 0), f"level {k} count mismatch"
    assert ng.total_nodes() == sum(counts[1:]) + 1


@pytest.mark.slow
def test_size_tree_caps_covers_build(oracle_run):
    """Capacities from the native pre-pass must cover the measured JAX tree
    build (the property the PanicButton relies on at startup)."""
    import jax.numpy as jnp

    from openmm_agbnp_jax.ops import tree as T

    params, pos, radii, volumes, gammas, gv, _ = oracle_run
    caps = native.size_tree_caps(params, pos, boost=1.2)

    lvl1 = T.make_level1(jnp.asarray(pos), jnp.asarray(radii),
                         jnp.asarray(volumes), jnp.asarray(gammas),
                         jnp.asarray(params.ishydrogen, jnp.int32))
    n = params.n
    pi, pj = np.triu_indices(n, 1)
    levels, diag = T.build_tree(lvl1, jnp.asarray(pi, jnp.int32),
                                jnp.asarray(pj, jnp.int32), caps)
    counts = np.asarray(diag["counts"])
    sibs = np.asarray(diag["max_siblings"])
    assert (counts <= np.asarray(caps.caps)).all(), (counts, caps.caps)
    assert (sibs[:-1] - 1 <= np.asarray(caps.offs)).all(), (sibs, caps.offs)
    # and the native counts agree with the JAX build's
    gvn = native.NativeGaussVol(params.n, params.ishydrogen)
    gvn.compute_tree(pos, radii, volumes, gammas)
    nat_counts, _ = gvn.level_stats()
    np.testing.assert_array_equal(counts, nat_counts[2:9])


def test_native_agbnp1_full_pipeline(gaussvol_system):
    """The native full-AGBNP1 engine (Born radii from natively-built I4
    spline tables, GB, vdW, descreening, WU gamma pass — mirroring
    reference ReferenceAGBNPKernels.cpp:274-795) must hit the golden
    anchors and match the JAX float64 pipeline at benchmark tolerance.

    This is the independent full-pipeline ground truth: native C++ vs JAX
    share no code, only the published model."""
    from openmm_agbnp_jax.models.agbnp_jax import AGBNPModel

    params, pos = gaussvol_system
    nat = native.NativeAGBNP1(params)
    out = nat.energy_forces(pos)

    # golden anchors (reference test fixture printouts)
    assert out["energy"] == pytest.approx(-2476.66, abs=1e-2)
    assert out["e_cav"] == pytest.approx(872.514, abs=1e-3)
    pos2 = np.array(pos)
    pos2[121, 1] += 0.002
    out2 = nat.energy_forces(pos2)
    assert out2["energy"] - out["energy"] == pytest.approx(0.0874992,
                                                           abs=1e-6)
    assert out["force"][121][1] * -0.002 == pytest.approx(0.0886249,
                                                          abs=1e-6)

    # vs the JAX f64 pipeline (same spline-LUT semantics, tables built
    # independently): ~1e-11 agreement expected, 1e-9 asserted
    m = AGBNPModel(params, version=1, dtype=np.float64)
    e, f, det = m.energy_forces(pos, with_details=True)
    f = np.asarray(f)
    assert abs(out["energy"] - float(e)) <= 1e-9 * abs(float(e))
    assert np.abs(out["force"] - f).max() <= 1e-9 * max(1.0,
                                                        np.abs(f).max())
    np.testing.assert_allclose(out["born_radius"],
                               np.asarray(det["details"]["born_radius"]),
                               rtol=1e-10)
    np.testing.assert_allclose(out["self_volume"],
                               np.asarray(det["details"]["self_volume"]),
                               rtol=1e-9, atol=1e-12)
