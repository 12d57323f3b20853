"""Parity of the jitted flat-tree pipeline against the float64 oracle.

These tests cover the device compute path (on CPU, float64): exact node-set
reproduction of the overlap tree, golden-anchor energies, analytic forces vs
the oracle and vs jax.grad through the whole pipeline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openmm_agbnp_jax.models.agbnp_jax import AGBNPModel
from openmm_agbnp_jax.models.oracle import (
    agbnp1_energy_forces,
    gvolsa_energy_forces,
)
from openmm_agbnp_jax.ops.tree import TreeCaps, check_overflow


@pytest.fixture(scope="module")
def model_v1(gaussvol_system):
    params, pos = gaussvol_system
    return AGBNPModel(params, version=1)


@pytest.fixture(scope="module")
def model_v0(gaussvol_system):
    params, pos = gaussvol_system
    return AGBNPModel(params, version=0)


@pytest.mark.slow
def test_gvolsa_parity(gaussvol_system, model_v0):
    params, pos = gaussvol_system
    e_o, f_o, _ = gvolsa_energy_forces(params, pos)
    e, f = model_v0.energy_forces(pos)
    assert float(e) == pytest.approx(e_o, abs=1e-9)
    assert float(e) == pytest.approx(872.514, abs=1e-3)
    np.testing.assert_allclose(np.array(f), f_o, atol=1e-10)


def test_agbnp1_parity(gaussvol_system, model_v1):
    params, pos = gaussvol_system
    e_o, f_o = agbnp1_energy_forces(params, pos)
    e, f = model_v1.energy_forces(pos)
    assert float(e) == pytest.approx(e_o, abs=1e-8)
    assert float(e) == pytest.approx(-2476.66, abs=1e-2)
    np.testing.assert_allclose(np.array(f), f_o, atol=1e-9)


@pytest.mark.slow
def test_sorted_segment_reduce_matches_scatter(gaussvol_system, model_v1):
    """The sorted-segment upward reduction (bnd path) must agree with the
    plain segment-sum scatter path on a real build."""
    from openmm_agbnp_jax.ops.tree import (
        build_tree, make_level1, reduce_tree,
    )

    params, pos = gaussvol_system
    m = model_v1
    gdr = jnp.asarray(m.arrays["gamma"]) / params.roffset
    lvl1 = make_level1(jnp.asarray(pos),
                       jnp.asarray(m.arrays["radii_large"]),
                       jnp.asarray(m.arrays["vol_large"]), gdr,
                       jnp.asarray(m.arrays["ishydrogen"]))
    levels, _ = build_tree(lvl1, jnp.asarray(m.arrays["pairs_i"]),
                           jnp.asarray(m.arrays["pairs_j"]), m.caps,
                           pairs_valid=jnp.asarray(m.arrays["pairs_valid"]))
    assert all("bnd" in l for l in levels)
    red_scan = reduce_tree(levels, lvl1, with_selfvol=True)
    stripped = tuple({k: v for k, v in l.items() if k != "bnd"}
                     for l in levels)
    red_scat = reduce_tree(stripped, lvl1, with_selfvol=True)
    np.testing.assert_allclose(float(red_scan["energy"]),
                               float(red_scat["energy"]), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(red_scan["dr"]),
                               np.asarray(red_scat["dr"]), atol=1e-10)
    np.testing.assert_allclose(np.asarray(red_scan["self_volume"]),
                               np.asarray(red_scat["self_volume"]),
                               atol=1e-10)


@pytest.mark.slow
def test_chunked_sibling_build_matches_oneshot(gaussvol_system, model_v1,
                                               monkeypatch):
    """The memory-bounded chunked level build (dispatched above
    _CHUNK_BUILD_ELEMS window candidates; what >12k-atom systems use) must
    reproduce the one-shot slice-window build exactly: same node data,
    indices, validity, and counts at every level."""
    from openmm_agbnp_jax.ops import tree as T

    params, pos = gaussvol_system
    m = model_v1
    gdr = jnp.asarray(m.arrays["gamma"]) / params.roffset
    lvl1 = make_level1_args = (jnp.asarray(pos),
                               jnp.asarray(m.arrays["radii_large"]),
                               jnp.asarray(m.arrays["vol_large"]), gdr,
                               jnp.asarray(m.arrays["ishydrogen"]))
    lvl1 = T.make_level1(*make_level1_args)

    def build():
        return T.build_tree(lvl1, jnp.asarray(m.arrays["pairs_i"]),
                            jnp.asarray(m.arrays["pairs_j"]), m.caps,
                            pairs_valid=jnp.asarray(
                                m.arrays["pairs_valid"]))

    levels_a, diag_a = build()
    monkeypatch.setattr(T, "_CHUNK_BUILD_ELEMS", 0)
    monkeypatch.setattr(T, "_SLICE_BUILD_TOTAL", 0)  # pressure the build
    monkeypatch.setattr(T, "_CHUNK_LEVEL_MIN", 0)
    monkeypatch.setattr(T, "_CHUNK_ROWS", 128)  # force multi-block scans
    levels_b, diag_b = build()
    np.testing.assert_array_equal(np.asarray(diag_a["counts"]),
                                  np.asarray(diag_b["counts"]))
    for la, lb in zip(levels_a, levels_b):
        np.testing.assert_array_equal(np.asarray(la["valid"]),
                                      np.asarray(lb["valid"]))
        np.testing.assert_array_equal(np.asarray(la["_ints"]),
                                      np.asarray(lb["_ints"]))
        np.testing.assert_allclose(np.asarray(la["_dat"]),
                                   np.asarray(lb["_dat"]), rtol=0, atol=0)
        np.testing.assert_array_equal(np.asarray(la["bnd"]["pmono"]),
                                      np.asarray(lb["bnd"]["pmono"]))


@pytest.mark.slow
def test_agbnp1_forces_equal_autodiff(gaussvol_system, model_v1):
    """The hand-derived analytic force chain must equal jax.grad through the
    entire pipeline (tree build treated as fixed topology, as the reference
    does)."""
    params, pos = gaussvol_system
    m = model_v1
    e, f = m.energy_forces(pos)
    grad = jax.grad(lambda q: m._jit_ef(m.arrays, q)["energy"])(
        jnp.asarray(pos))
    np.testing.assert_allclose(np.array(-grad), np.array(f),
                               rtol=1e-9, atol=1e-9)


def test_no_overflow_on_fixture(gaussvol_system, model_v1):
    params, pos = gaussvol_system
    e, f, out = model_v1.energy_forces(pos, with_details=True)
    assert not check_overflow(out["diag"])["any"]


@pytest.mark.slow
def test_overflow_detect_and_grow(gaussvol_system):
    """PanicButton path: undersized capacities are detected and grown until
    the evaluation is exact (OpenCLAGBNPKernels.cpp:3598-3634 analogue)."""
    params, pos = gaussvol_system
    e_ref, _ = agbnp1_energy_forces(params, pos)
    small = AGBNPModel(params, version=1,
                       caps=TreeCaps(caps=(1024, 1024, 1024, 1024, 512, 128, 128),
                                     offs=(48, 32, 24, 16, 8, 4)))
    _, _, out = small.energy_forces(pos, with_details=True)
    assert small.check_and_grow(out["diag"])
    for _ in range(8):
        e, f, out = small.energy_forces(pos, with_details=True)
        if not small.check_and_grow(out["diag"]):
            break
    assert float(e) == pytest.approx(e_ref, abs=1e-8)


def test_translation_invariance(gaussvol_system, model_v1):
    params, pos = gaussvol_system
    e, f = model_v1.energy_forces(pos)
    e2, f2 = model_v1.energy_forces(pos + np.array([1.0, -2.0, 0.5]))
    assert float(e2) == pytest.approx(float(e), abs=1e-8)
    assert np.abs(np.array(f2).sum(0)).max() < 1e-8


@pytest.mark.slow
def test_row_structured_build_matches_flat(gaussvol_system, model_v1):
    """The gather-free [N, kmax] row build (pair_rows=True, the MD path)
    must be bitwise-identical to the flat triangular-pair build."""
    from openmm_agbnp_jax.models.agbnp_jax import energy_forces
    from openmm_agbnp_jax.ops.neighbors import (
        half_neighbor_pairs, tree_pair_cutoff)

    params, pos = gaussvol_system
    m = model_v1
    ref = energy_forces(m.arrays, pos, caps=m.caps, version=1,
                        roffset=params.roffset, ntypes_j=m.ntypes_j)

    rcut = tree_pair_cutoff(params.radii_large) + 0.1
    heavy = jnp.asarray(np.asarray(params.ishydrogen) == 0)
    pi, pj, pv, _ = half_neighbor_pairs(jnp.asarray(pos), heavy, rcut, 64)
    a = {**m.arrays, "pairs_i": pi, "pairs_j": pj, "pairs_valid": pv}
    out = energy_forces(a, pos, caps=m.caps, version=1,
                        roffset=params.roffset, ntypes_j=m.ntypes_j,
                        pair_rows=True)
    assert float(out["energy"]) == float(ref["energy"])
    np.testing.assert_array_equal(np.array(out["force"]),
                                  np.array(ref["force"]))


@pytest.mark.slow
def test_descreen_horizon_pallas_matches_xla(gaussvol_system):
    """OpenCL-backend cutoff semantics (Born/descreening sweeps truncated at
    the nonbonded cutoff, reference OpenCLAGBNPKernels.cpp:2258): the f32
    XLA path must agree with the f64 one under the same truncated horizon,
    and the truncation must actually change the energy vs the 2 nm
    default."""
    params, pos = gaussvol_system
    kw = dict(version=1, cutoff=1.0, positions=np.asarray(pos))
    m_64 = AGBNPModel(params, dtype=np.float64, descreen_horizon="cutoff",
                      **kw)
    m_32 = AGBNPModel(params, dtype=np.float32, descreen_horizon="cutoff",
                      **kw)
    m_ref = AGBNPModel(params, dtype=np.float64, **kw)
    e0, f0 = m_64.energy_forces(pos)
    e1, f1 = m_32.energy_forces(pos)
    er, _ = m_ref.energy_forces(pos)
    f0, f1 = np.asarray(f0), np.asarray(f1)
    assert abs(float(e1) - float(e0)) <= 5e-3
    assert np.abs(f1 - f0).max() <= 3e-6 * np.abs(f0).max()
    # the 1 nm truncation is a real (small) physics change vs 2 nm
    assert abs(float(er) - float(e0)) > 1e-3


def test_reduce_tree2_selfvol_a_channel():
    """reduce_tree2's with_selfvol_a channel (added for the fused AGBNP2
    cavity custom_vjp forwards) must equal per-tree reduce_tree
    self-volumes exactly on both parameterizations."""
    import jax.numpy as jnp

    from openmm_agbnp_jax.models.agbnp_jax import prepare_arrays
    from openmm_agbnp_jax.models.oracle import AGBNPParams
    from openmm_agbnp_jax.ops import tree as T

    rng = np.random.default_rng(3)
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    pos = 0.28 * g + 0.03 * rng.standard_normal((64, 3))
    ish = (np.arange(64) % 3 == 2).astype(np.int64)
    params = AGBNPParams(radius=np.where(ish > 0, 0.12, 0.16),
                         gamma=np.where(ish > 0, 0.0, 48.9528),
                         alpha=np.where(ish > 0, -20.0, -60.0),
                         charge=rng.uniform(-0.3, 0.3, 64), ishydrogen=ish)
    a = prepare_arrays(params)
    posj = jnp.asarray(pos)
    gdr = jnp.asarray(a["gamma"]) / params.roffset
    l1a = T.make_level1(posj, jnp.asarray(a["radii_large"]),
                        jnp.asarray(a["vol_large"]), gdr,
                        jnp.asarray(a["ishydrogen"]))
    l1b = T.make_level1(posj, jnp.asarray(a["radii_vdw"]),
                        jnp.asarray(a["vol_vdw"]), -gdr,
                        jnp.asarray(a["ishydrogen"]))
    caps = T.TreeCaps.for_natoms(64, boost=1.5)
    levels, _ = jax.jit(lambda: T.build_tree(
        l1a, a["pairs_i"], a["pairs_j"], caps,
        pairs_valid=a["pairs_valid"]))()
    la, lb = T.rescan_volumes2(T.tree_topology(levels), l1a, l1b)
    ra, rb = T.reduce_tree2(la, lb, l1a, l1b, with_selfvol_b=True,
                            with_selfvol_a=True)
    ref_a = T.reduce_tree(la, l1a, with_selfvol=True)
    ref_b = T.reduce_tree(lb, l1b, with_selfvol=True)
    np.testing.assert_allclose(np.asarray(ra["self_volume"]),
                               np.asarray(ref_a["self_volume"]),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(rb["self_volume"]),
                               np.asarray(ref_b["self_volume"]),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(float(ra["energy"]), float(ref_a["energy"]),
                               rtol=1e-12)
    np.testing.assert_allclose(float(rb["energy"]), float(ref_b["energy"]),
                               rtol=1e-12)


@pytest.mark.parametrize("deriv", [False, True], ids=["value", "deriv"])
def test_spline_lookup_matches_oracle_i4_spline(gaussvol_system, deriv):
    """The gather-based Q4 spline lookup of the pair phases reproduces the
    f64 oracle's natural-spline evaluation (I4LookupTables.eval /
    evalderiv) at random distances over the whole 2 nm grid and random
    (screened, screener) type pairs."""
    from openmm_agbnp_jax.models.i4_tables import I4LookupTables
    from openmm_agbnp_jax.ops.born import spline_lookup

    params, _ = gaussvol_system
    t = I4LookupTables(params.radii_vdw, params.ishydrogen)
    rng = np.random.default_rng(11)
    m = 400
    d = rng.uniform(0.0, 1.999, m)
    ti = rng.integers(0, t.ntypes_screened, m)
    tj = rng.integers(0, t.ntypes_screener, m)
    val, dval = spline_lookup(jnp.asarray(d), jnp.asarray(ti),
                              jnp.asarray(tj), t.yval.reshape(-1),
                              t.y2val.reshape(-1), t.ntypes_screener,
                              deriv=deriv)
    got = np.asarray(dval if deriv else val)
    oracle = t.evalderiv if deriv else t.eval
    ref = np.array([oracle(x, a, b) for x, a, b in zip(d, ti, tj)])
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


def test_build_budgets_follow_memory_limit(monkeypatch):
    """The one-shot/chunked tree build budgets are candidate counts derived
    from the default device's memory limit (the named host constant where
    the device reports none) and the unpadded candidate row bytes; a module
    attribute that is set overrides its budget."""
    from openmm_agbnp_jax.ops import tree as T

    for dtype in (np.float32, np.float64):
        per = T._candidate_row_bytes(dtype)
        assert per == (T._D + 6) * np.dtype(dtype).itemsize + 12
        stats = jax.devices()[0].memory_stats() or {}
        limit = stats.get("bytes_limit", T._HOST_MEMORY_BYTES)
        total, level_min, build_elems = T._build_budgets(dtype)
        assert total == int(limit * T._SLICE_BUILD_SHARE) // per
        assert level_min == int(limit * T._CHUNK_LEVEL_SHARE) // per
        assert build_elems == int(limit * T._CHUNK_BUILD_SHARE) // per
        assert total > build_elems > level_min > 0
    monkeypatch.setattr(T, "_SLICE_BUILD_TOTAL", 7)
    monkeypatch.setattr(T, "_CHUNK_LEVEL_MIN", 0)
    assert T._build_budgets(np.float32)[:2] == (7, 0)
