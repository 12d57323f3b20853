"""DCD trajectory IO (io/dcd.py) and run_md snapshot reporting.

The reference gets trajectory output from OpenMM's app layer; here the
framework writes the standard CHARMM/NAMD single-precision DCD flavor
directly, validated by byte-level header checks and an exact round trip.
"""

import os
import struct

import numpy as np
import pytest

from openmm_agbnp_jax.io.dcd import read_dcd, write_dcd


def test_dcd_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    frames = rng.normal(scale=2.0, size=(5, 37, 3))
    path = os.path.join(tmp_path, "t.dcd")
    write_dcd(path, frames, dt_ps=0.002, first_step=100, interval=50)
    back, info = read_dcd(path)
    # coordinates survive the f32 Angstrom round trip
    np.testing.assert_allclose(back, frames, atol=5e-6)
    assert info["first_step"] == 100 and info["interval"] == 50
    assert info["dt_ps"] == pytest.approx(0.002, rel=1e-6)
    assert info["box"] is None


def test_dcd_round_trip_with_box(tmp_path):
    frames = np.random.default_rng(1).normal(size=(3, 11, 3))
    box = [4.0, 5.0, 6.0]
    path = os.path.join(tmp_path, "b.dcd")
    write_dcd(path, frames, box=box)
    back, info = read_dcd(path)
    np.testing.assert_allclose(back, frames, atol=5e-6)
    np.testing.assert_allclose(info["box"], np.tile(box, (3, 1)), rtol=1e-12)


def test_dcd_header_layout(tmp_path):
    """Byte-level header contract that external readers (VMD/mdtraj/
    MDAnalysis) depend on: Fortran record markers, 'CORD' magic, icntrl
    frame bookkeeping, CHARMM version tag, natoms record."""
    frames = np.zeros((2, 7, 3))
    path = os.path.join(tmp_path, "h.dcd")
    write_dcd(path, frames, interval=10, first_step=20)
    raw = open(path, "rb").read()
    (n0,) = struct.unpack("<i", raw[:4])
    assert n0 == 84  # 'CORD' + 20 ints
    assert raw[4:8] == b"CORD"
    icntrl = struct.unpack("<20i", raw[8:88])
    assert icntrl[0] == 2            # frames
    assert icntrl[1] == 20           # first step
    assert icntrl[2] == 10           # save interval
    assert icntrl[19] == 24          # CHARMM version tag
    assert struct.unpack("<i", raw[88:92])[0] == 84  # trailing marker
    # single-frame write accepts [N, 3] too
    write_dcd(path, frames[0])
    back, _ = read_dcd(path)
    assert back.shape == (1, 7, 3)


@pytest.mark.slow
def test_run_md_reports_frames(tmp_path):
    """run_md(report_interval=k) returns snapshots at the requested steps;
    the final snapshot is exactly final_pos; frames write out as DCD."""
    from openmm_agbnp_jax.io.dms import load_dms
    from openmm_agbnp_jax.md.simulation import Simulation

    path = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "data", "trpcage_agbnp1.dms")
    sim = Simulation(load_dms(path), version=1, dtype=np.float64)
    seen = []
    res = sim.run_md(25, neighbor_every=5, report_interval=10,
                     reporter=lambda s, p, v: seen.append(s))
    assert res["frame_steps"].tolist() == [10, 20, 25]
    assert seen == [10, 20, 25]
    assert res["frames"].shape == (3, sim.positions.shape[0], 3)
    np.testing.assert_array_equal(res["frames"][-1],
                                  np.asarray(res["final_pos"]))
    # frames differ between snapshots (the system actually moved)
    assert np.abs(res["frames"][1] - res["frames"][0]).max() > 1e-6
    dcd = os.path.join(tmp_path, "traj.dcd")
    write_dcd(dcd, res["frames"], dt_ps=0.001, interval=10)
    back, _ = read_dcd(dcd)
    np.testing.assert_allclose(back, res["frames"], atol=5e-6)


def test_maxwell_boltzmann_velocities():
    """setVelocitiesToTemperature analogue: exact kinetic temperature after
    COM removal, zero total momentum."""
    import jax

    from openmm_agbnp_jax.md.integrators import (
        KB, maxwell_boltzmann_velocities)

    rng = np.random.default_rng(2)
    masses = np.abs(rng.normal(loc=12.0, scale=3.0, size=64)) + 1.0
    vel = np.asarray(maxwell_boltzmann_velocities(
        jax.random.PRNGKey(3), masses, 300.0))
    p = (masses[:, None] * vel).sum(axis=0)
    np.testing.assert_allclose(p, 0.0, atol=1e-9)
    ke = 0.5 * (masses[:, None] * vel * vel).sum()
    ndof = 64 * 3 - 3
    assert 2 * ke / (ndof * KB) == pytest.approx(300.0, rel=1e-10)
