"""Large-system scaling check: synthetic protein-like blobs beyond the
shipped benchmark systems (the largest .dms is 2clr at 5983 atoms).

Generates an N-atom pseudo-protein at protein-like density (~95 atoms/nm^3,
~60% heavy), runs the AGBNP1 energy+forces pipeline through AGBNPModel
(cell-grid neighbor build above 3k atoms) with the PanicButton retry loop,
and times steady-state evaluations.

Usage: python benchmarks/synthetic_scale.py [natoms ...]   (default 10240)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from openmm_agbnp_jax.utils.compile_cache import enable_compile_cache

enable_compile_cache()


def synthetic_system(natoms: int, seed: int = 0):
    """Protein-like synthetic ball: jittered cubic lattice at protein
    density trimmed to a sphere, 60% heavy atoms with AGBNP-like
    radii/charges, common gamma, hydrogens interleaved.

    A lattice (not uniform random placement) guarantees realistic minimum
    separations (~0.17 nm): uniform sampling puts some pairs at near-zero
    distance, which explodes both the overlap tree and the forces the
    moment MD starts (observed round 4 as an unconvergeable PanicButton
    regrow loop at 10k atoms)."""
    rng = np.random.default_rng(seed)
    density = 95.0  # atoms / nm^3, protein-like
    a = density ** (-1.0 / 3.0)  # ~0.219 nm lattice constant
    m = int(np.ceil((natoms * 6 / np.pi) ** (1.0 / 3.0))) + 2
    g = (np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) - (m - 1) / 2.0) * a
    g = g + rng.uniform(-0.12 * a, 0.12 * a, size=g.shape)
    order = np.argsort(np.linalg.norm(g, axis=1), kind="stable")
    pos = g[order[:natoms]]
    ish = (rng.uniform(size=natoms) < 0.4).astype(np.int64)
    radius = np.where(ish > 0, 0.125,
                      rng.choice([0.15, 0.16, 0.17, 0.19], size=natoms))
    gamma = np.where(ish > 0, 0.0, 48.9528)
    alpha = np.where(ish > 0, -20.0, rng.uniform(-90.0, -40.0, size=natoms))
    charge = rng.uniform(-0.15, 0.15, size=natoms)
    charge -= charge.mean()
    return pos, radius, gamma, alpha, charge, ish


def run(natoms: int, repeats: int = 10):
    from openmm_agbnp_jax.models.agbnp_jax import AGBNPModel
    from openmm_agbnp_jax.models.oracle import AGBNPParams

    pos, radius, gamma, alpha, charge, ish = synthetic_system(natoms)
    params = AGBNPParams(radius=radius, gamma=gamma, alpha=alpha,
                         charge=charge, ishydrogen=ish)
    dtype = np.float32 if jax.devices()[0].platform != "cpu" else np.float64
    t0 = time.time()
    m = AGBNPModel(params, version=1, cutoff=1.0, dtype=dtype, positions=pos)
    print(f"n={natoms} init {time.time()-t0:.1f}s "
          f"grid={'on' if m.neighbor_grid is not None else 'off'} "
          f"kmax={m.neighbor_kmax} caps={m.caps.caps}", flush=True)

    t0 = time.time()
    for _ in range(8):  # PanicButton loop
        e, f, out = m.energy_forces(pos, with_details=True)
        if not m.check_and_grow(out["diag"]):
            break
    jax.block_until_ready(f)
    print(f"  first eval (incl compile) {time.time()-t0:.1f}s "
          f"E={float(e):.2f}", flush=True)
    assert np.isfinite(float(e)) and np.isfinite(np.asarray(f)).all()

    t0 = time.time()
    for _ in range(repeats):
        e, f = m.energy_forces(pos)
    jax.block_until_ready(f)
    dt = (time.time() - t0) / repeats
    print(f"  steady-state eval {dt*1e3:.2f} ms", flush=True)
    return dt


def synthetic_dms(natoms: int):
    """The synthetic ball as a Simulation-ready BONDED system.

    Round-4/5 finding: AGBNP-only dynamics (include_mm=False) has NO
    repulsive wall — the cavity+GB+dispersion forces are net attractive at
    contact, so the ball implodes under MD and the overlap tree grows
    without bound (an unconvergeable PanicButton loop that looks like a
    capacity bug but is the physics of a core-less potential).  Free LJ
    spheres at protein density don't work either: the tree-rich packing
    the model is built for (covalently bonded, overlapping vdW spheres)
    puts nearest neighbors far inside any realistic LJ contact, which
    detonates instead.  The resolution is the same as a real protein's:
    BOND the nearest neighbors (harmonic springs, LJ-excluded) so the
    tree-rich first-shell overlaps are held by bonds, and let LJ keep the
    non-bonded second shell (~0.31+ nm here) at bay.  The result is a
    dense bonded polymer ball — stable under 300 K Langevin and
    overlap-tree-rich like a protein interior."""
    from types import SimpleNamespace

    pos, radius, gamma, alpha, charge, ish = synthetic_system(natoms)
    # bond each atom to its 3 nearest neighbors (deduplicated): a stiff
    # percolated network whose first-shell geometry — the part that sets
    # the overlap-tree density — is pinned near the initial sizing, so
    # capacity demand stays stationary under 300 K dynamics (the property
    # a SCALING benchmark needs; a real protein gets it from its covalent
    # topology)
    from scipy.spatial import cKDTree

    tree = cKDTree(pos)
    dd, jj = tree.query(pos, k=4)
    bonds = []
    seen = set()
    for i in range(natoms):
        for m in range(1, 4):
            j = int(jj[i, m])
            a, b = (i, j) if i < j else (j, i)
            if (a, b) not in seen:
                seen.add((a, b))
                bonds.append((a, b, float(dd[i, m])))
    bond_idx = np.array([(a, b) for a, b, _ in bonds], np.int32)
    bond_r0 = np.array([d for _, _, d in bonds])
    z2 = np.zeros((0, 2), np.int32)
    return SimpleNamespace(
        agbnp_radius=radius, agbnp_gamma=gamma, agbnp_alpha=alpha,
        charges=charge, ishydrogen=ish, positions=pos,
        velocities=np.zeros_like(pos),
        masses=np.where(ish > 0, 1.008, 12.011), n=natoms,
        # LJ wall just inside the second-neighbor shell; bonded first
        # neighbors are excluded below
        lj_sigma=np.where(ish > 0, 0.22, 0.28),
        lj_epsilon=np.where(ish > 0, 0.08, 0.30),
        bond_idx=bond_idx, bond_r0=bond_r0,
        bond_k=np.full(len(bonds), 1.5e5),
        angle_idx=np.zeros((0, 3), np.int32), angle_theta0=np.zeros(0),
        angle_k=np.zeros(0),
        dihedral_idx=np.zeros((0, 4), np.int32),
        dihedral_phi0=np.zeros(0), dihedral_fc=np.zeros((0, 5)),
        exclusions=bond_idx, pair_idx=z2, pair_aij=np.zeros(0),
        pair_bij=np.zeros(0), pair_qij=np.zeros(0))


def run_md(natoms: int, nsteps: int = 100, scan_unroll: int = None,
           neighbor_every: int = 20):
    """Full MD loop at synthetic scale: Langevin under the fused scan with
    on-device neighbor rebuilds, stale-topology rescans and PanicButton
    overflow recovery — Simulation duck-types the dms object, so a
    synthetic system drives the identical code path the .dms benchmarks
    use (full MM LJ/Coulomb + AGBNP)."""
    from openmm_agbnp_jax.md.simulation import Simulation

    sysns = synthetic_dms(natoms)
    t0 = time.time()
    sim = Simulation(sysns, version=1, cutoff=1.0, dtype=np.float32,
                     include_mm=True)
    print(f"n={natoms} MD init {time.time()-t0:.1f}s", flush=True)
    if scan_unroll is None:
        # large systems: unroll=1 keeps the runner program a quarter the
        # size (see make_langevin_runner)
        scan_unroll = 1 if natoms > 8000 else 4
    if natoms > 8000:
        # huge systems: a heat phase, shrink-to-fit, then one rebuild
        # window per device execution timed window-by-window, each with
        # its own PanicButton retry (see _run_md_windows)
        res = _run_md_windows(sim, nsteps, neighbor_every, scan_unroll)
    else:
        res = sim.benchmark_langevin(nsteps=nsteps, dt=0.001,
                                     temperature=300.0,
                                     neighbor_every=neighbor_every,
                                     scan_unroll=scan_unroll)
    e = np.asarray(res["energies"])
    assert np.isfinite(e).all()
    ms_step = res.get("ms_step", 1e3 * res["elapsed_s"] / nsteps)
    print(f"  MD {res.get('steps_done', nsteps)} steps: "
          f"{res['ns_day']:.3f} ns/day ({ms_step:.1f} ms/step), "
          f"overflow={res['overflow']}, regrows={res.get('regrows', 0)}"
          + (f", windows={res['windows']}" if "windows" in res else ""),
          flush=True)
    return res


def _run_md_windows(sim, nsteps, neighbor_every, scan_unroll,
                    dt=0.001, temperature=300.0, heat_windows: int = 4,
                    max_regrow: int = 12):
    """Window-by-window large-N MD with the full PanicButton contract:
    EVERY window — heat and timed alike — that overflows any capacity
    channel is discarded, the overflowed channels are regrown, and the
    window is retried from its starting state (the reference's protocol:
    overflow => forces invalid => resize => retry, never report —
    OpenCLAGBNPKernels.cpp:3598-3634).  A window whose clean run directly
    followed a regrow is excluded from the timing sample (its run pays the
    recompile).  ns/day therefore always comes from clean windows only."""
    import jax
    import numpy as np

    def make_run():
        return sim.make_langevin_runner(dt, temperature, 1.0,
                                        neighbor_every=neighbor_every,
                                        scan_unroll=scan_unroll)

    state = dict(run=make_run(), regrows=0)
    # thermalized start: beginning at zero velocity makes every capacity
    # (neighbor kmax, tree levels) drift upward while the system heats,
    # so a cold-sized warm window under-sizes the timed ones
    key = jax.random.PRNGKey(0)
    sim.set_velocities_to_temperature(temperature, seed=1)
    pos, vel = sim.positions, sim.velocities

    def advance(pos, vel, key, label):
        """One clean window from (pos, vel, key): regrow + retry on any
        overflow.  Returns (out, elapsed_of_clean_run, regrew_here)."""
        regrew = False
        while True:
            t0 = time.perf_counter()
            out = state["run"](pos, vel, key, neighbor_every)
            counts = np.asarray(out[4][0])  # device sync
            elapsed = time.perf_counter() - t0
            rep = sim.overflow_report(counts, out[4][1],
                                      np.asarray(out[4][2]),
                                      np.asarray(out[4][3]))
            if not rep:
                return out, elapsed, regrew
            state["regrows"] += 1
            if state["regrows"] > max_regrow:
                raise RuntimeError(
                    f"PanicButton failed to converge after {max_regrow} "
                    f"regrows; still over: {rep}")
            print(f"  {label}: overflow {rep} -> regrow "
                  f"({state['regrows']}/{max_regrow})", flush=True)
            regrew = True
            # escalating headroom (see Simulation.run_md): each regrow
            # pays a multi-minute recompile at this scale, so widen the
            # margin on every retry
            sim._regrow(counts, out[4][1], np.asarray(out[4][2]),
                        wu=np.asarray(out[4][3]),
                        headroom=min(1.3 * 1.25 ** (state["regrows"] - 1),
                                     2.6))
            state["run"] = make_run()

    # heat phase: several windows so the timed sample measures a
    # thermalized configuration (capacity maxima keep drifting while the
    # lattice melts; with one window the timed run kept regrowing)
    for w in range(heat_windows):
        out, _, _ = advance(pos, vel, key, f"heat window {w}")
        pos, vel, key = out[0], out[1], out[2]
    if state["regrows"]:
        # shrink-to-fit after the transient: regrows only ever grow, so
        # post-heat capacities carry the melt spike + escalation headroom
        # and every padded row costs step time; re-size everything from
        # the equilibrated configuration (PanicButton grows back if lean
        # proves wrong — the timed loop below retries as usual)
        sim.resize_caps_to_current(np.asarray(pos))
        state["run"] = make_run()
        print(f"  shrink-to-fit: caps={sim.agbnp.caps.caps} "
              f"kmax={sim.kmax}", flush=True)
    nwin = max(1, nsteps // neighbor_every - heat_windows)
    times = []
    e = out[3]
    for w in range(nwin):
        out, elapsed, regrew = advance(pos, vel, key, f"timed window {w}")
        pos, vel, key = out[0], out[1], out[2]
        e = out[3]
        if not regrew:
            times.append(elapsed)
    med = float(np.median(times)) if times else float("inf")
    done = (len(times) + heat_windows) * neighbor_every
    return dict(ns_day=neighbor_every * dt * 1e-3 / med * 86400.0,
                elapsed_s=float(np.sum(times)),
                ms_step=med / neighbor_every * 1e3,
                windows=len(times), steps_done=done,
                energies=np.asarray(e), overflow=False,
                regrows=state["regrows"])


if __name__ == "__main__":
    md = "--md" in sys.argv
    sizes = [int(x) for x in sys.argv[1:] if not x.startswith("-")] or [10240]
    for n in sizes:
        if md:
            run_md(n)
        else:
            run(n)
