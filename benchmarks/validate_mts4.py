"""Protocol-length validation of the 4 fs r-RESPA + SHAKE/RATTLE
configuration (mts_inner=2, dt=4 fs outer / 2 fs bonded, X-H constraints).

The 4 fs MTS configuration can only headline if
the configuration is validated at protocol length like mts_wu4 was
(benchmarks/validate_mts.py).  Same two checks over the same simulated
time (10 ps):

  1. NVT ensemble statistics at 300 K vs the exact 1 fs unconstrained
     integrator: kinetic temperature (constrained-DOF corrected) and
     potential-energy distribution.
  2. NVE drift: friction=0 (r-RESPA velocity Verlet + RATTLE), total
     energy at segment boundaries, drift slope per ns.

Writes results into benchmarks/mts_validation.json under "<system>_mts4".
Usage: python benchmarks/validate_mts4.py [1li2_agbnp1 ...]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from openmm_agbnp_jax.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from benchmarks.validate_mts import CONFIGS, kinetic_energy
from openmm_agbnp_jax.io.dms import load_dms
from openmm_agbnp_jax.md.simulation import Simulation

HERE = os.path.dirname(os.path.abspath(__file__))
KB = 0.00831446261815324  # kJ/mol/K


def temp_of(sim, vel, n_con):
    n_dof = 3 * len(np.asarray(sim.masses)) - n_con
    return 2.0 * kinetic_energy(sim.masses, vel) / (n_dof * KB)


def run_nvt(sim, n_con, dt, mts_inner, nsteps, nseg=20, seed=11):
    run = sim.make_langevin_runner(dt, 300.0, 1.0,
                                   neighbor_every=max(1, int(0.04 / dt)),
                                   mts_inner=mts_inner)
    key = jax.random.PRNGKey(seed)
    pos, vel = sim.positions, sim.velocities
    per = nsteps // nseg
    pe, temps = [], []
    t0 = time.time()
    for s in range(nseg):
        pos, vel, key, e, diag = run(pos, vel, key, per)
        e = np.asarray(e)
        pe.append(e)
        temps.append(temp_of(sim, vel, n_con))
        if sim._check_overflow(np.asarray(diag[0]), diag[1],
                               np.asarray(diag[2]), np.asarray(diag[3])):
            raise RuntimeError("overflow during validation run")
    pe = np.concatenate(pe)
    return dict(elapsed_s=time.time() - t0,
                pe_mean=float(pe[len(pe) // 5:].mean()),
                pe_std=float(pe[len(pe) // 5:].std()),
                temp_mean=float(np.mean(temps[nseg // 5:])),
                temp_std=float(np.std(temps[nseg // 5:])))


def run_nve(sim, dt, mts_inner, nsteps, nseg=10):
    eq = sim.make_langevin_runner(dt, 300.0, 1.0,
                                  neighbor_every=max(1, int(0.04 / dt)),
                                  mts_inner=mts_inner)
    key = jax.random.PRNGKey(7)
    pos, vel, key, _, _ = eq(sim.positions, sim.velocities, key,
                             nsteps // 5)
    run = sim.make_langevin_runner(dt, 300.0, 0.0,
                                   neighbor_every=max(1, int(0.04 / dt)),
                                   mts_inner=mts_inner)
    force_fn = jax.jit(sim.force_fn())

    def e_tot(pos, vel):
        e, _, _ = force_fn(pos)
        return float(np.asarray(e)) + kinetic_energy(sim.masses, vel)

    per = nsteps // nseg
    es = [e_tot(pos, vel)]
    for s in range(nseg):
        pos, vel, key, e, diag = run(pos, vel, key, per)
        np.asarray(e)
        es.append(e_tot(pos, vel))
    es = np.asarray(es)
    t_ns = np.arange(nseg + 1) * per * dt * 1e-3
    slope = float(np.polyfit(t_ns, es, 1)[0])
    return dict(e_tot=[float(x) for x in es], drift_kj_per_ns=slope,
                drift_rel_per_ns=slope / abs(es[0]))


def main():
    systems = [s for s in sys.argv[1:] if not s.startswith("-")] \
        or ["1li2_agbnp1"]
    sim_ps = float(os.environ.get("MTS4_VALIDATE_PS", "10.0"))
    path = os.path.join(HERE, "mts_validation.json")
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    dtype = np.float32 if jax.devices()[0].platform != "cpu" else np.float64
    for name in systems:
        cfg = CONFIGS[name]
        res = {}
        # exact 1 fs unconstrained run (the reference protocol) as the
        # ensemble baseline, same simulated time
        dms = load_dms(os.path.join(HERE, "data", f"{name}.dms"))
        sim0 = Simulation(dms, version=1, cutoff=cfg["cutoff"], dtype=dtype,
                          descreen_horizon=cfg["dh"])
        sim0.set_velocities_to_temperature(300.0, seed=1)
        res["nvt_1fs"] = run_nvt(sim0, 0, 0.001, 0, int(sim_ps * 1000))
        print(f"{name} NVT 1fs exact: "
              f"T={res['nvt_1fs']['temp_mean']:.2f}"
              f"+-{res['nvt_1fs']['temp_std']:.2f} K  "
              f"PE={res['nvt_1fs']['pe_mean']:.1f}"
              f"+-{res['nvt_1fs']['pe_std']:.1f}", flush=True)

        dms = load_dms(os.path.join(HERE, "data", f"{name}.dms"))
        simc = Simulation(dms, version=1, cutoff=cfg["cutoff"], dtype=dtype,
                          descreen_horizon=cfg["dh"], constraints=True)
        n_con = int(simc.constraints.n_constraints)
        simc.set_velocities_to_temperature(300.0, seed=1)
        res["nvt_mts4"] = run_nvt(simc, n_con, 0.004, 2,
                                  int(sim_ps * 250))
        print(f"{name} NVT mts4+constraints: "
              f"T={res['nvt_mts4']['temp_mean']:.2f}"
              f"+-{res['nvt_mts4']['temp_std']:.2f} K  "
              f"PE={res['nvt_mts4']['pe_mean']:.1f}"
              f"+-{res['nvt_mts4']['pe_std']:.1f} "
              f"(n_con={n_con})", flush=True)
        res["nve_mts4"] = run_nve(simc, 0.004, 2, int(sim_ps * 250))
        print(f"{name} NVE mts4: drift "
              f"{res['nve_mts4']['drift_kj_per_ns']:.2f} kJ/mol/ns "
              f"({res['nve_mts4']['drift_rel_per_ns']:.2e} rel)", flush=True)
        out[name + "_mts4"] = res
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
    print("wrote benchmarks/mts_validation.json")


if __name__ == "__main__":
    main()
