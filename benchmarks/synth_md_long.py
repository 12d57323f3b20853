"""Continuous >=1k-step 10,240-atom MD through Simulation.run_md.

The large-N window-median protocol (benchmarks/synthetic_scale.py) hides
rebuild amortization and host-sync costs that the small systems'
wall-clock numbers pay.  This runs ONE continuous run_md (segmented loop + exact
PanicButton segment retries + checkpoint after every clean segment — the
production shape at this scale) and reports BOTH the end-to-end wall-clock
ns/day and the per-window median, plus the regrow count and an energy-
trace finiteness check, then exercises checkpoint/restart at this scale.

Usage: python benchmarks/synth_md_long.py [natoms] [nsteps]
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from openmm_agbnp_jax.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from benchmarks.synthetic_scale import synthetic_dms
from openmm_agbnp_jax.md.simulation import Simulation


def build_sim(natoms, dtype):
    return Simulation(synthetic_dms(natoms), version=1, cutoff=1.0,
                      dtype=dtype, include_mm=True)


def main():
    natoms = int(sys.argv[1]) if len(sys.argv) > 1 else 10240
    nsteps = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    ne = 20
    dtype = np.float32
    ckpt = os.path.join(tempfile.gettempdir(), f"synth{natoms}_ck.npz")

    t0 = time.time()
    sim = build_sim(natoms, dtype)
    sim.set_velocities_to_temperature(300.0, seed=1)
    print(f"n={natoms} init {time.time()-t0:.0f}s", flush=True)

    # short heat + capacity-converge phase (not timed as production):
    # thermalizes and lets the PanicButton find steady capacities so the
    # continuous run's wall clock is not dominated by warm-up recompiles.
    # Window-by-window with prints — every compile/regrow is visible.
    heat_regrows = 0
    for w in range(6):
        t0 = time.time()
        r = sim.run_md(ne, dt=0.001, neighbor_every=ne, segment=ne,
                       scan_unroll=1, max_regrow=12, seed=w)
        sim.positions = r["final_pos"]
        sim.velocities = r["final_vel"]
        heat_regrows += r["regrows"]
        print(f"heat window {w}: {time.time()-t0:.0f}s "
              f"({r['regrows']} regrows)", flush=True)
    heat = dict(regrows=heat_regrows)
    print(f"heat: {heat_regrows} regrows total", flush=True)
    if heat_regrows:
        # shrink-to-fit: drop the melt transient's capacity overshoot
        # before timing (md/simulation.py::resize_caps_to_current)
        sim.resize_caps_to_current()
        print(f"shrink-to-fit: caps={sim.agbnp.caps.caps} "
              f"kmax={sim.kmax}", flush=True)

    # continuous production run, checkpointed every segment
    from openmm_agbnp_jax.io.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    res = sim.run_md(nsteps, dt=0.001, neighbor_every=ne, segment=ne,
                     scan_unroll=1, max_regrow=12, checkpoint_path=ckpt)
    wall = time.perf_counter() - t0
    e = np.asarray(res["energies"])
    ns_day_wall = nsteps * 0.001 * 1e-3 / wall * 86400.0
    print(f"continuous {nsteps} steps: wall {wall:.1f}s -> "
          f"{ns_day_wall:.3f} ns/day end-to-end "
          f"({1e3*wall/nsteps:.1f} ms/step), "
          f"run_md {res['ns_day']:.3f} ns/day "
          f"({1e3*res['elapsed_s']/nsteps:.1f} ms/step), "
          f"regrows={res['regrows']}, overflow={res['overflow']}, "
          f"energies finite={bool(np.isfinite(e).all())}", flush=True)

    # checkpoint/restart at scale: resume the last segment boundary and
    # verify the restarted step runs clean from the saved state
    ck = load_checkpoint(ckpt)
    res2 = sim.run_md(ne, dt=0.001, neighbor_every=ne, segment=ne,
                      scan_unroll=1, pos=ck["positions"],
                      vel=ck["velocities"], key=ck["key"])
    print(f"restart from step {ck['step']}: ran {ne} more steps clean "
          f"(overflow={res2['overflow']}), checkpoint/resume OK",
          flush=True)

    import json
    out = dict(natoms=natoms, nsteps=nsteps,
               ns_day_wallclock=round(ns_day_wall, 3),
               ms_step_wallclock=round(1e3 * wall / nsteps, 2),
               ns_day_run_md=round(res["ns_day"], 3),
               ms_step_run_md=round(1e3 * res["elapsed_s"] / nsteps, 2),
               regrows=int(res["regrows"]), overflow=bool(res["overflow"]),
               heat_regrows=int(heat["regrows"]))
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           f"synth_md_long_{natoms}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
