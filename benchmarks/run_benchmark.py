"""Per-protein MD benchmark harness, mirroring the reference's example/
scripts (reference example/t4lysozyme_benchmark.py etc.): load the .dms
system, run N Langevin steps at 300 K / 1 fs, print elapsed time and ns/day,
and write final positions/velocities back into a copy of the .dms file.

Usage:
  python benchmarks/run_benchmark.py --system 1li2_agbnp1 --steps 10000
  python benchmarks/run_benchmark.py --all --steps 2000

Systems shipped in benchmarks/data: trpcage_agbnp1 (NoCutoff in the
reference protocol), 1li2_agbnp1 (t4lysozyme), 1dwc_agbnp1, 2clr_agbnp1,
rnaseh_agbnp1 (CutoffNonPeriodic 1 nm in the reference protocol).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SYSTEMS = ["trpcage_agbnp1", "1li2_agbnp1", "1dwc_agbnp1", "2clr_agbnp1",
           "rnaseh_agbnp1"]

# reference benchmark configurations (example/*_benchmark.py:10-19):
# trpcage NoCutoff, the rest CutoffNonPeriodic 1 nm
CUTOFFS = {"trpcage_agbnp1": None, "1li2_agbnp1": 1.0, "1dwc_agbnp1": 1.0,
           "2clr_agbnp1": 1.0, "rnaseh_agbnp1": 1.0}


def run_one(name, steps, dtype, out_dms=None, descreen_horizon=None,
            mts_inner=0, dt=0.001, constraints=False):
    import numpy as np

    from openmm_agbnp_jax.io.dms import load_dms, save_dms
    from openmm_agbnp_jax.md.simulation import Simulation

    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "data", f"{name}.dms")
    dms = load_dms(path)
    sim = Simulation(dms, version=1, cutoff=CUTOFFS.get(name), dtype=dtype,
                     skin=0.25, descreen_horizon=descreen_horizon,
                     constraints=constraints)
    # neighbor windows cover ~40 fs of drift regardless of the step size
    ne = max(1, int(round(40 * 0.001 / dt)))
    res = sim.benchmark_langevin(nsteps=steps, dt=dt, temperature=300.0,
                                 friction=1.0, neighbor_every=ne,
                                 mts_inner=mts_inner)
    print(json.dumps(dict(system=name, natoms=dms.n, steps=steps,
                          dt_fs=dt * 1e3, mts_inner=mts_inner,
                          constraints=constraints,
                          elapsed_s=round(res["elapsed_s"], 3),
                          steps_per_s=round(res["steps_per_s"], 2),
                          ns_day=round(res["ns_day"], 3),
                          overflow=res["overflow"])), flush=True)
    if out_dms:
        save_dms(path, out_dms, np.asarray(res["final_pos"]),
                 np.asarray(res["final_vel"]))
    return res


def main():
    import jax
    import numpy as np

    ap = argparse.ArgumentParser()
    ap.add_argument("--system", default="1li2_agbnp1")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--save", default=None,
                    help="write final state to this .dms path")
    ap.add_argument("--mts-inner", type=int, default=0,
                    help="r-RESPA bonded substeps per outer step (0 = "
                         "plain middle-scheme Langevin)")
    ap.add_argument("--dt", type=float, default=0.001,
                    help="outer step in ps (default 1 fs, the reference "
                         "protocol)")
    ap.add_argument("--constraints", action="store_true",
                    help="SHAKE/RATTLE the Desmond X-H constraint tables")
    ap.add_argument("--descreen-horizon", default=None,
                    help='"cutoff" for the reference OpenCL backend\'s '
                         "cutoff-mode semantics, a float (nm), or unset "
                         "for the Reference-platform 2 nm LUT horizon")
    args = ap.parse_args()
    dh = args.descreen_horizon
    if dh not in (None, "cutoff"):
        dh = float(dh)

    from openmm_agbnp_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    platform = jax.devices()[0].platform
    dtype = np.float32 if platform != "cpu" else np.float64
    systems = SYSTEMS if args.all else [args.system]
    for name in systems:
        run_one(name, args.steps, dtype,
                out_dms=args.save if not args.all else None,
                descreen_horizon=dh, mts_inner=args.mts_inner, dt=args.dt,
                constraints=args.constraints)


if __name__ == "__main__":
    main()
