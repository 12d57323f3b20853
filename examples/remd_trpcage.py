"""Temperature replica-exchange MD on trp-cage, all on device.

The reference ecosystem runs AGBNP replica exchange through external
host-side schedulers (ASyncRE) with one device per replica; here the whole
REMD loop — per-replica AGBNP1 dynamics and the Metropolis rung swaps —
runs inside one jit, with the replica axis sharded over however many
devices jax exposes (all replicas fit on one device at this size).

Usage:  python examples/remd_trpcage.py [ncycles] [steps_per_cycle]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from openmm_agbnp_jax.io.dms import load_dms
    from openmm_agbnp_jax.md.simulation import Simulation
    from openmm_agbnp_jax.parallel.remd import (
        TemperatureREMD, geometric_ladder)

    ncycles = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    spc = int(sys.argv[2]) if len(sys.argv) > 2 else 250

    here = os.path.dirname(os.path.abspath(__file__))
    dms = load_dms(os.path.join(here, "..", "benchmarks", "data",
                                "trpcage_agbnp1.dms"))
    sim = Simulation(dms, version=1)
    sim.set_velocities_to_temperature(300.0)

    ladder = geometric_ladder(300.0, 450.0, 8)
    print("ladder (K):", np.round(ladder, 1))
    remd = TemperatureREMD(sim, ladder)
    res = remd.sample(ncycles=ncycles, steps_per_cycle=spc,
                      neighbor_every=40, jitter=1e-3)

    print(f"{ncycles} cycles x {spc} steps:",
          round(res["ns_day_per_replica"], 2), "ns/day per replica,",
          round(res["ns_day_per_replica"] * len(ladder), 1),
          "ns/day aggregate")
    print("adjacent-pair acceptance:", np.round(res["pair_acceptance"], 2))
    print("rung of each replica per cycle:")
    for c, row in enumerate(res["rung"]):
        print(f"  cycle {c}: {row}")


if __name__ == "__main__":
    main()
