"""Multi-device single-system MD example.

Runs trp-cage AGBNP1 Langevin MD with every step's pair phases and
fixed-topology overlap-tree passes sharded over an "atoms" device mesh
(`Simulation.make_langevin_runner(mesh=...)`;
`parallel/sharding.py::sharded_energy_forces`).  The reference plugin is
strictly single-device (multiple OpenCL contexts rejected,
reference OpenCLAGBNPKernels.cpp:410-412); here XLA inserts the
all_gather/psum_scatter/psum collectives between the devices.

It runs on the first N_DEVICES devices JAX has and never picks a platform
itself.  To rehearse on the CPU, choose it from outside:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python examples/multichip_md.py [nsteps]

Usage: python examples/multichip_md.py [nsteps]   (f32, 4 devices)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from openmm_agbnp_jax.io.dms import load_dms
from openmm_agbnp_jax.md.simulation import Simulation
from openmm_agbnp_jax.parallel.sharding import atom_mesh

N_DEVICES = 4


def main():
    nsteps = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    here = os.path.dirname(os.path.abspath(__file__))
    dms = load_dms(os.path.join(here, "..", "benchmarks", "data",
                                "trpcage_agbnp1.dms"))
    sim = Simulation(dms, version=1, dtype=np.float32)

    mesh = atom_mesh(N_DEVICES)
    print(f"devices: {len(mesh.devices.ravel())} x "
          f"{mesh.devices.ravel()[0].platform}")
    # a window length that divides nsteps keeps this to ONE compiled
    # executable (a remainder window would compile a second one)
    ne = 10 if nsteps % 10 == 0 else (nsteps if nsteps <= 10 else
                                      next(w for w in range(10, 0, -1)
                                           if nsteps % w == 0))
    run = sim.make_langevin_runner(dt=0.001, temperature=300.0,
                                   neighbor_every=ne, mesh=mesh)
    key = jax.random.PRNGKey(0)
    pos, vel, key, energies, (counts, nbmax, sibs, *_) = run(
        sim.positions, sim.velocities, key, nsteps)
    energies = np.asarray(energies)
    assert np.isfinite(energies).all()
    assert not sim._check_overflow(np.asarray(counts), nbmax, sibs)
    print(f"{nsteps} steps sharded over {N_DEVICES} devices; "
          f"E[0]={energies[0]:.2f} E[-1]={energies[-1]:.2f} kJ/mol")


if __name__ == "__main__":
    main()
