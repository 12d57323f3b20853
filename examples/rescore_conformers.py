"""Batched conformer rescoring on trp-cage: score a pose ensemble in one
vmapped AGBNP evaluation.

The reference plugin scores one conformation per Context evaluation
(openmmapi/src/AGBNPForceImpl.cpp:32-36), so rescoring B poses costs B
serial GPU round trips.  Here the whole batch is one jit executable on the
device — the docking/rescoring workload AGBNP was designed for (see the
AGBNP/BEDAM literature cited in the reference README).

Usage:  python examples/rescore_conformers.py [nposes] [batch_reps]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from openmm_agbnp_jax import AGBNPForce, ConformerScorer
    from openmm_agbnp_jax.io.dms import load_dms

    nposes = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 5

    here = os.path.dirname(os.path.abspath(__file__))
    dms = load_dms(os.path.join(here, "..", "benchmarks", "data",
                                "trpcage_agbnp1.dms"))
    n = len(dms.positions)

    force = AGBNPForce()
    force.setVersion(1)
    for i in range(n):
        force.addParticle(dms.agbnp_radius[i], dms.agbnp_gamma[i],
                          dms.agbnp_alpha[i], dms.charges[i],
                          bool(dms.ishydrogen[i]))

    # a stand-in pose ensemble: independently perturbed copies of the
    # crystal conformation (real use: docking poses / MD snapshots)
    rng = np.random.default_rng(0)
    poses = dms.positions[None] + 0.004 * rng.standard_normal(
        (nposes, n, 3))

    scorer = ConformerScorer(force, dms.positions, dtype=np.float32)

    t0 = time.time()
    res = scorer.score(poses)
    compile_s = time.time() - t0

    t0 = time.time()
    for _ in range(reps):
        res = scorer.score(poses)
    per_batch = (time.time() - t0) / reps

    e = res["energy"]
    order = np.argsort(e)
    print(f"system: trp-cage ({n} atoms), {nposes} poses")
    print(f"first call (incl. compile): {compile_s:.2f} s")
    print(f"steady state: {per_batch * 1e3:.1f} ms/batch = "
          f"{nposes / per_batch:.0f} poses/s")
    print(f"best pose: #{order[0]} at {e[order[0]]:.2f} kJ/mol; "
          f"spread {e.max() - e.min():.2f} kJ/mol")
    print("top 5:", ", ".join(f"#{i} {e[i]:.2f}" for i in order[:5]))


if __name__ == "__main__":
    main()
