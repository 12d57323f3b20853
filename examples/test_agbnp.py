"""Install smoke test: minimize -> Langevin equilibration -> Verlet
energy-conservation check on trp-cage with AGBNP1 implicit solvent.

The equivalent of the reference's documented install test
(reference example/test_agbnp.py: DesmondDMSFile + createSystem(OPLS=True,
implicitSolvent='AGBNP'), minimizeEnergy, 10000 Langevin steps at 0.5 fs /
300 K, then 1000 Verlet steps at 1 fs watching total-energy drift;
README.md:69-78).  Runs on whatever jax.devices() provides.

Usage:  python examples/test_agbnp.py [system]        (default trpcage_agbnp1)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from openmm_agbnp_jax.utils.compile_cache import enable_compile_cache


def main(system=None):
    import jax.numpy as jnp

    from openmm_agbnp_jax.io.dms import load_dms
    from openmm_agbnp_jax.md.minimize import fire_minimize
    from openmm_agbnp_jax.md.simulation import Simulation

    enable_compile_cache()
    # step counts overridable so the CI smoke test can run this exact code
    # path in seconds (tests/test_example.py)
    n_lang = int(os.environ.get("AGBNP_TEST_LANGEVIN_STEPS", "10000"))
    n_verlet = int(os.environ.get("AGBNP_TEST_VERLET_STEPS", "1000"))
    n_min = int(os.environ.get("AGBNP_TEST_MINIMIZE_ITERS", "200"))

    if system is None:
        system = sys.argv[1] if len(sys.argv) > 1 else "trpcage_agbnp1"
    here = os.path.dirname(os.path.abspath(__file__))
    dms = load_dms(os.path.join(here, "..", "benchmarks", "data",
                                f"{system}.dms"))
    platform = jax.devices()[0].platform
    dtype = np.float32 if platform != "cpu" else np.float64
    print(f"Started at: {time.asctime()}  (platform {platform}, "
          f"{dms.n} atoms)")

    sim = Simulation(dms, version=1, cutoff=None, dtype=dtype, skin=0.25)
    fn = sim.force_fn()
    fn_jit = jax.jit(fn)
    e0 = fn_jit(sim.positions)[0]
    print(f"Initial potential energy: {float(e0):.3f} kJ/mol")

    print("Minimization/equilibration ...")
    pos, etrace = fire_minimize(fn, sim.positions, maxiter=n_min)
    print(f"Minimized energy: {float(etrace[-1]):.3f} kJ/mol")

    run = sim.make_langevin_runner(dt=0.0005, temperature=300.0, friction=1.0,
                                  neighbor_every=20)
    key = jax.random.PRNGKey(0)
    vel = jnp.zeros_like(pos)
    t0 = time.perf_counter()
    pos, vel, key, energies, (counts, nbmax, *_rest) = run(pos, vel, key,
                                                           n_lang)
    jax.block_until_ready(pos)
    lang_s = time.perf_counter() - t0
    print(f"Langevin {n_lang} x 0.5 fs: {lang_s:.1f} s "
          f"({n_lang * 0.0005e-3 / lang_s * 86400:.2f} ns/day), "
          f"final E_pot {float(energies[-1]):.2f} kJ/mol")

    print("Test energy conservation ...")
    vrun = sim.make_verlet_runner(dt=0.001)
    pos2, vel2, pe, ke = vrun(pos, vel, n_verlet)
    jax.block_until_ready(pos2)
    etot = np.asarray(pe) + np.asarray(ke)
    drift = float(etot[-1] - etot[0])
    drift_rate = drift / (n_verlet * 0.001)  # kJ/mol per ps
    print(f"Total-energy drift over 1 ps Verlet: {drift:+.4f} kJ/mol "
          f"({drift_rate:+.4f} kJ/mol/ps)")
    tol = float(os.environ.get("AGBNP_TEST_DRIFT_TOL", "5.0"))
    ok = abs(drift_rate) < tol
    print("PASS" if ok else "FAIL (drift too large)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
