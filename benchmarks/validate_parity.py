"""Correctness-config validation harness (BASELINE configs 1-2, 4).

Runs the golden-anchor checks and cross-precision/device parity on the
shipped systems:
  * 264-atom fixture: GVolSA 872.514 / AGBNP1 -2476.66 golden anchors
  * trpcage / 1li2 / rnaseh / 1dwc / 2clr: float32 (device) vs float64 (CPU)
    relative force error — the deployment-precision analogue of the
    reference's Single-vs-Double platform tests
    (platforms/opencl/tests/CMakeLists.txt:18-20).

Usage: python benchmarks/validate_parity.py [--mode cpu|device] [--systems ...]
Writes one JSON line per system; run with --mode cpu first (float64
references are cached to .npy), then --mode device.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".parity_cache")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["cpu", "device"], default="cpu")
    ap.add_argument("--systems", nargs="*",
                    default=["trpcage_agbnp1", "1li2_agbnp1",
                             "rnaseh_agbnp1", "1dwc_agbnp1", "2clr_agbnp1"])
    args = ap.parse_args()

    import jax

    if args.mode == "cpu":
        jax.config.update("jax_platforms", "cpu")
    # x64 on: float64 references on CPU, float64 accumulators (mixed
    # precision) on device
    jax.config.update("jax_enable_x64", True)
    from openmm_agbnp_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np

    from openmm_agbnp_jax.io.dms import load_dms
    from openmm_agbnp_jax.models.agbnp_jax import AGBNPModel
    from openmm_agbnp_jax.models.oracle import AGBNPParams

    os.makedirs(CACHE, exist_ok=True)
    dtype = np.float64 if args.mode == "cpu" else np.float32

    if args.mode == "cpu":
        # golden anchors through the fast path
        from openmm_agbnp_jax.io.gaussvol_dat import load_gaussvol_dat

        pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(
            os.path.join(os.path.dirname(HERE), "tests", "fixtures",
                         "gaussvol.dat"))
        p = AGBNPParams(radius=radius, gamma=gamma, alpha=alpha,
                        charge=charge, ishydrogen=ish)
        for version, anchor in ((0, 872.514), (1, -2476.66)):
            m = AGBNPModel(p, version=version, dtype=np.float64,
                           positions=pos)
            e, _ = m.energy_forces(pos)
            ok = abs(float(e) - anchor) < 0.01
            print(json.dumps(dict(check=f"golden_v{version}",
                                  energy=round(float(e), 4), anchor=anchor,
                                  ok=bool(ok))), flush=True)

    for name in args.systems:
        dms = load_dms(os.path.join(HERE, "data", f"{name}.dms"))
        p = AGBNPParams(radius=dms.agbnp_radius, gamma=dms.agbnp_gamma,
                        alpha=dms.agbnp_alpha, charge=dms.charges,
                        ishydrogen=dms.ishydrogen)
        m = AGBNPModel(p, version=1, dtype=dtype, positions=dms.positions,
                       mixed=(args.mode == "device"))
        for _ in range(6):
            e, f, out = m.energy_forces(dms.positions, with_details=True)
            if not m.check_and_grow(out["diag"]):
                break
        e = float(e)
        f = np.asarray(f, dtype=np.float64)
        ref_path = os.path.join(CACHE, f"{name}_f64.npz")
        rec = dict(system=name, natoms=int(dms.n), mode=args.mode,
                   energy=round(e, 6))
        if args.mode == "cpu":
            np.savez(ref_path, e=e, f=f)
        elif os.path.exists(ref_path):
            ref = np.load(ref_path)
            scale = np.abs(ref["f"]).max()
            rec["force_rel_err"] = float(np.abs(f - ref["f"]).max() / scale)
            rec["energy_rel_err"] = float(abs(e - float(ref["e"]))
                                          / abs(float(ref["e"])))
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
