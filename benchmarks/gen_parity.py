"""Parity artifact: native C++ f64 vs JAX f64 (CPU) vs JAX f32 (device).

Generates benchmarks/parity_rNN.json with, for every shipped .dms system
and both descreening horizons (the Reference-platform 2 nm LUT horizon and
the OpenCL-backend cutoff horizon):

  * native:  the independent C++ AGBNP1 engine (runtime/gaussvol_native.cpp,
    mirroring reference ReferenceAGBNPKernels.cpp:274-795) in float64 — the
    ground truth.  Shares no code with the JAX path.
  * jax_f64: the JAX pipeline at float64 on CPU (small systems — CPU compile
    cost bounds the big ones).  Run in a subprocess.
  * device_f32: the deployment path (the XLA pair phases) at float32 on
    the default JAX device, which must be a GPU.  Run in a subprocess: the
    parent never initializes a jax backend, so only one process at a time
    holds the card.

Reported per comparison: relative energy error and max force error relative
to the force scale.  The BASELINE criterion is rel-err <= 1e-5 vs
Reference-platform (f64) semantics for the deployment path.

Usage: python benchmarks/gen_parity.py [tag]
"""

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

SYSTEMS = ["trpcage_agbnp1", "1li2_agbnp1", "rnaseh_agbnp1", "1dwc_agbnp1",
           "2clr_agbnp1"]
JAX_F64_SYSTEMS = {"trpcage_agbnp1", "1li2_agbnp1"}
CUTOFF = 1.0


def _force_err(f, ref):
    import numpy as np

    scale = max(1.0, float(np.abs(ref).max()))
    return float(np.abs(np.asarray(f) - np.asarray(ref)).max()) / scale


def native_eval(name, horizon):
    import numpy as np

    from openmm_agbnp_jax.io.dms import load_dms
    from openmm_agbnp_jax.models.oracle import AGBNPParams
    from openmm_agbnp_jax.runtime.native import NativeAGBNP1

    dms = load_dms(os.path.join(HERE, "data", f"{name}.dms"))
    params = AGBNPParams(radius=dms.agbnp_radius, gamma=dms.agbnp_gamma,
                         alpha=dms.agbnp_alpha, charge=dms.charges,
                         ishydrogen=dms.ishydrogen)
    nat = NativeAGBNP1(params)
    out = nat.energy_forces(np.asarray(dms.positions), cutoff=CUTOFF,
                            horizon=horizon)
    return params, np.asarray(dms.positions), out


def _eval_subprocess(name, horizon_mode, mode):
    """Evaluate one system in a clean subprocess.  mode "f64": forced-CPU
    x64 path; mode "device_f32": the f32 deployment path on the default
    JAX device, which must be a GPU.  Returns (energy, force) or None."""
    fp = os.path.join(tempfile.gettempdir(), f"parity_f_{mode}.npy")
    if mode == "f64":
        setup = ("import jax\n"
                 "jax.config.update('jax_enable_x64', True)\n")
        model = ("m = AGBNPModel(params, version=1, dtype=np.float64, "
                 f"positions=pos, cutoff={CUTOFF}, "
                 f"descreen_horizon={horizon_mode!r})")
    else:
        setup = ("import jax\n"
                 "if jax.devices()[0].platform != 'gpu':\n"
                 "    print('NOGPU'); raise SystemExit\n")
        model = ("m = AGBNPModel(params, version=1, dtype=np.float32, "
                 f"positions=pos, cutoff={CUTOFF}, "
                 f"descreen_horizon={horizon_mode!r})")
    code = f"""
import sys, os
sys.path.insert(0, {ROOT!r})
import numpy as np
{setup}
from openmm_agbnp_jax.utils.compile_cache import enable_compile_cache
enable_compile_cache()
from openmm_agbnp_jax.io.dms import load_dms
from openmm_agbnp_jax.models.agbnp_jax import AGBNPModel
from openmm_agbnp_jax.models.oracle import AGBNPParams
dms = load_dms(os.path.join({HERE!r}, "data", "{name}.dms"))
params = AGBNPParams(radius=dms.agbnp_radius, gamma=dms.agbnp_gamma,
                     alpha=dms.agbnp_alpha, charge=dms.charges,
                     ishydrogen=dms.ishydrogen)
pos = np.asarray(dms.positions)
{model}
e, f = m.energy_forces(pos)
np.save({fp!r}, np.asarray(f))
print("E", float(e))
"""
    env = dict(os.environ)
    if mode == "f64":
        env["JAX_PLATFORMS"] = "cpu"
    else:
        env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=2400, env=env)
    outlines = [ln for ln in r.stdout.splitlines() if ln]
    if (r.returncode != 0 or not outlines
            or not outlines[-1].startswith("E ")):
        return None
    import numpy as np

    e = float(outlines[-1].split()[1])
    f = np.load(fp)
    return e, f


def main():
    tag = sys.argv[1] if len(sys.argv) > 1 else "gpu"
    report = {"cutoff_nm": CUTOFF, "criterion":
              "deployment (device_f32) rel force err vs native f64 <= 1e-5"}

    for name in SYSTEMS:
        report[name] = {}
        for hname, horizon in (("lut2nm", None), ("cutoff", CUTOFF)):
            params, pos, nat = native_eval(name, horizon)
            entry = {"natoms": int(params.n),
                     "native_energy": nat["energy"]}
            hz = "cutoff" if hname == "cutoff" else None
            if name in JAX_F64_SYSTEMS:
                r64 = _eval_subprocess(name, hz, "f64")
                if r64 is not None:
                    e64, f64 = r64
                    entry["jax_f64_energy"] = e64
                    entry["jax_f64_vs_native_rel_e"] = (
                        abs(e64 - nat["energy"]) / abs(nat["energy"]))
                    entry["jax_f64_vs_native_force"] = _force_err(
                        f64, nat["force"])
            acc = _eval_subprocess(name, hz, "device_f32")
            if acc is not None:
                e32, f32 = acc
                entry["device_f32_energy"] = e32
                entry["device_f32_vs_native_rel_e"] = (
                    abs(e32 - nat["energy"]) / abs(nat["energy"]))
                entry["device_f32_vs_native_force"] = _force_err(
                    f32, nat["force"])
            else:
                entry["device_f32"] = "no GPU available"
            report[name][hname] = entry
            print(name, hname, json.dumps(entry), flush=True)

    out = os.path.join(HERE, f"parity_{tag}.json")
    with open(out, "w") as fh:
        json.dump(report, fh, indent=1)
    print("wrote", out)


if __name__ == "__main__":
    main()
