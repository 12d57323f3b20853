"""AGBNP1 MD throughput on one NVIDIA GPU: t4lysozyme (1li2) and trp-cage.

Reference protocol: 10,000 Langevin steps at 1 fs / 300 K with wall-clock
timing (reference example/t4lysozyme_benchmark.py:21-34, system
1li2_agbnp1.dms, CutoffNonPeriodic 1 nm).  Here the same system runs with
the full AGBNP1 + OPLS force field fused under jit/lax.scan on the default
JAX device, which must be a GPU: the script exits non-zero on any other
platform and never falls back.

Prints ONE JSON line naming the device (platform, device_kind, count) with
ns/day per leg and the overflow/regrow accounting of the run each number
came from.  BENCH_STEPS, BENCH_SYSTEM and BENCH_DESCREEN_HORIZON
(cutoff | lut | <nm>) adjust the protocol.

vs_baseline: the reference repo publishes no numbers (BASELINE.md); the
baseline constant below is the wall-clock-derived estimate for the
reference's OpenCL backend on a mid-2017 GPU for this 1310-atom system at
1 fs (~10k steps in ~170 s -> ~5 ns/day).  It is an assumption, recorded
here explicitly, not a measured number; see BASELINE.md "Quantitative
baseline bracket".
"""

import json
import os
import sys

BASELINE_NS_DAY = 5.0

# the reference protocol is 10,000 steps wall-clock
# (example/t4lysozyme_benchmark.py:22-31)
NSTEPS = int(os.environ.get("BENCH_STEPS", "10000"))
SYSTEM = os.environ.get("BENCH_SYSTEM", "1li2_agbnp1")
# extra legs riding the same JSON line: trp-cage (the other named BASELINE
# metric) and the parity-anchored 2 nm LUT horizon run
EXTRA = os.environ.get("BENCH_EXTRA", "1") == "1"


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)

    import jax
    import numpy as np

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: the default JAX device is "
                         f"{dev.platform!r}, not a GPU; nothing was measured")

    from openmm_agbnp_jax.io.dms import load_dms
    from openmm_agbnp_jax.md.simulation import Simulation
    from openmm_agbnp_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    # CutoffNonPeriodic 1 nm: the reference benchmark configuration for this
    # system (example/t4lysozyme_benchmark.py:14-16).  In cutoff mode the
    # reference's OpenCL backend truncates its Born/descreening sweeps at
    # the cutoff too (r2 < CUTOFF_SQUARED over the cutoff neighbor list,
    # OpenCLAGBNPKernels.cpp:2258 / AGBNPBornRadii.cl:268), so matching
    # that is the apples-to-apples configuration; set
    # BENCH_DESCREEN_HORIZON=lut for the Reference-platform 2 nm horizon.
    dh = os.environ.get("BENCH_DESCREEN_HORIZON", "cutoff")
    dh = None if dh == "lut" else ("cutoff" if dh == "cutoff" else float(dh))

    accounting = {}

    def measure(key, name, horizon, wu_every: int = 1):
        """One reference-protocol run; the overflow/regrow state of the
        run the number came from is recorded per metric (a number from an
        overflowed run must never look clean — the reference's PanicButton
        contract is overflow => forces invalid => retry,
        OpenCLAGBNPKernels.cpp:3598-3634)."""
        d = load_dms(os.path.join(here, "benchmarks", "data", f"{name}.dms"))
        sim = Simulation(d, version=1, cutoff=1.0, dtype=np.float32,
                         skin=0.25, descreen_horizon=horizon)
        r = sim.benchmark_langevin(nsteps=NSTEPS, dt=0.001,
                                   temperature=300.0, friction=1.0,
                                   neighbor_every=40, wu_every=wu_every)
        accounting[key] = {"overflow": bool(r["overflow"]),
                           "regrows": int(r.get("regrows", 0))}
        if r["overflow"]:
            return None  # tainted: retries exhausted; never report ns/day
        return round(r["ns_day"], 3)

    # headline: the WU gamma-rescan force pass as an r-RESPA impulse every
    # 4 steps (md/integrators.py::wu_impulse_langevin_block), next to the
    # strict full-force-every-step run of the reference's own protocol
    sysname = SYSTEM.split('_')[0]
    headline_key = f"ns_day_{sysname}_agbnp1_mts_wu4"
    out = {
        "metric": headline_key,
        "value": measure(headline_key, SYSTEM, dh, wu_every=4),
        "unit": "ns/day",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "protocol": (f"{NSTEPS} Langevin steps @ 1 fs / 300 K, "
                     "CutoffNonPeriodic 1 nm, f32, wall-clock "
                     "(reference example/t4lysozyme_benchmark.py:22-31); "
                     "WU force pass as r-RESPA impulse every 4 steps"),
    }
    strict_key = f"ns_day_{sysname}_agbnp1_strict"
    strict = measure(strict_key, SYSTEM, dh)
    headline = out["value"]
    # vs_baseline is the protocol-matched strict run
    out["vs_baseline"] = round((strict if strict is not None else headline)
                               / BASELINE_NS_DAY, 3)
    extra = {strict_key: strict}
    if EXTRA:
        extra["ns_day_trpcage_agbnp1"] = measure(
            "ns_day_trpcage_agbnp1", "trpcage_agbnp1", dh)
        lut_key = f"ns_day_{sysname}_agbnp1_lut_horizon"
        extra[lut_key] = measure(lut_key, SYSTEM, None)
        # 4 fs r-RESPA outer / 2 fs bonded + SHAKE/RATTLE X-H constraints
        d4 = load_dms(os.path.join(here, "benchmarks", "data",
                                   f"{SYSTEM}.dms"))
        sim4 = Simulation(d4, version=1, cutoff=1.0, dtype=np.float32,
                          skin=0.25, descreen_horizon=dh, constraints=True)
        r4 = sim4.benchmark_langevin(nsteps=max(1, NSTEPS // 4), dt=0.004,
                                     temperature=300.0, friction=1.0,
                                     neighbor_every=10, mts_inner=2)
        key4 = f"ns_day_{sysname}_mts4fs_constraints"
        accounting[key4] = {"overflow": bool(r4["overflow"]),
                            "regrows": int(r4.get("regrows", 0))}
        extra[key4] = None if r4["overflow"] else round(r4["ns_day"], 3)
        # large-system MD: the 10,240-atom synthetic bonded ball through
        # the segmented run_md loop
        synth_steps = int(os.environ.get("BENCH_SYNTH_STEPS", "400"))
        if synth_steps > 0:
            from benchmarks.synthetic_scale import run_md as synth_md
            r = synth_md(10240, nsteps=synth_steps)
            accounting["ns_day_synth10k"] = {
                "overflow": bool(r["overflow"]),
                "regrows": int(r.get("regrows", 0)),
                "windows": int(r.get("windows", 0))}
            extra["ns_day_synth10k"] = (None if r["overflow"]
                                        else round(r["ns_day"], 3))
    out["extra_metrics"] = extra
    out["overflow_accounting"] = accounting
    print(json.dumps(out))


if __name__ == "__main__":
    main()
