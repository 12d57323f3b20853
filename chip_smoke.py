"""Smoke run of the AGBNP implicit-solvent MD path on NVIDIA GPUs.

    python chip_smoke.py            # one GPU: every default phase
    python chip_smoke.py --multi    # four GPUs: the sharded paths only

Default phases, one process on one card, each printed with its seconds and
compile seconds beside the card's name and power limit:

  1. card identity (device_kind; nvidia-smi name and power limit), then
     every program of the phases below compiled concurrently into the
     persistent compile cache (each program's compile seconds printed);
  2. golden anchors through AGBNPForce/Context on the 264-atom reference
     fixture: v0 E_cav 872.514 and v1 E -2476.66 in f64 (0.01 absolute,
     the printed digits of the reference golden files) and f32 (0.5
     absolute, the spread of reordered f32 pair sums), plus the v1
     displacement check 0.0874992 / 0.0886249 in f64;
  3. parity of 1li2 (1,310 atoms) and 2clr (5,983 atoms) at
     CutoffNonPeriodic 1 nm, with the cutoff and the 2 nm LUT descreening
     horizons, against the independent native C++ f64 engine: f32 within
     1e-5 relative energy and 1e-5 max|dF|/max|F| (sums are reordered and
     scatter-adds run as atomics; every matmul on the path asks for
     Precision.HIGHEST, so no TF32 enters), f64 within 1e-9;
  4. 1,000 steps of Simulation.run_md (1 fs Langevin, 300 K, cutoff 1 nm,
     neighbor_every=40, f32) on 1li2 and 2clr: finite energies, no
     unresolved overflow, mean temperature in 250-350 K; a smoke timing,
     not a benchmark; memory analysis of the step program and peak bytes;
     and one 200-step segment run twice from the same state and key,
     reporting whether the two results are bitwise equal;
  5. T-REMD with 4 trp-cage replicas on one card for 2 exchange cycles.

--multi runs __graft_entry__.multichip_checks on 4 cards: atom-sharded
energy/forces on 2clr against the dense single-card result, 50 steps of
atom-sharded MD, and the replica-ensemble step and T-REMD on a 4-card
replica mesh against the vmapped single-card step.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}},
printed only when every phase passed.  The script exits non-zero, printing
no such line, when the default device is not a GPU or any phase failed.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "benchmarks", "data")
FIXTURE = os.path.join(HERE, "tests", "fixtures", "gaussvol.dat")

GOLDEN_V0 = 872.514
GOLDEN_V1 = -2476.66
GOLDEN_DE = 0.0874992
GOLDEN_GRAD = 0.0886249
GOLDEN_TOL = {"f64": 0.01, "f32": 0.5}
PARITY_TOL = {"f32": 1e-5, "f64": 1e-9}
MD_SYSTEMS = ("1li2_agbnp1", "2clr_agbnp1")
HORIZONS = ("cutoff", None)  # descreening horizon: the cutoff, or 2 nm LUT
MD_STEPS = 1000
SEGMENT = 200


def card_identity() -> str:
    """nvidia-smi's name and power limit of every card, from a child
    process that does not touch JAX."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=120, check=True)
    return "; ".join(ln.strip() for ln in r.stdout.splitlines() if ln)


def require_gpu(jax):
    """The default device, which must be a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: the default JAX device is "
                         f"{dev.platform!r}, not a GPU; nothing was run")
    return dev


class Phases:
    """Runs named phases, keeps going after a failure, and reports each
    with its wall seconds beside the card line."""

    def __init__(self, card: str):
        self.card = card
        self.failed = []

    def run(self, name, fn, *args):
        print(f"== {name} [{self.card}]", flush=True)
        t0 = time.perf_counter()
        try:
            fn(*args)
            status = "ok"
        except Exception as exc:  # report every phase, fail at the end
            traceback.print_exc()
            self.failed.append(name)
            status = f"FAILED: {type(exc).__name__}: {exc}"
        print(f"== {name}: {status} ({time.perf_counter() - t0:.1f} s)",
              flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def timed(fn, *args):
    """(result, seconds) of fn(*args) with the result on the host."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# -- phase 2 ---------------------------------------------------------------

def fixture_params():
    from openmm_agbnp_jax.io.gaussvol_dat import load_gaussvol_dat
    from openmm_agbnp_jax.models.oracle import AGBNPParams

    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(FIXTURE)
    return AGBNPParams(radius=radius, gamma=gamma, alpha=alpha,
                       charge=charge, ishydrogen=ish), pos


def dtype_of(prec: str):
    import numpy as np

    return np.float64 if prec == "f64" else np.float32


def golden_context(version: int, prec: str):
    """A Context bound to the fixture's AGBNPForce, positions set."""
    from openmm_agbnp_jax import AGBNPForce, Context

    params, pos = fixture_params()
    force = AGBNPForce()
    force.setVersion(version)
    for i in range(params.n):
        force.addParticle(params.radius[i], params.gamma[i],
                          params.alpha[i], params.charge[i],
                          bool(params.ishydrogen[i]))
    ctx = Context(force, dtype=dtype_of(prec))
    ctx.setPositions(pos)
    return ctx, pos


def golden_anchors(prec: str):
    """v0/v1 golden energies through AGBNPForce/Context (and, in f64, the
    reference's displacement check)."""
    import numpy as np

    tol = GOLDEN_TOL[prec]
    for version, golden in ((0, GOLDEN_V0), (1, GOLDEN_V1)):
        ctx, pos = golden_context(version, prec)
        (e, f), first = timed(ctx.getEnergyForces)
        (e, f), steady = timed(ctx.getEnergyForces)
        e = float(e)
        print(f"  v{version} {prec}: E {e:.6f} (golden {golden}, "
              f"|dE| {abs(e - golden):.3g} <= {tol}); "
              f"compile ~{first - steady:.1f} s, eval {steady * 1e3:.2f} ms",
              flush=True)
        check(abs(e - golden) <= tol, f"v{version} {prec} golden missed")
        check(np.isfinite(np.asarray(f)).all(), "non-finite forces")
        if version == 1 and prec == "f64":
            pos2 = np.array(pos, copy=True)
            pos2[121, 1] += 0.002
            ctx.setPositions(pos2)
            e2, _ = ctx.getEnergyForces()
            de = float(e2) - e
            grad = -float(np.asarray(f)[121, 1]) * 0.002
            print(f"  v1 f64 displacement: dE {de:.7f} (golden "
                  f"{GOLDEN_DE}), gradient prediction {grad:.7f} (golden "
                  f"{GOLDEN_GRAD})", flush=True)
            check(abs(de - GOLDEN_DE) <= 1e-6, "displacement dE missed")
            check(abs(grad - GOLDEN_GRAD) <= 1e-6,
                  "displacement gradient missed")


# -- phase 3 ---------------------------------------------------------------

def dms_params(name):
    from openmm_agbnp_jax.io.dms import load_dms
    from openmm_agbnp_jax.models.oracle import AGBNPParams

    dms = load_dms(os.path.join(DATA, f"{name}.dms"))
    params = AGBNPParams(radius=dms.agbnp_radius, gamma=dms.agbnp_gamma,
                         alpha=dms.agbnp_alpha, charge=dms.charges,
                         ishydrogen=dms.ishydrogen)
    return dms, params


def parity_model(name: str, prec: str, horizon, cutoff: float = 1.0):
    """AGBNPModel of a shipped system at CutoffNonPeriodic `cutoff`."""
    import numpy as np

    from openmm_agbnp_jax.models.agbnp_jax import AGBNPModel

    dms, params = dms_params(name)
    pos = np.asarray(dms.positions)
    return AGBNPModel(params, version=1, cutoff=cutoff, dtype=dtype_of(prec),
                      positions=pos, descreen_horizon=horizon), params, pos


def parity(name: str, prec: str, cutoff: float = 1.0):
    """AGBNPModel on the card against the native f64 engine, for the
    cutoff and the 2 nm LUT descreening horizons."""
    import numpy as np

    from openmm_agbnp_jax.runtime.native import NativeAGBNP1

    native = None
    tol = PARITY_TOL[prec]
    for horizon in HORIZONS:
        m, params, pos = parity_model(name, prec, horizon, cutoff)
        native = native or NativeAGBNP1(params)
        t0 = time.perf_counter()
        ref = native.energy_forces(pos, cutoff=cutoff,
                                   horizon=cutoff if horizon else None)
        t_native = time.perf_counter() - t0
        (e, f), first = timed(m.energy_forces, pos)
        (e, f), steady = timed(m.energy_forces, pos)
        f = np.asarray(f, np.float64)
        rel_e = abs(float(e) - ref["energy"]) / abs(ref["energy"])
        rel_f = (float(np.abs(f - ref["force"]).max())
                 / float(np.abs(ref["force"]).max()))
        label = "cutoff 1 nm" if horizon else "LUT 2 nm"
        print(f"  {name} N={params.n} {prec} horizon {label}: E {float(e):.6f}"
              f" native {ref['energy']:.6f}; rel dE {rel_e:.3g}, "
              f"max|dF|/max|F| {rel_f:.3g} (<= {tol}); compile "
              f"~{first - steady:.1f} s, eval {steady * 1e3:.2f} ms, "
              f"native {t_native:.2f} s", flush=True)
        check(rel_e <= tol and rel_f <= tol,
              f"{name} {prec} {label} parity missed")


# -- phase 4 ---------------------------------------------------------------

def md_sim(name: str):
    """The reference-protocol f32 Simulation of a shipped system, with
    Maxwell-Boltzmann velocities at 300 K."""
    import numpy as np

    from openmm_agbnp_jax.md.simulation import Simulation

    dms, _ = dms_params(name)
    sim = Simulation(dms, version=1, cutoff=1.0, dtype=np.float32,
                     skin=0.25, descreen_horizon="cutoff")
    sim.set_velocities_to_temperature(300.0, seed=1)
    return sim


def md_runner(sim):
    """The Langevin runner run_md builds for the reference protocol."""
    return sim.make_langevin_runner(dt=0.001, temperature=300.0,
                                    friction=1.0, neighbor_every=40)

def md(name: str, nsteps: int = MD_STEPS, segment: int = SEGMENT):
    """Simulation.run_md at the reference protocol, then the determinism
    probe on one segment."""
    import jax
    import numpy as np

    from openmm_agbnp_jax.md.integrators import temperature

    sim = md_sim(name)
    stamps, temps = [], []

    def reporter(step, pos, vel):
        stamps.append(time.perf_counter())
        temps.append(float(temperature(vel, sim.masses)))

    t0 = time.perf_counter()
    res = sim.run_md(nsteps, dt=0.001, temperature=300.0, friction=1.0,
                     neighbor_every=40, report_interval=segment,
                     reporter=reporter, seed=0)
    seg = np.diff([t0] + stamps)
    steady = seg[1:] if len(seg) > 1 else seg
    ms_step = 1e3 * float(np.mean(steady)) / segment
    mean_t = float(np.mean(temps))
    e = np.asarray(res["energies"])
    print(f"  {name} N={sim.masses.shape[0]} f32 run_md {nsteps} steps: "
          f"regrows {res['regrows']}, E[0] {e[0]:.3f} E[-1] {e[-1]:.3f} "
          f"kJ/mol, mean T {mean_t:.1f} K over {len(temps)} samples; "
          f"first segment {seg[0]:.1f} s (compile included), smoke timing "
          f"(not a benchmark) {ms_step:.3f} ms/step", flush=True)
    check(np.isfinite(e).all(), "non-finite MD energies")
    check(not res["overflow"], "unresolved capacity overflow")
    check(250.0 <= mean_t <= 350.0, f"mean temperature {mean_t:.1f} K")

    run = md_runner(sim)
    pos0, vel0 = sim.positions, sim.velocities
    key = jax.random.PRNGKey(7)
    t0 = time.perf_counter()
    compiled = run.lower(pos0, vel0, key, segment).compile()
    t_lower = time.perf_counter() - t0
    print(f"  {name} step program ({segment // 40} windows x 40 steps) "
          f"memory_analysis (lower+compile {t_lower:.1f} s): "
          f"{compiled.memory_analysis()}", flush=True)
    a = jax.block_until_ready(run(pos0, vel0, key, segment))
    b = jax.block_until_ready(run(pos0, vel0, key, segment))
    same = all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a[:4], b[:4]))
    dpos = float(np.abs(np.asarray(a[0]) - np.asarray(b[0])).max())
    de = float(np.abs(np.asarray(a[3]) - np.asarray(b[3])).max())
    print(f"  {name} determinism: one {segment}-step segment twice from the "
          f"same state and key: bitwise equal {same}; max |dpos| {dpos:.3g} "
          f"nm, max |dE| {de:.3g} kJ/mol", flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  {name} peak_bytes_in_use {stats.get('peak_bytes_in_use')}",
          flush=True)


# -- phase 5 ---------------------------------------------------------------

def remd_cycles(n_replicas: int = 4, ncycles: int = 2):
    """ncycles T-REMD exchange cycles of trp-cage replicas on one card."""
    import numpy as np

    from openmm_agbnp_jax.md.simulation import Simulation
    from openmm_agbnp_jax.parallel.remd import (
        TemperatureREMD, geometric_ladder)
    from openmm_agbnp_jax.parallel.sharding import replica_mesh

    dms, _ = dms_params("trpcage_agbnp1")
    sim = Simulation(dms, version=1, cutoff=1.0, dtype=np.float32,
                     skin=0.25, descreen_horizon="cutoff")
    remd = TemperatureREMD(sim, geometric_ladder(300.0, 450.0, n_replicas),
                           mesh=replica_mesh(1))
    states, xkey = remd.initial_states(jitter=1e-4)
    run = remd.make_runner(dt=0.001, steps_per_cycle=20, neighbor_every=20,
                           scan_unroll=1)
    return timed(run, states, xkey, ncycles)


def remd(n_replicas: int = 4, ncycles: int = 2):
    """T-REMD with trp-cage replicas on one card: rungs stay a permutation
    of the ladder and the energies are finite."""
    import numpy as np

    (states, xkey, out), seconds = remd_cycles(n_replicas, ncycles)
    rungs = np.asarray(out["rung"])
    print(f"  T-REMD {n_replicas} trp-cage replicas x {ncycles} cycles on one "
          f"card in {seconds:.1f} s (compile included): rungs "
          f"{rungs.tolist()}, U {np.asarray(out['U']).tolist()}", flush=True)
    for c in range(rungs.shape[0]):
        check(sorted(rungs[c].tolist()) == list(range(n_replicas)),
              f"cycle {c} rungs are not a permutation: {rungs[c]}")
    check(np.isfinite(np.asarray(out["U"])).all(), "non-finite U")
    check(np.isfinite(np.asarray(out["energies"])).all(),
          "non-finite energies")


# -- the compile phase -----------------------------------------------------

def precompile():
    """Compile every program of the phases below concurrently, one thread
    each, into the persistent compile cache the phases then load from.
    Prints each program's compile seconds."""
    import jax
    import jax.numpy as jnp

    from openmm_agbnp_jax.runtime import native
    from openmm_agbnp_jax.utils.compile_cache import run_concurrently

    native.available()  # build the native library once, before the threads

    def in_prec(prec, fn):
        def job():
            with jax.enable_x64(prec == "f64"):
                return fn()
        return job

    def model_program(m, pos):
        return m._jit_ef.lower(m.arrays, jnp.asarray(pos, m.dtype)).compile()

    jobs = {}
    for prec in ("f32", "f64"):
        for version in (0, 1):
            jobs[f"golden v{version} {prec}"] = in_prec(
                prec, lambda v=version, p=prec: model_program(
                    golden_context(v, p)[0]._model, fixture_params()[1]))
        for name in MD_SYSTEMS:
            for horizon in HORIZONS:
                jobs[f"parity {name} {prec} horizon {horizon}"] = in_prec(
                    prec, lambda n=name, p=prec, h=horizon: model_program(
                        *parity_model(n, p, h)[::2]))
    for name in MD_SYSTEMS:
        def md_program(name=name):
            sim = md_sim(name)
            return md_runner(sim).lower(sim.positions, sim.velocities,
                                        jax.random.PRNGKey(0),
                                        SEGMENT).compile()
        jobs[f"md {name} window program"] = md_program
    jobs["t-remd runner (compile + 2 cycles)"] = remd_cycles
    for label, (_, seconds) in run_concurrently(jobs).items():
        print(f"  {label}: {seconds:.1f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded paths, on 4 GPUs")
    args = ap.parse_args(argv)

    import jax

    dev = require_gpu(jax)
    sys.path.insert(0, HERE)
    from openmm_agbnp_jax.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    card = card_identity()
    print(f"device_kind {dev.device_kind}; {len(jax.devices())} device(s); "
          f"jax {jax.__version__}; compile cache {cache}", flush=True)
    print(f"card (nvidia-smi name, power.limit): {card}", flush=True)
    phases = Phases(card)

    if args.multi:
        import __graft_entry__ as graft

        if len(jax.devices()) < 4:
            raise SystemExit(f"--multi needs 4 GPUs, JAX has "
                             f"{len(jax.devices())}")
        phases.run("multi: sharded paths on 4 cards vs one card",
                   graft.multichip_checks, 4)
    else:
        phases.run("compile (all programs, concurrently)", precompile)
        phases.run("golden f32", golden_anchors, "f32")
        with jax.enable_x64(True):
            phases.run("golden f64", golden_anchors, "f64")
        for name in MD_SYSTEMS:
            phases.run(f"parity {name} f32 vs native f64", parity, name,
                       "f32")
            with jax.enable_x64(True):
                phases.run(f"parity {name} f64 vs native f64", parity, name,
                           "f64")
        for name in MD_SYSTEMS:
            phases.run(f"md {name}", md, name)
        phases.run("t-remd", remd)

    print(f"card (nvidia-smi name, power.limit): {card}", flush=True)
    if phases.failed:
        print(f"chip_smoke: {len(phases.failed)} phase(s) failed: "
              f"{phases.failed}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
