"""Temperature replica-exchange MD (T-REMD) over the replica mesh.

The reference plugin exists to power implicit-solvent replica-exchange
free-energy workflows (AGBNP is the Gallicchio-lab solvation model used by
their asynchronous replica-exchange pipelines), but the plugin itself is
hard single-device (one OpenCL context enforced, reference
OpenCLAGBNPKernels.cpp:412-413) and exchanges live in external host-side
schedulers.  Here the entire REMD loop — per-replica AGBNP1 dynamics AND
the Metropolis exchange moves — runs on device under one jit, with the
replica axis sharded over the device mesh (`parallel/sharding.py`):

- Replicas keep their configurations in place; *temperature rungs* are
  swapped.  Only scalars (potential energies, rung indices) cross replica
  boundaries, so an exchange moves O(R) floats between devices, never
  coordinates.
- Exchanges use the standard alternating even/odd neighbor-pair scheme
  (DEO): on cycle c, rung pairs (0,1),(2,3),... for even c, (1,2),(3,4),...
  for odd c, accepted with the Metropolis probability
  min(1, exp[(beta_i - beta_j)(U_i - U_j)]) where U_i is the potential of
  the configuration currently holding rung i.
- On acceptance the two replicas trade rungs and rescale their velocities
  by sqrt(T_new/T_old) (the canonical momentum-rescaling exchange move).

The exchange step itself is dense [R]-vector arithmetic (an inverse
permutation, one gather, one uniform draw per pair) — trivially
shardable, deterministic, and exactly unit-tested against a NumPy
reimplementation (tests/test_remd.py).
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..md.integrators import KB, langevin_middle_step
from .sharding import replica_mesh


def geometric_ladder(t_min: float, t_max: float, n: int):
    """Geometric temperature ladder — the standard spacing that gives
    roughly uniform exchange acceptance when heat capacity is flat."""
    if n == 1:
        return np.asarray([t_min])
    r = (t_max / t_min) ** (1.0 / (n - 1))
    return t_min * r ** np.arange(n)


def attempt_swaps(key, rung, U, betas, parity):
    """One even/odd neighbor-swap sweep over temperature rungs.

    rung[r]: temperature-rung index currently held by replica r (a
    permutation of 0..R-1).  U[r]: potential energy of replica r.  parity:
    0 pairs rungs (0,1),(2,3),...; 1 pairs (1,2),(3,4),...

    Returns (new_rung, accept_by_rung) where accept_by_rung[q] is True iff
    rung q took part in an accepted swap this sweep.  Pure function of its
    inputs (same key -> same decisions), replica-axis shardable.
    """
    R = rung.shape[0]
    q = jnp.arange(R)
    # partner rung under this parity; out-of-range partners are masked off
    up = (q - parity) % 2 == 0
    partner = jnp.where(up, q + 1, q - 1)
    valid = (partner >= 0) & (partner < R)
    partner_c = jnp.clip(partner, 0, R - 1)

    # replica currently holding each rung (inverse permutation), and its U
    ror = jnp.zeros(R, rung.dtype).at[rung].set(
        jnp.arange(R, dtype=rung.dtype))
    U_rung = U[ror]

    # Metropolis: symmetric in the pair (same delta and same uniform seen
    # from both sides, drawn at the pair's lower rung)
    delta = (betas - betas[partner_c]) * (U_rung - U_rung[partner_c])
    u = jax.random.uniform(key, (R,), dtype=U.dtype)
    u_pair = u[jnp.minimum(q, partner_c)]
    accept = valid & (u_pair < jnp.exp(jnp.minimum(delta, 0.0)))

    new_rung_of_rung = jnp.where(accept, partner_c, q).astype(rung.dtype)
    new_rung = new_rung_of_rung[rung]
    return new_rung, accept


class TemperatureREMD:
    """On-device T-REMD over AGBNP implicit-solvent replicas.

    sim: a md.simulation.Simulation for the system (its version/cutoff/
    constraints settings apply to every replica).  temperatures: the rung
    ladder, one replica per rung.  Replica r starts at rung r.
    """

    def __init__(self, sim, temperatures, mesh=None):
        self.sim = sim
        self.temps = np.asarray(temperatures, dtype=np.float64)
        R = self.temps.shape[0]
        if R < 1:
            raise ValueError("need at least one temperature")
        self.n_replicas = R
        if mesh is None:
            ndev = len(jax.devices())
            use = max(d for d in range(1, ndev + 1) if R % d == 0)
            mesh = replica_mesh(use)
        self.mesh = mesh
        self.rep_sharding = NamedSharding(mesh, P("replica"))
        self.scalar_sharding = NamedSharding(mesh, P())

    def initial_states(self, jitter: float = 0.0, seed: int = 0):
        """(pos[R], vel[R], key[R], rung[R]) + the exchange key."""
        R = self.n_replicas
        sim = self.sim
        pos = jnp.broadcast_to(sim.positions, (R,) + sim.positions.shape)
        if jitter > 0:
            pos = pos + jitter * jax.random.normal(
                jax.random.PRNGKey(seed + 7919), pos.shape, pos.dtype)
        vel = jnp.broadcast_to(sim.velocities, (R,) + sim.velocities.shape)
        keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(R) + seed)
        rung = jnp.arange(R, dtype=jnp.int32)
        states = (pos, vel, keys, rung)
        states = jax.tree.map(
            lambda x: jax.device_put(x, self.rep_sharding), states)
        xkey = jax.device_put(jax.random.PRNGKey(seed + 104729),
                              self.scalar_sharding)
        return states, xkey

    def make_runner(self, dt=0.001, friction=1.0, steps_per_cycle: int = 40,
                    neighbor_every: int = 40, scan_unroll: int = 4,
                    vdw_compact: bool = True, vdw_relax: float = 0.5):
        """run(states, xkey, ncycles) -> (states, xkey, out).

        out: dict with U [C, R] (potential at each exchange attempt),
        rung [C, R] (rung per replica after each cycle), accept [C, R]
        (per-rung accepted-swap indicator), energies [R, C*spc] (per-step
        potentials), and the overflow diagnostics (counts, nbmax, sibs,
        vdw_counts).

        Each cycle runs `steps_per_cycle` middle-Langevin steps per replica
        at its current rung temperature, rebuilding the neighbor list and
        overlap-tree topology every `neighbor_every` steps (clamped to the
        cycle length; cycles need not divide into windows — a short
        remainder window absorbs the rest), then attempts one even/odd
        exchange sweep.
        """
        sim = self.sim
        R = self.n_replicas
        temps = jnp.asarray(self.temps)
        betas = jnp.asarray(1.0 / (KB * self.temps))
        spc = int(steps_per_cycle)
        ne = min(int(neighbor_every), spc)
        # static window plan for one cycle: full windows + remainder
        nwin, rem = divmod(spc, ne)

        from ..ops import tree as _T

        heavy, rcut, kmax = sim.heavy_mask, sim.rcut_list, sim.kmax
        nbfn = sim.neighbor_fn
        roffset = sim.agbnp.params.roffset
        use_vdwc = (vdw_compact and sim.agbnp2 is None
                    and sim.agbnp.version in (0, 1))
        vdw_caps = sim._ensure_vdw_caps(vdw_relax) if use_vdwc else None

        def window(carry, _, ninner, temp, ff):
            """One stale-topology MD window for a single replica (matches
            ReplicaEnsemble.make_runner's outer): rebuild neighbors +
            topology (plus the compacted vdW-channel topology when
            vdw_compact), scan `ninner` Langevin steps at `temp`."""
            pos, vel, key = carry
            a = ff["a"]
            pi, pj, pv, nbmax = nbfn(pos, heavy, rcut, kmax)
            gdr = a["gamma"] / roffset
            lvl1 = _T.make_level1(pos, a["radii_large"], a["vol_large"],
                                  gdr, a["ishydrogen"])
            levels, bdiag = _T.build_tree(lvl1, pi, pj, sim.agbnp.caps,
                                          pairs_valid=pv, pair_rows=True)
            topo = _T.tree_topology(levels)
            vdw_topo = None
            vdw_counts = jnp.zeros(7, jnp.int32)
            if use_vdwc:
                lvl1v = _T.make_level1(pos, a["radii_vdw"], a["vol_vdw"],
                                       -gdr, a["ishydrogen"])
                vdw_topo, vdw_counts = _T.compact_topology(
                    _T.rescan_volumes(topo, lvl1v), vdw_caps,
                    relax=vdw_relax)
                vdw_counts = vdw_counts.astype(jnp.int32)
            ffn = sim.force_fn(pairs=(pi, pj, pv), topology=topo, ff=ff,
                               vdw_topology=vdw_topo)
            inner = langevin_middle_step(ffn, sim.masses, dt, temp,
                                         friction,
                                         constraints=sim.constraints)
            (pos, vel, key), (energies, counts) = jax.lax.scan(
                inner, (pos, vel, key), length=ninner,
                unroll=min(scan_unroll, ninner))
            maxcounts = _T.merge_counts(jnp.max(counts, axis=0),
                                        bdiag["counts"])
            return (pos, vel, key), (energies, maxcounts, nbmax,
                                     bdiag["max_siblings"], vdw_counts,
                                     ffn)

        def replica_cycle(ff, temp, pos, vel, key):
            """steps_per_cycle steps for one replica at temperature `temp`;
            returns final state, per-step energies, the potential at the
            final positions (for the exchange test), and diagnostics."""
            carry = (pos, vel, key)
            outs = []
            if nwin:
                def body(c, x):
                    st, (e, mc, nb, sb, vc, _) = window(c, x, ninner=ne,
                                                        temp=temp, ff=ff)
                    return st, (e, mc, nb, sb, vc)
                carry, (e, mc, nb, sb, vc) = jax.lax.scan(body, carry,
                                                          length=nwin)
                outs.append((e.reshape(-1), jnp.max(mc, axis=0),
                             jnp.max(nb), jnp.max(sb, axis=0),
                             jnp.max(vc, axis=0)))
                ffn_last = None
            if rem:
                carry, (e, mc, nb, sb, vc, ffn_last) = window(
                    carry, None, ninner=rem, temp=temp, ff=ff)
                outs.append((e, mc, nb, sb, vc))
            else:
                # no remainder window: build a fresh evaluation context at
                # the final positions for the exchange energy
                ffn_last = None
            pos, vel, key = carry
            if ffn_last is None:
                pi, pj, pv, nbmax = nbfn(pos, heavy, rcut, kmax)
                a = ff["a"]
                lvl1 = _T.make_level1(pos, a["radii_large"], a["vol_large"],
                                      a["gamma"] / roffset, a["ishydrogen"])
                levels, bdiag = _T.build_tree(lvl1, pi, pj, sim.agbnp.caps,
                                              pairs_valid=pv, pair_rows=True)
                topo = _T.tree_topology(levels)
                ffn_last = sim.force_fn(pairs=(pi, pj, pv), topology=topo,
                                        ff=ff)
                outs.append((jnp.zeros((0,), outs[0][0].dtype)
                             if outs else jnp.zeros((0,), pos.dtype),
                             bdiag["counts"], nbmax, bdiag["max_siblings"],
                             jnp.zeros(7, jnp.int32)))
            U = ffn_last(pos)[0]
            energies = jnp.concatenate([o[0] for o in outs])
            mc = outs[0][1]
            for o in outs[1:]:
                mc = _T.merge_counts(mc, o[1])
            nb = jnp.max(jnp.stack([o[2] for o in outs]))
            sb = jnp.max(jnp.stack([o[3] for o in outs]), axis=0)
            vc = jnp.max(jnp.stack([o[4] for o in outs]), axis=0)
            return pos, vel, key, energies, U, (mc, nb, sb, vc)

        vcycle = jax.vmap(replica_cycle, in_axes=(None, 0, 0, 0, 0))

        def cycle(carry, parity, ff):
            pos, vel, keys, rung, xkey = carry
            temp = temps[rung].astype(pos.dtype)
            pos, vel, keys, energies, U, diag = vcycle(ff, temp, pos, vel,
                                                       keys)
            xkey, sub = jax.random.split(xkey)
            new_rung, accept = attempt_swaps(sub, rung, U,
                                             betas.astype(U.dtype), parity)
            # accepted swap: momenta rescaled to the new bath temperature
            scale = jnp.sqrt(temps[new_rung] / temps[rung]).astype(vel.dtype)
            vel = vel * scale[:, None, None]
            return ((pos, vel, keys, new_rung, xkey),
                    (U, new_rung, accept, energies) + diag)

        @partial(jax.jit, static_argnames=("ncycles",))
        def run_ff(ff, states, xkey, ncycles: int):
            pos, vel, keys, rung = states
            parities = jnp.arange(ncycles, dtype=jnp.int32) % 2
            carry, (U, rungs, accept, energies, mc, nb, sb, vc) = \
                jax.lax.scan(partial(cycle, ff=ff),
                             (pos, vel, keys, rung, xkey), parities)
            pos, vel, keys, rung, xkey = carry
            out = dict(U=U, rung=rungs, accept=accept,
                       energies=jnp.swapaxes(energies, 0, 1).reshape(R, -1),
                       counts=jnp.max(mc, axis=(0, 1)),
                       nbmax=jnp.max(nb),
                       sibs=jnp.max(sb, axis=(0, 1)),
                       vdw_counts=jnp.max(vc, axis=(0, 1)))
            return (pos, vel, keys, rung), xkey, out

        def run(states, xkey, ncycles: int):
            return run_ff(sim.ff_state(), states, xkey, ncycles)

        return run

    def sample(self, ncycles=10, steps_per_cycle=40, dt=0.001, friction=1.0,
               neighbor_every: int = 40, jitter: float = 1e-3,
               seed: int = 0):
        """Run REMD and return exchange statistics + timing.

        Raises on capacity overflow (any replica, any cycle) like the
        single-system benchmark paths — REMD results from truncated trees
        are never reported.
        """
        run = self.make_runner(dt=dt, friction=friction,
                               steps_per_cycle=steps_per_cycle,
                               neighbor_every=neighbor_every)
        states, xkey = self.initial_states(jitter=jitter, seed=seed)
        states, xkey, out = run(states, xkey, ncycles)  # compile + warm
        jax.block_until_ready(out["U"])
        t0 = time.perf_counter()
        states, xkey, out = run(states, xkey, ncycles)
        jax.block_until_ready(out["U"])
        elapsed = time.perf_counter() - t0
        if self.sim._check_overflow(np.asarray(out["counts"]),
                                    int(out["nbmax"]),
                                    np.asarray(out["sibs"]),
                                    np.asarray(out["vdw_counts"])):
            raise RuntimeError(
                "tree/neighbor capacity overflow during REMD; regrow "
                "Simulation capacities (caps_boost) and rerun")
        accept = np.asarray(out["accept"])  # [C, R] per-rung indicator
        # acceptance per adjacent-rung pair (q, q+1): attempts alternate
        # with cycle parity — pair q is attempted on cycles with
        # parity == q % 2
        C, R = accept.shape
        rates = np.full(max(R - 1, 0), np.nan)
        for q in range(R - 1):
            att = [c for c in range(C) if c % 2 == q % 2]
            if att:
                rates[q] = accept[att, q].mean()
        nsteps = ncycles * steps_per_cycle
        ns_day = nsteps * dt * 1e-3 / elapsed * 86400.0
        return dict(states=states, xkey=xkey, U=np.asarray(out["U"]),
                    rung=np.asarray(out["rung"]),
                    pair_acceptance=rates, elapsed_s=elapsed,
                    ns_day_per_replica=ns_day,
                    energies=np.asarray(out["energies"]))
