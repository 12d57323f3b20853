"""Multi-chip sharding for AGBNP MD: replica data parallelism + atom-sharded
pair phases.

The reference is strictly single-device (multiple OpenCL contexts are
rejected, reference OpenCLAGBNPKernels.cpp:412-413); its parallel dimension
is intra-GPU work-groups.  Across devices the natural scale-out axes are:

  * `replica`: independent MD replicas (free-energy / ensemble workflows,
    BASELINE config 5) — pure data parallelism via vmap + sharded batch
    dimension.
  * `atoms`: the O(N^2) pair phases (Born radii / GB / descreening) sharded
    over screened-atom rows via shard_map; each device computes the partial
    sums over its row block against all screeners, with a psum only where a
    per-screener reduction (W/U accumulators, j-side forces) is needed.

Both are expressed with jax.sharding.Mesh + NamedSharding/shard_map so XLA
inserts the collectives.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def replica_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()[:n_devices]
    return Mesh(np.array(devices), axis_names=("replica",))


def make_replica_ensemble_step(step_fn, mesh: Mesh):
    """Shard a per-replica MD step over the `replica` mesh axis.

    step_fn(state_pytree) -> state_pytree for one replica; states are stacked
    on a leading replica axis and sharded across devices.
    """
    vstep = jax.vmap(step_fn)

    def sharded(tree_axis0_spec):
        return NamedSharding(mesh, tree_axis0_spec)

    rep = NamedSharding(mesh, P("replica"))

    @partial(jax.jit,
             in_shardings=(rep,),
             out_shardings=rep)
    def run(states):
        return vstep(states)

    return run


def atom_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()[:n_devices]
    return Mesh(np.array(devices), axis_names=("atoms",))


def sharded_pair_phases(mesh: Mesh, a: dict, ntypes_j: int, cutoff=None,
                        box=None, axis: str = "atoms"):
    """The real AGBNP1 pair phases (Born radii -> GB -> vdW -> descreening)
    sharded over screened-atom rows via shard_map.

    Each device owns a contiguous row block and the replicated screener
    arrays; the only collectives are one all_gather (Born radii, needed by
    the GB pair term) and psums for the scalar energies, the screener-side
    W/U accumulators, and the screener-reaction forces — this is the
    multi-chip decomposition of the reference's warp-tile sweeps
    (AGBNPBornRadii.cl:181-490, AGBNPGBEnergy.cl:58-383).

    `a` is the prepare_arrays dict.  Returns fn(pos, s_factor) -> dict with
    the same fields the dense single-device path produces (gb_self, gb_pair,
    e_vdw, born_radius [N], pair_force [N, 3], evdw_der_W, egb_der_U), equal
    to it to float64 roundoff.
    """
    from ..ops import born as B

    ndev = mesh.shape[axis]
    n = int(np.asarray(a["charge"]).shape[0])
    npad = -(-n // ndev) * ndev
    pad = npad - n

    def padded(x, fill=0.0):
        return jnp.pad(jnp.asarray(x), (0, pad), constant_values=fill)

    def kernel(pos_blk, row_blk, radii_blk, ti_blk, ch_blk, al_blk,
               pos, s_factor, ish, tj, yflat, y2flat, charge):
        psum = partial(jax.lax.psum, axis_name=axis)
        gather = partial(jax.lax.all_gather, axis_name=axis, tiled=True)
        return B.pair_phases_rows(
            pos_blk, row_blk, pos, radii_blk, s_factor, ish, ti_blk, tj,
            yflat, y2flat, ntypes_j, ch_blk, charge, al_blk, cutoff=cutoff,
            box=box, psum=psum, all_gather=gather)

    smapped = jax.shard_map(
        kernel, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
                  P(), P(), P(), P(), P(), P(), P()),
        out_specs=dict(gb_self=P(), gb_pair=P(), e_vdw=P(),
                       born_radius=P(axis), row_force=P(axis),
                       col_force=P(), evdw_der_W=P(), egb_der_U=P()),
    )

    def fn(pos, s_factor):
        dt = pos.dtype
        # padded rows sit far away with zero charge/alpha and never screen
        # (ishydrogen=1, s_factor=0), so every padded contribution is zero
        far = 1e3 * (1.0 + 0.618 * jnp.arange(pad, dtype=dt))
        pos_p = jnp.concatenate(
            [pos, jnp.stack([far, far, far], axis=-1)], axis=0)
        out = smapped(
            pos_p, jnp.arange(npad, dtype=jnp.int32),
            padded(a["radii_vdw"], 0.1).astype(dt),
            padded(a["type_i"]).astype(jnp.int32),
            padded(a["charge"]).astype(dt), padded(a["alpha"]).astype(dt),
            pos, jnp.asarray(s_factor, dt),
            jnp.asarray(a["ishydrogen"], jnp.int32),
            jnp.asarray(a["type_j"], jnp.int32),
            jnp.asarray(a["yflat"], dt), jnp.asarray(a["y2flat"], dt),
            jnp.asarray(a["charge"], dt))
        return dict(gb_self=out["gb_self"], gb_pair=out["gb_pair"],
                    e_vdw=out["e_vdw"], born_radius=out["born_radius"][:n],
                    pair_force=out["row_force"][:n] + out["col_force"],
                    evdw_der_W=out["evdw_der_W"], egb_der_U=out["egb_der_U"])

    return fn


def _shard_topology(topology, ndev: int):
    """Strip a tree_topology() result down to the row-aligned leaves the
    fixed-topology passes need (indices, validity, the monotone parent ids),
    so every leaf shards evenly over the mesh rows."""
    out = []
    for t in topology:
        cap = t["valid"].shape[0]
        if cap % ndev != 0:
            raise ValueError(
                f"tree level capacity {cap} not divisible by {ndev} devices"
            )
        d = dict(_ints=t["_ints"], valid=t["valid"], atom=t["atom"],
                 parent=t["parent"])
        if "bnd" in t:
            d["bnd"] = dict(pmono=t["bnd"]["pmono"])
        out.append(d)
    return tuple(out)


def sharded_energy_forces(mesh: Mesh, a: dict, roffset: float, ntypes_j: int,
                          cutoff=None, box=None, axis: str = "atoms",
                          descreen_horizon=None):
    """The FULL fixed-topology AGBNP1 pipeline sharded over one mesh axis:
    cavity tree passes (rescan_volumes2 + reduce_tree2) and the W/U
    gamma-rescan force pass run on row BLOCKS of the overlap-tree levels
    (ops/tree.py TreeComm collectives: per-level all_gather downward,
    psum_scatter/psum upward), with the pair phases row-sharded over atoms
    in the same shard_map — so a single large system scales across chips,
    which the reference explicitly cannot do (single OpenCL context
    enforced, OpenCLAGBNPKernels.cpp:412-413).

    The tree BUILD stays replicated: in MD it amortizes over 20-40 step
    rebuild windows while these fixed-topology passes dominate the step.

    Returns fn(pos, topology) -> dict(energy, force, e_cav, self_volume,
    born_radius), equal to the unsharded energy_forces(topology=...) to
    float roundoff (tests/test_parallel.py).
    """
    from ..ops import born as B
    from ..ops import tree as T

    ndev = mesh.shape[axis]
    n = int(np.asarray(a["charge"]).shape[0])
    npad = -(-n // ndev) * ndev
    pad = npad - n
    comm = T.TreeComm(axis=axis, ndev=ndev)

    def body(topo, rep, pos_blk, row_blk, radii_blk, ti_blk, ch_blk,
             al_blk):
        pos = rep["pos"]
        # cavity: both parameterizations rescanned + reduced on level blocks
        lvl1_large = T.make_level1(pos, rep["radii_large"], rep["vol_large"],
                                   rep["gamma_dr"], rep["ishydrogen"])
        lvl1_vdw = T.make_level1(pos, rep["radii_vdw"], rep["vol_vdw"],
                                 -rep["gamma_dr"], rep["ishydrogen"])
        la, lb = T.rescan_volumes2(topo, lvl1_large, lvl1_vdw, comm=comm)
        red1, red2 = T.reduce_tree2(la, lb, lvl1_large, lvl1_vdw, comm=comm)
        e_cav = red1["energy"] + red2["energy"]
        f_cav = -(red1["dr"] + red2["dr"])
        s_factor = red2["self_volume"] / rep["vol_vdw_all"]

        psum = partial(jax.lax.psum, axis_name=axis)
        gather = partial(jax.lax.all_gather, axis_name=axis, tiled=True)
        pp = B.pair_phases_rows(
            pos_blk, row_blk, pos, radii_blk, s_factor, rep["ish"], ti_blk,
            rep["type_j"], rep["yflat"], rep["y2flat"], ntypes_j, ch_blk,
            rep["charge"], al_blk, cutoff=cutoff, box=box,
            psum=psum, all_gather=gather, horizon=descreen_horizon)

        # self-volume-gradient forces via the fused W+U gamma rescan
        gamma_WU = (pp["evdw_der_W"] + pp["egb_der_U"]) / rep["vol_vdw_all"]
        lvl1_WU = {**lvl1_vdw, "gamma1i": gamma_WU}
        red_WU = T.reduce_tree(T.rescan_gammas(lb, lvl1_WU, comm=comm),
                               lvl1_WU, with_selfvol=False, comm=comm)

        # row_force back to replicated full rows: place the block at its
        # offset and psum (all_gather output stays device-varying under
        # shard_map's replication checker; psum is the provably-replicated
        # reduction)
        nblk = pp["row_force"].shape[0]
        off = jax.lax.axis_index(axis) * nblk
        row_full = psum(jax.lax.dynamic_update_slice(
            jnp.zeros((nblk * comm.ndev, 3), pp["row_force"].dtype),
            pp["row_force"], (off, jnp.zeros((), off.dtype))))
        pair_force = row_full[:n] + pp["col_force"]
        energy = e_cav + pp["gb_self"] + pp["gb_pair"] + pp["e_vdw"]
        force = f_cav + pair_force - red_WU["dr"]
        return dict(energy=energy, force=force, e_cav=e_cav,
                    self_volume=red2["self_volume"],
                    born_radius=pp["born_radius"])

    smapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(), P(axis), P(axis), P(axis), P(axis),
                  P(axis), P(axis)),
        out_specs=dict(energy=P(), force=P(), e_cav=P(), self_volume=P(),
                       born_radius=P(axis)),
    )

    def fn(pos, topology, arrays=None):
        # arrays: pass the force-field dict as a TRACED argument from jitted
        # MD runners (closing over host numpy bakes [N]-array constants into
        # the graph — see AGBNPModel._build_jit's ff-as-args convention);
        # defaults to the dict captured at construction for one-shot use
        av = a if arrays is None else arrays
        dt = pos.dtype
        topo = _shard_topology(topology, ndev)
        rep = dict(
            pos=pos,
            radii_large=jnp.asarray(av["radii_large"], dt),
            vol_large=jnp.asarray(av["vol_large"], dt),
            radii_vdw=jnp.asarray(av["radii_vdw"], dt),
            vol_vdw=jnp.asarray(av["vol_vdw"], dt),
            vol_vdw_all=jnp.asarray(av["vol_vdw_all"], dt),
            gamma_dr=jnp.asarray(av["gamma"], dt) / roffset,
            ishydrogen=jnp.asarray(av["ishydrogen"], jnp.int32),
            ish=jnp.asarray(av["ishydrogen"], jnp.int32),
            type_j=jnp.asarray(av["type_j"], jnp.int32),
            yflat=jnp.asarray(av["yflat"], dt),
            y2flat=jnp.asarray(av["y2flat"], dt),
            charge=jnp.asarray(av["charge"], dt),
        )
        # padded rows sit far away with zero charge/alpha so every padded
        # pair contribution is zero (same scheme as sharded_pair_phases)
        far = 1e3 * (1.0 + 0.618 * jnp.arange(pad, dtype=dt))
        pos_p = jnp.concatenate(
            [pos, jnp.stack([far, far, far], axis=-1)], axis=0)

        def padt(x, fill=0.0):
            return jnp.pad(jnp.asarray(x), (0, pad), constant_values=fill)

        out = smapped(
            topo, rep, pos_p, jnp.arange(npad, dtype=jnp.int32),
            padt(av["radii_vdw"], 0.1).astype(dt),
            padt(av["type_i"]).astype(jnp.int32),
            padt(av["charge"]).astype(dt), padt(av["alpha"]).astype(dt))
        out["born_radius"] = out["born_radius"][:n]
        return out

    return fn
