"""Jittable GVolSA / AGBNP1 pipelines over the flattened overlap tree.

This is the device compute path: a pure function of positions (parameters and
spline tables passed as a pytree of arrays) that reproduces the reference
pipeline (reference ReferenceAGBNPKernels.cpp:152-795, OpenCL launch
sequences OpenCLAGBNPKernels.cpp:3229-4216) as one fused XLA computation:

  build tree (large radii) -> reduce -> E_vol1, F1
  rescan (vdW radii)       -> reduce -> E_vol2, F2, self volumes
  Born radii (spline LUT)  -> GB self/pair + vdW dispersion + direct forces
  BrW/BrU chain factors    -> descreening sweep -> W, U + direct forces
  two gamma rescans        -> tree-propagated self-volume gradient forces

Everything is static-shaped; forces are analytic (the same closed-form
reverse chain the reference derives by hand), so a single jit call yields
energy and forces with no host round-trips.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import born as B
from ..ops import tree as T
from .constants import sphere_volume
from .i4_tables import I4LookupTables
from .oracle import AGBNPParams


def prepare_arrays(params: AGBNPParams, dtype=np.float64,
                   pairs: tuple | None = None) -> dict:
    """Build the pytree of parameter/table arrays consumed by the pipeline.

    pairs: optional (i, j) candidate 2-body pairs; defaults to all i<j.
    Everything stays host-side numpy: the arrays dict is a jit argument, so
    the transfer happens in one batch at the first call.
    """
    p = params
    n = p.n
    tables = I4LookupTables(p.radii_vdw, p.ishydrogen)
    if pairs is None:
        pairs = np.triu_indices(n, 1)
    return dict(
        radii_large=np.asarray(p.radii_large, dtype),
        radii_vdw=np.asarray(p.radii_vdw, dtype),
        gamma=np.asarray(p.gamma, dtype),
        alpha=np.asarray(p.alpha, dtype),
        charge=np.asarray(p.charge, dtype),
        ishydrogen=np.asarray(p.ishydrogen, np.int32),
        vol_large=np.where(p.ishydrogen > 0, 0.0,
                           sphere_volume(p.radii_large)).astype(dtype),
        vol_vdw=np.where(p.ishydrogen > 0, 0.0,
                         sphere_volume(p.radii_vdw)).astype(dtype),
        vol_vdw_all=np.asarray(sphere_volume(p.radii_vdw), dtype),
        type_i=np.asarray(tables.type_screened, np.int32),
        type_j=np.asarray(tables.type_screener, np.int32),
        yflat=np.asarray(tables.yval.reshape(-1), dtype),
        y2flat=np.asarray(tables.y2val.reshape(-1), dtype),
        pairs_i=np.asarray(pairs[0], np.int32),
        pairs_j=np.asarray(pairs[1], np.int32),
        pairs_valid=(np.asarray(pairs[2])
                     if len(pairs) > 2 else np.ones(len(pairs[0]), bool)),
    )


def tree_passes(a: dict, pos, caps: T.TreeCaps, roffset: float,
                topology=None, pair_rows: bool = False):
    """Two-pass cavity evaluation.

    With topology given (a T.tree_topology result from an earlier build),
    the build is replaced by a fixed-topology volume rescan — the fast MD
    path between topology rebuilds.  Both parameterizations ride the SAME
    fused sweep: the vdW channel only widens the per-row gathers/scatters.

    Returns (e_cav, f_cav, self_volume, levels_vdw, lvl1_vdw, diag, red1,
    red2) where levels_vdw feeds the W/U gamma pass.
    """
    gamma_dr = a["gamma"] / roffset

    lvl1_large = T.make_level1(pos, a["radii_large"], a["vol_large"],
                               gamma_dr, a["ishydrogen"])
    lvl1_vdw = T.make_level1(pos, a["radii_vdw"], a["vol_vdw"],
                             -gamma_dr, a["ishydrogen"])
    if topology is None:
        levels, diag = T.build_tree(lvl1_large, a["pairs_i"], a["pairs_j"],
                                    caps, pairs_valid=a["pairs_valid"],
                                    pair_rows=pair_rows)
        red1 = T.reduce_tree(levels, lvl1_large, with_selfvol=False)
        levels_vdw = T.rescan_volumes(levels, lvl1_vdw)
        red2 = T.reduce_tree(levels_vdw, lvl1_vdw, with_selfvol=True)
    else:
        # fast MD path: both parameterizations rescanned and reduced in one
        # fused pass over the fixed topology
        counts = jnp.stack([jnp.sum(t["valid"]) for t in topology])
        diag = dict(counts=counts, caps=jnp.array(caps.caps),
                    max_siblings=jnp.zeros(7, jnp.int32),
                    offs=jnp.array(caps.offs + (0,)))
        levels_large, levels_vdw = T.rescan_volumes2(topology, lvl1_large,
                                                     lvl1_vdw)
        red1, red2 = T.reduce_tree2(levels_large, levels_vdw,
                                    lvl1_large, lvl1_vdw)

    e_cav = red1["energy"] + red2["energy"]
    f_cav = -(red1["dr"] + red2["dr"])
    return (e_cav, f_cav, red2["self_volume"], levels_vdw, lvl1_vdw, diag,
            red1, red2)


def energy_forces(a: dict, pos, caps: T.TreeCaps, version: int,
                  roffset: float, ntypes_j: int, cutoff=None, topology=None,
                  mixed: bool = False, neighbor_rcut: float = 0.0,
                  neighbor_kmax: int = 0, box=None, pair_rows: bool = False,
                  pair_shard=None, neighbor_grid=None,
                  descreen_horizon=None, vdw_topology=None,
                  wu_mode: str = "fused"):
    """Full GVolSA (version 0) / AGBNP1 (version 1) energy + analytic forces.

    With neighbor_kmax > 0, the 2-body candidate pairs are built on device
    from a half neighbor list instead of the arrays' pair list — the
    memory-safe mode for large systems (the all-pairs candidate buffer
    grows as N^2/2).

    With box (orthorhombic [3] lengths), the Born/GB/descreening pair phases
    use minimum-image deltas (CutoffPeriodic, AGBNPForce.h:55); the overlap
    tree keeps raw deltas like every reference backend (its overlaps span
    <~0.7 nm and assume a whole solute).

    descreen_horizon < 2 nm truncates the Born-radius/descreening sweeps
    at that distance — the reference's OpenCL-backend semantics in cutoff
    mode (its sweeps ride the cutoff neighbor list and apply
    r2 < CUTOFF_SQUARED, OpenCLAGBNPKernels.cpp:2258,
    AGBNPBornRadii.cl:268).  Default None keeps the Reference-platform
    2 nm LUT horizon (the parity ground truth).
    """
    if neighbor_kmax > 0:
        from ..ops.neighbors import cell_neighbor_pairs, half_neighbor_pairs

        if neighbor_grid is not None:
            pi, pj, pv, nbmax = cell_neighbor_pairs(
                pos, a["ishydrogen"] == 0, neighbor_rcut, neighbor_kmax,
                grid=neighbor_grid)
        else:
            pi, pj, pv, nbmax = half_neighbor_pairs(
                pos, a["ishydrogen"] == 0, neighbor_rcut, neighbor_kmax)
        a = {**a, "pairs_i": pi, "pairs_j": pj, "pairs_valid": pv}
        pair_rows = True
    e_cav, f_cav, self_volume, levels_vdw, lvl1_vdw, diag, red1, red2 = \
        tree_passes(a, pos, caps, roffset, topology=topology,
                    pair_rows=pair_rows)
    if neighbor_kmax > 0:
        diag = {**diag, "neighbor_max": nbmax,
                "neighbor_kmax": jnp.asarray(neighbor_kmax)}

    details = dict(e_vol1=red1["energy"], e_vol2=red2["energy"], e_cav=e_cav)
    if version == 0:
        return dict(energy=e_cav, force=f_cav, diag=diag, details=details)

    # volume scaling factors (ReferenceAGBNPKernels.cpp:420-430)
    s_factor = self_volume / a["vol_vdw_all"]

    if pair_shard is not None:
        # multi-chip: the pair phases row-sharded over the atoms mesh axis
        # (parallel/sharding.py::sharded_pair_phases)
        pp = pair_shard(pos, s_factor)
        gb_self, gb_pair_e, e_vdw = pp["gb_self"], pp["gb_pair"], pp["e_vdw"]
        br = pp["born_radius"]
        pair_force = pp["pair_force"]
        evdw_der_W, egb_der_U = pp["evdw_der_W"], pp["egb_der_U"]
    else:
        accum = jnp.float64 if (mixed and pos.dtype != jnp.float64) else None
        geom = B.born_radii(pos, a["radii_vdw"], s_factor, a["ishydrogen"],
                            a["type_i"], a["type_j"], a["yflat"], a["y2flat"],
                            ntypes_j, accum_dtype=accum, box=box,
                            horizon=descreen_horizon)
        br = geom["born_radius"]

        gb = B.gb_energy(pos, a["charge"], br, geom, cutoff=cutoff,
                         accum_dtype=accum)
        e_vdw = B.vdw_energy(a["alpha"], br)

        evdw_der_brw, egb_der_bru = B.born_chain_factors(
            a["alpha"], a["charge"], br, geom["inv_br_fp"], gb["egb_der_Y"])

        sweep = B.descreening_sweep(geom, s_factor, evdw_der_brw,
                                    egb_der_bru, accum_dtype=accum)
        gb_self, gb_pair_e = gb["gb_self"], gb["gb_pair"]
        pair_force = gb["force"] + sweep["force"]
        evdw_der_W, egb_der_U = sweep["evdw_der_W"], sweep["egb_der_U"]

    # self-volume gradient components via a gamma rescan.  The reference runs
    # two separate passes for W (vdW) and U (GB)
    # (ReferenceAGBNPKernels.cpp:713-747); the reduction is linear in gamma
    # and both carry unit weights, so one pass over gamma_W + gamma_U gives
    # the identical force sum at half the tree work.
    #
    # wu_mode: "fused" folds the WU force in (the reference semantics);
    # "split" returns it separately (force_wu) for the mts_wu r-RESPA
    # impulse; "skip" omits the pass entirely (the impulse integrator's
    # off-step evaluation).  The energy never depends on this pass.
    if wu_mode == "skip":
        energy = e_cav + gb_self + gb_pair_e + e_vdw
        force = f_cav + pair_force
        details.update(gb_self=gb_self, gb_pair=gb_pair_e, e_vdw=e_vdw,
                       born_radius=br, self_volume=self_volume,
                       s_factor=s_factor)
        return dict(energy=energy, force=force, diag=diag, details=details)
    gamma_WU = (evdw_der_W + egb_der_U) / a["vol_vdw_all"]
    if vdw_topology is not None:
        # compacted WU pass: vdw_topology is the ancestor closure of the
        # vdW-live rows (T.compact_topology, ~13-19% of the topology) and
        # carries the entire WU force signal; one rescan_volumes over it
        # recomputes volumes AND propagates the WU gammas (its packed chain
        # includes gamma), replacing the full-size rescan_gammas + reduce.
        lvl1_WU = T.make_level1(pos, a["radii_vdw"], a["vol_vdw"], gamma_WU,
                                a["ishydrogen"])
        red_WU = T.reduce_tree(T.rescan_volumes(vdw_topology, lvl1_WU),
                               lvl1_WU, with_selfvol=False)
    else:
        lvl1_WU = {**lvl1_vdw, "gamma1i": gamma_WU}
        red_WU = T.reduce_tree(T.rescan_gammas(levels_vdw, lvl1_WU), lvl1_WU,
                               with_selfvol=False)

    energy = e_cav + gb_self + gb_pair_e + e_vdw
    if wu_mode == "split":
        force = f_cav + pair_force
        details["force_wu"] = -red_WU["dr"]
    else:
        force = f_cav + pair_force - red_WU["dr"]

    details.update(gb_self=gb_self, gb_pair=gb_pair_e, e_vdw=e_vdw,
                   born_radius=br, self_volume=self_volume, s_factor=s_factor)
    return dict(energy=energy, force=force, diag=diag, details=details)


def batched_diag_max(diag) -> dict:
    """Reduce a vmapped diag pytree (leading batch axis on every leaf) to
    the worst case over the batch, so the host-side PanicButton check
    (`ops.tree.check_overflow`) sees the largest tree any conformer built."""
    return {k: np.max(np.asarray(v), axis=0) for k, v in diag.items()}


class AGBNPModel:
    """Prepared AGBNP system with a jit-compiled energy/forces entry point.

    The public-facing fast path: mirrors what a Context bound to an
    AGBNPForce provides in the reference (energy + forces per call), with the
    whole pipeline fused under one jit.
    """

    def __init__(self, params: AGBNPParams, caps: T.TreeCaps | None = None,
                 version: int = 1, cutoff: float | None = None,
                 dtype=np.float64, pairs=None, positions=None,
                 mixed: bool = False, box=None,
                 caps_boost: float = 1.6, descreen_horizon=None):
        self.params = params
        self.version = version
        self.cutoff = cutoff
        self.mixed = mixed
        # "cutoff": truncate the Born/descreening sweeps at the nonbonded
        # cutoff — the reference OpenCL backend's cutoff-mode semantics
        # (r2 < CUTOFF_SQUARED in its sweeps, OpenCLAGBNPKernels.cpp:2258);
        # None keeps the Reference-platform 2 nm LUT horizon
        if descreen_horizon == "cutoff":
            descreen_horizon = cutoff
        self.descreen_horizon = descreen_horizon
        self.box = None if box is None else jnp.asarray(box, dtype)
        if caps is None:
            caps = self._sized_caps(params, positions, caps_boost)
        self.caps = caps
        self.dtype = dtype
        # large systems: build candidate pairs on device per evaluation (an
        # all-pairs list grows as N^2/2); small ones keep the exact
        # triangular list
        self.neighbor_rcut = 0.0
        self.neighbor_kmax = 0
        self.neighbor_grid = None
        if pairs is None and positions is not None and params.n > 2000:
            from ..md.simulation import _host_max_neighbors
            from ..ops.neighbors import CellGrid, tree_pair_cutoff

            self.neighbor_rcut = tree_pair_cutoff(params.radii_large) + 0.05
            heavy = np.asarray(params.ishydrogen) == 0
            seen = _host_max_neighbors(np.asarray(positions), heavy,
                                       self.neighbor_rcut)
            self.neighbor_kmax = int(np.ceil(seen * 1.5 / 16) * 16)
            if params.n > 3000:
                self.neighbor_grid = CellGrid(np.asarray(positions),
                                              self.neighbor_rcut,
                                              heavy_mask=heavy)
            pairs = (np.zeros(1, np.int32), np.zeros(1, np.int32),
                     np.zeros(1, bool))  # placeholder; rebuilt on device
        self.arrays = prepare_arrays(params, dtype=dtype, pairs=pairs)
        self.ntypes_j = int(np.max(np.asarray(self.arrays["type_j"])) + 1)
        self._build_jit()

    def update_params(self, params: AGBNPParams) -> bool:
        """Parameter-only update (updateParametersInContext semantics,
        reference AGBNPForce.cpp:76-78).

        The parameter arrays are jit *arguments*, so when the new parameters
        keep every static shape (same atom count/hydrogen pattern and the
        same radius-type table dimensions) this is just an array swap — the
        compiled executable is reused, like the reference's device-array
        re-upload.  Returns True if no recompilation was needed.
        """
        old = self.arrays
        pairs = (old["pairs_i"], old["pairs_j"], old["pairs_valid"])
        arrays = prepare_arrays(params, dtype=self.dtype, pairs=pairs)
        ntypes_j = int(np.max(np.asarray(arrays["type_j"])) + 1)
        same = (ntypes_j == self.ntypes_j
                and set(arrays) == set(old)
                and all(np.shape(arrays[k]) == np.shape(old[k])
                        for k in arrays))
        self.params = params
        self.arrays = arrays
        if not same:
            self.ntypes_j = ntypes_j
            self._build_jit()
            return False
        return True

    @staticmethod
    def _sized_caps(params, positions, boost: float = 1.6):
        """Capacity sizing: exact native pre-pass on the given positions
        (the reference's CPU GaussVol pre-pass analogue) when the native
        runtime is available, else the measured-ratio heuristic."""
        if positions is not None:
            try:
                from ..runtime.native import size_tree_caps
                return size_tree_caps(params, np.asarray(positions),
                                      boost=boost)
            except Exception as exc:  # compiler/ABI failure: degrade loudly
                import warnings
                warnings.warn(
                    "native tree-sizing pre-pass unavailable "
                    f"({type(exc).__name__}: {exc}); falling back to "
                    "heuristic TreeCaps", RuntimeWarning)
        return T.TreeCaps.for_natoms(params.n, boost=max(1.0, boost / 1.6))

    def _build_jit(self):
        self._jit_ef = jax.jit(partial(
            energy_forces, caps=self.caps, version=self.version,
            roffset=self.params.roffset, ntypes_j=self.ntypes_j,
            cutoff=self.cutoff, mixed=self.mixed,
            neighbor_rcut=self.neighbor_rcut,
            neighbor_kmax=self.neighbor_kmax,
            neighbor_grid=self.neighbor_grid, box=self.box,
            descreen_horizon=self.descreen_horizon))
        self._jit_vef = None  # batched variant rebuilt lazily after regrow
        self._jit_e = None    # energy-only variant (wu_mode="skip"), lazy

    def energy_forces(self, pos, with_details: bool = False):
        out = self._jit_ef(self.arrays, jnp.asarray(pos, self.dtype))
        if with_details:
            return out["energy"], out["force"], out
        return out["energy"], out["force"]

    def energy_only(self, pos, with_details: bool = False):
        """Energy without the WU gamma-rescan force pass (the pass carries
        force only — the includeForces=False evaluation path of
        AGBNPForceImpl::calcForcesAndEnergy, reference
        openmmapi/src/AGBNPForceImpl.cpp:32-36)."""
        if self._jit_e is None:
            self._jit_e = jax.jit(partial(
                energy_forces, caps=self.caps, version=self.version,
                roffset=self.params.roffset, ntypes_j=self.ntypes_j,
                cutoff=self.cutoff, mixed=self.mixed,
                neighbor_rcut=self.neighbor_rcut,
                neighbor_kmax=self.neighbor_kmax,
                neighbor_grid=self.neighbor_grid, box=self.box,
                descreen_horizon=self.descreen_horizon, wu_mode="skip"))
        out = self._jit_e(self.arrays, jnp.asarray(pos, self.dtype))
        if with_details:
            return out["energy"], out
        return out["energy"]

    def batched_energy_forces(self, pos_batch):
        """Evaluate B conformations [B, N, 3] of the same system in one
        vmapped jit call (the batched-rescoring path; no reference analogue
        — the reference scores one conformation per Context evaluation).

        Returns the full out dict with every leaf carrying a leading batch
        axis; pass the diag through `batched_diag_max` before
        `check_and_grow`.
        """
        if self._jit_vef is None:
            self._jit_vef = jax.jit(jax.vmap(
                partial(energy_forces, caps=self.caps, version=self.version,
                        roffset=self.params.roffset, ntypes_j=self.ntypes_j,
                        cutoff=self.cutoff, mixed=self.mixed,
                        neighbor_rcut=self.neighbor_rcut,
                        neighbor_kmax=self.neighbor_kmax,
                        neighbor_grid=self.neighbor_grid, box=self.box,
                        descreen_horizon=self.descreen_horizon),
                in_axes=(None, 0)))
        return self._jit_vef(self.arrays, jnp.asarray(pos_batch, self.dtype))

    def check_and_grow(self, diag) -> bool:
        """PanicButton: grow capacities if the last evaluation overflowed.
        Returns True if a re-evaluation is needed."""
        ov = T.check_overflow(diag)
        nb_over = ("neighbor_max" in diag
                   and int(diag["neighbor_max"]) > self.neighbor_kmax > 0)
        if not ov["any"] and not nb_over:
            return False
        if ov["any"]:
            self.caps = self.caps.grow(
                [bool(c) for c in ov["cap_overflow"]],
                [bool(s) for s in ov["sib_overflow"][:-1]])
        if nb_over:
            self.neighbor_kmax = int(np.ceil(
                int(diag["neighbor_max"]) * 1.5 / 16) * 16)
        self._build_jit()
        return True
