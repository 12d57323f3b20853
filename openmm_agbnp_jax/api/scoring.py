"""Batched conformer rescoring: score B conformations of one molecule in a
single vmapped evaluation, optionally sharded over a device mesh.

This is a capability with no direct reference analogue — the
reference plugin (openmmapi/src/AGBNPForceImpl.cpp:32-36) evaluates one
conformation per Context call, so rescoring a pose ensemble costs B serial
GPU round trips.  Here the whole batch is one jit executable: the overlap
tree builds, Born-radius sweeps, and GB sums batch on the leading axis, and
with a replica mesh the batch is data-parallel across chips with no
collectives (embarrassingly parallel scoring, the docking/rescoring
workload AGBNP was built for).

Semantics per conformer are identical to api.force.Context.getEnergyForces:
the same energy_forces pipeline, the same PanicButton capacity-regrow loop
(worst case over the batch via batched_diag_max).
"""

from __future__ import annotations

import numpy as np

from .force import AGBNPForce, NonbondedMethod

_DETAIL_TERMS = ("e_cav", "e_vol1", "e_vol2", "gb_self", "gb_pair", "e_vdw")


class ConformerScorer:
    """Vectorized AGBNP scorer over conformations of a fixed particle table.

    Parameters
    ----------
    force: an AGBNPForce (version 0, 1 or 2; NoCutoff or
        CutoffNonPeriodic).  Version 2 scores through the batched AGBNP2
        energy with autodiff forces (per-conformer MS candidate rebuild on
        device); refine() supports versions 0/1 only.
    positions: representative coordinates [N, 3] or a batch [B, N, 3] used
        to size the overlap-tree capacities (the native sizing pre-pass runs
        on the largest-tree candidate); scoring positions may differ.
    mesh: optional jax.sharding.Mesh with one axis; the batch axis is
        sharded over it (batches are padded to a device multiple).
    dtype: compute dtype (float32 for deployment, float64 for parity).
    """

    def __init__(self, force: AGBNPForce, positions, dtype=np.float32,
                 mesh=None, mixed: bool = False, caps=None,
                 caps_boost: float = 1.6):
        from ..models.agbnp_jax import AGBNPModel

        if force.getVersion() not in (0, 1, 2):
            raise ValueError("ConformerScorer supports versions 0, 1 and 2")
        if force.getNonbondedMethod() == NonbondedMethod.CutoffPeriodic:
            raise ValueError(
                "ConformerScorer is for gas-phase/implicit-solvent poses; "
                "CutoffPeriodic is not supported")
        if mesh is not None and len(mesh.axis_names) != 1:
            raise ValueError("mesh must have exactly one axis")
        pos_b = np.asarray(positions, dtype=np.float64)
        pos = pos_b[0] if pos_b.ndim == 3 else pos_b
        cutoff = (None
                  if force.getNonbondedMethod() == NonbondedMethod.NoCutoff
                  else force.getCutoffDistance())
        self._is_v2 = force.getVersion() == 2
        self._pos0 = pos
        if self._is_v2:
            # AGBNP2 batch scoring: shared capacities sized from the first
            # conformer (regrown from the batched [18] overflow vector on
            # demand); MS candidate pairs rebuilt per conformer on device.
            # caps plumbs through; caps_boost is a version-0/1 tree-sizing
            # knob (AGBNP2 sizes its two trees internally, ms_boost).
            from ..models.agbnp2_jax import AGBNP2Model, ms_pair_cutoff

            if mixed:
                raise ValueError(
                    "mixed=True is a version-0/1 option; AGBNP2 scoring "
                    "runs the f32 (or f64) pipeline directly")
            self._model = AGBNP2Model(force.to_params(), dtype=dtype,
                                      positions=pos, cutoff=cutoff,
                                      caps=caps)
            self._ms_rcut = ms_pair_cutoff(self._model.params.radii_vdw)
            heavy = np.asarray(self._model.params.ishydrogen) == 0
            from ..md.simulation import _host_max_neighbors
            seen = max(_host_max_neighbors(p, heavy, self._ms_rcut)
                       for p in (pos_b if pos_b.ndim == 3 else pos_b[None]))
            self._ms_kmax_list = int(np.ceil(seen * 1.5 / 16) * 16)
            self._v2_jit = None
        else:
            self._model = AGBNPModel(force.to_params(),
                                     version=force.getVersion(),
                                     cutoff=cutoff, dtype=dtype, caps=caps,
                                     caps_boost=caps_boost, mixed=mixed,
                                     positions=pos)
        self._mesh = mesh
        self._force = force

    @property
    def model(self):
        return self._model

    def updateParametersInContext(self, force: AGBNPForce | None = None):
        """Parameter-only refresh (AGBNPForce.cpp:76-78 semantics): swaps
        the jit-argument arrays; the compiled batch executable is reused
        when every static shape is unchanged."""
        self._force = force or self._force
        if self._is_v2:
            from ..models.agbnp2_jax import AGBNP2Model

            m2 = self._model
            self._model = AGBNP2Model(
                self._force.to_params(), dtype=m2.dtype,
                positions=np.asarray(self._pos0), cutoff=m2.cutoff,
                caps=m2.caps, caps_ms=m2.caps_ms, cap_ms=m2.cap_ms,
                ms_kmax=m2.ms_kmax, ms_sub_k=m2.ms_sub_k)
            # the cached vmapped jit closes over the old model's arrays and
            # static config (common_gamma, roffset, ntypes_j, caps) — it
            # must be rebuilt or score() keeps computing with stale params
            self._v2_jit = None
            return
        self._model.update_params(self._force.to_params())

    def _shard(self, pos_batch):
        """Pad the batch to a device multiple and shard the leading axis."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        ndev = self._mesh.devices.size
        b = pos_batch.shape[0]
        pad = (-b) % ndev
        if pad:
            pos_batch = np.concatenate(
                [pos_batch, np.repeat(pos_batch[-1:], pad, axis=0)], axis=0)
        sharding = NamedSharding(self._mesh, P(self._mesh.axis_names[0]))
        return jax.device_put(pos_batch, sharding), b

    def _score_v2(self, pos, nb, forces: bool, details: bool):
        """Batched AGBNP2 scoring: per-conformer MS candidate rebuild on
        device + the jitted v2 energy with autodiff forces, vmapped over
        the batch; capacities shared across the batch and regrown from the
        batched [18] overflow vector (worst conformer)."""
        import jax
        import jax.numpy as jnp

        from ..models.agbnp2_jax import agbnp2_energy
        from ..ops.neighbors import half_neighbor_pairs

        heavy = jnp.asarray(
            np.asarray(self._model.params.ishydrogen) == 0)

        for _ in range(8):
            m2 = self._model
            if self._v2_jit is None:
                def one(a2, q):
                    mpi, mpj, mpv, cand_nb = half_neighbor_pairs(
                        q, heavy, self._ms_rcut, self._ms_kmax_list)

                    def e_only(q):
                        e, diags, det = agbnp2_energy(
                            a2, q, m2.caps, m2.caps_ms, m2.params.roffset,
                            m2.ntypes_j, mpi, mpj, mpv, m2.cap_ms,
                            m2.ms_kmax, m2.common_gamma, cutoff=m2.cutoff,
                            ms_sub_k=m2.ms_sub_k,
                            ms_sub_rcut=m2.ms_sub_rcut)
                        return e, (diags, det)

                    (e, (diags, det)), grad = jax.value_and_grad(
                        e_only, has_aux=True)(q)
                    d0, d1 = diags
                    counts = jnp.concatenate([
                        d0["counts"].astype(jnp.int32),
                        d1["counts"].astype(jnp.int32),
                        jnp.stack([d1["ms_count"], d1["ms_nbmax"], cand_nb,
                                   d1["ms_sub_max"]]).astype(jnp.int32)])
                    keep = ("e_vol1", "e_vol2", "gb_self", "gb_pair",
                            "e_vdw", "e_ms_vdw", "e_ms_large")
                    return dict(energy=e, force=-grad, counts=counts,
                                details={k: det[k] for k in keep})

                self._v2_jit = jax.jit(jax.vmap(one, in_axes=(None, 0)))
            out = self._v2_jit(
                {k: jnp.asarray(v) for k, v in m2.arrays.items()},
                jnp.asarray(pos, m2.dtype))
            cmax = np.max(np.asarray(out["counts"]), axis=0)
            if not self._regrow_v2(cmax):
                break
        else:
            raise RuntimeError("AGBNP2 capacities failed to converge")
        res = {"energy": np.asarray(out["energy"])[:nb]}
        if forces:
            res["force"] = np.asarray(out["force"])[:nb]
        if details:
            for k, v in out["details"].items():
                res[k] = np.asarray(v)[:nb]
        return res

    def _regrow_v2(self, c, headroom: float = 1.3) -> bool:
        """Batched-worst-case PanicButton for v2 scoring; True = regrown
        (the vmapped jit is rebuilt)."""
        from ..models.agbnp2_jax import AGBNP2Model
        from ..ops.tree import TreeCaps

        m2 = self._model
        over = (bool((c[:7] > np.asarray(m2.caps.caps)).any()
                     or (c[7:14] > np.asarray(m2.caps_ms.caps)).any()
                     or int(c[14]) > m2.cap_ms or int(c[15]) > m2.ms_kmax
                     or int(c[16]) > self._ms_kmax_list
                     or int(c[17]) > m2.ms_sub_k))
        if not over:
            return False

        def r(x, align=128):
            return max(align, int(np.ceil(x / align)) * align)

        def grow_caps(old, counts):
            return TreeCaps(
                caps=tuple(max(c0, 2 * c0 if int(k) > c0 else c0,
                               r(int(k) * headroom))
                           for c0, k in zip(old.caps, counts)),
                offs=old.offs)

        if int(c[16]) > self._ms_kmax_list:
            self._ms_kmax_list = int(np.ceil(int(c[16]) * 1.5 / 16) * 16)
        self._model = AGBNP2Model(
            self._force.to_params(), dtype=m2.dtype,
            positions=np.asarray(self._pos0), cutoff=m2.cutoff,
            caps=grow_caps(m2.caps, c[:7]),
            caps_ms=grow_caps(m2.caps_ms, c[7:14]),
            cap_ms=(r(int(c[14]) * 1.5) if int(c[14]) > m2.cap_ms
                    else m2.cap_ms),
            ms_kmax=(int(np.ceil(int(c[15]) * 1.5 / 16) * 16)
                     if int(c[15]) > m2.ms_kmax else m2.ms_kmax),
            ms_sub_k=(int(np.ceil(int(c[17]) * 1.5 / 16) * 16)
                      if int(c[17]) > m2.ms_sub_k else m2.ms_sub_k))
        self._v2_jit = None
        return True

    def refine(self, positions, maxiter: int = 200, **fire_kw):
        """FIRE-minimize every conformation (vmapped), then rescore.

        The batched analogue of the reference workflow's per-pose
        simulation.minimizeEnergy() (reference example/test_agbnp.py:49).
        Returns the score() dict plus "positions" [B, N, 3] (minimized) and
        "energy_trace" [B, maxiter].  Tree capacities regrow from the worst
        tree seen by ANY pose at ANY iteration (the minimizer tracks
        running diag maxima, md/minimize.py::make_fire_runner).
        """
        import jax

        from ..models.agbnp_jax import batched_diag_max
        from ..md.minimize import make_fire_runner

        if self._is_v2:
            raise ValueError("refine() supports versions 0/1; score AGBNP2 "
                             "poses directly or minimize through md/")
        pos = np.asarray(positions, dtype=np.float64)
        if pos.ndim == 2:
            pos = pos[None]
        if pos.ndim != 3 or pos.shape[1:] != (self._model.params.n, 3):
            raise ValueError(
                f"expected positions [B, {self._model.params.n}, 3], got "
                f"{pos.shape}")
        nb = pos.shape[0]
        if self._mesh is not None:
            pos, nb = self._shard(pos)

        for _ in range(8):
            m = self._model
            key = (id(m.caps), maxiter, tuple(sorted(fire_kw.items())))
            if getattr(self, "_refine_key", None) != key:
                from functools import partial

                from ..models.agbnp_jax import energy_forces

                def run(arrays, pos0):
                    fn = partial(energy_forces, arrays, caps=m.caps,
                                 version=m.version, roffset=m.params.roffset,
                                 ntypes_j=m.ntypes_j, cutoff=m.cutoff,
                                 mixed=m.mixed,
                                 neighbor_rcut=m.neighbor_rcut,
                                 neighbor_kmax=m.neighbor_kmax,
                                 neighbor_grid=m.neighbor_grid, box=m.box,
                                 descreen_horizon=m.descreen_horizon)
                    return make_fire_runner(fn, maxiter=maxiter,
                                            **fire_kw)(pos0)

                self._refine_jit = jax.jit(jax.vmap(run, in_axes=(None, 0)))
                self._refine_key = key
            import jax.numpy as jnp

            pmin, etrace, diag = self._refine_jit(
                m.arrays, jnp.asarray(pos, m.dtype))
            if not m.check_and_grow(batched_diag_max(diag)):
                break
        else:
            raise RuntimeError("overlap tree capacities failed to converge")
        res = self.score(np.asarray(pmin)[:nb])
        res["positions"] = np.asarray(pmin)[:nb]
        res["energy_trace"] = np.asarray(etrace)[:nb]
        return res

    def score(self, positions, forces: bool = False, details: bool = False):
        """Score a batch of conformations.

        positions: [B, N, 3] (or [N, 3], treated as B=1).
        Returns a dict with "energy" [B] (kJ/mol), plus "force" [B, N, 3]
        when forces=True and per-term energies (e_cav, gb_self, gb_pair,
        e_vdw, ...) when details=True.
        """
        pos = np.asarray(positions, dtype=np.float64)
        if pos.ndim == 2:
            pos = pos[None]
        if pos.ndim != 3 or pos.shape[1:] != (self._model.params.n, 3):
            raise ValueError(
                f"expected positions [B, {self._model.params.n}, 3], got "
                f"{pos.shape}")
        from ..models.agbnp_jax import batched_diag_max

        nb = pos.shape[0]
        if self._mesh is not None:
            pos, nb = self._shard(pos)
        if self._is_v2:
            return self._score_v2(pos, nb, forces, details)
        for _ in range(8):
            out = self._model.batched_energy_forces(pos)
            if not self._model.check_and_grow(batched_diag_max(out["diag"])):
                break
        else:
            raise RuntimeError("overlap tree capacities failed to converge")
        res = {"energy": np.asarray(out["energy"])[:nb]}
        if forces:
            res["force"] = np.asarray(out["force"])[:nb]
        if details:
            for k in _DETAIL_TERMS:
                if k in out["details"]:
                    res[k] = np.asarray(out["details"][k])[:nb]
        return res
