"""On-device MD loop: AGBNP implicit solvent + MM force field under lax.scan.

The reference benchmark protocol is 10,000 Langevin steps with wall-clock
timing (reference example/t4lysozyme_benchmark.py:30-34).  Here the whole
inner loop — AGBNP tree build + pair phases, MM forces, integrator update,
periodic on-device neighbor-list rebuild — is a single jitted nested
lax.scan with no host round-trips; the host only sees the final state and
the per-step energy trace.
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models.agbnp_jax import AGBNPModel, energy_forces
from ..models.oracle import AGBNPParams
from ..ops.neighbors import half_neighbor_pairs, tree_pair_cutoff
from .forces import MMForceField
from .integrators import langevin_middle_step, velocity_verlet_step


def _host_max_neighbors(pos, heavy, rcut, chunk: int = 2048):
    """Max half-list neighbor count, row-chunked so host memory stays
    O(N*chunk) instead of O(N^2) for large systems."""
    n = pos.shape[0]
    jj = np.arange(n)
    best = 0
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d2 = np.sum((pos[s:e, None, :] - pos[None, :, :]) ** 2, axis=-1)
        ok = ((jj[None, :] > jj[s:e, None]) & (d2 < rcut * rcut)
              & heavy[s:e, None] & heavy[None, :])
        best = max(best, int(ok.sum(axis=1).max()))
    return best


class Simulation:
    """MD simulation of a DMS system with AGBNP implicit solvent.

    Mirrors the capability of the reference benchmark scripts
    (DesmondDMSFile.createSystem(implicitSolvent='AGBNP') + LangevinIntegrator
    + Simulation.step), with the entire step fused on device.
    """

    def __init__(self, dms, version: int = 1, cutoff: float | None = None,
                 dtype=np.float64, include_mm: bool = True,
                 caps=None, pairs=None, skin: float = 0.15,
                 kmax: int | None = None, vsites=None, mixed: bool = False,
                 caps_boost: float = 1.10, constraints: bool = False,
                 descreen_horizon=None):
        self.dms = dms
        self.dtype = dtype
        self.version = version
        self.vsites = vsites.arrays(dtype) if vsites is not None and             getattr(vsites, "count", 0) > 0 else None
        params = AGBNPParams(radius=dms.agbnp_radius, gamma=dms.agbnp_gamma,
                             alpha=dms.agbnp_alpha, charge=dms.charges,
                             ishydrogen=dms.ishydrogen)
        self.agbnp2 = None
        if version == 2:
            # AGBNP2 MD: JAX energy + autodiff forces, MS candidate pairs
            # rebuilt on device each evaluation (the reference's v2 cannot
            # run MD — its hand force chain is WIP)
            from ..models.agbnp2_jax import AGBNP2Model, ms_pair_cutoff

            self.agbnp2 = AGBNP2Model(params, dtype=dtype,
                                      positions=np.asarray(dms.positions),
                                      cutoff=cutoff)
            self.agbnp = self.agbnp2  # caps/params access for shared paths
            self.ms_rcut = ms_pair_cutoff(params.radii_vdw)
            heavy_np = np.asarray(params.ishydrogen) == 0
            seen = _host_max_neighbors(np.asarray(dms.positions), heavy_np,
                                       self.ms_rcut)
            self.ms_kmax_list = int(np.ceil(seen * 1.5 / 16) * 16)
        else:
            # MD runs with tighter tree-capacity headroom than the one-shot
            # API: the row-indexed tree ops cost per padded row; counts
            # drift slowly at equilibrium, overflow is detected every
            # segment, and the PanicButton grow path covers the tail
            self.agbnp = AGBNPModel(params, version=version, cutoff=cutoff,
                                    dtype=dtype, caps=caps, pairs=pairs,
                                    positions=dms.positions, mixed=mixed,
                                    caps_boost=caps_boost,
                                    descreen_horizon=descreen_horizon)
        self.mm = MMForceField.from_dms(dms, cutoff=cutoff, dtype=dtype) \
            if include_mm else None
        self.masses = jnp.asarray(dms.masses, dtype)
        self.positions = jnp.asarray(dms.positions, dtype)
        self.velocities = jnp.asarray(dms.velocities, dtype)

        # neighbor-list sizing pass (the analogue of the reference's CPU
        # GaussVol pre-pass, OpenCLAGBNPKernels.cpp:566-617)
        self.rcut_list = tree_pair_cutoff(params.radii_large) + skin
        heavy = np.asarray(params.ishydrogen) == 0
        if kmax is None:
            seen = _host_max_neighbors(np.asarray(dms.positions), heavy,
                                       self.rcut_list)
            kmax = int(np.ceil(seen * 1.5 / 16) * 16)
        self.kmax = kmax
        self.heavy_mask = jnp.asarray(heavy)
        # O(N) cell-grid neighbor build above the dense-rebuild crossover
        # (the analogue of OpenMM's cell-based tiles the reference rides)
        from ..ops.neighbors import CellGrid, cell_neighbor_pairs
        self.grid = None
        if params.n > 3000:
            self.grid = CellGrid(np.asarray(dms.positions), self.rcut_list,
                                 heavy_mask=heavy)
        self.neighbor_fn = (partial(cell_neighbor_pairs, grid=self.grid)
                            if self.grid is not None else half_neighbor_pairs)
        # Desmond X-H constraint tables -> SHAKE/RATTLE in the MD loop (the
        # reference gets these through DesmondDMSFile.createSystem)
        self.constraints = None
        if constraints:
            from .constraints import Constraints
            self.constraints = Constraints.from_dms(dms)

    def resize_caps_to_current(self, positions=None, caps_boost: float = 1.3):
        """Shrink-to-fit: re-size every capacity (tree caps, neighbor kmax,
        cell grid, WU-compact caps) from a fresh sizing pass
        on the CURRENT configuration, discarding regrow history.

        PanicButton regrows only ever GROW, so after a violent transient
        (a synthetic system's initial melt, an unfolded start) the
        converged capacities carry the transient's spike plus escalation
        headroom, and every padded row costs real step time.  Call this once the system is equilibrated; runners
        built before it are stale (rebuild with make_langevin_runner),
        and if the lean capacities prove too small the normal PanicButton
        path grows them back — safe by construction."""
        if self.agbnp2 is not None:
            raise ValueError("resize_caps_to_current supports versions 0/1")
        pos = (np.asarray(self.positions) if positions is None
               else np.asarray(positions))
        m = self.agbnp
        self.agbnp = AGBNPModel(
            m.params, version=m.version, cutoff=m.cutoff, dtype=self.dtype,
            positions=pos, mixed=m.mixed,
            caps_boost=caps_boost, descreen_horizon=m.descreen_horizon)
        heavy = np.asarray(m.params.ishydrogen) == 0
        seen = _host_max_neighbors(pos, heavy, self.rcut_list)
        self.kmax = int(np.ceil(seen * 1.5 / 16) * 16)
        if self.grid is not None:
            from ..ops.neighbors import CellGrid, cell_neighbor_pairs
            self.grid = CellGrid(pos, self.rcut_list, heavy_mask=heavy)
            self.neighbor_fn = partial(cell_neighbor_pairs, grid=self.grid)
        # the lazy WU-compact sizing pass reads self.positions; point it at
        # the configuration being sized from
        self.positions = jnp.asarray(pos, self.dtype)
        self._vdw_caps = None

    def set_velocities_to_temperature(self, temperature, seed: int = 0):
        """Maxwell-Boltzmann velocities at `temperature` (OpenMM's
        Context.setVelocitiesToTemperature analogue), COM motion removed."""
        from .integrators import maxwell_boltzmann_velocities
        self.velocities = maxwell_boltzmann_velocities(
            jax.random.PRNGKey(seed), self.masses, temperature,
            dtype=self.positions.dtype)
        return self.velocities

    def _agbnp_force(self, pos, pairs=None, topology=None, a=None,
                     vdw_topology=None, wu_mode: str = "fused"):
        a = self.agbnp.arrays if a is None else a
        if pairs is not None:
            a = {**a, "pairs_i": pairs[0], "pairs_j": pairs[1],
                 "pairs_valid": pairs[2]}
        out = energy_forces(a, pos, caps=self.agbnp.caps,
                            version=self.agbnp.version,
                            roffset=self.agbnp.params.roffset,
                            ntypes_j=self.agbnp.ntypes_j,
                            cutoff=self.agbnp.cutoff, topology=topology,
                            pair_rows=pairs is not None,
                            mixed=self.agbnp.mixed,
                            descreen_horizon=self.agbnp.descreen_horizon,
                            vdw_topology=vdw_topology,
                            wu_mode=wu_mode)
        energy = out["energy"]
        counts = out["diag"]["counts"].astype(jnp.int32)
        if wu_mode == "split":
            return energy, out["force"], out["details"]["force_wu"], counts
        return energy, out["force"], counts

    def ff_state(self):
        """The force-field parameter pytree the MD runners take as a jit
        ARGUMENT.  Closing over the host numpy arrays instead would bake
        them into the compiled graph as constants — XLA then constant-folds
        [N, N] parameter subexpressions at compile time, which multiplied
        runner compile times and produced 60+ MB executables."""
        ff = dict(a=self.agbnp.arrays)
        if self.mm is not None:
            ff["mm"] = self.mm.arrays
            ff["mm_excl_mask"] = self.mm._excl_mask()
        return ff

    def _sharded_ef(self, mesh):
        """Cached sharded_energy_forces closure for this mesh (the full
        tree+pair AGBNP1 pipeline decomposed over the `atoms` axis,
        parallel/sharding.py)."""
        if getattr(self, "_sharded_fn_mesh", None) is not mesh:
            from ..parallel.sharding import sharded_energy_forces

            self._sharded_fn = sharded_energy_forces(
                mesh, self.agbnp.arrays, self.agbnp.params.roffset,
                self.agbnp.ntypes_j, cutoff=self.agbnp.cutoff,
                box=self.agbnp.box,
                descreen_horizon=self.agbnp.descreen_horizon)
            self._sharded_fn_mesh = mesh
        return self._sharded_fn

    def force_fn(self, pairs=None, topology=None, ff=None, mesh=None,
                 split: bool = False, vdw_topology=None,
                 wu_mode: str = "fused"):
        """Returns fn(pos) -> (energy, force, tree_counts); the counts ride
        the scan outputs so overflow is detectable after an MD run (the
        in-loop PanicButton, reference OpenCLAGBNPKernels.cpp:3598-3634).

        With mesh (jax.sharding.Mesh with an "atoms" axis), the AGBNP pair
        phases AND fixed-topology tree passes run sharded over the mesh via
        shard_map (multi-chip single-system MD); requires a topology and
        version 1.  MM terms and the integrator stay replicated.

        With split, returns (slow_fn, fast_fn) for the MTS (r-RESPA)
        integrators instead: slow_fn(pos) -> (e, f, counts) is the AGBNP
        implicit solvent + MM dense LJ/Coulomb class, fast_fn(pos) ->
        (e, f) is the stiff bonded + 1-4 class.

        ff: optional ff_state() pytree (may be traced); without it the
        stored host arrays are used (and become graph constants)."""
        from .vsites import project_positions, spread_forces

        if self.agbnp2 is not None:
            if split:
                raise ValueError("MTS supports AGBNP versions 0/1")
            if mesh is not None:
                raise ValueError("mesh-sharded force requires version 1")
            return self._force_fn_v2(ms_pairs=pairs, topology=topology)
        if split and self.mm is None:
            raise ValueError("MTS needs an MM force field (the fast class)")

        if mesh is not None and (topology is None or self.agbnp.version != 1):
            raise ValueError("mesh-sharded force requires version 1 and a "
                             "prebuilt topology")
        if wu_mode != "fused" and (split or mesh is not None
                                   or self.agbnp.version != 1):
            raise ValueError("wu_mode split/skip (mts_wu) requires "
                             "version 1 without MTS or mesh sharding")
        if ff is None:
            ff = self.ff_state()
        a = ff["a"]
        mm_a = ff.get("mm")

        if mesh is not None:
            sfn = self._sharded_ef(mesh)

            def agbnp_part(pos):
                out = sfn(pos, topology, arrays=a)
                counts = jnp.stack([jnp.sum(t["valid"]) for t in topology])
                return out["energy"], out["force"], counts
        else:
            def agbnp_part(pos):
                return self._agbnp_force(pos, pairs, topology, a=a,
                                         vdw_topology=vdw_topology,
                                         wu_mode=wu_mode)

        if split:
            def slow_fn(pos):
                if self.vsites is not None:
                    pos = project_positions(pos, self.vsites)
                energy, force, counts = agbnp_part(pos)
                # dense LJ/Coulomb belongs to the slow class (RESPA splits
                # by timescale)
                e_nb, g_nb = jax.value_and_grad(
                    partial(self.mm.energy_nonbonded, a=mm_a,
                            excl_mask=ff["mm_excl_mask"]))(pos)
                energy = energy + e_nb
                force = force - g_nb
                if self.vsites is not None:
                    force = spread_forces(force, self.vsites)
                return energy, force, counts

            def fast_fn(pos):
                if self.vsites is not None:
                    pos = project_positions(pos, self.vsites)
                e, g = jax.value_and_grad(
                    partial(self.mm.energy_bonded_and_14, a=mm_a))(pos)
                force = -g
                if self.vsites is not None:
                    force = spread_forces(force, self.vsites)
                return e, force

            return slow_fn, fast_fn

        def fn(pos):
            if self.vsites is not None:
                pos = project_positions(pos, self.vsites)
            out = agbnp_part(pos)
            energy, force, counts = out[0], out[1], out[-1]
            if self.mm is not None:
                mm_e = partial(self.mm.energy, a=mm_a,
                               excl_mask=ff["mm_excl_mask"])
                e_mm, g_mm = jax.value_and_grad(mm_e)(pos)
                energy = energy + e_mm
                force = force - g_mm
            if self.vsites is not None:
                force = spread_forces(force, self.vsites)
            if wu_mode == "split":
                f_wu = out[2]
                if self.vsites is not None:
                    f_wu = spread_forces(f_wu, self.vsites)
                return energy, force, f_wu, counts
            return energy, force, counts
        return fn

    def _v2_build(self, pos):
        """Window-start AGBNP2 build: one full evaluation extracting the
        stale-window topology — both tree topologies and the frozen MS
        compaction — plus the [17] overflow counts vector.  Returns
        (ms_pairs, (topology, countsvec)) in the force_fn(pairs=...,
        topology=...) convention."""
        from ..models.agbnp2_jax import agbnp2_energy

        m2 = self.agbnp2
        a2 = {k: jnp.asarray(v) for k, v in m2.arrays.items()}
        mpi, mpj, mpv, cand_nb = half_neighbor_pairs(
            pos, self.heavy_mask, self.ms_rcut, self.ms_kmax_list)
        _, diags, _, topo = agbnp2_energy(
            a2, pos, m2.caps, m2.caps_ms, m2.params.roffset, m2.ntypes_j,
            mpi, mpj, mpv, m2.cap_ms, m2.ms_kmax, m2.common_gamma,
            cutoff=m2.cutoff, with_topology=True,
            ms_sub_k=m2.ms_sub_k, ms_sub_rcut=m2.ms_sub_rcut)
        d0, d1 = diags
        countsvec = jnp.concatenate([
            d0["counts"].astype(jnp.int32),
            d1["counts"].astype(jnp.int32),
            jnp.stack([d1["ms_count"], d1["ms_nbmax"],
                       cand_nb, d1["ms_sub_max"]]).astype(jnp.int32)])
        return (mpi, mpj, mpv), (topo, countsvec)

    def _force_fn_v2(self, ms_pairs=None, topology=None):
        """AGBNP2 force function: on-device MS candidate rebuild + jitted
        energy with autodiff forces (models/agbnp2_jax.py), plus the MM
        force field.

        With ms_pairs (frozen MS candidate rows) and topology
        ((topo_dict, build_countsvec) from _v2_build), the tree builds are
        replaced by fixed-topology rescans — the stale-topology MD window;
        the build's overflow vector rides the per-step outputs unchanged
        (rescans cannot overflow)."""
        from ..models.agbnp2_jax import agbnp2_energy
        from .vsites import project_positions, spread_forces

        m2 = self.agbnp2
        heavy = self.heavy_mask
        ms_rcut = self.ms_rcut
        ms_kmax_list = self.ms_kmax_list

        def e_only(pos):
            # numpy-hosted param arrays become trace-time constants here
            # (indexing them with tracers directly would fail)
            a2 = {k: jnp.asarray(v) for k, v in m2.arrays.items()}
            if topology is not None:
                topo, build_counts = topology
                mpi, mpj, mpv = ms_pairs
                e, _, details = agbnp2_energy(
                    a2, pos, m2.caps, m2.caps_ms, m2.params.roffset,
                    m2.ntypes_j, mpi, mpj, mpv, m2.cap_ms, m2.ms_kmax,
                    m2.common_gamma, cutoff=m2.cutoff, topology=topo,
                    ms_sub_k=m2.ms_sub_k, ms_sub_rcut=m2.ms_sub_rcut)
                return e, build_counts
            mpi, mpj, mpv, cand_nb = half_neighbor_pairs(pos, heavy, ms_rcut,
                                                         ms_kmax_list)
            e, diags, details = agbnp2_energy(
                a2, pos, m2.caps, m2.caps_ms, m2.params.roffset,
                m2.ntypes_j, mpi, mpj, mpv, m2.cap_ms, m2.ms_kmax,
                m2.common_gamma, cutoff=m2.cutoff,
                ms_sub_k=m2.ms_sub_k, ms_sub_rcut=m2.ms_sub_rcut)
            d0, d1 = diags
            # [18] overflow vector: main tree [7], MS tree [7], then
            # (MS particle count, MS-tree neighbor max, candidate-pair max,
            #  MS subtraction-list max)
            countsvec = jnp.concatenate([
                d0["counts"].astype(jnp.int32),
                d1["counts"].astype(jnp.int32),
                jnp.stack([d1["ms_count"], d1["ms_nbmax"],
                           cand_nb, d1["ms_sub_max"]]).astype(jnp.int32)])
            return e, countsvec

        def fn(pos):
            if self.vsites is not None:
                pos = project_positions(pos, self.vsites)
            (energy, counts), grad = jax.value_and_grad(
                e_only, has_aux=True)(pos)
            force = -grad
            if self.mm is not None:
                e_mm, g_mm = jax.value_and_grad(self.mm.energy)(pos)
                energy = energy + e_mm
                force = force - g_mm
            if self.vsites is not None:
                force = spread_forces(force, self.vsites)
            return energy, force, counts
        return fn

    def make_langevin_runner(self, dt=0.001, temperature=300.0, friction=1.0,
                             neighbor_every: int = 10,
                             rebuild_topology: bool = True,
                             topology_relax=None, mesh=None,
                             mts_inner: int = 0, scan_unroll: int = 4,
                             vdw_compact: bool = True,
                             vdw_relax: float = 0.5, wu_every: int = 1):
        """Returns run(pos, vel, key, nsteps) — a nested-scan Langevin loop.

        With mts_inner > 0, each step is a multiple-timestep (r-RESPA)
        outer step of length dt: one full AGBNP + MM-nonbonded evaluation
        (the slow impulse) plus mts_inner bonded-force substeps at
        dt/mts_inner (md/integrators.py::mts_langevin_step).  `nsteps`
        then counts OUTER steps, and simulated time per step is still dt —
        a production-throughput option beyond the reference's fixed
        1 fs/full-evaluation protocol.  Combine with constraints=True to
        run dt = 2 fs outer / 1 fs bonded substeps.  Neighbor/topology
        rebuild windows also count outer steps, so scale neighbor_every
        down when raising dt (positions drift dt per outer step).

        With mesh (an "atoms"-axis jax.sharding.Mesh), every step's AGBNP
        pair phases and fixed-topology tree passes run sharded over the
        mesh (multi-chip single-system MD, parallel/sharding.py); the tree
        build at each rebuild boundary, the MM terms, and the integrator
        stay replicated.  Requires version 1 with rebuild windows.

        With neighbor_every > 0, the half neighbor list is rebuilt on device
        every `neighbor_every` steps and the tree's 2-body candidates come
        from it; with 0, every step uses the full triangular pair list.

        scan_unroll unrolls the inner step scan (XLA emits scan_unroll step
        bodies per loop iteration, shrinking per-iteration loop overhead
        and letting ops fuse across steps) at some compile-time cost.

        With rebuild_topology, the overlap-tree *topology* is also rebuilt
        only at those boundaries and each step runs the ~15x cheaper
        fixed-topology volume rescan — the MD analogue of a Verlet-list
        skin.  Overlaps that newly cross the switching threshold between
        rebuilds enter with (smoothly) zero weight, so the error is bounded
        by the switching window and vanishes at each rebuild; set False for
        strict per-step reference semantics.

        With vdw_compact (versions 0/1 with rebuild windows, the default),
        each rebuild also extracts the ancestor closure of the vdW-live
        tree rows (plus a vdw_relax birth margin below the volume switch)
        and the per-step vdW-channel passes — E_vol2 + self-volumes and the
        WU gamma-rescan force pass — run on that compacted topology, exact
        at the rebuild point (dropped subtrees contribute 0.0,
        ops/tree.py::compact_topology) at ~13-19% of the full rows.
        """
        masses, rcut, kmax = self.masses, self.rcut_list, self.kmax
        heavy = self.heavy_mask
        nbfn = self.neighbor_fn

        from .integrators import mts_langevin_step

        def make_step(ff=None, pairs=None, topology=None, vdw_topology=None):
            if mts_inner:
                slow, fast = self.force_fn(pairs=pairs, topology=topology,
                                           ff=ff, mesh=mesh, split=True,
                                           vdw_topology=vdw_topology)
                return mts_langevin_step(slow, fast, masses, dt, temperature,
                                         friction, mts_inner,
                                         constraints=self.constraints)
            return langevin_middle_step(
                self.force_fn(pairs=pairs, topology=topology, ff=ff,
                              mesh=mesh, vdw_topology=vdw_topology),
                masses, dt, temperature, friction,
                constraints=self.constraints)

        # v2 with rebuild windows runs the stale-topology rescan path
        # between builds (see _v2_build); neighbor_every <= 0 keeps the
        # strict rebuild-everything-per-step evaluation

        if mesh is not None and (neighbor_every <= 0 or not rebuild_topology):
            raise ValueError("mesh-sharded MD requires topology-rebuild "
                             "windows (neighbor_every > 0, "
                             "rebuild_topology=True)")
        if wu_every > 1 and (mts_inner or mesh is not None
                             or self.agbnp2 is not None
                             or self.agbnp.version != 1
                             or neighbor_every <= 0):
            raise ValueError("wu_every > 1 (mts_wu) requires version 1 "
                             "rebuild-window MD without MTS/mesh")

        if neighbor_every <= 0:
            @partial(jax.jit, static_argnames=("nsteps",))
            def run_ff(ff, pos, vel, key, nsteps: int):
                step = make_step(ff=ff)
                (pos, vel, key), (energies, counts) = jax.lax.scan(
                    step, (pos, vel, key), length=nsteps,
                    unroll=min(scan_unroll, nsteps))
                return pos, vel, key, energies, (jnp.max(counts, axis=0),
                                                 jnp.zeros((), jnp.int32),
                                                 jnp.zeros(7, jnp.int32),
                                                 jnp.zeros(7, jnp.int32))

            def run(pos, vel, key, nsteps: int):
                return run_ff(self.ff_state(), pos, vel, key, nsteps)

            return run

        caps = self.agbnp.caps
        roffset = self.agbnp.params.roffset
        use_vdwc = (vdw_compact and rebuild_topology and mesh is None
                    and self.agbnp2 is None and self.agbnp.version in (0, 1))
        vdw_caps = self._ensure_vdw_caps(vdw_relax) if use_vdwc else None

        @partial(jax.jit, static_argnames=("nouter", "ninner"))
        def run_ff(ff, pos, vel, key, nouter: int, ninner: int):
            a = ff["a"]

            def outer(carry, _):
                pos, vel, key = carry
                if self.agbnp2 is not None:
                    # v2 stale-topology window: one full build (topology +
                    # frozen MS compaction extracted), then fixed-topology
                    # rescan steps; only the build can overflow, so its
                    # [17] counts vector rides every step's output
                    pairs_w, topo_w = self._v2_build(pos)
                    inner = make_step(ff=ff, pairs=pairs_w, topology=topo_w)
                    (pos, vel, key), (energies, counts) = jax.lax.scan(
                        inner, (pos, vel, key), length=ninner,
                        unroll=min(scan_unroll, ninner))
                    return ((pos, vel, key),
                            (energies, jnp.max(counts, axis=0),
                             jnp.zeros((), jnp.int32),
                             jnp.zeros(7, jnp.int32),
                             jnp.zeros(7, jnp.int32)))
                pi, pj, pv, nbmax = nbfn(pos, heavy, rcut, kmax)
                topo = None
                build_counts = None
                sib_max = jnp.zeros(7, jnp.int32)
                vdw_topo = None
                vdw_counts = jnp.zeros(7, jnp.int32)
                if rebuild_topology:
                    from ..ops import tree as _T
                    gdr = a["gamma"] / roffset
                    lvl1 = _T.make_level1(pos, a["radii_large"],
                                          a["vol_large"], gdr,
                                          a["ishydrogen"])
                    levels, bdiag = _T.build_tree(lvl1, pi, pj, caps,
                                                  pairs_valid=pv,
                                                  relax=topology_relax,
                                                  pair_rows=True)
                    topo = _T.tree_topology(levels)
                    build_counts = bdiag["counts"]
                    sib_max = bdiag["max_siblings"]
                    if use_vdwc:
                        # compacted vdW-channel topology for this window:
                        # the ancestor closure of the vdW-live rows
                        # (~13-19% of the build, tree.compact_topology);
                        # serves E_vol2/self-volumes AND the WU force pass
                        lvl1v = _T.make_level1(pos, a["radii_vdw"],
                                               a["vol_vdw"], -gdr,
                                               a["ishydrogen"])
                        vdw_topo, vdw_counts = _T.compact_topology(
                            _T.rescan_volumes(topo, lvl1v), vdw_caps,
                            relax=vdw_relax)
                        vdw_counts = vdw_counts.astype(jnp.int32)
                if wu_every > 1:
                    # mts_wu: the WU gamma-rescan force pass as an r-RESPA
                    # impulse every wu_every steps (integrators.py::
                    # wu_impulse_langevin_block); off-impulse steps skip the
                    # pass entirely
                    from .integrators import wu_impulse_langevin_block
                    mk = dict(pairs=(pi, pj, pv), topology=topo,
                              ff=ff, vdw_topology=vdw_topo)
                    split_fn = self.force_fn(wu_mode="split", **mk)
                    skip_fn = self.force_fn(wu_mode="skip", **mk)

                    def blockstep(k):
                        return wu_impulse_langevin_block(
                            split_fn, skip_fn, masses, dt, temperature,
                            friction, k, constraints=self.constraints)

                    nblk, remk = divmod(ninner, wu_every)
                    carry = (pos, vel, key)
                    elist, clist = [], []
                    if nblk:
                        carry, (e, c) = jax.lax.scan(
                            blockstep(wu_every), carry, length=nblk,
                            unroll=min(max(1, scan_unroll // wu_every),
                                       nblk))
                        elist.append(e.reshape(-1))
                        clist.append(jnp.max(c, axis=0))
                    if remk:
                        carry, (e, c) = blockstep(remk)(carry, None)
                        elist.append(e)
                        clist.append(c)
                    pos, vel, key = carry
                    energies = jnp.concatenate(elist)
                    counts = jnp.stack(clist)
                else:
                    inner = make_step(ff=ff, pairs=(pi, pj, pv),
                                      topology=topo, vdw_topology=vdw_topo)
                    (pos, vel, key), (energies, counts) = jax.lax.scan(
                        inner, (pos, vel, key), length=ninner,
                        unroll=min(scan_unroll, ninner))
                maxcounts = jnp.max(counts, axis=0)
                if build_counts is not None:
                    from ..ops.tree import merge_counts
                    maxcounts = merge_counts(maxcounts, build_counts)
                return ((pos, vel, key),
                        (energies, maxcounts, nbmax, sib_max, vdw_counts))

            (pos, vel, key), (energies, counts, nbmax, sibs, wu) = \
                jax.lax.scan(outer, (pos, vel, key), length=nouter)
            return (pos, vel, key, energies.reshape(-1),
                    (jnp.max(counts, axis=0), jnp.max(nbmax),
                     jnp.max(sibs, axis=0), jnp.max(wu, axis=0)))

        def run(pos, vel, key, nsteps: int):
            ff = self.ff_state()
            nouter, rem = divmod(nsteps, neighbor_every)
            outs = []
            if nouter:
                pos, vel, key, e, diag = run_ff(ff, pos, vel, key, nouter,
                                                neighbor_every)
                outs.append((e, diag))
            if rem:
                # nsteps need not divide into rebuild windows: one short
                # remainder window (its own compiled executable)
                pos, vel, key, e, diag = run_ff(ff, pos, vel, key, 1, rem)
                outs.append((e, diag))
            if len(outs) == 1:
                e, diag = outs[0]
            else:
                e = jnp.concatenate([o[0] for o in outs])
                diag = tuple(jnp.maximum(a, b)
                             for a, b in zip(outs[0][1], outs[1][1]))
            return pos, vel, key, e, diag

        def lower(pos, vel, key, nsteps: int):
            """Lower the full-window program run(pos, vel, key, nsteps)
            compiles (for compiled.memory_analysis() and the like)."""
            return run_ff.lower(self.ff_state(), pos, vel, key,
                                max(nsteps // neighbor_every, 1),
                                neighbor_every)

        run.lower = lower
        return run

    def make_verlet_runner(self, dt=0.001):
        @partial(jax.jit, static_argnames=("nsteps",))
        def run_ff(ff, pos, vel, nsteps: int):
            fn = self.force_fn(ff=ff)
            step = velocity_verlet_step(fn, self.masses, dt,
                                        constraints=self.constraints)
            _, force, _ = fn(pos)
            (pos, vel, force), (pe, ke, _) = jax.lax.scan(
                step, (pos, vel, force), length=nsteps)
            return pos, vel, pe, ke

        def run(pos, vel, nsteps: int):
            return run_ff(self.ff_state(), pos, vel, nsteps)

        return run

    def benchmark_langevin(self, nsteps=1000, dt=0.001, temperature=300.0,
                           friction=1.0, seed=0, warmup=True,
                           neighbor_every: int = 10,
                           rebuild_topology: bool = True,
                           mts_inner: int = 0, max_regrow: int = 3,
                           scan_unroll: int = 4, vdw_compact: bool = True,
                           wu_every: int = 1):
        """Timed Langevin MD, reference-benchmark style. Returns dict with
        ns/day and the energy trace.  If a capacity overflow is detected
        (PanicButton, reference OpenCLAGBNPKernels.cpp:3598-3634) the caps
        are regrown and the whole timed run repeats, up to max_regrow
        times, so the reported numbers always come from a clean run."""
        for attempt in range(max_regrow + 1):
            run = self.make_langevin_runner(dt, temperature, friction,
                                            neighbor_every=neighbor_every,
                                            rebuild_topology=rebuild_topology,
                                            mts_inner=mts_inner,
                                            scan_unroll=scan_unroll,
                                            vdw_compact=vdw_compact,
                                            wu_every=wu_every)
            key = jax.random.PRNGKey(seed)
            pos, vel = self.positions, self.velocities
            if warmup:
                # warm with the SAME static nsteps so the timed call reuses
                # the compiled executable (a different length would recompile)
                out = run(pos, vel, key, nsteps)
                jax.block_until_ready(out)
            t0 = time.perf_counter()
            pos, vel, key, energies, (counts, nbmax, sibs, *wu) = run(
                pos, vel, key, nsteps)
            wu = wu[0] if wu else None
            counts = np.asarray(counts)  # device sync
            elapsed = time.perf_counter() - t0
            ns_day = nsteps * dt * 1e-3 / elapsed * 86400.0
            overflow = self._check_overflow(counts, nbmax, sibs, wu)
            if not overflow or attempt == max_regrow:
                break
            self._regrow(counts, nbmax, sibs, wu=wu)
        return dict(ns_day=ns_day, elapsed_s=elapsed, steps_per_s=nsteps / elapsed,
                    final_pos=pos, final_vel=vel, tree_counts_max=counts,
                    neighbor_max=int(nbmax), overflow=overflow,
                    regrows=attempt, energies=np.asarray(energies))

    def _check_overflow(self, counts, nbmax, sibs, wu=None) -> bool:
        if self.agbnp2 is not None:
            return self._check_overflow_v2(counts)
        return bool(self.overflow_report(counts, nbmax, sibs, wu))

    def overflow_report(self, counts, nbmax, sibs, wu=None) -> dict:
        """Which PanicButton channels overflowed: {channel: (seen, cap)}.

        Empty dict = clean run.  Channels: tree level caps, sibling
        enumeration windows, neighbor kmax (also carries cell-grid capacity
        overflow as kmax+1) and compacted-WU per-level caps.  The per-channel accounting is what
        the reference's PanicButton readback distinguishes via separate
        device flags (OpenCLAGBNPKernels.cpp:3598-3634)."""
        rep = {}
        caps = np.asarray(self.agbnp.caps.caps)
        offs = np.asarray(self.agbnp.caps.offs)
        counts = np.asarray(counts)
        for i, (c, c0) in enumerate(zip(counts[:len(caps)], caps)):
            if int(c) > int(c0):
                rep[f"tree_level{i + 1}"] = (int(c), int(c0))
        # the deepest level's sibling groups are never enumerated further
        # (MAX_ORDER truncation, reference gaussvol.cpp:211), so only the
        # windows that actually generate children can overflow
        sibs = np.asarray(sibs)
        for i, (sb, o0) in enumerate(zip(sibs[:len(offs)], offs)):
            if int(sb) - 1 > int(o0):
                rep[f"sibling_window{i + 1}"] = (int(sb) - 1, int(o0))
        if int(nbmax) > self.kmax:
            rep["neighbor_kmax"] = (int(nbmax), int(self.kmax))
        if wu is not None and getattr(self, "_vdw_caps", None) is not None:
            # a WU kept-row count past its compact capacity means live rows
            # were truncated out of the WU force pass: regrow
            for i, (k, o) in enumerate(zip(np.asarray(wu),
                                           self._vdw_caps[1])):
                if int(k) > int(o):
                    rep[f"wu_compact_level{i + 1}"] = (int(k), int(o))
        return rep

    def _check_overflow_v2(self, countsvec) -> bool:
        """AGBNP2 overflow test over the [18] diagnostics vector."""
        c = np.asarray(countsvec)
        m2 = self.agbnp2
        return bool(
            (c[:7] > np.asarray(m2.caps.caps)).any()
            or (c[7:14] > np.asarray(m2.caps_ms.caps)).any()
            or int(c[14]) > m2.cap_ms
            or int(c[15]) > m2.ms_kmax
            or int(c[16]) > self.ms_kmax_list
            or (len(c) > 17 and int(c[17]) > m2.ms_sub_k))

    def _regrow_v2(self, countsvec, headroom: float = 1.3):
        """PanicButton resize for AGBNP2: regrow the main-tree caps, the
        MS-tree caps, the MS particle capacity, and both neighbor widths
        from the measured maxima, then rebuild the model."""
        from ..models.agbnp2_jax import AGBNP2Model
        from ..ops.tree import TreeCaps

        c = np.asarray(countsvec)
        m2 = self.agbnp2

        def r(x, align=128):
            return max(align, int(np.ceil(x / align)) * align)

        def grow_caps(old, counts):
            return TreeCaps(
                caps=tuple(max(c0, 2 * c0 if int(k) > c0 else c0,
                               r(int(k) * headroom))
                           for c0, k in zip(old.caps, counts)),
                offs=old.offs)

        caps = grow_caps(m2.caps, c[:7])
        caps_ms = grow_caps(m2.caps_ms, c[7:14])
        cap_ms = m2.cap_ms
        if int(c[14]) > cap_ms:
            cap_ms = r(int(c[14]) * 1.5)
        ms_kmax = m2.ms_kmax
        if int(c[15]) > ms_kmax:
            ms_kmax = int(np.ceil(int(c[15]) * 1.5 / 16) * 16)
        if int(c[16]) > self.ms_kmax_list:
            self.ms_kmax_list = int(np.ceil(int(c[16]) * 1.5 / 16) * 16)
        ms_sub_k = m2.ms_sub_k
        if len(c) > 17 and int(c[17]) > ms_sub_k:
            ms_sub_k = int(np.ceil(int(c[17]) * 1.5 / 16) * 16)
        self.agbnp2 = AGBNP2Model(m2.params, dtype=self.dtype,
                                  positions=np.asarray(self.dms.positions),
                                  cutoff=m2.cutoff, caps=caps,
                                  caps_ms=caps_ms, cap_ms=cap_ms,
                                  ms_kmax=ms_kmax, ms_sub_k=ms_sub_k)
        self.agbnp = self.agbnp2

    def _ensure_vdw_caps(self, relax: float = 0.5, boost: float = 1.5):
        """Static per-level capacities for the compacted vdW-channel
        topology (ops/tree.py::compact_topology), sized from the kept-row
        counts of one build+rescan on the current positions — the
        compaction analogue of the neighbor-list sizing pass.  Cached per
        relax value; _regrow updates the cache on overflow."""
        cached = getattr(self, "_vdw_caps", None)
        if cached is not None and cached[0] == relax:
            return cached[1]
        from ..ops import tree as _T
        a = self.agbnp.arrays
        caps = self.agbnp.caps
        roffset = self.agbnp.params.roffset

        @jax.jit
        def counts_fn(pos):
            pi, pj, pv, _ = self.neighbor_fn(pos, self.heavy_mask,
                                             self.rcut_list, self.kmax)
            gdr = a["gamma"] / roffset
            lvl1 = _T.make_level1(pos, a["radii_large"], a["vol_large"],
                                  gdr, a["ishydrogen"])
            levels, _ = _T.build_tree(lvl1, pi, pj, caps, pairs_valid=pv,
                                      pair_rows=True)
            lvl1v = _T.make_level1(pos, a["radii_vdw"], a["vol_vdw"], -gdr,
                                   a["ishydrogen"])
            lv = _T.rescan_volumes(_T.tree_topology(levels), lvl1v)
            # only the counts output is used; XLA dead-code-eliminates the
            # compaction gathers themselves
            return _T.compact_topology(lv, [l["valid"].shape[0] for l in lv],
                                       relax=relax)[1]

        c = np.asarray(counts_fn(self.positions))
        wu = tuple(max(8, int(np.ceil(int(k) * boost / 8) * 8)) for k in c)
        self._vdw_caps = (relax, wu)
        return wu

    def _regrow(self, counts, nbmax, sibs, headroom: float = 1.3, wu=None):
        """PanicButton resize (reference OpenCLAGBNPKernels.cpp:340-343,
        3598-3634): rebuild the model with capacities covering the measured
        maxima plus headroom.  Compiled runners built before this call are
        stale — rebuild them with make_langevin_runner."""
        from ..ops.tree import TreeCaps

        if self.agbnp2 is not None:
            return self._regrow_v2(counts, headroom)
        old = self.agbnp.caps

        def r(x, align=128):
            return max(align, int(np.ceil(x / align)) * align)

        # a truncated level hides its children, so measured counts
        # underestimate deeper levels: overflowed levels at least double
        # (the reference's tree_size_boost x2) for geometric convergence
        counts = np.asarray(counts)
        caps = tuple(max(c0, 2 * c0 if int(c) > c0 else c0,
                         r(int(c) * headroom))
                     for c0, c in zip(old.caps, counts[:len(old.caps)]))
        sibs = np.asarray(sibs)
        offs = tuple(max(o0, 2 * o0 if int(sb) - 1 > o0 else o0,
                         int(np.ceil(max(int(sb) - 1, 1) * headroom)))
                     for o0, sb in zip(old.offs, sibs[:-1]))
        if wu is not None and getattr(self, "_vdw_caps", None) is not None:
            relax, old_wu = self._vdw_caps
            wu = np.asarray(wu)
            new_wu = tuple(max(o, 2 * o if int(k) > o else o,
                               max(8, int(np.ceil(int(k) * headroom / 8) * 8)))
                           for o, k in zip(old_wu, wu))
            self._vdw_caps = (relax, new_wu)
        if int(nbmax) > self.kmax:
            if self.grid is not None:
                # a cell-capacity overflow reports kmax+1 through this
                # channel; regrow the grid capacity alongside kmax
                from ..ops.neighbors import cell_neighbor_pairs as _cnp
                self.grid = self.grid.grown()
                self.neighbor_fn = partial(_cnp, grid=self.grid)
            self.kmax = int(np.ceil(int(nbmax) * 1.5 / 16) * 16)
        m = self.agbnp
        self.agbnp = AGBNPModel(m.params, caps=TreeCaps(caps=caps, offs=offs),
                                version=m.version, cutoff=m.cutoff,
                                dtype=self.dtype, mixed=m.mixed,
                                positions=np.asarray(self.dms.positions),
                                descreen_horizon=m.descreen_horizon)

    def run_md(self, nsteps, dt=0.001, temperature=300.0, friction=1.0,
               seed=0, neighbor_every: int = 20, segment: int | None = None,
               max_regrow: int = 8, pos=None, vel=None, key=None,
               mts_inner: int = 0, report_interval: int = 0, reporter=None,
               checkpoint_path: str | None = None, scan_unroll: int = 4):
        """Langevin MD with automatic PanicButton recovery.

        Runs in segments; when a segment overflowed the overlap-tree
        capacities, the sibling windows, or the neighbor list, its results
        are discarded (forces invalid), the capacities are regrown from the
        measured maxima, the step function is recompiled, and the segment is
        retried from its starting state — the MD-loop equivalent of the
        reference's PanicButton protocol (device flag -> setForcesValid
        (false) -> buffer resize -> OpenMM retries the step,
        OpenCLAGBNPKernels.cpp:3598-3634).  Returns the same dict as
        benchmark_langevin plus 'regrows'.

        report_interval > 0 collects a position snapshot every that many
        steps (it becomes the segment size, so each snapshot costs the
        per-segment host sync run_md already pays): the returned dict gains
        'frames' [F, N, 3] and 'frame_steps'; write them out with
        io.dcd.write_dcd.  `reporter(step, pos, vel)` is additionally
        called per snapshot when given (e.g. incremental trajectory IO).
        Snapshots come only from clean (non-overflowed) segments.

        checkpoint_path writes an exact-resume checkpoint (io/checkpoint.py)
        after every clean segment: positions, velocities, completed-step
        count, and the Langevin PRNG key at the boundary.  Resuming with
        `ck = load_checkpoint(p); run_md(nsteps - ck['step'],
        pos=ck['positions'], vel=ck['velocities'], key=ck['key'], ...)`
        (same dt/segment/neighbor_every) reproduces the uninterrupted
        trajectory (bitwise on the CPU; on the GPU to the run-to-run
        spread of atomic scatter-adds).  `key` overrides the seed-derived PRNG key
        (accepts a saved raw key-data array).
        """
        if report_interval:
            if segment is not None and segment != report_interval:
                raise ValueError("segment and report_interval conflict; "
                                 "give one of them")
            segment = max(int(report_interval), 1)
        elif neighbor_every <= 0:
            # strict rebuild-every-step evaluation: any segment size works
            segment = min(nsteps, 50) if segment is None else segment
        else:
            if segment is None:
                segment = min(nsteps, 50 * neighbor_every)
            segment -= segment % neighbor_every
            segment = max(segment, min(nsteps, neighbor_every))
        assert segment > 0

        run = self.make_langevin_runner(dt, temperature, friction,
                                        neighbor_every=neighbor_every,
                                        mts_inner=mts_inner,
                                        scan_unroll=scan_unroll)
        if key is None:
            key = jax.random.PRNGKey(seed)
        else:
            key = jnp.asarray(key, jnp.uint32)
        pos = self.positions if pos is None else jnp.asarray(pos, self.dtype)
        vel = self.velocities if vel is None else jnp.asarray(vel, self.dtype)
        energies = []
        frames, frame_steps = [], []
        done = 0
        regrows = 0
        t0 = time.perf_counter()
        while done < nsteps:
            # the runner splits any n into full windows + a remainder
            n = min(segment, nsteps - done)
            new_pos, new_vel, new_key, e, (counts, nbmax, sibs, *wu) = \
                run(pos, vel, key, n)
            wu = wu[0] if wu else None
            counts = np.asarray(counts)  # sync
            if self._check_overflow(counts, nbmax, sibs, wu):
                if regrows >= max_regrow:
                    raise RuntimeError(
                        "overlap-tree capacities failed to converge after "
                        f"{max_regrow} regrows")
                regrows += 1
                # escalating headroom: on a thermalizing system every
                # capacity channel drifts up together, and each regrow
                # costs a full recompile — growing the margin per retry
                # collapses 5-6 incremental regrows into 2-3
                self._regrow(counts, nbmax, sibs, wu=wu,
                             headroom=min(1.3 * 1.25 ** (regrows - 1), 2.6))
                run = self.make_langevin_runner(dt, temperature, friction,
                                                neighbor_every=neighbor_every,
                                                mts_inner=mts_inner,
                                                scan_unroll=scan_unroll)
                continue  # retry the segment from (pos, vel, key)
            pos, vel, key = new_pos, new_vel, new_key
            energies.append(np.asarray(e))
            done += n
            if checkpoint_path is not None:
                from ..io.checkpoint import save_checkpoint
                save_checkpoint(checkpoint_path, done, pos, vel, key,
                                meta=dict(dt=dt, temperature=temperature,
                                          friction=friction,
                                          neighbor_every=neighbor_every,
                                          segment=segment, nsteps=nsteps))
            if report_interval:
                frames.append(np.asarray(pos))
                frame_steps.append(done)
                if reporter is not None:
                    reporter(done, pos, vel)
        elapsed = time.perf_counter() - t0
        out = dict(ns_day=nsteps * dt * 1e-3 / elapsed * 86400.0,
                   elapsed_s=elapsed, steps_per_s=nsteps / elapsed,
                   final_pos=pos, final_vel=vel, regrows=regrows,
                   energies=np.concatenate(energies),
                   tree_counts_max=counts, neighbor_max=int(nbmax),
                   overflow=False)
        if report_interval:
            out["frames"] = np.stack(frames)
            out["frame_steps"] = np.asarray(frame_steps)
        return out
