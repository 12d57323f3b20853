"""Flattened fixed-shape Gaussian overlap tree (JAX/XLA).

Array-level redesign of the reference's recursive overlap tree
(reference: gaussvol/gaussvol.cpp:103-519 for the CPU recursion and
platforms/opencl/src/kernels/GVolOverlapTree.cl / GVolSelfVolume.cl for the
GPU work-group version).  Instead of pointer-chasing recursion or spin-lock
tree sections, each overlap level k (2..MAX_ORDER) is a dense padded array of
nodes with a validity mask:

  level k arrays [cap_k]: atom (last atom of the k-tuple), parent (index into
  the level k-1 arrays), product Gaussian (gv, ga, gc), switched volume,
  switch chain factor sfp, dV/dV_parent (dvv1), position-gradient piece dv1,
  gamma sum gamma1i, valid.

Construction is level-synchronous: level-(k+1) candidates are sibling pairs
(nodes sharing a parent) enumerated with a static per-level sibling-offset
window, overlapped with the partner's last-atom Gaussian (whose atomic row
is carried in the level so the enumeration needs no dynamic gather), pruned
by the switching threshold, and compacted into the next level's capacity by
a vectorized per-row sort plus an O(rows) scatter-cumsum slot map
(_compact_rows) — no O(candidates) scatter or gather anywhere.  Each level
is kept grouped by parent and volume-sorted within the
group — the same descending-volume sibling order the reference fixes at
creation (add_children, gaussvol.cpp:169-171) — because the sort decides
under which sibling each deeper overlap is materialized and therefore which
sibling pairs get enumerated next; with it, the materialized node sets match
the reference exactly (verified node-for-node on the shipped fixtures).

The bottom-up volume/energy/gradient reduction
(gaussvol.cpp:400-519, GVolSelfVolume.cl:9-202) becomes per-level
segment-sums: children's (psi, F, P) accumulators are gathered into parents
level by level; the fixed-point atomic adds of the GPU version become
`jax.ops.segment_sum`s (on the GPU these lower to float atomic
scatter-adds, so the summation order, and the last bits, can change from
run to run).

Capacity overflow is detected and reported (the PanicButton analogue,
OpenCLAGBNPKernels.cpp:3598-3634): the host checks the returned diagnostics
and rebuilds with larger capacities.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models.constants import MAX_ORDER
from .gaussians import atomic_gaussian_exponent, ogauss, survives

# Levels 2..MAX_ORDER are stored; index l in tuples below is level l+2.
NUM_TREE_LEVELS = MAX_ORDER - 1  # 7

@dataclasses.dataclass(frozen=True)
class TreeComm:
    """Collective hooks that let the fixed-topology passes run on row
    BLOCKS of the level arrays inside jax.shard_map (multi-chip tree
    decomposition, parallel/sharding.py::sharded_energy_forces).

    The downward rescans keep the parent level replicated (all_gather of
    each level's freshly computed block) so the per-row parent gathers stay
    local; the upward reductions segment-sum each device's rows into the
    full parent space and reduce across devices — psum_scatter back to
    blocks between levels, a plain psum at the atom level where the
    results (energy, deposits, level-1 accumulators) must be replicated.
    This is the multi-chip analogue of the reference's tree sections
    (one section per compute unit, OpenCLAGBNPKernels.cpp:75-195), with
    XLA collectives replacing shared global memory.
    """

    axis: str
    ndev: int

    def full(self, x):
        """Row block -> replicated full rows."""
        return jax.lax.all_gather(x, self.axis, axis=0, tiled=True)

    def reduce_blocks(self, x):
        """Full-space partial sums -> this device's row block of the total."""
        return jax.lax.psum_scatter(x, self.axis, scatter_dimension=0,
                                    tiled=True)

    def reduce_full(self, x):
        """Full-space partial sums -> replicated total."""
        return jax.lax.psum(x, self.axis)


@dataclasses.dataclass(frozen=True)
class TreeCaps:
    """Static per-level capacities and sibling-offset windows.

    caps[l]: max nodes at level l+2.
    offs[l]: max sibling offset used when generating level l+3 from level l+2
             (must be >= max surviving children-per-parent minus one).

    Defaults derived from measured overlap statistics on the reference's
    shipped systems (trpcage, 1li2 at large radii) with ~1.6x headroom, in
    the spirit of the reference's tree_size_boost
    (OpenCLAGBNPKernels.h:145).
    """

    caps: tuple
    offs: tuple

    @staticmethod
    def for_natoms(natoms: int, boost: float = 1.0) -> "TreeCaps":
        def r(x, align=128):
            v = int(np.ceil(x * boost))
            return max(align, (v + align - 1) // align * align)

        caps = (r(12 * natoms), r(28 * natoms), r(26 * natoms),
                r(14 * natoms), r(5 * natoms), r(1 * natoms), r(natoms // 2))
        offs = (48, 32, 24, 16, 8, 4)
        return TreeCaps(caps=caps, offs=offs)

    def grow(self, level_overflows, sib_overflows=None) -> "TreeCaps":
        """Double capacities/windows of overflowed levels (PanicButton
        resize, OpenCLAGBNPKernels.cpp:340-343)."""
        caps = tuple(c * 2 if ov else c
                     for c, ov in zip(self.caps, level_overflows))
        offs = self.offs
        if sib_overflows is not None:
            offs = tuple(o * 2 if ov else o
                         for o, ov in zip(self.offs, sib_overflows))
        return TreeCaps(caps=caps, offs=offs)


def make_level1(pos, radius, volume, gamma, ishydrogen):
    """Level-1 (atomic) node arrays.

    Mirrors init_overlap_tree's 1-body seeding (gaussvol.cpp:129-148):
    a = KFC/r^2, volume zeroed for hydrogens.
    """
    vol = jnp.where(ishydrogen > 0, 0.0, volume)
    ga = atomic_gaussian_exponent(radius)
    at = jnp.concatenate([vol[:, None], ga[:, None], pos, gamma[:, None]],
                         axis=1)  # packed [N, 6]: gv, ga, gc, gamma
    return dict(gv=vol, ga=ga, gc=pos, gamma1i=gamma, _at=at)


# Packed per-level float layout [cap, 13]:
#   0 gv, 1 ga, 2:5 gc, 5 volume(switched), 6 sfp, 7 dvv1, 8:11 dv1,
#   11 gamma1i, 12 ai (atomic exponent of the last atom)
# Keeping every per-node float in ONE matrix means each pipeline stage
# (candidate math, compaction gather, sort gather, mask) is a single fused
# XLA op instead of one per field.  Column 12 duplicates level1.ga[atom] so
# the bottom-up reduction never re-gathers it: the value rides in the
# already-gathered row instead of costing a fresh [cap] gather.
_D = 13


def _level_views(dat, ints, valid):
    return dict(_dat=dat, _ints=ints, atom=ints[:, 0], parent=ints[:, 1],
                valid=valid,
                gv=dat[:, 0], ga=dat[:, 1], gc=dat[:, 2:5],
                volume=dat[:, 5], sfp=dat[:, 6], dvv1=dat[:, 7],
                dv1=dat[:, 8:11], gamma1i=dat[:, 11], ai=dat[:, 12])


def _cand_dat(s_gv, s_ga, s_gc, s_gamma, a):
    """Packed 2-Gaussian product: s-side scalars x atomic packed rows
    (a[..., 6]: gv, ga, gc, gamma).  Returns (dat[..., _D], sgvol)."""
    from ..models.constants import PI
    from .gaussians import pol_switchfunc

    a_gv = a[..., 0]
    a_ga = a[..., 1]
    a_gc = a[..., 2:5]
    dist = a_gc - s_gc
    d2 = jnp.sum(dist * dist, axis=-1)
    # Degenerate (zero-padded) rows — both-side zeros in the build's
    # sibling windows, or an EMPTY level's row 0 that a rescan gathers as
    # every invalid node's parent — would produce df = 0*inf = NaN and
    # (PI/df)^1.5 = inf.  The primal masks them downstream, but jax.grad
    # multiplies their NaN/inf partials by zero cotangents (NaN again),
    # poisoning the whole position gradient (observed: AGBNP2 autodiff
    # forces on trees with empty deep levels).  Guard every division so
    # both the primal AND its linearization stay finite on junk rows.
    a12 = s_ga + a_ga
    ok = (s_ga > 0.0) & (a_ga > 0.0)
    deltai = 1.0 / jnp.where(a12 > 0.0, a12, 1.0)
    df = s_ga * a_ga * deltai
    ef = jnp.exp(-df * d2)
    df_safe = jnp.where(ok, df, 1.0)
    gvol = jnp.where(ok, (s_gv * a_gv * (df_safe / PI) ** 1.5) * ef, 0.0)
    dgvol = -2.0 * df * gvol
    dgvolv = jnp.where(s_gv > 0, gvol / jnp.where(s_gv > 0, s_gv, 1.0), 0.0)
    gc12 = (s_gc * s_ga[..., None] + a_gc * a_ga[..., None]) * deltai[..., None]
    s, sp = pol_switchfunc(gvol)
    sgvol = s * gvol
    sfp = sp * gvol + s
    dv1 = dist * (-dgvol)[..., None]
    dat = jnp.concatenate([
        gvol[..., None], a12[..., None], gc12, sgvol[..., None],
        sfp[..., None], dgvolv[..., None], dv1,
        (s_gamma + a[..., 5])[..., None],
        jnp.broadcast_to(a_ga, gvol.shape)[..., None],   # ai passthrough
    ], axis=-1)
    return dat, sgvol


def _compact(mask, cand_dat, cand_ints, cap, parent_cap):
    """Pack masked candidates into a fixed-capacity level, grouped by parent
    and volume-sorted within each group.

    The descending-volume sibling order matters: it decides under which
    sibling each next-level overlap is materialized (add_children sorts
    children by volume, gaussvol.cpp:169-171), and because overlap volumes
    are not monotone with order for closely-packed atoms, the attachment
    changes which sibling pairs are enumerated at the next level.
    """
    count = jnp.sum(mask)
    idx = jnp.nonzero(mask, size=cap, fill_value=0)[0]
    valid = jnp.arange(cap) < count

    parent_key = jnp.where(valid, cand_ints[:, 1][idx], parent_cap)
    vol_key = jnp.where(valid, cand_dat[:, 5][idx], 0.0)
    perm = jnp.lexsort((-vol_key, parent_key))
    idx = idx[perm]
    # invalid slots carry the max parent sentinel, so the stable sort keeps
    # them at the tail and the validity prefix is unchanged by the perm

    dat = jnp.where(valid[:, None], cand_dat[idx], 0.0)
    ints = jnp.where(valid[:, None], cand_ints[idx], 0)
    lvl = _level_views(dat, ints, valid)
    # monotone segment-id vector of the packed (parent-sorted) layout, so
    # the upward reductions use the same sorted-scatter path as
    # _compact_rows (only pmono is consumed downstream)
    lvl["bnd"] = dict(pmono=jax.lax.cummax(
        jnp.where(valid, lvl["parent"], 0)))
    return lvl, count


def _survive_mask(dat, sgvol, relax):
    """Node survival.  relax=None reproduces the reference pruning
    (switched volume > FLT_MIN, gaussvol.cpp:233); relax<1 keeps nodes with
    raw volume > VOLMINA*relax as zero-contribution "birth margin" slots so
    a stale topology stays exact while volumes drift across the switching
    threshold (used by the rebuild-every-K MD mode)."""
    from ..models.constants import VOLMINA

    if relax is None:
        return survives(sgvol)
    return dat[..., 0] > VOLMINA * relax


def _pair_candidates(level1, pairs_i, pairs_j, pairs_valid=None, relax=None):
    """2-body overlaps for the given (i, j) candidate pairs (i-major order)."""
    at = level1["_at"]
    si = at[pairs_i]
    dat, sgvol = _cand_dat(si[:, 0], si[:, 1], si[:, 2:5], si[:, 5],
                           at[pairs_j])
    mask = _survive_mask(dat, sgvol, relax)
    if pairs_valid is not None:
        mask = mask & pairs_valid
    ints = jnp.stack([pairs_j, pairs_i], axis=1).astype(jnp.int32)
    return dat, ints, mask


def _compact_rows(key, mask, cap):
    """Row-structured compaction: pack survivors of a [rows, width] candidate
    grid into a fixed-cap level, row-grouped with key-descending order within
    each row (rows are parents, so this reproduces _compact's
    (parent asc, volume desc) order without any O(rows*width) scatter/gather:
    one vectorized per-row sort + O(rows) scatter + O(cap) gathers).

    Returns (row_of_slot, off_of_slot, valid, count, cnt, bnd) where off is
    the within-row candidate offset, so the flat candidate index is
    row * width + off.  bnd carries pmono, the monotone per-parent segment-id
    vector of the packed layout — a free byproduct of the compaction that
    the sorted-scatter upward reductions consume.
    """
    rows, width = key.shape
    iw = jnp.arange(width, dtype=jnp.int32)
    skey = jnp.where(mask, -key, jnp.inf)
    _, off_sorted = jax.lax.sort(
        (skey, jnp.broadcast_to(iw[None, :], (rows, width))),
        dimension=1, num_keys=1, is_stable=True)
    cnt = jnp.sum(mask, axis=1).astype(jnp.int32)
    ends = jnp.cumsum(cnt)
    starts = ends - cnt
    count = ends[-1]
    # row id per output slot: +1 at every row start (duplicates from empty
    # rows make the running count skip them), then an inclusive scan
    marks = jnp.zeros(cap, jnp.int32).at[starts].add(1, mode="drop")
    slot = jnp.arange(cap, dtype=jnp.int32)
    row = jnp.clip(jnp.cumsum(marks) - 1, 0, rows - 1)
    pos = slot - starts[row]
    off = off_sorted.reshape(-1)[row * width + jnp.clip(pos, 0, width - 1)]
    valid = slot < count
    # row is monotone nondecreasing over ALL slots (including the invalid
    # tail), so it doubles as the sorted segment-id vector for the upward
    # reductions (invalid rows carry zero data)
    bnd = dict(pmono=row)
    return row, off, valid, count, cnt, bnd


# Sibling-level build memory budgets.  The one-shot build materializes
# [cap_prev, offs] candidate tensors (a _D-float packed row plus the
# partner's 6-float atomic row and 3 ints per candidate); the chunked build
# streams the candidate math through a lax.scan and recomputes only the
# `cap` surviving rows, bounding memory by the chunk size at some extra
# cost.  build_tree chunks only when the WHOLE build's candidates exceed
# _SLICE_BUILD_TOTAL, and then chunks each level above _CHUNK_LEVEL_MIN
# (a level-local call without the whole-build view chunks above
# _CHUNK_BUILD_ELEMS).  The three budgets are candidate counts derived at
# trace time from the device's memory limit and the candidate row bytes
# (_build_budgets); a module attribute set to an int overrides its budget
# (tests force the chunked path that way).
_CHUNK_BUILD_ELEMS = None
_CHUNK_LEVEL_MIN = None
_SLICE_BUILD_TOTAL = None
# Shares of the device memory limit the one-shot candidate tensors may take.
_SLICE_BUILD_SHARE = 1 / 4
_CHUNK_BUILD_SHARE = 1 / 8
_CHUNK_LEVEL_SHARE = 1 / 16
# Memory limit assumed where the device reports none (the CPU backend, which
# the tests run on): a budget for host RAM, not for any accelerator.
_HOST_MEMORY_BYTES = 8 << 30
_CHUNK_ROWS = 1 << 16


def _candidate_row_bytes(dtype) -> int:
    """Unpadded bytes of one sibling-build candidate: the packed _D-float
    node row, the partner's 6-float atomic row and 3 int32 index fields."""
    return (_D + 6) * np.dtype(dtype).itemsize + 3 * 4


def _build_budgets(dtype) -> tuple:
    """(slice_total, chunk_level_min, chunk_build_elems) candidate budgets
    from the default device's memory limit; module attributes that are set
    override their budget."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = int(stats.get("bytes_limit", _HOST_MEMORY_BYTES))
    per = _candidate_row_bytes(dtype)

    def budget(override, share):
        return int(limit * share) // per if override is None else override

    return (budget(_SLICE_BUILD_TOTAL, _SLICE_BUILD_SHARE),
            budget(_CHUNK_LEVEL_MIN, _CHUNK_LEVEL_SHARE),
            budget(_CHUNK_BUILD_ELEMS, _CHUNK_BUILD_SHARE))


def _build_sibling_level(prev_lvl, prev_a6, level1, offs, cap, relax,
                         pressured=None):
    """Next-level build without O(ncand) gathers: the partner's atomic row
    comes from a shifted window of the level's own carried atomic matrix
    (prev_a6[s] == level1._at[atom_s]) instead of a dynamic gather, and
    compaction uses _compact_rows.  Returns (lvl, a6, count, max_sib).

    pressured: whether the whole build exceeds the one-shot memory budget
    (computed by build_tree); None falls back to the per-level threshold
    alone."""
    cap_prev = prev_lvl["_dat"].shape[0]
    elems = cap_prev * offs
    _, level_min, build_elems = _build_budgets(prev_lvl["_dat"].dtype)
    chunk = (elems > build_elems if pressured is None
             else pressured and elems > level_min)
    if chunk:
        return _build_sibling_level_chunked(prev_lvl, prev_a6, level1,
                                            offs, cap, relax)
    src_i = jnp.concatenate(
        [prev_lvl["_ints"], prev_lvl["valid"][:, None].astype(jnp.int32)],
        axis=1)
    srcp_i = jnp.pad(src_i, ((0, offs), (0, 0)), constant_values=-1)
    win_i = jnp.stack([srcp_i[o:o + cap_prev] for o in range(1, offs + 1)],
                      axis=1)  # [cap_prev, offs, 3]
    srcp_a = jnp.pad(prev_a6, ((0, offs), (0, 0)))
    win_a = jnp.stack([srcp_a[o:o + cap_prev] for o in range(1, offs + 1)],
                      axis=1)  # [cap_prev, offs, 6]
    pair_ok = ((win_i[:, :, 2] > 0)
               & prev_lvl["valid"][:, None]
               & (win_i[:, :, 1] == prev_lvl["parent"][:, None]))

    dat_s = prev_lvl["_dat"]
    dat, sgvol = _cand_dat(dat_s[:, 0:1], dat_s[:, 1:2],
                           dat_s[:, None, 2:5], dat_s[:, 11:12], win_a)
    mask = pair_ok & _survive_mask(dat, sgvol, relax)

    row, off, valid, count, cnt, bnd = _compact_rows(dat[:, :, 5], mask, cap)
    idx = row * offs + off
    out_dat = jnp.where(valid[:, None], dat.reshape(cap_prev * offs, _D)[idx],
                        0.0)
    atom2 = jnp.where(valid, win_i[:, :, 0].reshape(-1)[idx], 0)
    ints = jnp.stack([atom2, jnp.where(valid, row, 0)], axis=1)     .astype(jnp.int32)
    a6 = level1["_at"][atom2]
    lvl = _level_views(out_dat, ints, valid)
    lvl["bnd"] = bnd
    return lvl, a6, count, jnp.max(cnt)


def _build_sibling_level_chunked(prev_lvl, prev_a6, level1, offs, cap,
                                 relax):
    """Memory-bounded variant of _build_sibling_level for huge levels.

    Phase 1 scans the rows in _CHUNK_ROWS blocks, computing per row only
    the survivor mask, the volume-descending within-row candidate order,
    and the survivor count — never materializing the full
    [cap_prev, offs, _D] candidate tensor.  Phase 2 is the _compact_rows
    cumsum placement on the counts.  Phase 3 recomputes the 2-Gaussian
    candidate data (deterministic) for just the `cap` selected slots.
    Same node set, order, and packed layout as the one-shot path
    (tests force the dispatch threshold down to cross-check them)."""
    cap_prev = prev_lvl["_dat"].shape[0]
    src_i = jnp.concatenate(
        [prev_lvl["_ints"], prev_lvl["valid"][:, None].astype(jnp.int32)],
        axis=1)
    srcp_i = jnp.pad(src_i, ((0, offs), (0, 0)), constant_values=-1)
    srcp_a = jnp.pad(prev_a6, ((0, offs), (0, 0)))

    B = min(_CHUNK_ROWS, cap_prev)
    nblk = -(-cap_prev // B)
    capp = nblk * B
    padr = capp - cap_prev
    dat_s = jnp.pad(prev_lvl["_dat"], ((0, padr), (0, 0)))
    parent_p = jnp.pad(prev_lvl["parent"], (0, padr))
    valid_p = jnp.pad(prev_lvl["valid"], (0, padr))
    ow = jnp.arange(1, offs + 1, dtype=jnp.int32)
    iw = jnp.arange(offs, dtype=jnp.int32)

    def blk(carry, start):
        rows = jax.lax.dynamic_slice_in_dim(dat_s, start, B)
        par = jax.lax.dynamic_slice_in_dim(parent_p, start, B)
        val = jax.lax.dynamic_slice_in_dim(valid_p, start, B)
        idxw = (start + jnp.arange(B, dtype=jnp.int32))[:, None] + ow[None, :]
        wi = srcp_i[jnp.minimum(idxw, srcp_i.shape[0] - 1)]
        wa = srcp_a[jnp.minimum(idxw, srcp_a.shape[0] - 1)]
        pair_ok = ((wi[:, :, 2] > 0) & val[:, None]
                   & (wi[:, :, 1] == par[:, None]))
        dat, sgvol = _cand_dat(rows[:, 0:1], rows[:, 1:2],
                               rows[:, None, 2:5], rows[:, 11:12], wa)
        m = pair_ok & _survive_mask(dat, sgvol, relax)
        skey = jnp.where(m, -dat[:, :, 5], jnp.inf)
        _, off_sorted = jax.lax.sort(
            (skey, jnp.broadcast_to(iw[None, :], (B, offs))),
            dimension=1, num_keys=1, is_stable=True)
        return carry, (off_sorted, jnp.sum(m, axis=1).astype(jnp.int32))

    starts = (jnp.arange(nblk, dtype=jnp.int32) * B)
    _, (off_sorted, cnt) = jax.lax.scan(blk, 0, starts)
    off_sorted = off_sorted.reshape(capp, offs)
    cnt = cnt.reshape(capp)

    # _compact_rows placement on the counts (padded rows have cnt == 0)
    ends = jnp.cumsum(cnt)
    starts_r = ends - cnt
    count = ends[-1]
    marks = jnp.zeros(cap, jnp.int32).at[starts_r].add(1, mode="drop")
    slot = jnp.arange(cap, dtype=jnp.int32)
    row = jnp.clip(jnp.cumsum(marks) - 1, 0, cap_prev - 1)
    pos = slot - starts_r[row]
    off = off_sorted.reshape(-1)[row * offs + jnp.clip(pos, 0, offs - 1)]
    valid = slot < count

    # recompute candidate data for the selected slots only
    src_idx = jnp.where(valid, row + 1 + off, 0)
    partner_a = srcp_a[src_idx]                      # [cap, 6]
    atom2 = jnp.where(valid, srcp_i[src_idx, 0], 0)
    rows_sel = dat_s[row]
    dat_sel, _ = _cand_dat(rows_sel[:, 0:1], rows_sel[:, 1:2],
                           rows_sel[:, None, 2:5], rows_sel[:, 11:12],
                           partner_a[:, None, :])
    out_dat = jnp.where(valid[:, None], dat_sel[:, 0, :], 0.0)
    ints = jnp.stack([atom2, jnp.where(valid, row, 0)], axis=1)     .astype(jnp.int32)
    a6 = level1["_at"][atom2]
    lvl = _level_views(out_dat, ints, valid)
    lvl["bnd"] = dict(pmono=row)
    return lvl, a6, count, jnp.max(cnt)


def _build_pair_level(level1, pj2d, pv2d, cap, relax):
    """Level-2 build from a fixed-width i-major neighbor grid [N, kmax]
    (half_neighbor_pairs layout): the i side is a broadcast, not a gather,
    and compaction is row-structured.  Returns (lvl, a6, count, max_sib)."""
    at = level1["_at"]
    n, kmax = pj2d.shape
    a = at[pj2d]  # [n, kmax, 6] — the one unavoidable gather
    dat, sgvol = _cand_dat(at[:, 0:1], at[:, 1:2], at[:, None, 2:5],
                           at[:, 5:6], a)
    mask = _survive_mask(dat, sgvol, relax)
    if pv2d is not None:
        mask = mask & pv2d

    row, off, valid, count, cnt, bnd = _compact_rows(dat[:, :, 5], mask, cap)
    idx = row * kmax + off
    out_dat = jnp.where(valid[:, None], dat.reshape(n * kmax, _D)[idx], 0.0)
    atom2 = jnp.where(valid, pj2d.reshape(-1)[idx], 0)
    ints = jnp.stack([atom2, jnp.where(valid, row, 0)], axis=1)     .astype(jnp.int32)
    a6 = at[atom2]
    lvl = _level_views(out_dat, ints, valid)
    lvl["bnd"] = bnd
    return lvl, a6, count, jnp.max(cnt)


def _max_siblings(level, parent_cap):
    """Largest number of surviving children under one parent."""
    cnt = jax.ops.segment_sum(level["valid"].astype(jnp.int32),
                              level["parent"], num_segments=parent_cap)
    return jnp.max(cnt)


def build_tree(level1, pairs_i, pairs_j, caps: TreeCaps, pairs_valid=None,
               relax=None, pair_rows: bool = False):
    """Builds all overlap levels 2..MAX_ORDER.

    pairs_i/pairs_j: candidate 2-body pairs (i < j), i-major order — from an
    all-pairs enumeration or a padded neighbor list (pairs_valid masks the
    list's padding slots; when the list is the fixed-width [N, kmax] grid of
    half_neighbor_pairs, level 2 takes the gather-free row path).  Returns
    (levels, diag) where diag carries per-level counts and overflow
    indicators.
    """
    natoms = level1["gv"].shape[0]
    levels = []
    counts = []
    sib_max = []

    if pair_rows:
        pj2d = pairs_j.reshape(natoms, -1)
        pv2d = None if pairs_valid is None else pairs_valid.reshape(natoms, -1)
        lvl, a6, count, msib = _build_pair_level(level1, pj2d, pv2d,
                                                 caps.caps[0], relax)
    else:
        dat, cints, mask = _pair_candidates(level1, pairs_i, pairs_j,
                                            pairs_valid, relax)
        lvl, count = _compact(mask, dat, cints, caps.caps[0], natoms)
        a6 = level1["_at"][lvl["atom"]]
        msib = _max_siblings(lvl, natoms)
    levels.append(lvl)
    counts.append(count)
    sib_max.append(msib)

    total_cand = sum(c * o for c, o in zip(caps.caps[:-1], caps.offs))
    pressured = total_cand > _build_budgets(level1["gv"].dtype)[0]
    for l in range(1, NUM_TREE_LEVELS):
        lvl, a6, count, msib = _build_sibling_level(
            levels[-1], a6, level1, caps.offs[l - 1], caps.caps[l], relax,
            pressured=pressured)
        levels.append(lvl)
        counts.append(count)
        sib_max.append(msib)

    diag = dict(
        counts=jnp.stack(counts),
        caps=jnp.array(caps.caps),
        max_siblings=jnp.stack(sib_max),
        offs=jnp.array(caps.offs + (0,)),
    )
    return tuple(levels), diag


def merge_counts(a, b):
    """Elementwise max of two per-level overflow-count vectors (the
    per-step rescan counts and the window's build counts)."""
    return jnp.maximum(a.astype(jnp.int32), b.astype(jnp.int32))


def check_overflow(diag) -> dict:
    """Host-side PanicButton check. Returns numpy bools per level."""
    counts = np.asarray(diag["counts"])
    caps = np.asarray(diag["caps"])
    sibs = np.asarray(diag["max_siblings"])
    offs = np.asarray(diag["offs"])
    cap_overflow = counts > caps
    sib_overflow = np.zeros_like(cap_overflow)
    sib_overflow[:-1] = (sibs[:-1] - 1) > offs[:-1]
    return dict(cap_overflow=cap_overflow, sib_overflow=sib_overflow,
                any=bool(cap_overflow.any() or sib_overflow.any()))


def _parent_gather(x, lvl):
    """Gather parent rows x[parent] for a level.  With build boundaries the
    monotone segment-id vector (pmono) replaces the raw parent indices —
    identical rows for every valid slot, but monotone over the invalid tail
    too, so XLA's sorted-gather lowering applies.  Invalid slots read the
    last valid parent instead of row 0; their output is junk either way and
    every consumer masks by validity."""
    bnd = lvl.get("bnd")
    if bnd is not None:
        return x.at[bnd["pmono"]].get(indices_are_sorted=True)
    return x[lvl["parent"]]


def _upward_segment_sum(x, lvl, num_parents):
    """The per-level child -> parent reduction of x [cap, C].

    When the level carries build boundaries (bnd), the monotone segment-id
    vector pmono lets XLA use the sorted-scatter lowering
    (indices_are_sorted).  Invalid tail rows carry zero data, so
    their carried-forward segment ids are harmless."""
    if "bnd" in lvl:
        return jax.ops.segment_sum(x, lvl["bnd"]["pmono"],
                                   num_segments=num_parents,
                                   indices_are_sorted=True)
    return jax.ops.segment_sum(x, lvl["parent"], num_segments=num_parents)


def tree_topology(levels):
    """Extract the shape-static topology (indices + validity) of a built
    tree; rescan_volumes reconstructs full levels from it, so the MD loop
    can carry just these small int arrays between rebuilds.  The build's
    segment boundaries ride along so the fixed-topology reduces keep the
    scan-based upward reduction."""
    out = []
    for l in levels:
        d = dict(_ints=l["_ints"], valid=l["valid"], atom=l["atom"],
                 parent=l["parent"])
        if "bnd" in l:
            d["bnd"] = l["bnd"]
        out.append(d)
    return tuple(out)


def compact_topology(levels, caps, relax: float = 0.5):
    """Compact a (rescanned) tree to the ancestor closure of its live rows.

    The vdW-channel tree passes — E_vol2 + self-volumes
    (ReferenceAGBNPKernels.cpp:358-384) and the WU gamma-rescan force pass
    (ReferenceAGBNPKernels.cpp:713-747) — run on the vdW-radii
    parameterization of the build topology, where only ~13-19% of rows
    have nonzero switched volume (the large parameterization keeps ~100%,
    so only the vdW channel compacts); a row with zero switched volume — and no
    live descendant — contributes exactly 0.0 to every reduction output
    (its psi/F/P columns and deposits all carry the switch factor), so
    dropping such rows is exact.  Keeping rows with raw volume >
    VOLMINA*relax (relax < 1) adds a birth margin: rows just under the
    switching threshold stay present so volume drift within an MD rebuild
    window crosses the switch smoothly inside the compacted set, the same
    error class as the window's topology staleness itself.

    `levels` must carry the target parameterization's volumes (a
    rescan_volumes result on the vdW level-1 data).  `caps` gives the
    static per-level compact capacities.  Returns (topology, counts) where
    topology is a tree_topology()-shaped tuple (parent indices remapped to
    compact coordinates, monotone pmono boundaries preserved — stable
    compaction of a parent-sorted level stays parent-sorted) usable
    directly by rescan_volumes/rescan_gammas/reduce_tree, and counts[7] is
    the pre-truncation kept-row count per level for overflow detection
    (count > cap means live rows were dropped: regrow).
    """
    from ..models.constants import VOLMINA

    keep = [l["valid"] & (l["gv"] > VOLMINA * relax) for l in levels]
    # ancestor closure: a kept row's parent chain must stay so parent
    # gathers and the downward gamma/volume chains remain intact (and so
    # dropped subtrees are all-dead, which is what makes dropping exact)
    for li in range(len(levels) - 1, 0, -1):
        up = jax.ops.segment_max(
            keep[li].astype(jnp.int32),
            jnp.where(keep[li], levels[li]["parent"], 0),
            num_segments=levels[li - 1]["valid"].shape[0])
        keep[li - 1] = keep[li - 1] | ((up > 0) & levels[li - 1]["valid"])

    counts = jnp.stack([jnp.sum(k) for k in keep])
    out = []
    prev_remap = None  # old parent index -> compact slot of previous level
    for li, (lvl, kp) in enumerate(zip(levels, keep)):
        cap = max(int(caps[li]), 8)
        sel = jnp.nonzero(kp, size=cap, fill_value=0)[0]
        valid = jnp.arange(cap) < jnp.minimum(counts[li], cap)
        atom = jnp.where(valid, lvl["atom"][sel], 0)
        parent = lvl["parent"][sel]
        if prev_remap is not None:
            parent = prev_remap[parent]
        parent = jnp.where(valid, parent, 0)
        out.append(dict(
            _ints=jnp.stack([atom, parent], axis=1).astype(jnp.int32),
            valid=valid, atom=atom, parent=parent,
            bnd=dict(pmono=jax.lax.cummax(parent))))
        prev_remap = jnp.cumsum(kp.astype(jnp.int32)) - 1
    return tuple(out), counts


def rescan_volumes(levels, level1, comm: TreeComm | None = None):
    """Recompute all node volumes/Gaussians on the fixed topology.

    The analogue of rescan_tree_v (gaussvol.cpp:254-327): new level-1 data
    (radii/volumes/gammas), same parent/atom indices, no re-pruning.
    Accepts full levels or a tree_topology() result.  With `comm`, the
    level arrays are per-device row blocks inside shard_map; each level's
    block is all_gathered so the next level's parent gathers see full rows.
    """
    new_levels = []
    # level-1 "dat" is the packed atomic table; map its columns to the same
    # (gv, ga, gc, gamma) positions the level matrices use
    prev_dat, cols = level1["_at"], (0, 1, 2, 11 - 6)
    for lvl in levels:
        sp = _parent_gather(prev_dat, lvl)
        g0, g1, gc0, gg = cols
        dat, _ = _cand_dat(sp[:, g0], sp[:, g1], sp[:, gc0:gc0 + 3],
                           sp[:, gg], level1["_at"][lvl["atom"]])
        # zero invalid rows like the build's _compact: junk would otherwise
        # compound down the parent chain (and poison jax.grad through the
        # masked-but-NaN-partial trap)
        dat = dat * lvl["valid"][:, None].astype(dat.dtype)
        nl = _level_views(dat, lvl["_ints"], lvl["valid"])
        if "bnd" in lvl:
            nl["bnd"] = lvl["bnd"]
        new_levels.append(nl)
        prev_dat = dat if comm is None else comm.full(dat)
        cols = (0, 1, 2, 11)
    return tuple(new_levels)


def rescan_gammas(levels, level1, comm: TreeComm | None = None):
    """Propagate new per-atom gammas down the fixed topology
    (rescan_tree_g, gaussvol.cpp:330-372).

    Layout note: the chain runs as 8-channel rows (gamma in column 0, zeros
    alongside), a layout kept from a backend where wide row gathers were
    cheaper per row than scalar ones; whether it pays on the GPU is an
    open measurement."""
    n = level1["gamma1i"].shape[0]
    dtype = level1["gamma1i"].dtype
    gam8 = jnp.concatenate([level1["gamma1i"][:, None],
                            jnp.zeros((n, 7), dtype)], axis=1)
    new_levels = []
    pg = gam8
    for lvl in levels:
        g8 = _parent_gather(pg, lvl) + gam8[lvl["atom"]]
        new_levels.append({**lvl, "gamma1i": g8[:, 0]})
        pg = g8 if comm is None else comm.full(g8)
    return tuple(new_levels)


def _deposit_sum(dep, atoms, natoms, lvl0):
    """The all-levels atom-deposit scatter of the bottom-up reduction."""
    return jax.ops.segment_sum(dep, atoms, num_segments=natoms)


def _pad8(x):
    """Zero-pad the channel axis to a multiple of 8: segment-sum scatters
    cost per ROW, so narrow rows are widened to 8 channels (a layout
    choice whose cost on the GPU is an open measurement)."""
    pad = (-x.shape[1]) % 8
    if pad == 0:
        return x
    return jnp.concatenate(
        [x, jnp.zeros((x.shape[0], pad), x.dtype)], axis=1)


def reduce_tree(levels, level1, with_selfvol: bool = True,
                with_freevol: bool = False, with_dv: bool = False,
                comm: TreeComm | None = None):
    """Bottom-up reduction: energy, gradients, self/free volumes.

    The flattened form of compute_volume_underslot2_r (gaussvol.cpp:400-519):
    for each level from the deepest up, per-node subtree accumulators are
    combined with the children's segment-summed accumulators, deposited onto
    the node's last atom, transformed by the (dv1, dvv1, a1/a1i) recursion
    and passed to the parents.

    Layout note: the gamma-weighted energy family needs the full
    (psi, F, P) chain (5 channels); the self/free-volume families only
    propagate their psi scalar (their F/P legs feed nothing downstream in
    the reference either), so all channels are packed into one [cap, C]
    matrix with ONE upward segment-sum and ONE atom-deposit segment-sum per
    level instead of one per quantity.

    Returns dict(energy, dr[, dv][, self_volume][, free_volume, volume]);
    dr is the energy gradient wrt positions (negate for force), dv the
    gradient wrt atomic volumes.  The gamma-rescan force passes
    (ReferenceAGBNPKernels.cpp:713-747) use with_selfvol=False.
    """
    natoms = level1["gv"].shape[0]
    dtype = level1["gv"].dtype

    # upward channels: [e_psi, e_f, e_px, e_py, e_pz] (+ sv_psi) (+ fv_psi)
    n_up = 5 + (1 if with_selfvol else 0) + (1 if with_freevol else 0)
    i_sv = 5
    i_fv = 5 + (1 if with_selfvol else 0)

    acc = None
    # deposit channels: [drx, dry, drz] (+ sv) (+ fv) (+ dv); all levels'
    # deposits are concatenated and scattered in ONE segment-sum at the end
    dep_rows = []
    dep_atoms = []

    for l in range(NUM_TREE_LEVELS - 1, -1, -1):
        lvl = levels[l]
        level_no = l + 2
        cf = -1.0 if level_no % 2 == 0 else 1.0
        volcoeffp = cf / level_no
        valid = lvl["valid"]
        vmask = valid.astype(dtype)

        ai = lvl["ai"]  # carried in the packed row; avoids a [cap] gather
        a1i = lvl["ga"]
        safe_a1i = jnp.where(valid, a1i, 1.0)
        c2 = ai / safe_a1i
        c2p = (a1i - ai) / safe_a1i

        gsfp = volcoeffp * lvl["sfp"] * lvl["gamma1i"]
        cols = [volcoeffp * lvl["gamma1i"] * lvl["volume"],   # e_psi
                gsfp]                                         # e_f
        cols += [jnp.zeros_like(gsfp)] * 3                    # e_p
        if with_selfvol:
            cols.append(volcoeffp * lvl["volume"])            # sv_psi
        if with_freevol:
            cols.append(cf * lvl["volume"])                   # fv_psi
        tot = jnp.stack(cols, axis=1) * vmask[:, None]
        if acc is not None:
            tot = tot + acc

        e_f = tot[:, 1]
        e_p = tot[:, 2:5]

        # deposits on the last atom, one packed segment-sum
        dr_dep = (-lvl["dv1"]) * e_f[:, None] + e_p * c2[:, None]
        dep_cols = [dr_dep]
        if with_selfvol:
            dep_cols.append(tot[:, i_sv:i_sv + 1])
        if with_freevol:
            dep_cols.append(tot[:, i_fv:i_fv + 1])
        if with_dv:
            dep_cols.append((lvl["gv"] * e_f)[:, None])
        dep_rows.append(jnp.concatenate(dep_cols, axis=1) * vmask[:, None])
        dep_atoms.append(lvl["atom"])

        # transform and pass up, one packed segment-sum
        p_out = lvl["dv1"] * e_f[:, None] + e_p * c2p[:, None]
        up = jnp.concatenate([
            tot[:, 0:1],                       # e_psi passes through
            (lvl["dvv1"] * e_f)[:, None],      # e_f
            p_out,                             # e_p
            tot[:, 5:],                        # sv/fv psi pass through
        ], axis=1) * vmask[:, None]
        nmul = 1 if comm is None else comm.ndev
        num_parents = natoms if l == 0 else (
            levels[l - 1]["valid"].shape[0] * nmul)
        acc = _upward_segment_sum(_pad8(up), lvl, num_parents)[:, :n_up]
        if comm is not None:
            # cross-device reduction of the full-parent-space partials:
            # back to this device's parent block between levels, replicated
            # at the atom level (the level-1 terms below run replicated)
            acc = (comm.reduce_full(acc) if l == 0
                   else comm.reduce_blocks(acc))

    deposits = _deposit_sum(_pad8(jnp.concatenate(dep_rows, axis=0)),
                            jnp.concatenate(dep_atoms, axis=0),
                            natoms, levels[0])
    if comm is not None:
        deposits = comm.reduce_full(deposits)

    # level 1 (atoms): volcoeff = volcoeffp = 1, sfp = 1, dvv1 = 1, dv1 = 0,
    # c2 = 1, c2p = 0 (gaussvol.cpp:413-435 with level == 1)
    gamma = level1["gamma1i"]
    vol = level1["gv"]

    e_psi = gamma * vol + acc[:, 0]
    e_f = gamma + acc[:, 1]
    dr = deposits[:, 0:3] + acc[:, 2:5]

    result = dict(energy=jnp.sum(e_psi), dr=dr)
    col = 3
    if with_selfvol:
        result["self_volume"] = vol + acc[:, i_sv] + deposits[:, col]
        col += 1
    if with_freevol:
        fv_psi = vol + acc[:, i_fv]
        result["free_volume"] = fv_psi + deposits[:, col]
        result["volume"] = jnp.sum(fv_psi)
        col += 1
    if with_dv:
        result["dv"] = vol * e_f + deposits[:, col]
    return result


def rescan_volumes2(levels, level1_a, level1_b,
                    comm: TreeComm | None = None):
    """Fixed-topology volume rescan for TWO parameterizations at once.

    The AGBNP cavity term evaluates the same topology twice (large radii,
    then vdW radii, ReferenceAGBNPKernels.cpp:293-384); fusing both into one
    sweep halves the gather/launch count: each level does ONE gather of the
    packed [cap, 2*_D] parent matrix and one of the [N, 12] atomic matrix.

    NOTE: invalid rows carry finite junk (every consumer masks by
    validity) — fine for the analytic force path this feeds; for
    jax.grad-through paths use rescan_volumes, which zeroes them.

    Returns (levels_a, levels_b).
    """
    out_a, out_b = [], []
    at2 = jnp.concatenate([level1_a["_at"], level1_b["_at"]], axis=1)  # [N,12]
    prev = at2
    prev_cols = ((0, 1, 2, 5), (6, 7, 8, 11))  # (gv, ga, gc0, gamma) per half
    for lvl in levels:
        sp = _parent_gather(prev, lvl)
        a2 = at2[lvl["atom"]]
        (ga0, ga1, gac, gag), (gb0, gb1, gbc, gbg) = prev_cols
        dat_a, _ = _cand_dat(sp[:, ga0], sp[:, ga1], sp[:, gac:gac + 3],
                             sp[:, gag], a2[:, 0:6])
        dat_b, _ = _cand_dat(sp[:, gb0], sp[:, gb1], sp[:, gbc:gbc + 3],
                             sp[:, gbg], a2[:, 6:12])
        la = _level_views(dat_a, lvl["_ints"], lvl["valid"])
        lb = _level_views(dat_b, lvl["_ints"], lvl["valid"])
        if "bnd" in lvl:
            la["bnd"] = lvl["bnd"]
            lb["bnd"] = lvl["bnd"]
        out_a.append(la)
        out_b.append(lb)
        prev = jnp.concatenate([dat_a, dat_b], axis=1)  # [cap, 2*_D]
        if comm is not None:
            prev = comm.full(prev)
        prev_cols = ((0, 1, 2, 11), (_D, _D + 1, _D + 2, _D + 11))
    return tuple(out_a), tuple(out_b)


def reduce_tree2(levels_a, levels_b, level1_a, level1_b,
                 with_selfvol_b: bool = True,
                 with_selfvol_a: bool = False,
                 comm: TreeComm | None = None):
    """Bottom-up reduction of two same-topology trees in one sweep.

    Packs both trees' accumulator channels into one matrix so each level
    runs a single upward segment-sum; deposits are batched into one scatter.
    Returns (result_a, result_b) like reduce_tree(with_selfvol=False) and
    reduce_tree(with_selfvol=with_selfvol_b).
    """
    natoms = level1_a["gv"].shape[0]
    dtype = level1_a["gv"].dtype
    nb = 5 + (1 if with_selfvol_b else 0)

    acc = None
    dep_rows = []
    dep_atoms = []

    for l in range(NUM_TREE_LEVELS - 1, -1, -1):
        la = levels_a[l]
        lb = levels_b[l]
        level_no = l + 2
        cf = -1.0 if level_no % 2 == 0 else 1.0
        volcoeffp = cf / level_no
        valid = la["valid"]
        vmask = valid.astype(dtype)

        cols = []
        for lv, l1 in ((la, level1_a), (lb, level1_b)):
            gsfp = volcoeffp * lv["sfp"] * lv["gamma1i"]
            cols += [volcoeffp * lv["gamma1i"] * lv["volume"], gsfp]
            cols += [jnp.zeros_like(gsfp)] * 3
        if with_selfvol_b:
            cols.append(volcoeffp * lb["volume"])
        if with_selfvol_a:
            cols.append(volcoeffp * la["volume"])
        tot = jnp.stack(cols, axis=1) * vmask[:, None]
        if acc is not None:
            tot = tot + acc

        dep_cols = []
        ups = []
        for base, lv, l1 in ((0, la, level1_a), (5, lb, level1_b)):
            e_f = tot[:, base + 1]
            e_p = tot[:, base + 2:base + 5]
            ai = lv["ai"]
            a1i = lv["ga"]
            safe = jnp.where(valid, a1i, 1.0)
            dep_cols.append((-lv["dv1"]) * e_f[:, None] + e_p * (ai / safe)[:, None])
            p_out = lv["dv1"] * e_f[:, None] + e_p * ((a1i - ai) / safe)[:, None]
            ups += [tot[:, base:base + 1], (lv["dvv1"] * e_f)[:, None], p_out]
        i_sva = 10 + (1 if with_selfvol_b else 0)
        if with_selfvol_b:
            dep_cols.append(tot[:, 10:11])
            ups.append(tot[:, 10:11])
        if with_selfvol_a:
            dep_cols.append(tot[:, i_sva:i_sva + 1])
            ups.append(tot[:, i_sva:i_sva + 1])
        dep_rows.append(jnp.concatenate(dep_cols, axis=1) * vmask[:, None])
        dep_atoms.append(la["atom"])

        up = jnp.concatenate(ups, axis=1) * vmask[:, None]
        nmul = 1 if comm is None else comm.ndev
        num_parents = natoms if l == 0 else (
            levels_a[l - 1]["valid"].shape[0] * nmul)
        acc = _upward_segment_sum(_pad8(up), la, num_parents)[:, :up.shape[1]]
        if comm is not None:
            acc = (comm.reduce_full(acc) if l == 0
                   else comm.reduce_blocks(acc))

    deposits = _deposit_sum(_pad8(jnp.concatenate(dep_rows, axis=0)),
                            jnp.concatenate(dep_atoms, axis=0),
                            natoms, levels_a[0])
    if comm is not None:
        deposits = comm.reduce_full(deposits)

    results = []
    for base, dbase, l1 in ((0, 0, level1_a), (5, 3, level1_b)):
        gamma = l1["gamma1i"]
        vol = l1["gv"]
        e_psi = gamma * vol + acc[:, base]
        dr = deposits[:, dbase:dbase + 3] + acc[:, base + 2:base + 5]
        results.append(dict(energy=jnp.sum(e_psi), dr=dr))
    if with_selfvol_b:
        results[1]["self_volume"] = (level1_b["gv"] + acc[:, 10]
                                     + deposits[:, 6])
    if with_selfvol_a:
        i_sva = 10 + (1 if with_selfvol_b else 0)
        results[0]["self_volume"] = (
            level1_a["gv"] + acc[:, i_sva]
            + deposits[:, 6 + (1 if with_selfvol_b else 0)])
    return results[0], results[1]
