"""On-device padded neighbor lists for the tree build and MD loop.

The reference relies on OpenMM's neighbor-list tiles for its 2-body overlap
candidates and pair sweeps (reference GVolOverlapTree.cl:127-313,
OpenCLAGBNPKernels.cpp:3521-3530).  Here the analogue is a fixed-width half
list [N, kmax] rebuilt on device: candidate (i, j>i) pairs within rcut,
heavy atoms only (hydrogen Gaussians carry zero volume and can never form a
surviving overlap, gaussvol.cpp:132), padded with a validity mask and an
overflow indicator (the neighbor-list analogue of the PanicButton).

The tree's 2-body survival criterion implies a hard geometric cutoff:
s(V12) V12 > MIN_GVOL requires V12 > VOLMINA, i.e.
d^2 < ln(v1 v2 (df/pi)^1.5 / VOLMINA) / df; `tree_pair_cutoff` evaluates it
for the worst-case (largest) radii so the list provably misses no overlap.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..models.constants import KFC, PI, VOLMINA, sphere_volume


def tree_pair_cutoff(radii_large) -> float:
    """Max distance at which a 2-body overlap (largest radii) can survive."""
    rmax = float(np.max(np.asarray(radii_large)))
    v = sphere_volume(rmax)
    a = KFC / (rmax * rmax)
    df = 0.5 * a
    pref = v * v * (df / PI) ** 1.5
    if pref <= VOLMINA:
        return 0.0
    return math.sqrt(math.log(pref / VOLMINA) / df)


class CellGrid:
    """Static cell-grid plan for the O(N) neighbor build.

    The reference gets O(N) candidate generation from OpenMM's cell-based
    tile lists; this is the fixed-shape analogue: grid *dimensions and cell
    capacity* are static (sized on the host from initial positions, like the
    CPU sizing pre-pass) while the grid *origin follows the solute* on
    device (min of current positions), so rigid drift/rotation never
    invalidates the plan.  Atoms beyond the static extent clamp to edge
    cells — clamping only reduces cell-index separation, so no close pair
    is ever missed (false positives are filtered by the distance check);
    what clamping can do is overflow a cell's capacity, which is detected
    and reported through the neighbor-overflow channel so the MD
    PanicButton regrows the plan.
    """

    def __init__(self, positions, rcut: float, margin: float = 0.5,
                 ccap: int | None = None, heavy_mask=None):
        pos = np.asarray(positions)
        if heavy_mask is not None:
            pos_h = pos[np.asarray(heavy_mask)]
        else:
            pos_h = pos
        lo = pos.min(axis=0) - margin
        hi = pos.max(axis=0) + margin
        self.rcut = float(rcut)
        self.margin = float(margin)
        self.origin = lo
        self.dims = np.maximum(np.ceil((hi - lo) / rcut).astype(int), 1)
        if ccap is None:
            # measured occupancy on the initial configuration + headroom
            c = np.clip(((pos_h - lo) / rcut).astype(int), 0, self.dims - 1)
            cid = (c[:, 0] * self.dims[1] + c[:, 1]) * self.dims[2] + c[:, 2]
            seen = int(np.bincount(cid).max()) if len(cid) else 1
            ccap = max(8, int(np.ceil(seen * 1.5 / 8) * 8))
        self.ccap = int(ccap)
        self.ncells = int(self.dims.prod())
        # static 27-cell stencil
        o = np.array([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                      for dz in (-1, 0, 1)], np.int32)
        self.stencil = o

    def grown(self) -> "CellGrid":
        """Doubled cell capacity (PanicButton regrow)."""
        g = CellGrid.__new__(CellGrid)
        g.rcut, g.origin, g.dims = self.rcut, self.origin, self.dims
        g.margin = self.margin
        g.ccap = self.ccap * 2
        g.ncells, g.stencil = self.ncells, self.stencil
        return g


def cell_neighbor_pairs(pos, heavy_mask, rcut: float, kmax: int,
                        grid: CellGrid):
    """O(N)-scaling half neighbor list via the cell grid.

    Same contract as half_neighbor_pairs: flat i-major (pairs_i, pairs_j,
    pairs_valid, max_neighbors) with invalid slots j == i; max_neighbors
    additionally reports kmax+1 when a grid cell overflowed its capacity
    (some pairs may then be missing, so the segment must be retried).
    """
    n = pos.shape[0]
    dims = jnp.asarray(np.asarray(grid.dims), jnp.int32)
    ncells, ccap = grid.ncells, grid.ccap

    # solute-following origin: rigid drift costs nothing; only expansion
    # beyond the static extent clamps (and overflow-detects)
    origin = jnp.min(jnp.where(heavy_mask[:, None], pos,
                               jnp.max(pos, axis=0)[None, :]),
                     axis=0) - grid.margin
    c = jnp.clip(((pos - origin[None, :]) / grid.rcut).astype(jnp.int32),
                 0, dims[None, :] - 1)
    cid = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
    # hydrogens go to a trash cell: they never appear as candidates
    cid = jnp.where(heavy_mask, cid, ncells)

    counts = jax.ops.segment_sum(jnp.ones(n, jnp.int32), cid,
                                 num_segments=ncells + 1)
    starts = jnp.cumsum(counts) - counts
    order = jnp.argsort(cid).astype(jnp.int32)     # stable
    rank = jnp.arange(n, dtype=jnp.int32) - starts[cid[order]]
    # clamped-rank collisions just overwrite a slot; the overflow flag
    # below forces a retry with a grown capacity
    slot = cid[order] * ccap + jnp.minimum(rank, ccap - 1)
    table = jnp.full(((ncells + 1) * ccap,), n, jnp.int32)
    table = table.at[slot].set(order)
    table = table.reshape(ncells + 1, ccap).at[ncells].set(n)

    # 27-cell stencil; out-of-grid stencil cells point at the trash row
    nbr = c[:, None, :] + jnp.asarray(grid.stencil)[None, :, :]
    in_grid = jnp.all((nbr >= 0) & (nbr < dims[None, None, :]), axis=-1)
    nbr_cid = (nbr[..., 0] * dims[1] + nbr[..., 1]) * dims[2] + nbr[..., 2]
    nbr_cid = jnp.where(in_grid, nbr_cid, ncells)

    cand = table[nbr_cid].reshape(n, 27 * ccap)    # [N, 27*ccap]
    jj = jnp.arange(n, dtype=jnp.int32)
    cand_c = jnp.minimum(cand, n - 1)
    if n * 27 * ccap > (1 << 25):
        # huge systems: three [N, 27*ccap] component gathers instead of
        # one pos[cand_c] row gather that materializes [N*27*ccap, 3] (a
        # layout kept from a backend that padded the minor dim of 3; which
        # form wins on the GPU is an open measurement).
        d2 = None
        for k in range(3):
            dk = pos[:, k][cand_c] - pos[:, k][:, None]
            d2 = dk * dk if d2 is None else d2 + dk * dk
    else:
        delta = pos[cand_c] - pos[:, None, :]
        d2 = jnp.sum(delta * delta, axis=-1)
    ok = ((cand < n) & (cand > jj[:, None]) & (d2 < rcut * rcut)
          & heavy_mask[:, None])

    key = jnp.where(ok, cand, n).astype(jnp.int32)
    pj = jax.lax.sort(key, dimension=1)[:, :kmax]
    valid = pj < n
    pi = jnp.broadcast_to(jj[:, None], (n, kmax))
    pj = jnp.where(valid, pj, pi)
    nb = jnp.sum(ok, axis=1)
    cell_over = jnp.max(counts[:ncells]) > ccap
    max_neighbors = jnp.maximum(jnp.max(nb),
                                jnp.where(cell_over, kmax + 1, 0))
    return (pi.reshape(-1).astype(jnp.int32),
            pj.reshape(-1).astype(jnp.int32),
            valid.reshape(-1),
            max_neighbors)


def half_neighbor_pairs(pos, heavy_mask, rcut: float, kmax: int):
    """Fixed-width half neighbor list as flat i-major candidate pairs.

    Returns (pairs_i [N*kmax], pairs_j, pairs_valid, max_neighbors).
    Invalid slots have pairs_j == pairs_i (masked out downstream).
    max_neighbors > kmax signals overflow.
    """
    n = pos.shape[0]
    dist = pos[None, :, :] - pos[:, None, :]
    d2 = jnp.sum(dist * dist, axis=-1)
    jj = jnp.arange(n)
    pair_ok = ((jj[None, :] > jj[:, None])
               & (d2 < rcut * rcut)
               & heavy_mask[:, None] & heavy_mask[None, :])
    # ascending-j order with invalid slots pushed to the end; the key IS the
    # neighbor index, so a value sort yields pj directly (no [N, kmax]
    # take_along_axis gather, which dominated the rebuild cost)
    key = jnp.where(pair_ok, jj[None, :], n).astype(jnp.int32)
    pj = jax.lax.sort(key, dimension=1)[:, :kmax]
    valid = pj < n
    pi = jnp.broadcast_to(jj[:, None], (n, kmax))
    pj = jnp.where(valid, pj, pi)
    max_neighbors = jnp.max(jnp.sum(pair_ok, axis=1))
    return (pi.reshape(-1).astype(jnp.int32),
            pj.reshape(-1).astype(jnp.int32),
            valid.reshape(-1),
            max_neighbors)
