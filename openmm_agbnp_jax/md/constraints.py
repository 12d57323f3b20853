"""Holonomic X-H distance constraints (SHAKE/RATTLE) as pure JAX updates.

The reference benchmark systems carry Desmond constraint tables
(constraint_ah{1,2,3}: one heavy atom + 1-3 hydrogens at fixed distances)
which the reference applies through DesmondDMSFile.createSystem(...)
(reference example/trpcage_benchmark.py:11) as OpenMM distance constraints;
its integrators then run SHAKE on positions and RATTLE on velocities each
step.

Those tables form a star forest — independent clusters of one heavy atom
X and up to 3 hydrogens, no constraint sharing between clusters — so the
coupled Lagrange system is block-diagonal with <=3x3 blocks.  The solver
here exploits that: RATTLE is a single exact batched 3x3 solve (the
velocity projection is linear), and SHAKE is Newton iteration with the
analytic 3x3 block inverse (quadratic convergence, 2-3 sweeps), both
fully vectorized over clusters with unique-index scatters.  This is the
same block-direct idea as OpenMM's CCMA, laid out for batched
dense algebra instead of a sparse matrix.  Systems whose constraint graph
is not a star forest fall back to the original global Jacobi iteration
under a lax.while_loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Every contraction here runs at full f32 (no TF32 on GPU tensor cores):
# the constraint solve targets a 1e-6 relative bond tolerance.
_HI = jax.lax.Precision.HIGHEST

_KMAX = 3  # constraint_ah1..3: at most 3 hydrogens per heavy atom


def _star_clusters(idx, d, masses):
    """Group [nc,2] (heavy, hydrogen) constraints into star clusters.

    Returns None unless every hydrogen appears exactly once, no atom is
    both heavy and hydrogen, and no heavy atom exceeds _KMAX hydrogens.
    """
    a, b = idx[:, 0], idx[:, 1]
    if len(set(b)) != len(b) or (set(a) & set(b)):
        return None
    order = np.argsort(a, kind="stable")
    groups = {}
    for k in order:
        groups.setdefault(int(a[k]), []).append(k)
    if max(len(g) for g in groups.values()) > _KMAX:
        return None
    ncl = len(groups)
    cx = np.zeros(ncl, np.int32)
    ch = np.zeros((ncl, _KMAX), np.int32)
    cd = np.ones((ncl, _KMAX), np.float64)
    cmask = np.zeros((ncl, _KMAX), bool)
    cimh = np.ones((ncl, _KMAX), np.float64)
    for i, (x, rows) in enumerate(sorted(groups.items())):
        cx[i] = x
        for j, k in enumerate(rows):
            ch[i, j] = b[k]
            cd[i, j] = d[k]
            cmask[i, j] = True
            cimh[i, j] = 1.0 / masses[b[k]]
    return dict(cx=cx, ch=ch, cd=cd, cmask=cmask,
                cimx=1.0 / masses[cx], cimh=cimh)


def _solve3(A, rhs):
    """Batched 3x3 solve by adjugate (vectorized, no LAPACK lowering)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    # Degenerate cluster geometry (collinear X-H bonds after a hard
    # collision) makes A singular; a sign-preserving determinant floor
    # keeps lambda finite so the Newton loop converges or hits max_iter
    # instead of silently exiting on NaN (the while_loop cond evaluates
    # False on NaN).  Mirrors the Jacobi path's denominator guard.
    scale = jnp.maximum(jnp.max(jnp.abs(A), axis=(-2, -1)) ** 3,
                        jnp.asarray(1e-30, A.dtype))
    floor = 1e-12 * scale
    det = jnp.where(jnp.abs(det) > floor,
                    det, jnp.where(det < 0, -floor, floor))
    x0 = co00 * rhs[..., 0] + co01 * rhs[..., 1] + co02 * rhs[..., 2]
    x1 = co10 * rhs[..., 0] + co11 * rhs[..., 1] + co12 * rhs[..., 2]
    x2 = co20 * rhs[..., 0] + co21 * rhs[..., 1] + co22 * rhs[..., 2]
    return jnp.stack([x0, x1, x2], axis=-1) / det[..., None]


class Constraints:
    """A fixed set of pairwise distance constraints.

    idx: [nc, 2] atom indices (heavy, hydrogen); d: [nc] target distances
    (nm); masses: [N].  tol is the relative distance tolerance (OpenMM
    integrator constraint-tolerance semantics).
    """

    def __init__(self, idx, d, masses, tol: float = 1e-8,
                 max_iter: int = 200):
        idx = np.asarray(idx, np.int32).reshape(-1, 2)
        self.n_constraints = idx.shape[0]
        self.a = jnp.asarray(idx[:, 0])
        self.b = jnp.asarray(idx[:, 1])
        self.d = jnp.asarray(np.asarray(d, np.float64))
        masses = np.asarray(masses, np.float64)
        self.inv_ma = jnp.asarray(1.0 / masses[idx[:, 0]])
        self.inv_mb = jnp.asarray(1.0 / masses[idx[:, 1]])
        self.tol = float(tol)
        self.max_iter = int(max_iter)
        self.clusters = None
        if self.n_constraints:
            cl = _star_clusters(np.asarray(idx, np.int64),
                                np.asarray(d, np.float64), masses)
            if cl is not None:
                self.clusters = {k: jnp.asarray(v) for k, v in cl.items()}

    def _tol(self, dtype):
        """Effective tolerance: the requested one, floored at what the
        compute dtype can express — in float32 a 1e-8 relative residual is
        below roundoff and the iteration would always run to max_iter."""
        return max(self.tol, 30.0 * float(jnp.finfo(dtype).eps))

    @staticmethod
    def from_dms(dms, tol: float = 1e-8):
        if dms.constraint_idx.size == 0:
            return None
        return Constraints(dms.constraint_idx, dms.constraint_d, dms.masses,
                           tol=tol)

    # ------------------------------------------------------------------
    # block-direct star-cluster solvers (the fast path)
    # ------------------------------------------------------------------

    def _cluster_fields(self, dtype):
        cl = self.clusters
        return (cl["cx"], cl["ch"], cl["cd"].astype(dtype),
                cl["cmask"], cl["cimx"].astype(dtype),
                cl["cimh"].astype(dtype))

    def _positions_clustered(self, x, x_ref):
        """SHAKE as Newton iteration with exact 3x3 block solves: each
        sweep solves the coupled linearized system of a whole cluster at
        once, so convergence is quadratic instead of Jacobi-linear."""
        cx, ch, d, mask, imx, imh = self._cluster_fields(x.dtype)
        d2 = d * d
        rref = x_ref[cx][:, None, :] - x_ref[ch]          # [ncl, K, 3]
        tol2 = 2.0 * self._tol(x.dtype)
        eye = jnp.eye(_KMAX, dtype=x.dtype)

        def residual(x):
            r = x[cx][:, None, :] - x[ch]
            return jnp.sum(r * r, axis=-1) - d2, r

        def cond(state):
            it, x = state
            diff, _ = residual(x)
            diff = jnp.where(mask, diff, 0.0)
            return (it < self.max_iter) & (
                jnp.max(jnp.abs(diff) / d2) > tol2)

        def body(state):
            it, x = state
            diff, r = residual(x)
            diff = jnp.where(mask, diff, 0.0)
            # A_ij = 2 [imX (r_i . rref_j) + delta_ij imH_i (r_i . rref_i)]
            rdot = jnp.einsum("cid,cjd->cij", r, rref, precision=_HI)
            diag = jnp.einsum("cid,cid->ci", r, rref, precision=_HI)
            # rotated-past-perpendicular guard (same as the Jacobi path)
            diag = jnp.where(jnp.abs(diag) > 1e-12 * d2, diag, d2)
            rdot = rdot * (1.0 - eye) + diag[:, :, None] * eye
            A = 2.0 * (imx[:, None, None] * rdot
                       + eye * (imh * diag)[:, :, None])
            # padded constraints: identity row/col, zero rhs -> lambda = 0
            pad = (mask[:, :, None] & mask[:, None, :])
            A = jnp.where(pad, A, eye)
            lam = _solve3(A, diff)
            lam = jnp.where(mask, lam, 0.0)
            dxh = lam[:, :, None] * rref                  # [ncl, K, 3]
            x = x.at[cx].add(-imx[:, None] * jnp.sum(dxh, axis=1))
            x = x.at[ch.reshape(-1)].add(
                (imh[:, :, None] * dxh).reshape(-1, 3))
            return it + 1, x

        _, x = jax.lax.while_loop(cond, body, (jnp.zeros((), jnp.int32), x))
        return x

    def _velocities_clustered(self, x, v):
        """RATTLE is linear in v: one exact block solve, no iteration."""
        cx, ch, d, mask, imx, imh = self._cluster_fields(v.dtype)
        d2 = d * d
        r = x[cx][:, None, :] - x[ch]                     # [ncl, K, 3]
        rv = jnp.einsum("cid,cid->ci", r, v[cx][:, None, :] - v[ch],
                        precision=_HI)
        rv = jnp.where(mask, rv, 0.0)
        eye = jnp.eye(_KMAX, dtype=v.dtype)
        rr = jnp.einsum("cid,cjd->cij", r, r, precision=_HI)
        A = (imx[:, None, None] * rr
             + eye * (imh * jnp.einsum("cid,cid->ci", r, r,
                                       precision=_HI))[:, :, None])
        pad = (mask[:, :, None] & mask[:, None, :])
        A = jnp.where(pad, A, eye)
        lam = _solve3(A, rv)
        lam = jnp.where(mask, lam, 0.0)
        dvh = lam[:, :, None] * r
        v = v.at[cx].add(-imx[:, None] * jnp.sum(dvh, axis=1))
        v = v.at[ch.reshape(-1)].add((imh[:, :, None] * dvh).reshape(-1, 3))
        return v

    # ------------------------------------------------------------------
    # public API (dispatches to the block solver when available)
    # ------------------------------------------------------------------

    def positions(self, x, x_ref):
        """SHAKE: project x onto the constraint manifold using reference
        directions from x_ref (the pre-step constrained positions)."""
        if self.n_constraints == 0:
            return x
        if self.clusters is not None:
            return self._positions_clustered(x, x_ref)
        a, b, d = self.a, self.b, self.d.astype(x.dtype)
        ima = self.inv_ma.astype(x.dtype)
        imb = self.inv_mb.astype(x.dtype)
        rref = x_ref[a] - x_ref[b]
        d2 = d * d
        # convergence measured as |r^2 - d^2| / (2 d^2) ~ relative distance
        # error, the OpenMM constraint-tolerance convention
        tol2 = 2.0 * self._tol(x.dtype)

        def residual(x):
            r = x[a] - x[b]
            return jnp.sum(r * r, axis=-1) - d2, r

        def cond(state):
            it, x = state
            diff, _ = residual(x)
            return (it < self.max_iter) & (
                jnp.max(jnp.abs(diff) / d2) > tol2)

        def body(state):
            it, x = state
            diff, r = residual(x)
            rr = jnp.sum(r * rref, axis=-1)
            # guard: if the bond rotated past perpendicular the linearized
            # step is invalid; fall back to the current direction
            rr = jnp.where(jnp.abs(rr) > 1e-12 * d2, rr, d2)
            g = diff / (2.0 * (ima + imb) * rr)
            dx = g[:, None] * rref
            x = x.at[a].add(-ima[:, None] * dx)
            x = x.at[b].add(imb[:, None] * dx)
            return it + 1, x

        _, x = jax.lax.while_loop(cond, body, (jnp.zeros((), jnp.int32), x))
        return x

    def velocities(self, x, v):
        """RATTLE: remove velocity components along the (current) constraint
        directions so d/dt |r|^2 = 0."""
        if self.n_constraints == 0:
            return v
        if self.clusters is not None:
            return self._velocities_clustered(x, v)
        a, b, d = self.a, self.b, self.d.astype(v.dtype)
        ima = self.inv_ma.astype(v.dtype)
        imb = self.inv_mb.astype(v.dtype)
        r = x[a] - x[b]
        d2 = d * d
        im = ima + imb

        def cdot(v):
            return jnp.sum(r * (v[a] - v[b]), axis=-1)

        # velocity tolerance: relative rate |r.dv| / d^2 (1/ps units)
        vtol = self._tol(v.dtype)

        def cond(state):
            it, v = state
            return (it < self.max_iter) & (
                jnp.max(jnp.abs(cdot(v)) / d2) > vtol)

        def body(state):
            it, v = state
            g = cdot(v) / (im * d2)
            dv = g[:, None] * r
            v = v.at[a].add(-ima[:, None] * dv)
            v = v.at[b].add(imb[:, None] * dv)
            return it + 1, v

        _, v = jax.lax.while_loop(cond, body, (jnp.zeros((), jnp.int32), v))
        return v

    def max_violation(self, x):
        """Worst relative distance error (diagnostic)."""
        if self.n_constraints == 0:
            return jnp.zeros(())
        r = x[self.a] - x[self.b]
        d = jnp.sqrt(jnp.sum(r * r, axis=-1))
        return jnp.max(jnp.abs(d - self.d.astype(x.dtype))
                       / self.d.astype(x.dtype))
