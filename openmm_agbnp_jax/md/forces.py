"""Molecular-mechanics force field terms in JAX (OPLS via Desmond DMS).

The reference plugin itself only provides the AGBNP force; its benchmarks run
full MD with the rest of the force field coming from the .dms files through a
modified DesmondDMSFile (reference example/t4lysozyme_benchmark.py:8-10,
`createSystem(..., OPLS=True, implicitSolvent='AGBNP')`).  To reproduce those
benchmarks end-to-end on the device this module implements the same terms as pure
jnp energy functions; forces come from jax.grad, fused into the MD step.

Terms (units: nm, kJ/mol, ps, e):
  * stretch_harm:   E = fc (r - r0)^2
  * angle_harm:     E = fc (theta - theta0)^2
  * dihedral_trig:  E = sum_{n=0..6} fc_n cos(n (phi - phi0))
  * nonbonded:      OPLS geometric-rule LJ + Coulomb, exclusions subtracted,
                    pre-scaled 1-4 pair terms (aij/r^12 - bij/r^6 + ke qij/r)
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

ONE_4PI_EPS0 = 138.935456  # kJ mol^-1 nm e^-2


def bond_energy(pos, idx, r0, k):
    d = pos[idx[:, 1]] - pos[idx[:, 0]]
    r = jnp.sqrt(jnp.sum(d * d, axis=-1))
    return jnp.sum(k * (r - r0) ** 2)


def angle_energy(pos, idx, theta0, k):
    a = pos[idx[:, 0]] - pos[idx[:, 1]]
    b = pos[idx[:, 2]] - pos[idx[:, 1]]
    cosang = jnp.sum(a * b, axis=-1) / jnp.sqrt(
        jnp.sum(a * a, axis=-1) * jnp.sum(b * b, axis=-1))
    theta = jnp.arccos(jnp.clip(cosang, -1.0, 1.0))
    return jnp.sum(k * (theta - theta0) ** 2)


def dihedral_angle(pos, idx):
    b1 = pos[idx[:, 1]] - pos[idx[:, 0]]
    b2 = pos[idx[:, 2]] - pos[idx[:, 1]]
    b3 = pos[idx[:, 3]] - pos[idx[:, 2]]
    n1 = jnp.cross(b1, b2)
    n2 = jnp.cross(b2, b3)
    b2n = b2 / jnp.linalg.norm(b2, axis=-1, keepdims=True)
    x = jnp.sum(n1 * n2, axis=-1)
    y = jnp.sum(jnp.cross(n1, n2) * b2n, axis=-1)
    return jnp.arctan2(y, x)


def dihedral_energy(pos, idx, phi0, fc):
    phi = dihedral_angle(pos, idx)
    dphi = phi[:, None] - phi0[:, None]
    orders = jnp.arange(fc.shape[1], dtype=pos.dtype)[None, :]
    return jnp.sum(fc * jnp.cos(orders * dphi))


def _lj_coulomb(d2, qq, aij, bij, dtype):
    inv2 = 1.0 / d2
    inv6 = inv2 * inv2 * inv2
    elj = aij * inv6 * inv6 - bij * inv6
    ecoul = ONE_4PI_EPS0 * qq * jnp.sqrt(inv2)
    return elj + ecoul


def dense_nonbonded_energy(pos, charge, sigma, epsilon, cutoff=None,
                           excl_mask=None):
    """The dense all-pairs LJ+Coulomb double sum (OPLS geometric rules).

    With excl_mask ([N, N] bool, True = excluded), excluded pairs are
    masked INSIDE the sum rather than subtracted afterwards: subtracting
    separately-computed exclusion terms leaves f32 cancellation residue of
    the huge bonded-pair LJ values (~27 kJ/mol and 0.7% forces measured on
    1li2) while the masked sum matches float64 to ~0.02 kJ/mol."""
    n = pos.shape[0]
    dist = pos[None, :, :] - pos[:, None, :]
    d2 = jnp.sum(dist * dist, axis=-1)
    eye = jnp.eye(n, dtype=bool)
    d2s = jnp.where(eye, 1.0, d2)

    # geometric combination (OPLS): sigma_ij = sqrt(si sj), eps_ij = sqrt(ei ej)
    sig2 = sigma[:, None] * sigma[None, :]   # = sigma_ij^2
    epsij = jnp.sqrt(epsilon[:, None] * epsilon[None, :])
    sr2 = sig2 / d2s
    sr6 = sr2 * sr2 * sr2
    elj = 4.0 * epsij * (sr6 * sr6 - sr6)
    ecoul = ONE_4PI_EPS0 * charge[:, None] * charge[None, :] / jnp.sqrt(d2s)

    mask = ~eye
    if excl_mask is not None:
        mask = mask & ~excl_mask
    if cutoff is not None:
        mask = mask & (d2s < cutoff * cutoff)
    return 0.5 * jnp.sum(jnp.where(mask, elj + ecoul, 0.0))


def pair14_energy(pos, pair_idx, pair_aij, pair_bij, pair_qij):
    """1-4 scaled pair terms (pre-scaled aij/bij/qij from the DMS tables)."""
    pi, pj = pair_idx[:, 0], pair_idx[:, 1]
    dxp = pos[pj] - pos[pi]
    d2p = jnp.sum(dxp * dxp, axis=-1)
    inv2 = 1.0 / d2p
    inv6 = inv2 ** 3
    return jnp.sum(pair_aij * inv6 * inv6 - pair_bij * inv6
                   + ONE_4PI_EPS0 * pair_qij * jnp.sqrt(inv2))


@dataclasses.dataclass
class MMForceField:
    """Static MM topology arrays prepared from a DMSSystem."""

    arrays: dict
    cutoff: float | None = None

    @staticmethod
    def from_dms(dms, cutoff=None, dtype=np.float64) -> "MMForceField":
        # host-side numpy throughout: the arrays ride into jit as arguments
        a = dict(
            bond_idx=np.asarray(dms.bond_idx, np.int32),
            bond_r0=np.asarray(dms.bond_r0, dtype),
            bond_k=np.asarray(dms.bond_k, dtype),
            angle_idx=np.asarray(dms.angle_idx, np.int32),
            angle_theta0=np.asarray(dms.angle_theta0, dtype),
            angle_k=np.asarray(dms.angle_k, dtype),
            dihedral_idx=np.asarray(dms.dihedral_idx, np.int32),
            dihedral_phi0=np.asarray(dms.dihedral_phi0, dtype),
            dihedral_fc=np.asarray(dms.dihedral_fc, dtype),
            charge=np.asarray(dms.charges, dtype),
            sigma=np.asarray(dms.lj_sigma, dtype),
            epsilon=np.asarray(dms.lj_epsilon, dtype),
            excl_idx=np.asarray(dms.exclusions, np.int32),
            pair_idx=np.asarray(dms.pair_idx, np.int32),
            pair_aij=np.asarray(dms.pair_aij, dtype),
            pair_bij=np.asarray(dms.pair_bij, dtype),
            pair_qij=np.asarray(dms.pair_qij, dtype),
            epsq=np.sqrt(np.asarray(dms.lj_epsilon, dtype)),
        )
        return MMForceField(arrays=a, cutoff=cutoff)

    def energy(self, pos, a=None, excl_mask=None):
        """Total MM energy.  `a`/`excl_mask` override the stored arrays so
        the MD runners can pass them as jit ARGUMENTS — closing over the
        host numpy arrays bakes them into the compiled graph as constants,
        which multiplies compile time (XLA constant-folds [N, N]
        subexpressions of them) and executable size."""
        a = self.arrays if a is None else a
        e = self.energy_bonded_and_14(pos, a)
        e += dense_nonbonded_energy(
            pos, a["charge"], a["sigma"], a["epsilon"], cutoff=self.cutoff,
            excl_mask=self._excl_mask() if excl_mask is None else excl_mask)
        return e

    def energy_nonbonded(self, pos, a=None, excl_mask=None):
        """Dense LJ/Coulomb only — part of the slow RESPA class."""
        a = self.arrays if a is None else a
        return dense_nonbonded_energy(
            pos, a["charge"], a["sigma"], a["epsilon"], cutoff=self.cutoff,
            excl_mask=self._excl_mask() if excl_mask is None else excl_mask)

    def _excl_mask(self):
        if not hasattr(self, "_excl_mask_cache"):
            ex = np.asarray(self.arrays["excl_idx"])
            n = int(self.arrays["charge"].shape[0])
            m = np.zeros((n, n), bool)
            m[ex[:, 0], ex[:, 1]] = True
            m[ex[:, 1], ex[:, 0]] = True
            self._excl_mask_cache = m
        return self._excl_mask_cache

    def energy_bonded_and_14(self, pos, a=None):
        """Bonded terms + 1-4 pairs — the non-dense part, and the fast
        class of the MTS (r-RESPA) split."""
        a = self.arrays if a is None else a
        e = bond_energy(pos, a["bond_idx"], a["bond_r0"], a["bond_k"])
        e += angle_energy(pos, a["angle_idx"], a["angle_theta0"], a["angle_k"])
        e += dihedral_energy(pos, a["dihedral_idx"], a["dihedral_phi0"],
                             a["dihedral_fc"])
        e += pair14_energy(pos, a["pair_idx"], a["pair_aij"],
                           a["pair_bij"], a["pair_qij"])
        return e
