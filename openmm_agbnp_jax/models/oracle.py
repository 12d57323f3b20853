"""Float64 NumPy oracle of the GaussVol / AGBNP1 reference semantics.

This module is the semantic ground truth for the device compute path.  It is a
direct, *slow* re-statement of the physics implemented by the reference
plugin's CPU platform (reference: gaussvol/gaussvol.cpp and
platforms/reference/src/ReferenceAGBNPKernels.cpp), re-derived from the math
rather than translated line-by-line.  Everything here runs in float64 NumPy
with Python recursion, so it is only suitable for test fixtures
(hundreds to a few thousand atoms).

Golden anchors (264-atom gaussvol.dat fixture from the reference test suite):
  * GVolSA  (version 0) surface-area energy: 872.514 kJ/mol
    (reference: platforms/reference/tests/v0.reference:2-7)
  * AGBNP1 (version 1) total energy: -2476.66 kJ/mol
    (reference: platforms/reference/tests/v1.reference:2)
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .constants import (
    AGBNP_HB_RADIUS,
    AGBNP_I4LOOKUP_MAXA,
    AGBNP_I4LOOKUP_NA,
    AGBNP_RADIUS_INCREMENT,
    DIELECTRIC_FACTOR,
    KFC,
    MAX_ORDER,
    MIN_GVOL,
    PFC,
    PI,
    PIFAC,
    VOLMINA,
    VOLMINB,
    sphere_volume,
)
from .i4_tables import I4LookupTables

# ---------------------------------------------------------------------------
# Gaussian overlap primitives
# ---------------------------------------------------------------------------


def pol_switchfunc(gvol: float, volmina: float, volminb: float):
    """Quintic switching function s(v) on an overlap volume and its derivative.

    Mirrors reference gaussvol/gaussvol.cpp:18-41: s ramps 0->1 on
    [volmina, volminb] with zero first/second derivatives at the ends.
    Returns (s, sp).
    """
    if gvol > volminb:
        swf, swfp = 1.0, 0.0
    elif gvol < volmina:
        swf, swfp = 0.0, 0.0
    else:
        swf, swfp = 0.0, 1.0
    swd = 1.0 / (volminb - volmina)
    swu = (gvol - volmina) * swd
    swu2 = swu * swu
    swu3 = swu * swu2
    s = swf + swfp * swu3 * (10.0 - 15.0 * swu + 6.0 * swu2)
    sp = swfp * swd * 30.0 * swu2 * (1.0 - 2.0 * swu + swu2)
    return s, sp


def ogauss_alpha(v1, a1, c1, v2, a2, c2):
    """Product of two spherical Gaussians in (V, a, c) form.

    Returns (switched_vol, v12, a12, c12, dVdr_over_r, dVdV1, sfp) following
    reference gaussvol/gaussvol.cpp:60-93:
      * v12/a12/c12 is the *unswitched* product Gaussian,
      * switched_vol = s(v12) * v12,
      * dVdr_over_r = (1/r) dV12/dr (unswitched),
      * dVdV1 = dV12/dV1 (unswitched),
      * sfp = d(s*V)/dV = s + V * ds/dV.
    """
    dist = c2 - c1
    d2 = float(np.dot(dist, dist))
    a12 = a1 + a2
    deltai = 1.0 / a12
    df = a1 * a2 * deltai

    ef = math.exp(-df * d2)
    gvol = (v1 * v2 / (PI / df) ** 1.5) * ef
    dgvol = -2.0 * df * gvol
    dgvolv = gvol / v1 if v1 > 0 else 0.0

    c12 = (c1 * a1 + c2 * a2) * deltai

    s, sp = pol_switchfunc(gvol, VOLMINA, VOLMINB)
    sfp = sp * gvol + s
    return s * gvol, gvol, a12, c12, dgvol, dgvolv, sfp


# ---------------------------------------------------------------------------
# Overlap tree
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Node:
    level: int
    gv: float          # unswitched Gaussian volume of the product
    ga: float          # Gaussian exponent
    gc: np.ndarray     # Gaussian center
    volume: float      # switched volume s*V
    dvv1: float        # dV/dV(parent), unswitched
    dv1: np.ndarray    # (1/r) dV/dr * (c_atom - c_parent) ... gradient piece
    gamma1i: float     # sum of constituent gammas
    sfp: float         # d(sV)/dV switch chain factor
    atom: int          # last atom of the overlap tuple
    parent: int        # parent slot
    children_start: int = -1
    children_count: int = -1
    self_volume: float = 0.0


class GOverlapTree:
    """Recursive Gaussian overlap tree (inclusion-exclusion over products).

    Flat slot layout identical in spirit to the reference
    (gaussvol/gaussvol.h:96-203): slot 0 is the root, slots 1..natoms are the
    atoms, children appended contiguously, each node's children generated from
    overlaps with its younger siblings, sorted by descending volume, pruned at
    MIN_GVOL, capped at MAX_ORDER-body.
    """

    def __init__(self, natoms: int):
        self.natoms = natoms
        self.nodes: list[_Node] = []

    # -- construction ------------------------------------------------------

    def init_overlap_tree(self, pos, radius, volume, gamma, ishydrogen):
        self.nodes = []
        root = _Node(0, 0.0, 0.0, np.zeros(3), 0.0, 0.0, np.zeros(3), 0.0, 1.0,
                     -1, -1, 1, self.natoms)
        self.nodes.append(root)
        for i in range(self.natoms):
            a = KFC / (radius[i] * radius[i])
            vol = 0.0 if ishydrogen[i] > 0 else volume[i]
            self.nodes.append(
                _Node(1, vol, a, np.asarray(pos[i], dtype=np.float64),
                      vol, 1.0, np.zeros(3), gamma[i], 1.0, i, 0))

    def _compute_children(self, root_index: int):
        """Overlap root with last atoms of its younger siblings."""
        out = []
        root = self.nodes[root_index]
        if root.parent < 0 or root.level >= MAX_ORDER:
            return out
        parent = self.nodes[root.parent]
        sib_start, sib_count = parent.children_start, parent.children_count
        for slotj in range(root_index + 1, sib_start + sib_count):
            sibling = self.nodes[slotj]
            atom2 = sibling.atom
            g2 = self.nodes[atom2 + 1]
            sgvol, gv, ga, gc, dVdr, dVdV, sfp = ogauss_alpha(
                root.gv, root.ga, root.gc, g2.gv, g2.ga, g2.gc)
            if sgvol > MIN_GVOL:
                out.append(_Node(
                    root.level + 1, gv, ga, gc, sgvol, dVdV,
                    (g2.gc - root.gc) * (-dVdr), root.gamma1i + g2.gamma1i,
                    sfp, atom2, root_index))
        return out

    def _add_children(self, parent_index: int, children):
        start = len(self.nodes)
        self.nodes[parent_index].children_start = start
        self.nodes[parent_index].children_count = len(children)
        children.sort(key=lambda n: -n.volume)
        for ch in children:
            ch.parent = parent_index
            ch.children_start = -1
            ch.children_count = -1
            self.nodes.append(ch)
        return start

    def _compute_andadd_children_r(self, root: int):
        children = self._compute_children(root)
        if children:
            start = self._add_children(root, children)
            for child in range(start, start + len(children)):
                self._compute_andadd_children_r(child)

    def compute_overlap_tree(self, pos, radius, volume, gamma, ishydrogen):
        self.init_overlap_tree(pos, radius, volume, gamma, ishydrogen)
        for slot in range(1, self.natoms + 1):
            self._compute_andadd_children_r(slot)

    # -- rescans -----------------------------------------------------------

    def rescan_tree_v(self, pos, radius, volume, gamma, ishydrogen):
        """Recompute volumes on the fixed topology with new radii/volumes.

        Mirrors reference gaussvol.cpp:254-327.
        """
        root = self.nodes[0]
        root.volume = 0.0
        root.dv1 = np.zeros(3)
        root.dvv1 = 0.0
        root.sfp = 1.0
        root.gamma1i = 0.0
        for i in range(self.natoms):
            nd = self.nodes[i + 1]
            a = KFC / (radius[i] * radius[i])
            vol = 0.0 if ishydrogen[i] > 0 else volume[i]
            nd.gv = vol
            nd.ga = a
            nd.gc = np.asarray(pos[i], dtype=np.float64)
            nd.volume = vol
            nd.dvv1 = 1.0
            nd.dv1 = np.zeros(3)
            nd.sfp = 1.0
            nd.gamma1i = gamma[i]
        self._rescan_r(0)

    def _rescan_r(self, slot: int):
        ov = self.nodes[slot]
        if ov.parent > 0:
            parent = self.nodes[ov.parent]
            g2 = self.nodes[ov.atom + 1]
            sgvol, gv, ga, gc, dVdr, dVdV, sfp = ogauss_alpha(
                parent.gv, parent.ga, parent.gc, g2.gv, g2.ga, g2.gc)
            ov.gv, ov.ga, ov.gc = gv, ga, gc
            ov.volume = sgvol
            ov.dv1 = (g2.gc - parent.gc) * (-dVdr)
            ov.dvv1 = dVdV
            ov.sfp = sfp
            ov.gamma1i = parent.gamma1i + g2.gamma1i
        if ov.children_start >= 0:
            for child in range(ov.children_start, ov.children_start + ov.children_count):
                self._rescan_r(child)

    def rescan_tree_g(self, gamma):
        self.nodes[0].gamma1i = 0.0
        for i in range(self.natoms):
            self.nodes[i + 1].gamma1i = gamma[i]
        self._rescan_gamma_r(0)

    def _rescan_gamma_r(self, slot: int):
        ov = self.nodes[slot]
        if ov.parent > 0:
            ov.gamma1i = self.nodes[ov.parent].gamma1i + self.nodes[ov.atom + 1].gamma1i
        if ov.children_start >= 0:
            for child in range(ov.children_start, ov.children_start + ov.children_count):
                self._rescan_gamma_r(child)

    # -- evaluation --------------------------------------------------------

    def compute_volume(self):
        """Single post-order pass: free/self volumes, energy, gradients.

        The alternating-sign inclusion-exclusion and the (P, F) gradient
        back-propagation follow reference gaussvol.cpp:400-519.

        Returns (volume, energy, dr, dv, free_volume, self_volume); dr is the
        *gradient* (not force).
        """
        n = self.natoms
        dr = np.zeros((n, 3))
        dv = np.zeros(n)
        free_volume = np.zeros(n)
        self_volume = np.zeros(n)

        def under_slot(slot: int):
            ov = self.nodes[slot]
            cf = -1.0 if ov.level % 2 == 0 else 1.0
            volcoeff = cf if ov.level > 0 else 0.0
            volcoeffp = volcoeff / ov.level if ov.level > 0 else 0.0

            atom = ov.atom
            ai = self.nodes[atom + 1].ga if ov.level > 0 else 1.0
            a1i = ov.ga
            a1 = a1i - ai

            psi1i = volcoeff * ov.volume
            f1i = volcoeff * ov.sfp
            p1i = np.zeros(3)
            psip1i = volcoeffp * ov.volume
            fp1i = volcoeffp * ov.sfp
            pp1i = np.zeros(3)
            energy1i = volcoeffp * ov.gamma1i * ov.volume
            fenergy1i = volcoeffp * ov.sfp * ov.gamma1i
            penergy1i = np.zeros(3)

            if ov.children_start >= 0:
                for sloti in range(ov.children_start, ov.children_start + ov.children_count):
                    (psi1it, f1it, p1it, psip1it, fp1it, pp1it,
                     energy1it, fenergy1it, penergy1it) = under_slot(sloti)
                    psi1i += psi1it
                    f1i += f1it
                    p1i = p1i + p1it
                    psip1i += psip1it
                    fp1i += fp1it
                    pp1i = pp1i + pp1it
                    energy1i += energy1it
                    fenergy1i += fenergy1it
                    penergy1i = penergy1i + penergy1it

            if ov.level > 0:
                free_volume[atom] += psi1i
                self_volume[atom] += psip1i
                c2 = ai / a1i
                dr[atom] += (-ov.dv1) * fenergy1i + penergy1i * c2
                dv[atom] += ov.gv * fenergy1i  # unswitched volume
                c2 = a1 / a1i
                p1i = ov.dv1 * f1i + p1i * c2
                pp1i = ov.dv1 * fp1i + pp1i * c2
                penergy1i = ov.dv1 * fenergy1i + penergy1i * c2
                f1i = ov.dvv1 * f1i
                fp1i = ov.dvv1 * fp1i
                fenergy1i = ov.dvv1 * fenergy1i
            return (psi1i, f1i, p1i, psip1i, fp1i, pp1i,
                    energy1i, fenergy1i, penergy1i)

        psi1i, _, _, _, _, _, energy1i, _, _ = under_slot(0)
        return psi1i, energy1i, dr, dv, free_volume, self_volume

    def nchildren_under_slot(self, slot: int) -> int:
        n = 0
        nd = self.nodes[slot]
        if nd.children_count > 0:
            n += nd.children_count
            for i in range(nd.children_count):
                n += self.nchildren_under_slot(nd.children_start + i)
        return n


class GaussVol:
    """Facade over the overlap tree, mirroring reference gaussvol.h:208-310."""

    def __init__(self, natoms: int, ishydrogen):
        self.natoms = natoms
        self.tree = GOverlapTree(natoms)
        self.radii = np.ones(natoms)
        self.volumes = np.zeros(natoms)
        self.gammas = np.zeros(natoms)
        self.ishydrogen = np.asarray(ishydrogen, dtype=np.int64)

    def set_radii(self, radii):
        self.radii = np.asarray(radii, dtype=np.float64)

    def set_volumes(self, volumes):
        self.volumes = np.asarray(volumes, dtype=np.float64)

    def set_gammas(self, gammas):
        self.gammas = np.asarray(gammas, dtype=np.float64)

    def compute_tree(self, positions):
        self.tree.compute_overlap_tree(positions, self.radii, self.volumes,
                                       self.gammas, self.ishydrogen)

    def compute_volume(self, positions):
        """Returns (volume, energy, force, gradV, free_volume, self_volume).

        Negates the gradient into a force and divides dv by the atomic volume
        (reference gaussvol.cpp:589-606).
        """
        volume, energy, dr, dv, free_volume, self_volume = self.tree.compute_volume()
        force = -dr
        gradV = np.where(self.volumes > 0, dv / np.where(self.volumes > 0, self.volumes, 1.0), dv)
        return volume, energy, force, gradV, free_volume, self_volume

    def rescan_tree_volumes(self, positions):
        self.tree.rescan_tree_v(positions, self.radii, self.volumes,
                                self.gammas, self.ishydrogen)

    def rescan_tree_gammas(self):
        self.tree.rescan_tree_g(self.gammas)

    def getstat(self):
        return np.array([self.tree.nchildren_under_slot(atom + 1)
                         for atom in range(self.natoms)], dtype=np.int64)


# ---------------------------------------------------------------------------
# Born-radius soft filter
# ---------------------------------------------------------------------------


def agbnp_swf_invbr(beta: float):
    """Soft-plus filter on the inverse Born radius.

    Keeps 1/B positive and bounded below by 1/AGBNP_I4LOOKUP_MAXA
    (reference ReferenceAGBNPKernels.cpp:41-55). Returns (filtered, fp).
    """
    a = 1.0 / AGBNP_I4LOOKUP_MAXA
    a2 = a * a
    if beta < 0.0:
        return a, 0.0
    t = math.sqrt(a2 + beta * beta)
    return t, beta / t


# ---------------------------------------------------------------------------
# Full model evaluations
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AGBNPParams:
    """Per-particle parameters, mirroring AGBNPForce::addParticle semantics.

    radius: vdW radius [nm]; gamma: surface tension [kJ/mol/nm^2];
    alpha: solute-solvent dispersion parameter; charge: electric charge [e];
    ishydrogen: 1 for hydrogens (no volume, never descreens).
    Hydrogen gammas are zeroed as in reference
    ReferenceAGBNPKernels.cpp:96-118.
    """

    radius: np.ndarray
    gamma: np.ndarray
    alpha: np.ndarray
    charge: np.ndarray
    ishydrogen: np.ndarray
    roffset: float = AGBNP_RADIUS_INCREMENT

    def __post_init__(self):
        self.radius = np.asarray(self.radius, dtype=np.float64)
        self.gamma = np.where(np.asarray(self.ishydrogen) > 0, 0.0,
                              np.asarray(self.gamma, dtype=np.float64))
        self.alpha = np.asarray(self.alpha, dtype=np.float64)
        self.charge = np.asarray(self.charge, dtype=np.float64)
        self.ishydrogen = np.asarray(self.ishydrogen, dtype=np.int64)

    @property
    def n(self):
        return self.radius.shape[0]

    @property
    def radii_large(self):
        return self.radius + self.roffset

    @property
    def radii_vdw(self):
        return self.radius


def gvolsa_energy_forces(params: AGBNPParams, pos: np.ndarray):
    """GVolSA (version 0): two-pass finite-difference surface-area energy.

    E_cav = E_vol(large radii, +gamma/dr) + E_vol(vdw radii, -gamma/dr)
    (reference ReferenceAGBNPKernels.cpp:152-271). Returns (energy, force).
    """
    n = params.n
    gv = GaussVol(n, params.ishydrogen)
    force = np.zeros((n, 3))

    gv.set_radii(params.radii_large)
    gv.set_volumes(np.where(params.ishydrogen > 0, 0.0, sphere_volume(params.radii_large)))
    gv.set_gammas(params.gamma / params.roffset)
    gv.compute_tree(pos)
    _, e1, f1, _, _, _ = gv.compute_volume(pos)
    force += f1

    gv.set_radii(params.radii_vdw)
    gv.set_volumes(np.where(params.ishydrogen > 0, 0.0, sphere_volume(params.radii_vdw)))
    gv.set_gammas(-params.gamma / params.roffset)
    gv.rescan_tree_volumes(pos)
    _, e2, f2, _, _, _ = gv.compute_volume(pos)
    force += f2

    return e1 + e2, force, (e1, e2)


def agbnp1_energy_forces(params: AGBNPParams, pos: np.ndarray,
                         i4_tables: I4LookupTables | None = None,
                         return_details: bool = False):
    """AGBNP1 (version 1): cavity + GB + vdW dispersion with analytic forces.

    Follows the 12-step pipeline of reference
    ReferenceAGBNPKernels.cpp:274-795 (see SURVEY.md section 3.2).
    Returns (energy, force) or (energy, force, details).
    """
    n = params.n
    pos = np.asarray(pos, dtype=np.float64)
    if i4_tables is None:
        i4_tables = I4LookupTables(params.radii_vdw, params.ishydrogen)

    gv = GaussVol(n, params.ishydrogen)
    force = np.zeros((n, 3))
    energy = 0.0

    # steps 1-3: volume energy 1 (large radii)
    gv.set_radii(params.radii_large)
    gv.set_gammas(params.gamma / params.roffset)
    gv.set_volumes(np.where(params.ishydrogen > 0, 0.0, sphere_volume(params.radii_large)))
    gv.compute_tree(pos)
    _, e1, f1, _, _, _ = gv.compute_volume(pos)
    force += f1
    energy += e1

    # step 4: volume energy 2 (vdW radii), rescan on fixed topology
    gv.set_radii(params.radii_vdw)
    gv.set_gammas(-params.gamma / params.roffset)
    gv.set_volumes(np.where(params.ishydrogen > 0, 0.0, sphere_volume(params.radii_vdw)))
    gv.rescan_tree_volumes(pos)
    _, e2, f2, _, _, self_volume = gv.compute_volume(pos)
    force += f2
    energy += e2

    # step 5: volume scaling factors
    vol_vdw = sphere_volume(params.radii_vdw)
    s_factor = self_volume / vol_vdw

    # step 6: inverse Born radii via the I4 lookup table
    inv_br = np.zeros(n)
    inv_br_fp = np.zeros(n)
    born_radius = np.zeros(n)
    for i in range(n):
        b = 1.0 / params.radii_vdw[i]
        for j in range(n):
            if i == j or params.ishydrogen[j] > 0:
                continue
            d = float(np.linalg.norm(pos[j] - pos[i]))
            if d < AGBNP_I4LOOKUP_MAXA:
                b -= PIFAC * s_factor[j] * i4_tables.eval(
                    d, i4_tables.type_screened[i], i4_tables.type_screener[j])
        filt, fp = agbnp_swf_invbr(b)
        born_radius[i] = 1.0 / filt
        inv_br[i] = b
        inv_br_fp[i] = fp

    # step 7: GB energy (self + pair), direct forces, Y accumulators
    egb_der_Y = np.zeros(n)
    gb_self = 0.0
    gb_pair = 0.0
    for i in range(n):
        gb_self += DIELECTRIC_FACTOR * params.charge[i] ** 2 / born_radius[i]
        for j in range(i + 1, n):
            dist = pos[j] - pos[i]
            d2 = float(np.dot(dist, dist))
            qqf = params.charge[j] * params.charge[i]
            qq = DIELECTRIC_FACTOR * qqf
            bb = born_radius[i] * born_radius[j]
            etij = math.exp(-0.25 * d2 / bb)
            fgb = 1.0 / math.sqrt(d2 + bb * etij)
            gb_pair += 2.0 * qq * fgb
            fgb3 = fgb ** 3
            mw = -2.0 * qq * (1.0 - 0.25 * etij) * fgb3
            g = dist * mw
            force[i] += g
            force[j] -= g
            ytij = qqf * (bb + 0.25 * d2) * etij * fgb3
            egb_der_Y[i] += ytij
            egb_der_Y[j] += ytij
    energy += gb_self + gb_pair

    # step 8: vdW dispersion energy
    evdw = float(np.sum(params.alpha / (born_radius + AGBNP_HB_RADIUS) ** 3))
    energy += evdw

    # step 9: per-atom chain-rule factors BrW (vdW) and BrU (GB)
    br = born_radius
    evdw_der_brw = (-PIFAC * 3.0 * params.alpha * br * br * inv_br_fp
                    / (br + AGBNP_HB_RADIUS) ** 4)
    egb_der_bru = (-PIFAC * DIELECTRIC_FACTOR
                   * (params.charge ** 2 + egb_der_Y * br) * inv_br_fp)

    # step 10: descreening derivative sweep
    evdw_der_W = np.zeros(n)
    egb_der_U = np.zeros(n)
    for i in range(n):
        for j in range(n):
            if i == j or params.ishydrogen[j] > 0:
                continue
            dist = pos[j] - pos[i]
            d = float(np.linalg.norm(dist))
            Qji = dQji = 0.0
            if d < AGBNP_I4LOOKUP_MAXA:
                ti = i4_tables.type_screened[i]
                tj = i4_tables.type_screener[j]
                Qji = i4_tables.eval(d, ti, tj)
                dQji = i4_tables.evalderiv(d, ti, tj)
            evdw_der_W[j] += evdw_der_brw[i] * Qji
            w = dist * (evdw_der_brw[i] * s_factor[j] * dQji / d)
            force[i] += w
            force[j] -= w
            egb_der_U[j] += egb_der_bru[i] * Qji
            w = dist * (egb_der_bru[i] * s_factor[j] * dQji / d)
            force[i] += w
            force[j] -= w

    # steps 11-12: self-volume components of the gradients via gamma rescans
    gv.set_gammas(evdw_der_W / vol_vdw)
    gv.rescan_tree_gammas()
    _, _, fW, _, _, _ = gv.compute_volume(pos)
    force += fW

    gv.set_gammas(egb_der_U / vol_vdw)
    gv.rescan_tree_gammas()
    _, _, fU, _, _, _ = gv.compute_volume(pos)
    force += fU

    if return_details:
        details = dict(e_vol1=e1, e_vol2=e2, e_cav=e1 + e2,
                       gb_self=gb_self, gb_pair=gb_pair, e_vdw=evdw,
                       born_radius=born_radius, self_volume=self_volume,
                       s_factor=s_factor, inv_br=inv_br,
                       egb_der_Y=egb_der_Y, evdw_der_brw=evdw_der_brw,
                       egb_der_bru=egb_der_bru, evdw_der_W=evdw_der_W,
                       egb_der_U=egb_der_U)
        return energy, force, details
    return energy, force
