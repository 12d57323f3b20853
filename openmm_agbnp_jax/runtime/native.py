"""ctypes bindings for the native GaussVol overlap-tree engine.

Builds the shared library on demand with the in-tree Makefile (g++); falls
back gracefully (available() -> False) when no compiler is present so the
pure-JAX path keeps working.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libgaussvol_native.so")
_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(_SO):
        try:
            subprocess.run(["make", "-C", _HERE], check=True,
                           capture_output=True)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.gv_create.restype = ctypes.c_void_p
    lib.gv_create.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.gv_destroy.argtypes = [ctypes.c_void_p]
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.gv_compute_tree.argtypes = [ctypes.c_void_p, dptr, dptr, dptr, dptr]
    lib.gv_rescan_volumes.argtypes = [ctypes.c_void_p, dptr, dptr, dptr, dptr]
    lib.gv_rescan_gammas.argtypes = [ctypes.c_void_p, dptr]
    lib.gv_compute_volume.argtypes = [ctypes.c_void_p, dptr, dptr, dptr, dptr,
                                      dptr, dptr]
    lib.gv_level_stats.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
    lib.gv_total_nodes.restype = ctypes.c_int
    lib.gv_total_nodes.argtypes = [ctypes.c_void_p]
    lib.agbnp1_create.restype = ctypes.c_void_p
    lib.agbnp1_create.argtypes = [ctypes.c_int, dptr, dptr, dptr, dptr,
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.c_double]
    lib.agbnp1_destroy.argtypes = [ctypes.c_void_p]
    lib.agbnp1_energy_forces.argtypes = [ctypes.c_void_p, dptr,
                                         ctypes.c_double, ctypes.c_double,
                                         dptr, dptr, dptr, dptr, dptr]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeGaussVol:
    """Fast float64 overlap-tree engine (sizing pre-pass + large-system
    oracle)."""

    def __init__(self, natoms: int, ishydrogen):
        lib = _load()
        if lib is None:
            raise RuntimeError("native gaussvol library unavailable")
        self._lib = lib
        self.natoms = natoms
        ish = np.ascontiguousarray(ishydrogen, dtype=np.int32)
        self._h = lib.gv_create(natoms,
                                ish.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gv_destroy(self._h)
            self._h = None

    def compute_tree(self, pos, radii, volumes, gammas):
        pos = np.ascontiguousarray(pos, dtype=np.float64)
        r = np.ascontiguousarray(radii, dtype=np.float64)
        v = np.ascontiguousarray(volumes, dtype=np.float64)
        g = np.ascontiguousarray(gammas, dtype=np.float64)
        self._lib.gv_compute_tree(self._h, _dp(pos), _dp(r), _dp(v), _dp(g))

    def rescan_volumes(self, pos, radii, volumes, gammas):
        pos = np.ascontiguousarray(pos, dtype=np.float64)
        r = np.ascontiguousarray(radii, dtype=np.float64)
        v = np.ascontiguousarray(volumes, dtype=np.float64)
        g = np.ascontiguousarray(gammas, dtype=np.float64)
        self._lib.gv_rescan_volumes(self._h, _dp(pos), _dp(r), _dp(v), _dp(g))

    def rescan_gammas(self, gammas):
        g = np.ascontiguousarray(gammas, dtype=np.float64)
        self._lib.gv_rescan_gammas(self._h, _dp(g))

    def compute_volume(self):
        """Returns (energy, volume, force, dv, free_volume, self_volume)."""
        n = self.natoms
        energy = np.zeros(1)
        volume = np.zeros(1)
        dr = np.zeros((n, 3))
        dv = np.zeros(n)
        fv = np.zeros(n)
        sv = np.zeros(n)
        self._lib.gv_compute_volume(self._h, _dp(energy), _dp(volume),
                                    _dp(dr), _dp(dv), _dp(fv), _dp(sv))
        return energy[0], volume[0], -dr, dv, fv, sv

    def total_nodes(self) -> int:
        return int(self._lib.gv_total_nodes(self._h))

    def level_stats(self):
        """Returns (counts[9], max_siblings[9]) for levels 0..8."""
        counts = np.zeros(9, dtype=np.int32)
        sibs = np.zeros(9, dtype=np.int32)
        ip = ctypes.POINTER(ctypes.c_int)
        self._lib.gv_level_stats(self._h, counts.ctypes.data_as(ip),
                                 sibs.ctypes.data_as(ip))
        return counts, sibs


class NativeAGBNP1:
    """Full native AGBNP1 pipeline (f64, O(N^2) sweeps): the independent
    benchmark-scale ground truth for the JAX path — overlap-tree cavity
    term, I4-spline Born radii (tables built natively from the closed-form
    i4 integral), GB self/pair, vdW dispersion, descreening chain, and the
    W/U gamma-rescan force pass.  Mirrors the semantics of reference
    ReferenceAGBNPKernels.cpp:274-795."""

    def __init__(self, params):
        lib = _load()
        if lib is None:
            raise RuntimeError("native agbnp1 library unavailable")
        self._lib = lib
        self.natoms = params.n
        r = np.ascontiguousarray(params.radii_vdw, np.float64)
        g = np.ascontiguousarray(params.gamma, np.float64)
        a = np.ascontiguousarray(params.alpha, np.float64)
        c = np.ascontiguousarray(params.charge, np.float64)
        ish = np.ascontiguousarray(params.ishydrogen, np.int32)
        self._keep = (r, g, a, c, ish)
        self._h = lib.agbnp1_create(
            params.n, _dp(r), _dp(g), _dp(a), _dp(c),
            ish.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            float(params.roffset))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.agbnp1_destroy(self._h)
            self._h = None

    def energy_forces(self, pos, cutoff=None, horizon=None):
        """Returns dict(energy, force [N, 3], born_radius, self_volume,
        e_cav, gb_self, gb_pair, e_vdw).  cutoff None = NoCutoff GB;
        horizon None = the 2 nm LUT descreening horizon ("cutoff" mode
        passes the cutoff value)."""
        n = self.natoms
        pos = np.ascontiguousarray(pos, np.float64)
        energy = np.zeros(1)
        force = np.zeros((n, 3))
        born = np.zeros(n)
        sv = np.zeros(n)
        comp = np.zeros(4)
        self._lib.agbnp1_energy_forces(
            self._h, _dp(pos), float(cutoff or 0.0), float(horizon or 0.0),
            _dp(energy), _dp(force), _dp(born), _dp(sv), _dp(comp))
        return dict(energy=energy[0], force=force, born_radius=born,
                    self_volume=sv, e_cav=comp[0], gb_self=comp[1],
                    gb_pair=comp[2], e_vdw=comp[3])


def size_tree_caps(params, pos, boost: float = 1.6, align: int = 128):
    """Capacity sizing pre-pass: build the tree natively at large radii and
    derive per-level capacities/sibling windows with headroom (the
    tree_size_boost analogue, reference OpenCLAGBNPKernels.h:145)."""
    from ..models.constants import sphere_volume
    from ..ops.tree import TreeCaps

    gv = NativeGaussVol(params.n, params.ishydrogen)
    radii = np.asarray(params.radii_large)
    volumes = np.where(params.ishydrogen > 0, 0.0, sphere_volume(radii))
    gv.compute_tree(pos, radii, volumes, params.gamma / params.roffset)
    counts, sibs = gv.level_stats()

    def r(x):
        return max(align, int(np.ceil(x / align)) * align)

    caps = tuple(r(counts[k] * boost) for k in range(2, 9))
    # offs[l] is the sibling window used to pair level-(l+2) nodes; it must
    # cover the largest sibling group at that level (minus one).  Windows
    # only widen the (rebuild-amortized) candidate grids, and equilibrium
    # sibling-group maxima fluctuate proportionally more than level counts
    # on small systems, so they always get at least 1.6x headroom
    offs_boost = max(boost, 1.6)
    offs = tuple(int(max(4, np.ceil(max(sibs[k] - 1, 1) * offs_boost)))
                 for k in range(2, 8))
    return TreeCaps(caps=caps, offs=offs)
