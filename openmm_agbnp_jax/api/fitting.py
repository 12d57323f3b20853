"""Differentiable AGBNP: gradients of the energy with respect to model
parameters over conformation batches.

A capability the reference cannot offer: its energy is C++/OpenCL, so
parameterizing AGBNP (surface tensions gamma, dispersion coefficients
alpha, charges) against target data means finite differences over full
re-evaluations.  Here the whole pipeline is traced by JAX, so
d(energy)/d(theta) is one reverse-mode pass, batched over conformations —
the force-field-fitting workflow as a first-class API.

Fittable parameters and where they enter (reference semantics):
  * gamma  — cavity surface tension (per atom; heavy atoms only, hydrogen
    gammas are pinned to zero as in ReferenceAGBNPKernels.cpp:100-116).
    NOTE the reference *kernel* additionally requires a single common
    gamma; the tree math itself (gamma1i sums, gaussvol.cpp) is per-atom,
    and fitting is exactly the use case for relaxing it.
  * alpha  — vdW dispersion coefficient, E_vdw = sum alpha_i/(B_i+rw)^3
    (ReferenceAGBNPKernels.cpp:513-521).
  * charge — GB self + pair energies (cpp:464-504).

Radii are NOT fittable through this path: the descreening spline tables
are built host-side per radius-type pair (models/i4_tables.py), so radius
gradients would need the closed-form i4 path; use finite differences with
`AGBNPModel.update_params` for radii.
"""

from __future__ import annotations

import numpy as np

FITTABLE = ("gamma", "alpha", "charge")


class ParameterGradients:
    """Differentiable energies over a fixed conformation batch.

    theta is a dict with any subset of {"gamma", "alpha", "charge"}, each
    an [N] array; entries override the model's parameter arrays inside the
    traced computation, so the same compiled executable serves every
    optimizer step.
    """

    def __init__(self, model):
        if model.version not in (0, 1):
            raise ValueError("versions 0 and 1 are supported")
        self._model = model
        self._jits = {}

    @property
    def model(self):
        return self._model

    def initial_theta(self, keys=FITTABLE) -> dict:
        """The model's current parameters as a theta dict (f64 numpy)."""
        p = self._model.params
        src = dict(gamma=p.gamma, alpha=p.alpha, charge=p.charge)
        return {k: np.asarray(src[k], np.float64) for k in keys}

    def _energy(self, theta: dict, pos):
        import jax.numpy as jnp

        from ..models.agbnp_jax import energy_forces

        m = self._model
        a = dict(m.arrays)
        for k in theta:
            if k not in FITTABLE:
                raise ValueError(f"unknown parameter {k!r}; fittable: "
                                 f"{FITTABLE}")
        if "gamma" in theta:
            a["gamma"] = jnp.where(a["ishydrogen"] > 0, 0.0,
                                   jnp.asarray(theta["gamma"], m.dtype))
        if "alpha" in theta:
            a["alpha"] = jnp.asarray(theta["alpha"], m.dtype)
        if "charge" in theta:
            a["charge"] = jnp.asarray(theta["charge"], m.dtype)
        out = energy_forces(a, jnp.asarray(pos, m.dtype), caps=m.caps,
                            version=m.version, roffset=m.params.roffset,
                            ntypes_j=m.ntypes_j, cutoff=m.cutoff,
                            mixed=m.mixed, neighbor_rcut=m.neighbor_rcut,
                            neighbor_kmax=m.neighbor_kmax,
                            neighbor_grid=m.neighbor_grid, box=m.box,
                            descreen_horizon=m.descreen_horizon)
        return out["energy"]

    def energies(self, theta: dict, poses):
        """Batched energies [B] at parameters theta (jit+vmap)."""
        import jax

        key = ("energies", tuple(sorted(theta)))
        if key not in self._jits:
            self._jits[key] = jax.jit(jax.vmap(self._energy,
                                               in_axes=(None, 0)))
        poses = np.asarray(poses)
        if poses.ndim == 2:
            poses = poses[None]
        return np.asarray(self._jits[key](theta, poses))

    def energy_grads(self, theta: dict, poses):
        """Per-pose parameter gradients: dict of [B, N] arrays
        d E_b / d theta_k (plus "energy" [B])."""
        import jax

        key = ("egrads", tuple(sorted(theta)))
        if key not in self._jits:
            vg = jax.value_and_grad(self._energy)
            self._jits[key] = jax.jit(jax.vmap(vg, in_axes=(None, 0)))
        poses = np.asarray(poses)
        if poses.ndim == 2:
            poses = poses[None]
        e, g = self._jits[key](theta, poses)
        out = {k: np.asarray(v) for k, v in g.items()}
        out["energy"] = np.asarray(e)
        return out

    def make_loss_grad(self, loss_fn):
        """jitted (loss, grad-wrt-theta) for loss_fn(energies [B]) -> scalar.

        The returned function vg(theta, poses) serves any optax-style
        optimization loop; poses is a fixed [B, N, 3] batch (same shape =
        same executable across steps).
        """
        import jax

        def loss(theta, poses):
            es = jax.vmap(self._energy, in_axes=(None, 0))(theta, poses)
            return loss_fn(es)

        return jax.jit(jax.value_and_grad(loss))
