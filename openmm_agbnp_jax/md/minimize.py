"""Energy minimization (FIRE) for MD setup.

The reference workflow minimizes before dynamics
(simulation.minimizeEnergy(), reference example/test_agbnp.py:49); here the
equivalent is the FIRE algorithm (fast inertial relaxation engine) as a
fixed-iteration lax.scan — jit-friendly, no line searches, robust for
MM+implicit-solvent landscapes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def fire_minimize(force_fn, pos0, maxiter: int = 200, dt0: float = 1e-4,
                  dt_max: float = 2e-3, n_min: int = 5, f_inc: float = 1.1,
                  f_dec: float = 0.5, alpha0: float = 0.1,
                  f_alpha: float = 0.99):
    """Minimize energy; force_fn(pos) -> (energy, force[, aux]).

    Returns (pos, energy_trace [maxiter]).
    """

    def step(state, _):
        pos, vel, dt, alpha, n_pos = state
        out = force_fn(pos)
        energy, force = out[0], out[1]
        power = jnp.vdot(force, vel, precision=jax.lax.Precision.HIGHEST)

        fnorm = jnp.linalg.norm(force) + 1e-30
        vnorm = jnp.linalg.norm(vel)
        vel_mixed = (1.0 - alpha) * vel + alpha * vnorm * force / fnorm

        uphill = power <= 0.0
        vel = jnp.where(uphill, jnp.zeros_like(vel), vel_mixed)
        n_pos = jnp.where(uphill, 0, n_pos + 1)
        grow = (~uphill) & (n_pos > n_min)
        dt = jnp.where(grow, jnp.minimum(dt * f_inc, dt_max),
                       jnp.where(uphill, dt * f_dec, dt))
        alpha = jnp.where(grow, alpha * f_alpha,
                          jnp.where(uphill, alpha0, alpha))

        vel = vel + dt * force
        pos = pos + dt * vel
        return (pos, vel, dt, alpha, n_pos), energy

    @partial(jax.jit, static_argnames=("iters",))
    def run(pos, iters: int):
        state = (pos, jnp.zeros_like(pos), jnp.asarray(dt0, pos.dtype),
                 jnp.asarray(alpha0, pos.dtype), jnp.asarray(0))
        state, energies = jax.lax.scan(step, state, length=iters)
        return state[0], energies

    return run(pos0, maxiter)


def make_fire_runner(force_fn, maxiter: int = 200, dt0: float = 1e-4,
                     dt_max: float = 2e-3, n_min: int = 5, f_inc: float = 1.1,
                     f_dec: float = 0.5, alpha0: float = 0.1,
                     f_alpha: float = 0.99):
    """Pure-function FIRE minimizer suitable for jit/vmap composition.

    force_fn(pos) -> out dict with "energy", "force" and (optionally)
    "diag".  Returns run(pos0) -> (pos_min, energy_trace [maxiter], diag),
    where diag is the last evaluation's diag with the overflow-checked
    counters ("counts", "max_siblings", "neighbor_max") replaced by running
    maxima over ALL iterations — minimization moves atoms, so the overlap
    tree seen mid-trajectory can be larger than at either endpoint and a
    PanicButton check must see the worst case (the same bookkeeping the MD
    runners do, md/simulation.py).
    """
    _MAXKEYS = ("counts", "max_siblings", "neighbor_max")

    def step(state, _):
        pos, vel, dt, alpha, n_pos, dmax = state
        out = force_fn(pos)
        energy, force = out["energy"], out["force"]
        diag = out.get("diag")
        if diag is not None:
            dmax = {k: jnp.maximum(dmax[k], diag[k]) for k in dmax}
        power = jnp.vdot(force, vel, precision=jax.lax.Precision.HIGHEST)

        fnorm = jnp.linalg.norm(force) + 1e-30
        vnorm = jnp.linalg.norm(vel)
        vel_mixed = (1.0 - alpha) * vel + alpha * vnorm * force / fnorm

        uphill = power <= 0.0
        vel = jnp.where(uphill, jnp.zeros_like(vel), vel_mixed)
        n_pos = jnp.where(uphill, 0, n_pos + 1)
        grow = (~uphill) & (n_pos > n_min)
        dt = jnp.where(grow, jnp.minimum(dt * f_inc, dt_max),
                       jnp.where(uphill, dt * f_dec, dt))
        alpha = jnp.where(grow, alpha * f_alpha,
                          jnp.where(uphill, alpha0, alpha))

        vel = vel + dt * force
        pos = pos + dt * vel
        return (pos, vel, dt, alpha, n_pos, dmax), energy

    def run(pos0):
        out0 = force_fn(pos0)
        diag0 = out0.get("diag")
        dmax0 = ({} if diag0 is None
                 else {k: diag0[k] for k in _MAXKEYS if k in diag0})
        state = (pos0, jnp.zeros_like(pos0), jnp.asarray(dt0, pos0.dtype),
                 jnp.asarray(alpha0, pos0.dtype), jnp.asarray(0), dmax0)
        state, energies = jax.lax.scan(step, state, length=maxiter)
        pos, dmax = state[0], state[5]
        diag = None if diag0 is None else {**diag0, **dmax}
        return pos, energies, diag

    return run
