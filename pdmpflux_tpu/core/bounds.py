"""Thinning-envelope construction and inversion (Andral & Kamatani 2024, §4).

JAX reimplementation of the reference's ``src/UpperBound.jl``:

* the grid envelope is pure, fixed-shape tensor math (no Python loops),
  batched over the grid axis and — via ``jax.vmap`` at the call site — over
  chain batches;
* the time-derivative of the rate along the flow is a single ``jax.jvp``
  (exact forward-mode tangent), replacing the reference's per-backend zoo
  (``UpperBound.jl:98-121``) — a finite-difference fallback is kept for
  non-differentiable user rates;
* Brent's method for the ``grid_size == 0`` constant bound
  (``UpperBound.jl:18-36``) becomes a fixed-iteration coarse-scan +
  golden-section refinement, which is jit-compilable (documented deviation:
  both find a *local* maximum; the thinning error-recovery path guarantees
  correctness of the sampled law either way — envelope slack only costs
  efficiency, never correctness).

The envelope inversion ``next_event`` (``UpperBound.jl:264-273``) is a
``searchsorted`` + linear interpolation, identical semantics including the
"no event within horizon" ``t_prop = inf`` overflow case.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from .types import BoundBox

# Golden-section constants for the constant-bound maximizer.
_INVPHI = 0.6180339887498949
_INVPHI2 = 0.38196601125010515


def _time_derivatives(scalar_fn: Callable, ts, horizon, mode: str):
    """Values and d/dt of ``scalar_fn`` (scalar- or vector-valued) on grid ``ts``.

    ``mode == "jvp"``: exact forward-mode tangents (one pass, fused).
    ``mode == "finite_diff"``: central differences with sqrt(eps)-scaled,
    boundary-aware steps — mirrors ``finite_difference_derivative``
    (``UpperBound.jl:50-76``), used when the user rate is not differentiable.
    """
    if mode == "jvp":
        def val_and_tangent(t):
            return jax.jvp(scalar_fn, (t,), (jnp.ones_like(t),))
        return jax.vmap(val_and_tangent)(ts)
    elif mode == "finite_diff":
        eps = jnp.finfo(ts.dtype).eps
        h = jnp.sqrt(eps) * jnp.maximum(1.0, jnp.abs(ts))
        lo = jnp.maximum(0.0, ts - h)
        hi = jnp.minimum(horizon, ts + h)
        f = jax.vmap(scalar_fn)(ts)
        f_lo = jax.vmap(scalar_fn)(lo)
        f_hi = jax.vmap(scalar_fn)(hi)
        span = hi - lo
        def div(num, den):
            den = jnp.where(den == 0, 1.0, den)
            return num / den
        # shapes: f may be (n,) or (n, d); broadcast the time axis.
        extra = (1,) * (f.ndim - 1)
        span_b = span.reshape(span.shape + extra)
        grads = div(f_hi - f_lo, span_b)
        return f, grads
    else:  # pragma: no cover - config error
        raise ValueError(f"unknown time-derivative mode: {mode}")


def _segment_envelope(values, grads, step_size):
    """Per-segment envelope from endpoint values/derivatives.

    Implements the tangent-intersection rule of ``upper_bound_grid``
    (``UpperBound.jl:123-131``): the envelope of each segment is
    ``max(f_left, f_right, f_left + g_left * s*, 0)`` where ``s*`` is the
    intersection offset of the two endpoint tangents, clamped to
    ``[0, step]``.  NaN intersections (parallel tangents) resolve to 0,
    exactly as the reference's ``replace(NaN => 0)``.

    Note on the vectorized variant: ``upper_bound_grid_vect``
    (``UpperBound.jl:229-235``) computes the intersection in *absolute* time
    but clamps it to the *relative* range ``[0, step]``; the scalar variant
    (``UpperBound.jl:123``) uses the algebraically equivalent offset form
    before clamping.  We use the offset form uniformly (the two differ only
    in which conservative envelope they produce; the thinning correction
    makes both exact in law).

    ``values``/``grads`` have the grid as axis 0; any trailing axes (e.g. a
    per-dimension axis for the vectorized strategy) ride along elementwise.
    """
    f0, f1 = values[:-1], values[1:]
    g0, g1 = grads[:-1], grads[1:]
    denom = g1 - g0
    num = f0 - f1 + g1 * step_size
    denom_safe = jnp.where(denom == 0, 1.0, denom)
    ip = jnp.where(denom == 0, 0.0, num / denom_safe)
    ip = jnp.where(jnp.isnan(ip), 0.0, ip)
    ip = jnp.clip(ip, 0.0, step_size)
    intersection = f0 + g0 * ip
    box = jnp.maximum(jnp.maximum(f0, f1), jnp.maximum(intersection, 0.0))
    return box


def upper_bound_grid(
    rate_fn: Callable,
    horizon,
    n_grid: int,
    refresh_rate=0.0,
    tderiv: str = "jvp",
) -> BoundBox:
    """Scalar-rate grid envelope — ``upper_bound_grid`` (``UpperBound.jl:92-137``).

    ``rate_fn(t) -> scalar`` is the (possibly signed) rate along the flow from
    the current state; ``n_grid`` points span ``[0, horizon]``.
    """
    ts = jnp.linspace(0.0, horizon, n_grid)
    step = horizon / (n_grid - 1)
    values, grads = _time_derivatives(rate_fn, ts, horizon, tderiv)
    box = _segment_envelope(values, grads, step) + refresh_rate
    cum = jnp.concatenate([jnp.zeros((1,), box.dtype), jnp.cumsum(box) * step])
    return BoundBox(grid=ts, box_max=box, cum_sum=cum, step_size=step)


def upper_bound_grid_vect(
    rate_vect_fn: Callable,
    horizon,
    n_grid: int,
    tderiv: str = "jvp",
) -> BoundBox:
    """Vectorized (per-dimension) grid envelope — ``UpperBound.jl:203-247``.

    ``rate_vect_fn(t) -> (d,)`` returns the per-dimension rate vector; the
    per-dimension envelopes are summed over dimensions into a single scalar
    envelope (``vec(sum(box_max, dims=1))`` in the reference).  No refresh
    rate is added (the reference's vectorized path has none).
    """
    ts = jnp.linspace(0.0, horizon, n_grid)
    step = horizon / (n_grid - 1)
    values, grads = _time_derivatives(rate_vect_fn, ts, horizon, tderiv)  # (n, d)
    box_nd = _segment_envelope(values, grads, step)  # (n-1, d)
    box = jnp.sum(box_nd, axis=-1)
    cum = jnp.concatenate([jnp.zeros((1,), box.dtype), jnp.cumsum(box) * step])
    return BoundBox(grid=ts, box_max=box, cum_sum=cum, step_size=step)


def upper_bound_constant(
    rate_fn: Callable,
    horizon,
    refresh_rate=0.0,
    n_coarse: int = 17,
    n_refine: int = 16,
) -> BoundBox:
    """Constant envelope via bounded maximization — ``UpperBound.jl:18-36``.

    The reference maximizes the unsigned rate on ``[0, horizon]`` with
    Brent's method.  Inside jit we use a fixed-cost scheme: evaluate on a
    coarse grid, bracket the best point, then golden-section refine.  Like
    Brent, this may return a local maximum; bound violations are repaired by
    the ``ar > 1`` recovery path of the engine, so the sampled law is exact.
    """
    ts = jnp.linspace(0.0, horizon, n_coarse)
    vals = jax.vmap(rate_fn)(ts)
    i = jnp.argmax(vals)
    span = horizon / (n_coarse - 1)
    lo = jnp.maximum(0.0, ts[i] - span)
    hi = jnp.minimum(horizon, ts[i] + span)

    def body(_, carry):
        lo, hi, best = carry
        m1 = lo + _INVPHI2 * (hi - lo)
        m2 = lo + _INVPHI * (hi - lo)
        f1 = rate_fn(m1)
        f2 = rate_fn(m2)
        best = jnp.maximum(best, jnp.maximum(f1, f2))
        take_left = f1 >= f2
        lo = jnp.where(take_left, lo, m1)
        hi = jnp.where(take_left, m2, hi)
        return lo, hi, best

    _, _, best = jax.lax.fori_loop(0, n_refine, body, (lo, hi, vals[i]))
    box = jnp.reshape(best + refresh_rate, (1,))
    grid = jnp.stack([jnp.zeros_like(horizon), horizon])
    cum = jnp.concatenate([jnp.zeros((1,), box.dtype), box * horizon])
    return BoundBox(grid=grid, box_max=box, cum_sum=cum, step_size=horizon)


def next_event(box: BoundBox, exp_rv):
    """Invert the piecewise-constant envelope at cumulative draw ``exp_rv``.

    Exact counterpart of ``next_event`` (``UpperBound.jl:264-273``):
    ``searchsortedfirst`` + linear interpolation within the segment; if
    ``exp_rv`` exceeds the integrated envelope, returns
    ``(inf, box_max[-1])`` — no event within the horizon.
    """
    cum = box.cum_sum
    n = cum.shape[0]
    idx = jnp.searchsorted(cum, exp_rv, side="left")
    overflow = idx >= n
    idx_c = jnp.clip(idx, 1, n - 1)
    lo = cum[idx_c - 1]
    hi = cum[idx_c]
    den = jnp.where(hi == lo, 1.0, hi - lo)
    frac = (exp_rv - lo) / den
    seg_len = box.grid[idx_c] - box.grid[idx_c - 1]
    tp = box.grid[idx_c - 1] + frac * seg_len
    tp = jnp.where(overflow, jnp.inf, tp)
    lam = jnp.where(overflow, box.box_max[-1], box.box_max[idx_c - 1])
    return tp, lam
