"""Diagnostics — counterpart of ``/root/reference/src/diagnostic.jl``.

* ``diagnostic(skeleton)``: 2x2 summary figure (inter-event times,
  acceptance-rate histogram with mean line, hitting-horizon and rejection
  histograms on log axes) + printed errored-bound total (diagnostic.jl:4-21).
* ``RV_diagnostic(skeleton, U, B)``: offline realized volatility of ``U``
  along the path, reconstructed with the *linear* masked flow exactly as the
  reference (diagnostic.jl:23-75 — approximate for curved-flow samplers,
  noted there too).
* ``ess`` / ``ess_per_dim``: effective sample size (Geyer initial positive
  sequence on FFT autocorrelations) — the quantity the benchmark targets
  (BASELINE.json) require; absent in the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .core.types import Skeleton


def diagnostic(skeleton: Skeleton, color="#78C2AD", show=False, save_path=None):
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    t = np.asarray(skeleton.t)
    ar = np.asarray(skeleton.ar)
    hit = np.asarray(skeleton.hitting_horizon)
    rej = np.asarray(skeleton.rejected)
    err = np.asarray(skeleton.errored_bound)
    if t.ndim == 2:
        # chain batch: pool only the valid (written) rows of each chain —
        # padding slots are zeros and would corrupt every histogram
        n_valid = np.asarray(skeleton.n_valid)
        valid = np.arange(t.shape[1])[None, :] < n_valid[:, None]
        dt = np.concatenate(
            [np.diff(t[b, : n_valid[b]]) for b in range(t.shape[0])]
        )
        ar, hit, rej, err = (a[valid] for a in (ar, hit, rej, err))
    else:
        dt = np.diff(t)
    err_total = int(err.sum())

    fig, axes = plt.subplots(2, 2, figsize=(12, 9))
    axes[0, 0].hist(dt, bins="auto", color=color)
    axes[0, 0].set(title="Time between events histogram", xlabel="Time",
                   ylabel="Count")
    axes[0, 1].hist(ar, bins="auto", color=color, density=True)
    axes[0, 1].axvline(ar.mean(), ls="--", color="#E95420")
    axes[0, 1].set(
        title=f"Acceptance rate histogram (Mean: {ar.mean():.3f})",
        xlabel="Rate", ylabel="Relative Frequency",
    )
    axes[1, 0].hist(hit, bins=15, color=color, log=True)
    axes[1, 0].set(
        title=f"Hitting horizon histogram (Total: {int(hit.sum())})",
        xlabel="Horizon", ylabel="Log Frequency",
    )
    axes[1, 1].hist(rej, bins=20, color=color, log=True)
    axes[1, 1].set(
        title=f"Rejection histogram (Total: {int(rej.sum())})",
        xlabel="Rejections", ylabel="Log Frequency",
    )
    fig.tight_layout()
    print("number of error bound:", err_total)
    if save_path:
        fig.savefig(save_path)
    if show:
        plt.show()
    return fig


def RV_diagnostic(skeleton: Skeleton, U, B: int = 0):
    """Offline realized volatility with linear masked-velocity flow
    (diagnostic.jl:37-75).

    Accepts a single-chain ``(N,)`` skeleton (returns a float, like the
    reference) or a chain-batch ``(Bc, N)`` skeleton (returns a ``(Bc,)``
    array of per-chain RVs — the reference has no chain batching at all).
    """
    t = np.asarray(skeleton.t)
    if t.ndim == 2:
        return _rv_diagnostic_batch(skeleton, U, B)
    N = len(t)
    if N == 0:
        return 0.0
    T = float(t[-1])
    if not np.isfinite(T) or T < 0:
        raise ValueError(
            f"history.t[end] must be finite and non-negative. Current value: {T}"
        )
    if B == 0:
        B = max(1, int(np.floor(np.sqrt(N))))
    elif B < 0:
        raise ValueError(f"B must be non-negative. Current value: {B}")
    if T == 0.0:
        return 0.0

    X = np.asarray(skeleton.x)
    V = np.asarray(skeleton.v)
    A = np.asarray(skeleton.is_active)
    boundaries = np.linspace(0.0, T, B + 1)
    idx = np.clip(np.searchsorted(t, boundaries, side="right") - 1, 0, N - 1)
    tau = boundaries - t[idx]
    x_b = X[idx] + np.where(A[idx], V[idx], 0.0) * tau[:, None]
    u = np.asarray(jax.vmap(U)(jnp.asarray(x_b)))
    # boundaries[0] == 0 gives x(0) = X[0]; increments telescope exactly as
    # the reference's per-event accumulation does.
    return float(np.sum(np.diff(u) ** 2) / T)


def _rv_diagnostic_batch(skeleton: Skeleton, U, B: int) -> np.ndarray:
    """Vectorized chain-batch RV: per-chain boundaries on the chain's own
    ``[0, t_end]`` with the padded tail masked out of the boundary search
    (one jitted call for the whole batch — a per-chain Python loop would pay
    one eager dispatch per chain)."""
    t = np.asarray(skeleton.t)
    n_valid = np.asarray(skeleton.n_valid)
    Bc, N = t.shape
    t_end = t[np.arange(Bc), np.maximum(n_valid - 1, 0)]
    if not (np.all(np.isfinite(t_end)) and np.all(t_end >= 0)):
        raise ValueError(
            "history.t[end] must be finite and non-negative for every chain."
        )
    if B == 0:
        B = max(1, int(np.floor(np.sqrt(max(int(n_valid.min()), 1)))))
    elif B < 0:
        raise ValueError(f"B must be non-negative. Current value: {B}")

    def rv_all(tm, X, V, A, nv, tend):
        col = jnp.arange(N, dtype=jnp.int32)[None, :]
        t_m = jnp.where(col < nv[:, None], tm, jnp.asarray(jnp.inf, tm.dtype))

        def one(tb, xb, vb, ab, te):
            bounds = jnp.linspace(0.0, 1.0, B + 1).astype(tb.dtype) * te
            idx = jnp.clip(
                jnp.searchsorted(tb, bounds, side="right") - 1, 0, N - 1
            )
            tau = bounds - tb[idx]  # idx stays in the finite valid prefix
            x_b = xb[idx] + jnp.where(ab[idx], vb[idx], 0.0) * tau[:, None]
            u = jax.vmap(U)(x_b)
            return jnp.where(
                te > 0, jnp.sum(jnp.diff(u) ** 2) / jnp.where(te > 0, te, 1.0),
                0.0,
            )

        return jax.vmap(one)(t_m, X, V, A, tend)

    out = jax.jit(rv_all)(
        jnp.asarray(t), jnp.asarray(skeleton.x), jnp.asarray(skeleton.v),
        jnp.asarray(skeleton.is_active), jnp.asarray(n_valid, jnp.int32),
        jnp.asarray(t_end),
    )
    return np.asarray(out)


def _autocorr_fft(x: np.ndarray) -> np.ndarray:
    n = len(x)
    x = x - x.mean()
    m = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, m)
    acov = np.fft.irfft(f * np.conj(f))[:n].real
    if acov[0] <= 0:
        return np.zeros(n)
    return acov / acov[0]


def ess(series: np.ndarray) -> float:
    """Effective sample size of a 1-d series via Geyer's initial positive
    sequence estimator: ``tau = -1 + 2 * sum_k Gamma_k`` over the pair sums
    ``Gamma_k = rho_{2k} + rho_{2k+1}`` truncated at the first non-positive
    pair; ``ESS = n / tau``."""
    series = np.asarray(series, float)
    n = len(series)
    if n < 4 or np.var(series) == 0:
        return float(n)
    rho = _autocorr_fft(series)
    n_pairs = (len(rho) - 1) // 2
    gamma = rho[: 2 * n_pairs : 2] + rho[1 : 2 * n_pairs + 1 : 2]
    nonpos = np.nonzero(gamma <= 0)[0]
    cut = int(nonpos[0]) if len(nonpos) else len(gamma)
    tau = -1.0 + 2.0 * float(np.sum(gamma[:cut]))
    return float(n / max(tau, 1e-12))


def ess_per_dim(samples: np.ndarray) -> np.ndarray:
    """ESS of each coordinate of an ``(N, d)`` sample array."""
    s = np.asarray(samples, float)
    return np.asarray([ess(s[:, j]) for j in range(s.shape[1])])


def ess_nd(samples: np.ndarray) -> np.ndarray:
    """Vectorized Geyer ESS: ``(B, N, d)`` chains-by-samples-by-coordinates
    (or ``(N, d)`` / ``(N,)``) -> per-series ESS with the chain/coordinate
    axes preserved.  Identical estimator to :func:`ess`, batched through one
    FFT so benchmark sweeps can afford ESS over *all* coordinates of
    hundreds of chains."""
    s = np.asarray(samples, float)
    shape = s.shape
    if s.ndim == 1:
        s = s[None, :, None]
    elif s.ndim == 2:
        s = s[None]
    B, N, d = s.shape
    if N < 4:
        full = np.full((B, d), float(N))
        return full[0, 0] if len(shape) == 1 else (
            full[0] if len(shape) == 2 else full
        )
    x = s - s.mean(axis=1, keepdims=True)
    m = 1 << (2 * N - 1).bit_length()
    f = np.fft.rfft(x, m, axis=1)
    acov = np.fft.irfft(f * np.conj(f), axis=1)[:, :N].real
    var0 = acov[:, 0:1]
    ok = var0 > 0
    rho = np.where(ok, acov / np.where(ok, var0, 1.0), 0.0)
    n_pairs = (N - 1) // 2
    gamma = rho[:, : 2 * n_pairs : 2] + rho[:, 1 : 2 * n_pairs + 1 : 2]
    nonpos = gamma <= 0
    first = np.where(nonpos.any(axis=1), nonpos.argmax(axis=1), n_pairs)
    k_idx = np.arange(n_pairs)[None, :, None]
    tau = -1.0 + 2.0 * np.sum(
        np.where(k_idx < first[:, None, :], gamma, 0.0), axis=1
    )
    out = np.where(ok[:, 0], N / np.maximum(tau, 1e-12), float(N))  # (B, d)
    if len(shape) == 1:
        return out[0, 0]
    if len(shape) == 2:
        return out[0]
    return out


def split_rhat(samples: np.ndarray) -> np.ndarray:
    """Split-R̂ per coordinate of a ``(B, N, d)`` chain batch (each chain is
    halved, giving ``2B`` sequences; Gelman-Rubin potential scale reduction
    on the halves).  Values near 1 indicate the chains agree with their own
    second halves and with each other."""
    s = np.asarray(samples, float)
    if s.ndim == 2:
        s = s[None]
    B, N, d = s.shape
    n = N // 2
    if n < 2:
        return np.ones(d)
    seq = np.concatenate([s[:, :n], s[:, n : 2 * n]], axis=0)  # (2B, n, d)
    mu = seq.mean(axis=1)
    W = seq.var(axis=1, ddof=1).mean(axis=0)
    B_var = n * mu.var(axis=0, ddof=1)
    var_plus = (n - 1) / n * W + B_var / n
    return np.sqrt(np.where(W > 0, var_plus / np.where(W > 0, W, 1.0), 1.0))


RHAT_THRESHOLD = 1.02
"""Default split-R̂ convergence gate, shared by :func:`ess_summary`, the
benchmark sweep (``benchmarks/run_baselines.py``), and the README table so
every published ESS/s number is gated identically.  Pass a stricter value
(e.g. the 1.01 of Vehtari et al. 2021) explicitly where needed."""


def ess_summary(samples: np.ndarray,
                rhat_threshold: float = RHAT_THRESHOLD) -> dict:
    """Aggregate cross-chain ESS with convergence gating.

    Estimator (printed by ``benchmarks/run_baselines.py``): per-chain Geyer
    ESS on every coordinate, summed over chains per coordinate (chains are
    independent by construction — distinct PRNG keys), with the **worst
    coordinate** reported as the aggregate; the sum is only trustworthy when
    the chains have converged, so ``converged`` gates on
    ``max_d split_rhat < rhat_threshold`` (default :data:`RHAT_THRESHOLD`).
    """
    s = np.asarray(samples, float)
    if s.ndim == 2:
        s = s[None]
    ess_bd = ess_nd(s)                    # (B, d)
    per_coord = ess_bd.sum(axis=0)        # (d,)
    rhat = split_rhat(s)
    return {
        "ess_per_coord": per_coord,
        "ess_total_worst_coord": float(per_coord.min()),
        "rhat": rhat,
        "rhat_max": float(rhat.max()),
        "converged": bool(rhat.max() < rhat_threshold),
    }
