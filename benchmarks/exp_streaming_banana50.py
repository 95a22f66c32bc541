"""Streaming statistics on the 50-d banana: past the HBM skeleton limit.

The materialized ``zigzag_banana_d50_constbound`` row is capped at ~16k
events/chain by the on-device accumulator (256 chains x 50 dims); its
split-R-hat gates at ~1.016 — barely inside the 1.02 threshold, because
the banana's curved ridge mixes slowly.  This run demonstrates that
``sample_streaming_stats`` generalizes beyond the sticky flagship: the
same ZigZag/constant-bound sampler runs 4x the events per chain in O(B*d)
memory with ``stop_when_converged`` treating the horizon as a budget.

Writes/updates the ``zigzag_banana_d50_streaming`` row of
``benchmarks/baseline_results.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _log(msg):
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--events-per-chain", type=int, default=65536)
    ap.add_argument("--n-samples", type=int, default=32768)
    ap.add_argument("--n-batches", type=int, default=64)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--no-write", action="store_true")
    args = ap.parse_args()

    import jax

    from pdmpflux_tpu.utils.profiling import enable_persistent_cache

    enable_persistent_cache()
    import jax.numpy as jnp

    import pdmpflux_tpu as pf

    B, d = args.chains, 50

    def banana_grad(x):
        m = x[0] ** 2 - 1
        g0 = x[0] - 2.0 * x[0] * (x[1] - m)
        g1 = x[1] - m
        return jnp.concatenate([jnp.array([g0, g1]), x[2:]])

    def make():
        return pf.ZigZag(d, banana_grad, grid_size=0)

    x0 = np.ones((B, d))
    v0 = np.ones((B, d))
    kw = dict(dtype=jnp.float32)

    _log("calibration...")
    cal = make()
    T_guess = 50.0
    t0 = time.time()
    run_cal = pf.sample_streaming_stats(
        cal, T_guess, x0, v0, n_samples=1024, n_batches=16, seed=args.seed,
        **kw,
    )
    rate = run_cal.events / B / T_guess
    _log(f"calibration: rate={rate:.1f} ev/chain/time in "
         f"{time.time()-t0:.1f}s")

    T = args.events_per_chain / rate
    # Size the fold window to the grid points one fill produces: the fill's
    # clock is capped so its grid advance fits [j_done, j_done + G), and a
    # G far below the natural advance throttles fills to a fraction of
    # their capacity (measured: G=512 ran this config at 9% fill
    # utilization, 1.5M events/s; G sized from the calibrated rate runs
    # full fills).  rows/time ~ rate / acceptance; dt_grid = T/n_samples.
    rows_per_time = rate * 1.1
    t_cap_est = 8192
    points_per_fill = args.n_samples * (t_cap_est / rows_per_time) / T
    G = int(min(8192, max(512, 1.3 * points_per_fill)))
    _log(f"gated run: T budget {T:.4g} (~{args.events_per_chain} "
         f"events/chain), grid_chunk={G}, stop_when_converged...")
    sampler = make()
    skw = dict(n_samples=args.n_samples, n_batches=args.n_batches,
               verbose=True, stop_when_converged=True, check_every=1,
               grid_chunk=G)
    # first run pays the program compile (the gated run is short — 16
    # fills — so compile would dominate its wall); report the warm rerun
    pf.sample_streaming_stats(sampler, float(T), x0, v0,
                              seed=args.seed + 1, **skw, **kw)
    t0 = time.time()
    run = pf.sample_streaming_stats(
        sampler, float(T), x0, v0, seed=args.seed + 2, **skw, **kw,
    )
    wall = time.time() - t0
    summ = pf.streaming_summary(run)
    ev_s = run.events / wall

    # banana truth: E = 0; Var = (1, 3, 1, ..., 1)
    truth_var = np.concatenate([[1.0, 3.0], np.ones(d - 2)])
    row = {
        "config": "zigzag_banana_d50_streaming",
        "backend": "auto",
        "platform": jax.devices()[0].platform,
        "chains": B,
        "events_per_chain": int(round(run.events / B)),
        "events_per_sec": round(ev_s, 1),
        "ess_per_sec_worst_coord": round(
            summ["ess_total_worst_coord"] / wall, 1),
        "ess_total_worst_coord": round(summ["ess_total_worst_coord"], 1),
        "rhat_max": round(summ["rhat_max"], 4),
        "rhat_ok": summ["converged"],
        "moment_mean_err_max": round(
            float(np.abs(summ["pooled_mean"]).max()), 4),
        "moment_var_relerr_max": round(
            float(np.abs(summ["pooled_var"] / truth_var - 1.0).max()), 4),
        "wall_s": round(wall, 3),
        "fills": run.fills,
        "note": (
            "streaming statistics with stop_when_converged: 4x the "
            "materialized row's HBM-capped events/chain budget, stopped at "
            "the split-R-hat gate (pdmpflux_tpu/streaming.py)"
        ),
    }
    print(json.dumps(row), flush=True)

    if not args.no_write:
        out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "baseline_results.json")
        rows = []
        if os.path.exists(out):
            with open(out) as f:
                rows = json.load(f)
        rows = [r for r in rows if r["config"] != row["config"]] + [row]
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)
        _log(f"wrote {out}")


if __name__ == "__main__":
    main()
