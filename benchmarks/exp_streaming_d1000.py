"""Convergence-gated dim-1000 sticky ESS/s via streaming statistics.

BASELINE.json config 5 (sticky Zig-Zag, spike-and-slab, dim=1000; reference
workload ``/root/reference/test/test_coverage.jl:254-292``) needs ~0.5M
events/chain to pass the split-R-hat gate — several HBMs' worth of skeleton
at B=128.  ``sample_streaming_stats`` folds each fill into O(B*d)
accumulators and discards it, so the run length is bounded by wall-clock,
not memory (VERDICT r4 item 1).

Two stages:

1. calibration — a short horizon measures events per unit time per chain;
2. the gated run — T extrapolated to hit ``--events-per-chain`` (default
   524288), folded over ``--n-samples`` grid points with ``--n-batches``
   ESS windows.

Writes/updates the ``sticky_zigzag_d1000_streaming`` row of
``benchmarks/baseline_results.json`` and prints it as one JSON line.
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
    ap.add_argument("--chains", type=int, default=128)
    ap.add_argument("--dim", type=int, default=1000)
    ap.add_argument("--kappa", type=float, default=10.0)
    ap.add_argument("--events-per-chain", type=int, default=524288)
    ap.add_argument("--n-samples", type=int, default=65536)
    ap.add_argument("--n-batches", type=int, default=128)
    ap.add_argument("--cal-events", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--t-cap", type=int, default=None)
    ap.add_argument("--autostop", action="store_true",
                    help="treat T as a budget: stop when split-R-hat gates (rhat-only checks every ~32 fills)")
    ap.add_argument("--no-write", action="store_true")
    args = ap.parse_args()

    import jax

    from pdmpflux_tpu.utils.profiling import enable_persistent_cache

    enable_persistent_cache()
    import jax.numpy as jnp

    import pdmpflux_tpu as pf
    from pdmpflux_tpu.utils import potentials

    B, d = args.chains, args.dim

    def make():
        return pf.StickyZigZagAD(d, potentials.gauss, np.full(d, args.kappa))

    x0 = np.full((B, d), 0.3)
    v0 = np.ones((B, d))
    kw = dict(dtype=jnp.float32)

    # --- stage 1: calibrate events per unit time ------------------------
    _log("calibration run (compile + rate estimate)...")
    cal = make()
    # crude initial horizon guess: per-chain event rate ~ sum of coordinate
    # rates ~ d * 0.5 at the spike-and-slab equilibrium; refined below
    T_guess = args.cal_events / (0.5 * d)
    t0 = time.time()
    run_cal = pf.sample_streaming_stats(
        cal, float(T_guess), x0, v0, n_samples=1024, n_batches=16,
        seed=args.seed, **kw,
    )
    wall_cal = time.time() - t0
    rate = run_cal.events / B / T_guess  # events per unit time per chain
    _log(f"calibration: {run_cal.events} events in {wall_cal:.1f}s "
         f"(T={T_guess:.3g}, rate={rate:.1f} ev/chain/time, "
         f"{run_cal.fills} fills)")

    # --- stage 2: the gated run ----------------------------------------
    T = args.events_per_chain / rate
    _log(f"gated run: T={T:.4g} for ~{args.events_per_chain} events/chain "
         f"x {B} chains...")
    sampler = make()
    t0 = time.time()
    run = pf.sample_streaming_stats(
        sampler, float(T), x0, v0, n_samples=args.n_samples,
        n_batches=args.n_batches, seed=args.seed + 1, verbose=True,
        t_cap=args.t_cap, stop_when_converged=args.autostop,
        check_every=4, **kw,
    )
    wall = time.time() - t0
    summ = pf.streaming_summary(run, x_ref=x0.mean(axis=0))
    ev_s = run.events / wall

    act_final = np.asarray(jax.device_get(run.state.is_active))
    row = {
        "config": "sticky_zigzag_d1000_streaming",
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
        "mean_absmax": round(float(np.abs(summ["pooled_mean"]).max()), 4),
        "var_mean": round(float(summ["pooled_var"].mean()), 4),
        "frozen_frac_final": round(float(1.0 - act_final.mean()), 4),
        "wall_s": round(wall, 3),
        "fills": run.fills,
        "horizon_T": round(T, 2),
        "n_grid_samples": args.n_samples,
        "note": (
            "streaming statistics: fills folded into O(B*d) moment/"
            "batch-mean accumulators and discarded, so the run is not "
            "bounded by HBM (pdmpflux_tpu/streaming.py); ESS via batch "
            "means over equal-time samples, burn-in 25%"
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
