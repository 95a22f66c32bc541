"""GPU bring-up measurements of the XLA stream path.

1. The flagship stream fill (ZigZag, 10-d Gaussian, B=8192, 2,047 events
   per chain, f32) timed alone, and the same run end to end through
   ``pf.sample_skeleton``.
2. One short ``jax.profiler`` trace of that fill, reduced to device kernels
   per transition and the device's idle share over the traced window.
3. Log-shift against gather event compaction at several state dimensions
   with the flagship fill width, which sets ``engine.GATHER_DIM_THRESHOLD``.

Run on the GPU (it refuses any other device)::

    python benchmarks/exp_bringup.py [--out benchmarks/bringup]

Prints one line per measurement and writes ``<out>/bringup.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _median_time(fn, reps=5):
    fn()  # warm
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def _block(tree):
    import jax

    return jax.block_until_ready(tree)


def reduce_trace(logdir):
    """Device kernel events and busy/idle share of every GPU plane in the
    newest ``.xplane.pb`` under ``logdir``."""
    import glob

    import jax

    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        return {"error": f"no xplane under {logdir}"}
    data = jax.profiler.ProfileData.from_file(paths[-1])
    out = {"planes": []}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        spans, names = [], {}
        line_names = []
        for line in plane.lines:
            line_names.append(line.name)
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.end_ns))
                names[ev.name] = names.get(ev.name, 0) + 1
        if not spans:
            out["planes"].append({"plane": plane.name, "lines": line_names})
            continue
        spans.sort()
        busy, cur_s, cur_e = 0, *spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = spans[-1][1] - spans[0][0]
        top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
        out["planes"].append({
            "plane": plane.name, "lines": line_names,
            "kernel_events": len(spans), "busy_ns": busy,
            "window_ns": window, "idle_share": 1.0 - busy / max(window, 1),
            "top_kernels": top,
        })
    return out


def fill_measurements(pf, jax, jnp, engine, outdir, B=8192, n_sk=2048,
                      dim=10):
    target = n_sk - 1
    sampler = pf.ZigZag(dim, lambda x: x)
    x0, v0 = np.zeros((B, dim)), np.ones((B, dim))

    def e2e(seed):
        skel = pf.sample_skeleton(sampler, n_sk, x0, v0, seed=seed,
                                  dtype=jnp.float32)
        return np.asarray(jax.device_get(skel.n_valid))

    e2e(0)
    e2e(1)  # compiles the learned fill width
    # the fill width the public path settled on
    t_cap = [k[1] for k in sampler._jit_cache
             if k[0] == "stream_one_shot"][-1]
    e2e_s = _median_time(lambda: e2e(2), reps=3)

    run = jax.jit(engine.make_stream_runner(sampler, t_cap, chunk=64),
                  static_argnums=(3,), donate_argnums=(1,))
    state = sampler.init_state_batch(x0, v0, 3, jnp.float32)

    def fill():
        stream = engine.empty_stream(t_cap, dim, jnp.float32, B)
        return _block(run(state, stream, jnp.zeros((B,), jnp.int32), target))

    res = fill()
    transitions = int(res.transitions)
    events = int(np.asarray(res.counts).sum())
    fill_s = _median_time(fill)
    rec = {
        "B": B, "events_per_chain": target, "t_cap": t_cap,
        "transitions": transitions, "fill_events": events,
        "fill_s": fill_s, "fill_events_per_s": events / fill_s,
        "e2e_s": e2e_s, "e2e_events_per_s": B * target / e2e_s,
    }
    print(f"[fill] {rec}", flush=True)

    logdir = os.path.join(outdir, "trace_fill")
    with jax.profiler.trace(logdir):
        fill()
    tr = reduce_trace(logdir)
    for p in tr.get("planes", []):
        if "kernel_events" in p:
            p["kernels_per_transition"] = p["kernel_events"] / transitions
    rec["trace"] = tr
    print(f"[trace] {json.dumps(tr)}", flush=True)
    return rec


COMPACTION_SHAPES = ((2, 8192), (4, 8192), (10, 8192), (10, 1024), (32, 1024), (64, 1024),
                     (100, 1024), (128, 1024), (256, 1024), (1000, 128))


def compaction_measurements(jax, jnp, engine, t_cap=2816, n_keep=2047,
                            shapes=COMPACTION_SHAPES):
    """Median warm time of each compaction formulation on a random stream
    of the flagship fill width (~73% event rows, the ZigZag ratio), per
    ``(dim, B)`` shape."""
    rows = []
    for dim, B in shapes:
        ks = jax.random.split(jax.random.key(dim), 4)
        stream = engine.Skeleton(
            x=jax.random.normal(ks[0], (B, t_cap, dim), jnp.float32),
            v=jax.random.normal(ks[1], (B, t_cap, dim), jnp.float32),
            t=jnp.cumsum(jax.random.uniform(ks[2], (B, t_cap)), axis=1),
            horizon=jnp.ones((B, t_cap)), ar=jnp.ones((B, t_cap)),
            is_active=jnp.ones((B, t_cap, dim), bool),
            rejected=jnp.zeros((B, t_cap), jnp.int32),
            errored_bound=jnp.zeros((B, t_cap), jnp.int32),
            hitting_horizon=jnp.zeros((B, t_cap), jnp.int32),
            error_value_ar=jnp.zeros((B, t_cap, 5), jnp.float32),
            kind=(jax.random.uniform(ks[3], (B, t_cap)) < 0.73).astype(
                jnp.int32),
            n_valid=jnp.full((B,), t_cap, jnp.int32),
        )
        rec = {"dim": dim, "B": B, "t_cap": t_cap, "n_keep": n_keep}
        for name, fn in (("logshift", engine._compact_rows_logshift),
                         ("gather", engine._compact_rows_gather)):
            f = jax.jit(fn, static_argnums=(1,))
            rec[f"{name}_s"] = _median_time(
                lambda: _block(f(stream, n_keep)))
        rec["gather_over_logshift"] = rec["gather_s"] / rec["logshift_s"]
        print(f"[compaction] {rec}", flush=True)
        rows.append(rec)
        del stream
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "benchmarks",
                                                  "bringup"))
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        print("exp_bringup: needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    import jax.numpy as jnp

    import pdmpflux_tpu as pf
    from chip_smoke import card_info
    from pdmpflux_tpu.core import engine
    from pdmpflux_tpu.utils.profiling import enable_persistent_cache

    enable_persistent_cache()
    os.makedirs(args.out, exist_ok=True)
    card = card_info()
    print(f"card: {card} device_kind: {jax.devices()[0].device_kind}",
          flush=True)
    out = {"card": card, "device_kind": jax.devices()[0].device_kind,
           "fill": fill_measurements(pf, jax, jnp, engine, args.out),
           "compaction": compaction_measurements(jax, jnp, engine)}
    with open(os.path.join(args.out, "bringup.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
