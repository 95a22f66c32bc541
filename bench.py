"""Benchmark: aggregate PDMP events/s on one GPU for the flagship config.

Config 1 of BASELINE.json: ZigZag on the 10-d Gaussian (the reference
README's canonical workload, ``README.md:33-47``), B=8192 chains x 2,048
skeleton points, float32, measured **end-to-end through the public API** —
``pf.sample_skeleton`` — so the number includes the stream fill, on-device
event compaction and skeleton assembly: exactly what a user gets.

``vs_baseline``: the reference publishes no absolute numbers (BASELINE.md),
so the anchor is MEASURED in the same process: the B=1 single-chain
throughput of this same framework on the same config through the same
public API.  ``vs_baseline`` = aggregate throughput / single-chain
throughput: the parallel speedup a reference user gains by switching.

Needs an NVIDIA GPU (exits nonzero otherwise).  Prints ONE JSON line
{"metric", "value", "unit", "vs_baseline", "device_kind", "card"}, where
``card`` is nvidia-smi's name and power limit.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        print("bench.py: needs an NVIDIA GPU; default device is "
              f"{jax.devices()[0].platform!r}", file=sys.stderr)
        sys.exit(2)
    import jax.numpy as jnp

    import pdmpflux_tpu as pf
    from chip_smoke import card_info
    from pdmpflux_tpu.utils.profiling import enable_persistent_cache

    enable_persistent_cache()
    dim, B, n_sk = 10, 8192, 2048
    x0, v0 = np.zeros((B, dim)), np.ones((B, dim))

    def go(seed, smp, b):
        t0 = time.perf_counter()
        skel = pf.sample_skeleton(smp, n_sk, x0[:b], v0[:b], seed=seed,
                                  dtype=jnp.float32)
        # n_valid is an output of the same program as the skeleton
        # buffers, so fetching it waits for the whole execution
        nv = np.asarray(jax.device_get(skel.n_valid))
        return skel, time.perf_counter() - t0, int(nv.sum()) - b

    sampler = pf.ZigZag(dim, lambda x: x)  # grad of the standard Gaussian
    go(0, sampler, B)  # compile
    go(0, sampler, B)  # compile the fill width learned from the first run
    wall, skel = float("inf"), None
    for rep in (1, 2):
        skel = None  # free the previous skeleton before the next run
        skel, w, events = go(rep, sampler, B)
        wall = min(wall, w)
    events_per_sec = events / wall
    complete = int(np.asarray(skel.n_valid).min()) == n_sk

    s1 = pf.ZigZag(dim, lambda x: x)
    go(0, s1, 1)
    go(0, s1, 1)
    wall1 = min(go(rep, s1, 1)[1] for rep in (1, 2))
    single_chain_eps = (n_sk - 1) / wall1

    mean, var = jax.device_get(
        pf.parallel.pooled_moments(skel, sampler, 256))
    moments_ok = bool(np.all(np.abs(mean) < 0.2)
                      and np.all(np.abs(var - 1.0) < 0.3))

    card = card_info()
    print(json.dumps({
        "metric": "zigzag_gauss10d_events_per_sec_per_gpu",
        "value": events_per_sec,
        "unit": "events/s",
        "vs_baseline": events_per_sec / single_chain_eps,
        "device_kind": jax.devices()[0].device_kind,
        "card": card,
    }))
    print(
        f"# device_kind={jax.devices()[0].device_kind} card=[{card}] "
        f"B={B} n_sk={n_sk} wall={wall:.4f}s complete={complete} "
        f"moments_ok={moments_ok} "
        f"single_chain_anchor={single_chain_eps:.1f} events/s",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
