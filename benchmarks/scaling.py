"""Scaling sweep (BASELINE.md last row: "1 chip -> 1 host -> N hosts").

Two axes, on the GPUs of one host (the script refuses any other device):

1. **Chain-batch scaling** (the per-device axis): flagship config
   (ZigZag, 10-d Gaussian) at B = 1 .. 8192, events/s and parallel
   efficiency vs B=1 — PDMP chains are embarrassingly parallel, so batch
   saturation is the single-device scaling story.

2. **Device-mesh scaling** via ``sample_skeleton_sharded`` over a
   ``chains`` mesh axis at n = 1, 2, 4, 8 devices (as many as are
   attached).  The per-device fill's HLO contains no cross-device
   collectives (tests/test_parallel.py::
   test_sharded_stream_fill_has_no_collectives), so the weak-scaling
   efficiency measures what the host and the devices add, not
   communication.

Writes ``benchmarks/scaling_results.json``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _flagship(pf):
    return pf.ZigZag(10, lambda x: x)


def batch_scaling(pf, jnp, jax, n_ev=1024):
    rows = []
    for B in (1, 64, 512, 2048, 8192):
        sampler = _flagship(pf)
        x0, v0 = np.zeros((B, 10)), np.ones((B, 10))
        kw = dict(dtype=jnp.float32)
        pf.sample_skeleton(sampler, n_ev, x0, v0, seed=0, **kw)  # compile
        # second warmup compiles the ratio-adapted fill geometry (see
        # api._sample_skeleton_events_stream) so the timed run is clean
        pf.sample_skeleton(sampler, n_ev, x0, v0, seed=0, **kw)
        t0 = time.perf_counter()
        skel = pf.sample_skeleton(sampler, n_ev, x0, v0, seed=1, **kw)
        total = int(np.asarray(skel.n_valid).sum()) - B
        wall = time.perf_counter() - t0
        rows.append({
            "axis": "chain_batch", "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
            "B": B, "events_per_chain": n_ev,
            "events_per_sec": round(total / wall, 1),
            "wall_s": round(wall, 3),
        })
        print(json.dumps(rows[-1]), flush=True)
    base = rows[0]["events_per_sec"]
    for r in rows:
        r["speedup_vs_B1"] = round(r["events_per_sec"] / base, 1)
    return rows


def mesh_scaling(pf, jnp, jax, n_ev=512, per_dev=256, n_list=(1, 2, 4, 8)):
    from pdmpflux_tpu.parallel import make_mesh
    from pdmpflux_tpu.parallel.sharded import sample_skeleton_sharded

    rows = []
    avail = len(jax.devices())
    for n in n_list:
        if n > avail:
            break
        mesh = make_mesh(n)
        B = per_dev * n
        sampler = _flagship(pf)
        x0, v0 = np.zeros((B, 10)), np.ones((B, 10))
        sample_skeleton_sharded(sampler, n_ev, x0, v0, seed=0, mesh=mesh,
                                dtype=jnp.float32)  # compile
        sample_skeleton_sharded(sampler, n_ev, x0, v0, seed=0, mesh=mesh,
                                dtype=jnp.float32)  # adapted-geometry compile
        t0 = time.perf_counter()
        run = sample_skeleton_sharded(sampler, n_ev, x0, v0, seed=1, mesh=mesh,
                                      dtype=jnp.float32)
        total = int(run.stats["events"]) - B
        wall = time.perf_counter() - t0
        rows.append({
            "axis": "device_mesh", "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
            "n_devices": n, "chains_per_device": per_dev,
            "events_per_chain": n_ev,
            "events_per_sec": round(total / wall, 1),
            "wall_s": round(wall, 3),
        })
        print(json.dumps(rows[-1]), flush=True)
    if rows:
        per_dev_base = rows[0]["events_per_sec"]
        for r in rows:
            ideal = per_dev_base * r["n_devices"]
            r["weak_scaling_efficiency"] = round(r["events_per_sec"] / ideal, 3)
    return rows


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--axis", choices=("batch", "mesh", "both"),
                    default="both")
    ap.add_argument("--per-dev", type=int, default=256,
                    help="chains per device for the mesh axis")
    ap.add_argument("--mesh-n-ev", type=int, default=512,
                    help="events per chain for the mesh axis")
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        print("scaling: needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    import jax.numpy as jnp

    import pdmpflux_tpu as pf

    rows = []
    if args.axis in ("batch", "both"):
        rows += batch_scaling(pf, jnp, jax)
    if args.axis in ("mesh", "both"):
        rows += mesh_scaling(pf, jnp, jax, n_ev=args.mesh_n_ev,
                             per_dev=args.per_dev)

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "scaling_results.json")
    # Merge with prior rows: a rerun of one axis updates only its own rows.
    def key(r):
        return (r["axis"], r["platform"], r.get("B"), r.get("n_devices"))

    merged = {}
    if os.path.exists(out):
        with open(out) as f:
            for r in json.load(f):
                merged[key(r)] = r
    for r in rows:
        merged[key(r)] = r
    with open(out, "w") as f:
        json.dump(list(merged.values()), f, indent=1)
    print(f"# wrote {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
