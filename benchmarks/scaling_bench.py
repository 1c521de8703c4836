#!/usr/bin/env python
"""
Atom-count scaling benchmark -> benchmarks/scaling.json.

Replicates the bundled 10,479-atom Mg(TFSI)2/DME box 2x2x1 / 2x2x2 /
2x2x4 (the north-star 50k-atom scale and beyond) and measures the
production RDF path (``rdf_cn._rdf_mean``: device sort + GPU pair
kernel + per-frame normalization, fast) in ms/frame on the GPU.

Methodology: steady-state per-frame cost as (t(T=20) - t(T=4)) / 16,
best-of-3 per side with a noise guard — see
``mdproptools_tpu.utilities.benchmarking.steady_state_seconds_per_frame``.

Run: python benchmarks/scaling_bench.py
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402

DATA = os.path.join(
    os.environ.get("MDPT_DATA_DIR",
                   os.path.join(os.path.dirname(HERE), "data", "mg_tfsi_dme")),
    "dump.nvt.2500000.dump")
RELATIONS = np.array([[8, 1], [8, 4], [8, 6], [8, 8]])


def main():
    import jax

    import jax.numpy as jnp

    from mdproptools_tpu.utilities.compile_cache import use_compile_cache

    use_compile_cache()

    from mdproptools_tpu.io.lammps_dump import read_trajectory
    from mdproptools_tpu.structural import rdf_cn

    traj = read_trajectory(DATA, columns=["id", "type", "x", "y", "z"])
    codes1 = traj.col("type")[0].astype(np.int64)
    pos1 = traj.cols(["x", "y", "z"])[0]
    L1 = traj.box_lengths[0]

    from mdproptools_tpu.utilities.benchmarking import (
        steady_state_seconds_per_frame,
    )

    rows = []
    for reps in [(1, 1, 1), (2, 1, 1), (2, 2, 1), (2, 2, 2), (2, 2, 4),
                 (2, 4, 4), (4, 4, 4)]:
        shifts = [(i, j, k) for i in range(reps[0])
                  for j in range(reps[1]) for k in range(reps[2])]
        pos = np.concatenate([pos1 + np.array(s) * L1 for s in shifts])
        codes = np.tile(codes1, len(shifts))
        L = L1 * np.array(reps)
        counts = np.bincount(codes - 1, minlength=9).astype(np.float64)

        def run(T):
            posT = np.broadcast_to(pos, (T,) + pos.shape).copy()
            lenT = np.broadcast_to(L, (T, 3)).copy()
            return rdf_cn._rdf_mean(
                posT, codes, 9, lenT, 0.05, 400, 20.0, RELATIONS,
                counts, counts, exclude_self=True, with_full=True,
                dtype=jnp.float32,
            )

        # shorter runs at the largest sizes
        light = {"t_small": 2, "t_big": 6, "repeats": 2} \
            if len(codes) > 400_000 else {}
        dt, noisy, (g_full, _) = steady_state_seconds_per_frame(
            run, **light)
        assert abs(float(g_full[-1]) - 1.0) < 0.05, "g(r->r_cut) != 1"
        row = {
            "atoms": int(len(codes)),
            "ms_per_frame": round(dt * 1000.0, 1),
            "frames_per_s": round(1.0 / dt, 2),
            "box": [round(float(v), 2) for v in L],
        }
        if noisy:
            row["noise_limited"] = True  # upper bound, not a delta
        if light:
            row["methodology"] = ("(t(6) - t(2)) / 4, best-of-2 — "
                                  "shortened runs at this size")
        rows.append(row)
        print(json.dumps(rows[-1]), flush=True)

    out = {
        "workload": ("full+partial RDF, 400 bins, r_cut=20, fast, "
                     "bundled box tiled"),
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "rows": rows,
        "unix_time": int(time.time()),
        "methodology": (
            "steady-state ms/frame = (t(T=20) - t(T=4)) / 16, best-of-3 "
            "per side with a noise guard (utilities/benchmarking.py), "
            "cancelling per-call re-trace/cache-load and the device "
            "fetch that a real trajectory pays once per 128-frame block, "
            "not per frame; includes the per-frame ORB sort. Box tiled "
            "from the bundled 49.18 A cube; r_cut 20 A."),
    }
    with open(os.path.join(HERE, "scaling.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print("wrote", os.path.join(HERE, "scaling.json"))


if __name__ == "__main__":
    main()
