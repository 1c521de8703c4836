#!/usr/bin/env python
"""
Long-trajectory streaming benchmark -> benchmarks/long_stream.json.

Replicates the bundled 101-frame trajectory 10x by symlinking the dump
files under increasing pseudo-timesteps, then runs `calc_atomic_rdf`
end-to-end (parse -> device -> CSV) over the 1010-frame glob. Host
memory must stay O(FRAME_BLOCK x N) regardless of trajectory length
(an eager read-all would need ~4.2 GB of float64 at this length and
~42 GB at 10k frames).

Run: python benchmarks/long_stream_bench.py  (JAX_PLATFORMS as shipped)
"""

import json
import os
import resource
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

DATA_DIR = os.environ.get(
    "MDPT_DATA_DIR",
    os.path.join(os.path.dirname(HERE), "data", "mg_tfsi_dme"))
MASS = [16.0, 12.01, 1.008, 14.01, 32.06, 16.0, 12.01, 19.0, 24.305]
REPLICAS = 10


def main():
    import jax

    from mdproptools_tpu.utilities.compile_cache import use_compile_cache

    use_compile_cache()

    from mdproptools_tpu.structural.rdf_cn import calc_atomic_rdf

    files = sorted(
        (f for f in os.listdir(DATA_DIR) if f.startswith("dump.nvt.")),
        key=lambda f: int(f.split(".")[2]),
    )
    step = int(files[1].split(".")[2]) - int(files[0].split(".")[2])
    span = (int(files[-1].split(".")[2]) + step)
    tmp = tempfile.mkdtemp(prefix="mdpt_longstream_")
    for rep in range(REPLICAS):
        for f in files:
            ts = int(f.split(".")[2]) + rep * span
            os.symlink(os.path.join(DATA_DIR, f),
                       os.path.join(tmp, f"dump.nvt.{ts}.dump"))
    n_frames = REPLICAS * len(files)

    def run():
        return calc_atomic_rdf(
            20, 0.05, 9, MASS, [[8], [1]],
            os.path.join(tmp, "dump.nvt.*.dump"),
            path_or_buff=os.path.join(tmp, "rdf.csv"), precision="fast",
        )

    run()  # warm: compiles + program cache
    t0 = time.time()
    df = run()
    wall = time.time() - t0
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    g_end = float(df[[c for c in df.columns if "full" in c][0]].tail(
        20).mean())
    assert abs(g_end - 1.0) < 0.05

    out = {
        "workload": ("calc_atomic_rdf end-to-end, streamed (parse -> "
                     "device -> CSV), fast"),
        "device": jax.devices()[0].device_kind,
        "frames": n_frames,
        "atoms": 10479,
        "bins": 400,
        "partials": 2,
        "wall_s": round(wall, 1),
        "frames_per_s": round(n_frames / wall, 1),
        "peak_host_rss_gb": round(peak_gb, 2),
        "note": (f"{REPLICAS}x the bundled trajectory via symlinked "
                 "replicas; host memory stays O(FRAME_BLOCK x N) "
                 "regardless of T. Warm run (programs cached); column-"
                 "masked native parse."),
        "g_full_at_r_cut": round(g_end, 4),
        "unix_time": int(time.time()),
    }
    with open(os.path.join(HERE, "long_stream.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
