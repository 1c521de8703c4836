#!/usr/bin/env python
"""
Parse-ceiling measurement: where does trajectory
ingestion saturate at the north-star shape (41,916 atoms/frame), and
what does the columnar cache buy?

On a one-core host the thread-pooled parser cannot fan out and a
process pool cannot either — the ceiling is single-core text-to-float
conversion. Legs, all ms/frame over the same
tiled 41,916-atom frames (host only, no device):

  raw_io       open().read() of the dump bytes — the disk/page-cache
               floor
  parse_full   text parse, the composite's 13-column set
  parse_msd    text parse, the MSD leg's narrow 4-column set
  cache_build  one-off cost of building the columnar cache (13 cols)
  cache_msd    cached read of the MSD columns (binary, page-cache)
  cache_full   cached read of all 13 columns

Writes benchmarks/parse_bench.json.
"""

import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402

LINKS = os.path.join(os.path.dirname(HERE), ".ns_links")
N_FRAMES = 256
COLS_FULL = ["id", "mol", "type", "q", "x", "y", "z", "xu", "yu", "zu",
             "vx", "vy", "vz"]
COLS_MSD = ["id", "xu", "yu", "zu"]


def main():
    from mdproptools_tpu.io.cache import build_cache
    from mdproptools_tpu.io.lammps_dump import iter_trajectory_blocks

    files = sorted(
        (f for f in os.listdir(LINKS) if f.startswith("dump.ns.")),
        key=lambda f: int(f.split(".")[2]))[:N_FRAMES]
    d = tempfile.mkdtemp(prefix="parsebench_")
    for f in files:
        os.symlink(os.path.realpath(os.path.join(LINKS, f)),
                   os.path.join(d, f))
    pattern = os.path.join(d, "dump.ns.*.dump")
    paths = [os.path.join(d, f) for f in files]
    total_bytes = sum(os.path.getsize(p) for p in paths)

    out = {"atoms": 41916, "n_frames": N_FRAMES,
           "bytes_per_frame_mb": round(total_bytes / N_FRAMES / 1e6, 2)}

    def leg(name, fn, frames=N_FRAMES):
        t0 = time.time()
        fn()
        dt = (time.time() - t0) / frames * 1e3
        out[name + "_ms_per_frame"] = round(dt, 1)
        print(f"{name:12s} {dt:8.1f} ms/frame", flush=True)

    # warm the page cache so raw_io measures steady-state reads
    for p in paths:
        with open(p, "rb") as fh:
            fh.read()

    leg("raw_io", lambda: [open(p, "rb").read() for p in paths])

    def parse(cols):
        def run():
            n = 0
            for blk in iter_trajectory_blocks(pattern, columns=cols,
                                              cache=False):
                n += blk.n_frames
            assert n == N_FRAMES
        return run

    leg("parse_full", parse(COLS_FULL))
    leg("parse_msd", parse(COLS_MSD))

    cache_dir = os.path.join(d, "cache")
    leg("cache_build",
        lambda: build_cache(pattern, cache_dir=cache_dir,
                            columns=COLS_FULL))

    def cached(cols):
        def run():
            n = 0
            for blk in iter_trajectory_blocks(pattern, columns=cols,
                                              cache=cache_dir):
                n += blk.n_frames
            assert n == N_FRAMES
        return run

    # first cached pass faults the cache files into the page cache;
    # report both cold and warm
    leg("cache_msd_cold", cached(COLS_MSD))
    leg("cache_msd", cached(COLS_MSD))
    leg("cache_full_cold", cached(COLS_FULL))
    leg("cache_full", cached(COLS_FULL))

    out["ncpu"] = os.cpu_count()
    out["note"] = (
        "single-core host: the text parse IS the ceiling (no thread or "
        "process fan-out possible); the columnar cache replaces it with "
        "binary page-cache reads for every pass after the first")
    out["unix_time"] = int(time.time())
    path = os.path.join(HERE, "parse_bench.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print("wrote", path)
    shutil.rmtree(d)


if __name__ == "__main__":
    main()
