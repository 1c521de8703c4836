#!/usr/bin/env python
"""
Multi-trajectory sweep benchmark -> benchmarks/sweep.json
(the "batched RDF/MSD/GK over 100+ trajectories" deployment).

Builds 100 replicate trajectories (each 11 of the bundled frames,
symlinked) and runs ``parallel.sweep_rdf`` over all of them: ONE
compiled block program serves every trajectory, with background-thread
parse prefetch overlapping device compute. Compares against serial
``calc_atomic_rdf`` calls on a sample of the same trajectories (which
since the entry-point program cache also reuse compiled programs — the
sweep's remaining edge is parse/compute overlap and zero per-call
dispatch bookkeeping).

Run: python benchmarks/sweep_bench.py   (JAX_PLATFORMS as shipped)
"""

import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

DATA_DIR = os.environ.get(
    "MDPT_DATA_DIR",
    os.path.join(os.path.dirname(HERE), "data", "mg_tfsi_dme"))
MASS = [16.0, 12.01, 1.008, 14.01, 32.06, 16.0, 12.01, 19.0, 24.305]
N_TRAJ = 100
FILES_PER_TRAJ = 11


def main():
    import jax

    from mdproptools_tpu.utilities.compile_cache import use_compile_cache

    use_compile_cache()

    from mdproptools_tpu.parallel import sweep_rdf
    from mdproptools_tpu.structural import rdf_cn
    from mdproptools_tpu.structural.rdf_cn import calc_atomic_rdf

    files = sorted(
        (f for f in os.listdir(DATA_DIR) if f.startswith("dump.nvt.")),
        key=lambda f: int(f.split(".")[2]),
    )[:FILES_PER_TRAJ]
    tmp = tempfile.mkdtemp(prefix="mdpt_sweep_")
    patterns = []
    for k in range(N_TRAJ):
        d = os.path.join(tmp, f"rep{k:03d}")
        os.makedirs(d)
        for f in files:
            os.symlink(os.path.join(DATA_DIR, f), os.path.join(d, f))
        patterns.append(os.path.join(d, "dump.nvt.*.dump"))

    kw = dict(num_mols=None, num_atoms_per_mol=None, precision="fast")
    # warm both paths (compile + program caches)
    sweep_rdf(patterns[:2], 20, 0.05, 9, MASS, [[8], [1]], **kw)
    calc_atomic_rdf(20, 0.05, 9, MASS, [[8], [1]], patterns[0],
                    save_mode=False, precision="fast")

    rdf_cn._trace_log.clear()
    t0 = time.time()
    df = sweep_rdf(patterns, 20, 0.05, 9, MASS, [[8], [1]], **kw)
    sweep_s = time.time() - t0
    n_programs = len(rdf_cn._trace_log)
    assert df["trajectory"].nunique() == N_TRAJ

    # serial baseline on a 10-trajectory sample, extrapolated
    t0 = time.time()
    for p in patterns[:10]:
        calc_atomic_rdf(20, 0.05, 9, MASS, [[8], [1]], p,
                        save_mode=False, precision="fast")
    serial_s = (time.time() - t0) / 10 * N_TRAJ

    frames = N_TRAJ * FILES_PER_TRAJ
    out = {
        "workload": ("sweep_rdf over 100 replicate trajectories "
                     f"({FILES_PER_TRAJ} frames x 10,479 atoms each, "
                     "400 bins + 2 partials), fast"),
        "device": jax.devices()[0].device_kind,
        "trajectories": N_TRAJ,
        "frames_total": frames,
        "sweep_wall_s": round(sweep_s, 1),
        "sweep_frames_per_s": round(frames / sweep_s, 1),
        "serial_entrypoint_wall_s_extrapolated": round(serial_s, 1),
        "block_programs_traced_during_sweep": n_programs,
        "note": ("one compiled block program serves all trajectories "
                 "(trace count above); all 100 running sums stay on "
                 "device and are fetched in ONE stacked transfer. Serial "
                 "calc_atomic_rdf also reuses cached programs, so the "
                 "sweep's remaining edge is parse/compute overlap + "
                 "the batched fetch"),
        "unix_time": int(time.time()),
    }
    with open(os.path.join(HERE, "sweep.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
