#!/usr/bin/env python
"""
Benchmark of the tracked metrics on one GPU.

Measures, end to end on the bundled 7-frame x 10,479-atom Mg(TFSI)2/DME
trajectory (or the trajectory under ``MDPT_DATA_DIR``; fast path unless
noted):
  1. RDF (400 bins + 4 partial relations) frames/sec — the headline —
     vs the reference-equivalent single-core float64 NumPy pair loop
     measured on the same host (the reference itself needs
     pymatgen/numba);
  2. MSD (molecular COM) + diffusion fit wall-clock (warm run: the
     one-time trace/compile is excluded, parse is not);
  3. Green-Kubo conductivity pipeline wall-clock (charge flux ->
     batched FFT correlation -> integral -> plateau fit -> sigma;
     warm run);
  4. the tri-property composite wall-clock (RDF + MSD + GK);
  5. RDF ms/frame at 41,916 atoms (the bundled box tiled 2x2x1);
  6. a bit-parity check: the compiled float64 pair kernel vs the plain
     XLA scatter path on one frame (exact equality required).

Prints ONE JSON line (the headline metric) and writes every row to
benchmarks/latest.json and benchmarks/history.jsonl. Every row names the
device it ran on.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# a longer trajectory of the same system when MDPT_DATA_DIR names one;
# otherwise the bundled 7-frame subset
DATA_DIR = os.environ.get("MDPT_DATA_DIR",
                          os.path.join(HERE, "data", "mg_tfsi_dme"))
DATA = os.path.join(DATA_DIR, "dump.nvt.*.dump")
OUT = os.path.join(HERE, "bench_out")  # run outputs (git-ignored)
MASS = [16.0, 12.01, 1.008, 14.01, 32.06, 16.0, 12.01, 19.0, 24.305]
NUM_MOLS = [591, 66, 33]
NUM_ATOMS_PER_MOL = [16, 15, 1]


def bench_rdf(jnp, rdf_cn, traj_cache):
    r_cut, bin_size, n_bins = 20.0, 0.05, 400
    relations = np.array([[8, 1], [8, 4], [8, 6], [8, 8]])
    pos, codes, lengths, counts = traj_cache
    T = pos.shape[0]

    def run():
        return rdf_cn._rdf_mean(
            pos, codes, 9, lengths, bin_size, n_bins, r_cut, relations,
            counts, counts, exclude_self=True, with_full=True,
            dtype=jnp.float32,
        )

    run()  # warm: compile (persistent-cached across rounds) + first pass
    t0 = time.time()
    g_full, g_part = run()  # ends with host fetches per block
    dt = time.time() - t0
    assert np.isfinite(g_full).all() and abs(g_full[-1] - 1.0) < 0.05, (
        "RDF sanity failed: g(r->r_cut) != 1"
    )
    return T / dt, dt


def bench_rdf_50k(jnp, rdf_cn, traj_cache):
    """RDF at the north-star 50k-atom scale: bundled box tiled 2x2x1.

    Steady-state ms/frame = (t(T=20) - t(T=4)) / 16, best-of-3 per side
    with a noise guard — see utilities/benchmarking.py for why the
    two-length delta is the honest per-frame estimator here."""
    from mdproptools_tpu.utilities.benchmarking import (
        steady_state_seconds_per_frame,
    )

    pos, codes, lengths, _ = traj_cache
    L = lengths[0]
    reps = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0)]
    pos50 = np.concatenate([pos[0] + np.array(r) * L for r in reps])
    codes50 = np.tile(codes, len(reps))
    len50 = np.array([L[0] * 2, L[1] * 2, L[2]])
    counts50 = np.bincount(codes50 - 1, minlength=9).astype(np.float64)
    relations = np.array([[8, 1], [8, 4], [8, 6], [8, 8]])

    def run(T):
        posT = np.broadcast_to(pos50, (T,) + pos50.shape).copy()
        lenT = np.broadcast_to(len50, (T, 3)).copy()
        return rdf_cn._rdf_mean(
            posT, codes50, 9, lenT, 0.05, 400, 20.0, relations,
            counts50, counts50, exclude_self=True, with_full=True,
            dtype=jnp.float32,
        )

    dt, _noisy, (g_full, _) = steady_state_seconds_per_frame(run)
    assert abs(float(g_full[-1]) - 1.0) < 0.05
    return pos50.shape[0], dt * 1000.0  # (atoms, ms/frame)


def bench_msd():
    """MSD + diffusion fit end-to-end; warm (second) run reported —
    the first pays the one-time trace and compile, which a long run
    amortizes across trajectories."""
    from mdproptools_tpu.dynamical.diffusion import Diffusion

    out = os.path.join(OUT, "msd")
    os.makedirs(out, exist_ok=True)
    dt = float("inf")
    for _ in range(2):
        t0 = time.time()
        d = Diffusion(timestep=1, units="real", outputs_dir=DATA_DIR,
                      diff_dir=out)
        msd, _ = d.get_msd_from_dump(
            "dump.nvt.*.dump", msd_type="com", num_mols=NUM_MOLS,
            num_atoms_per_mol=NUM_ATOMS_PER_MOL, mass=MASS,
            precision="fast",
        )
        diff = d.calc_diff(msd, dimension=3, save=False, plot=False)
        dt = min(dt, time.time() - t0)
    assert np.isfinite(diff["diffusion (m2/s)"].to_numpy()).all()
    return dt


def bench_gk():
    """Green-Kubo pipeline end-to-end; warm (second) run reported —
    the first pays the one-time trace and compile."""
    from mdproptools_tpu.dynamical.conductivity import Conductivity

    dt = float("inf")
    for _ in range(2):
        t0 = time.time()
        cond = Conductivity(
            "dump.nvt.*.dump", NUM_MOLS, NUM_ATOMS_PER_MOL,
            volume=49.182349 ** 3, mass=MASS, temp=298.15, timestep=1,
            units="real", working_dir=DATA_DIR, precision="fast",
        )
        j = cond.get_charge_flux()
        tot = cond.correlate_charge_flux(j)
        integ = cond.integrate_charge_flux_correlation(tot)
        # 101 widely-spaced frames -> noisy ACF; escalate tol until the
        # plateau detector finds a window (reference behavior on sparse
        # data)
        ave = None
        for tol in (1e-4, 1e-2, 0.5, 1.0, 2.0):
            try:
                ave, _ = cond.fit_curve(tot, integ, tol=tol)
                break
            except ValueError:
                continue
        if ave is None:
            raise RuntimeError(
                "plateau detection failed at every tolerance up to 2.0")
        sigma = cond.green_kubo(ave)
        dt = min(dt, time.time() - t0)
    assert np.isfinite(sigma).all()
    return dt


def bench_analyze():
    """Single-parse composite (``mdproptools_tpu.analyze``): RDF + MSD +
    GK from ONE streamed pass over the bundled trajectory — the
    composite's honest wall-clock (the per-property entry points each
    re-parse); warm (second) run reported."""
    from mdproptools_tpu import analyze

    outdir = os.path.join(OUT, "analyze")
    os.makedirs(outdir, exist_ok=True)
    dt = float("inf")
    for _ in range(2):
        t0 = time.time()
        out = analyze(
            DATA, 9, MASS, num_mols=NUM_MOLS,
            num_atoms_per_mol=NUM_ATOMS_PER_MOL,
            rdf=dict(r_cut=20.0, bin_size=0.05,
                     partial_relations=[[8, 8, 8, 8], [1, 4, 6, 8]],
                     save_mode=False),
            msd=dict(msd_type="com", calc_diff=True),
            conductivity=dict(volume=49.182349 ** 3, fit=False),
            precision="fast", working_dir=outdir,
        )
        dt = min(dt, time.time() - t0)
    assert abs(float(out["rdf"]["g_full(r)"].tail(20).mean()) - 1.0) < 0.05
    assert np.isfinite(out["diffusion"]["diffusion (m2/s)"].to_numpy()).all()
    assert np.isfinite(out["integral"]).all()
    return dt


def kernel_bit_parity(jnp, traj_cache):
    """Compiled float64 pair kernel (ORB tiles, cull, triangle) vs the
    plain XLA scatter path on one real frame: counts must be EXACTLY
    equal."""
    import jax

    from mdproptools_tpu.ops import pair_kernel
    from mdproptools_tpu.ops import pairs as pair_ops

    pos, codes, lengths, _ = traj_cache
    rels = np.array([[8, 1], [8, 4], [8, 6], [8, 8]])
    n = len(codes)
    n_pad = -(-n // pair_kernel.TILE) * pair_kernel.TILE
    with jax.enable_x64(True):
        L = jnp.asarray(lengths[0], jnp.float64)
        p = jnp.asarray(pos[0], jnp.float64)
        pr, pm, ty = pair_ops.orb_sorted_side(
            p, n, n_pad, L, jnp.asarray(codes - 1, jnp.int32),
            leaf=pair_kernel.TILE)
        got = pair_kernel.pair_hist_relations(
            pr, pm, ty, pr, pm, ty, rels - 1, L, 0.05, 400, 20.0, True,
            True, triangle=True)
        lay = pair_ops.build_type_layout(codes, 9)
        pp = pair_ops.gather_padded(p, lay)
        want = pair_ops.project_relations(pair_ops.pair_hist(
            pp, pp, lay, lay, L, 0.05, 400, 20.0, True,
            dtype=jnp.float64), rels, True)
        return all(np.array_equal(np.asarray(g), np.asarray(w))
                   for g, w in zip(got, want))


def main():
    import jax
    import jax.numpy as jnp  # noqa: E402

    from mdproptools_tpu.utilities.compile_cache import use_compile_cache

    use_compile_cache()
    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX backend is "
                 f"{jax.default_backend()!r}")

    from mdproptools_tpu.io.lammps_dump import read_trajectory  # noqa: E402
    from mdproptools_tpu.structural import rdf_cn  # noqa: E402

    traj = read_trajectory(DATA, columns=["id", "type", "x", "y", "z"])
    codes = traj.col("type")[0].astype(np.int64)
    traj_cache = (
        traj.cols(["x", "y", "z"]),
        codes,
        traj.box_lengths,
        np.bincount(codes - 1, minlength=9).astype(np.float64),
    )
    T = traj_cache[0].shape[0]

    rdf_fps, rdf_dt = bench_rdf(jnp, rdf_cn, traj_cache)
    msd_dt = bench_msd()
    gk_dt = bench_gk()
    analyze_dt = bench_analyze()
    parity_ok = kernel_bit_parity(jnp, traj_cache)
    n50, ms50 = bench_rdf_50k(jnp, rdf_cn, traj_cache)

    # reference-equivalent baseline: single-core float64 NumPy pair loop
    # (blocked exactly like tests/oracle.py), best of 2 one-frame runs at
    # 10.5k atoms plus ONE pass at the 42k headline scale (its O(N^2)
    # cost makes a second pass a poor use of bench time)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import oracle  # noqa: E402

    relations = [(8, 1), (8, 4), (8, 6), (8, 8)]
    base_time = float("inf")
    for _ in range(2):
        t0 = time.time()
        oracle.rdf_loop(traj_cache[0][0], codes, traj_cache[2][0], 20.0,
                        0.05, relations)
        base_time = min(base_time, time.time() - t0)
    base_fps = 1.0 / base_time

    # 42k-atom oracle frame (same tiling as bench_rdf_50k)
    L = traj_cache[2][0]
    reps = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0)]
    pos50 = np.concatenate([traj_cache[0][0] + np.array(r) * L
                            for r in reps])
    codes50 = np.tile(codes, len(reps))
    len50 = np.array([L[0] * 2, L[1] * 2, L[2]])
    t0 = time.time()
    oracle.rdf_loop(pos50, codes50, len50, 20.0, 0.05, relations)
    base_time_50k = time.time() - t0

    fps50 = 1000.0 / ms50
    rows = {
        "rdf_frames_per_s_41916_atoms": round(fps50, 3),
        "rdf_ms_per_frame_41916_atoms": round(ms50, 1),
        "rdf_speedup_vs_numpy_oracle_41916": round(fps50 * base_time_50k,
                                                   2),
        "rdf_frames_per_s_10479_atoms": round(rdf_fps, 3),
        "rdf_speedup_vs_numpy_oracle": round(rdf_fps * base_time, 2),
        "msd_com_end_to_end_s": round(msd_dt, 3),
        "gk_conductivity_end_to_end_s": round(gk_dt, 3),
        "composite_rdf_msd_gk_s": round(rdf_dt + msd_dt + gk_dt, 3),
        "analyze_one_parse_s": round(analyze_dt, 3),
        "kernel_vs_scatter_bit_parity": parity_ok,
        "frames": int(T),
        "backend": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
        "unix_time": int(time.time()),
    }
    os.makedirs(os.path.join(HERE, "benchmarks"), exist_ok=True)
    with open(os.path.join(HERE, "benchmarks", "latest.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    with open(os.path.join(HERE, "benchmarks", "history.jsonl"), "a") as fh:
        fh.write(json.dumps(rows) + "\n")

    assert parity_ok, "pair kernel vs scatter bit-parity FAILED"
    # headline: RDF frames/sec at 41,916 atoms (bundled box tiled 2x2x1)
    print(json.dumps({
        "metric": ("RDF frames/sec at 41,916 atoms (bundled box 2x2x1), "
                   "400 bins + 4 partials, "
                   f"{jax.devices()[0].device_kind} fast path vs "
                   "single-core f64 NumPy pair loop at the same "
                   f"size (10.5k atoms: {rows['rdf_frames_per_s_10479_atoms']} "
                   f"frames/s; composite RDF+MSD+GK "
                   f"{rows['composite_rdf_msd_gk_s']}s; "
                   f"kernel bit-parity {parity_ok})"),
        "value": round(fps50, 3),
        "unit": "frames/sec",
        "vs_baseline": round(fps50 * base_time_50k, 2),
    }))


if __name__ == "__main__":
    main()
