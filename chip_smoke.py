#!/usr/bin/env python
"""
Smoke run of the main path on a GPU: proves the system starts on the
card, runs every pair kernel as compiled for it, and gets the right
answers.

    python chip_smoke.py               # one GPU: phases 0-3
    python chip_smoke.py --four-cards  # four GPUs: phase 4 only

Phase 0  JAX version, device, card name and power limit, compile-cache
         directory, dump parser (native or Python).
Phase 1  The pair kernel (histogram and count modes) compiled at 10,479
         atoms (one bundled frame) and 41,916 atoms (the frame tiled
         2x2x1), r_cut 20 A, 400 bins, relations 8-1, 8-4, 8-6, 8-8:
         float64 counts must equal the plain XLA path exactly, float32
         counts the IEEE float32 NumPy reference loop.
Phase 2  calc_atomic_rdf fast (exact bins) == strict == the float64
         oracle; calc_atomic_cn fast vs strict; g(r -> 20 A) ~ 1 at
         41,916 atoms; steady-state ms/frame at both widths.
Phase 3  analyze() with the rdf, msd(com), conductivity, residence_time
         and hydration legs, fast against strict.
Phase 4  (--four-cards) calc_atomic_rdf at 41,916 atoms and analyze() on
         a ("frames",) 4-mesh and a ("frames", "atoms") 2x2 mesh against
         one card in the same process.

Everything is generated from data/mg_tfsi_dme (7 frames, 10,479 atoms);
the tiled dumps and outputs go to chip_smoke_out/ in the checkout. Any
failed check exits non-zero; the last line of a passing run is one JSON
object naming the device.
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data", "mg_tfsi_dme")
OUT = os.path.join(HERE, "chip_smoke_out")
MASS = [16.0, 12.01, 1.008, 14.01, 32.06, 16.0, 12.01, 19.0, 24.305]
NUM_MOLS = [591, 66, 33]
NUM_ATOMS_PER_MOL = [16, 15, 1]
RELATIONS = [[8, 8, 8, 8], [1, 4, 6, 8]]  # 8-1, 8-4, 8-6, 8-8
R_CUT, BIN = 20.0, 0.05
TILING = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0)]


def log(*args):
    print(*args, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)
    log(f"  ok: {what}")


def read_frame(path):
    """(positions (N, 3), types (N,), box lengths (3,)) of one dump."""
    from mdproptools_tpu.io.lammps_dump import read_trajectory

    t = read_trajectory(path, columns=["id", "type", "x", "y", "z"])
    return (t.cols(["x", "y", "z"])[0], t.col("type")[0].astype(np.int64),
            t.box_lengths[0])


def tiled_dumps():
    """The bundled frames tiled 2x2x1 (41,916 atoms), written once to a
    fixed directory; returns the glob pattern."""
    d = os.path.join(OUT, "tiled_2x2x1")
    files = sorted(glob.glob(os.path.join(DATA, "dump.nvt.*.dump")))
    if len(glob.glob(os.path.join(d, "dump.*.dump"))) != len(files):
        os.makedirs(d, exist_ok=True)
        for k, f in enumerate(files):
            pos, types, L = read_frame(f)
            p4 = np.concatenate([pos + np.array(r) * L for r in TILING])
            t4 = np.tile(types, len(TILING))
            L4 = L * np.array([2.0, 2.0, 1.0])
            tmp = os.path.join(d, f"dump.{k}.dump.tmp")
            with open(tmp, "w") as fh:
                fh.write(f"ITEM: TIMESTEP\n{k}\nITEM: NUMBER OF ATOMS\n"
                         f"{len(t4)}\nITEM: BOX BOUNDS pp pp pp\n")
                for ax in range(3):
                    fh.write(f"0.0 {float(L4[ax])!r}\n")
                fh.write("ITEM: ATOMS id type x y z\n")
                np.savetxt(fh, np.column_stack(
                    [np.arange(1, len(t4) + 1), t4, p4]),
                    fmt=["%d", "%d", "%.10f", "%.10f", "%.10f"])
            os.replace(tmp, os.path.join(d, f"dump.{k}.dump"))
    return os.path.join(d, "dump.*.dump")


def frame_widths():
    pos, types, L = read_frame(os.path.join(DATA, "dump.nvt.0.dump"))
    p4 = np.concatenate([pos + np.array(r) * L for r in TILING])
    return {10479: (pos, types, L),
            41916: (p4, np.tile(types, 4), L * np.array([2.0, 2.0, 1.0]))}


def phase0(jax, cache_dir):
    from mdproptools_tpu.io import _native

    log("== phase 0: environment")
    log("jax", jax.__version__)
    d = jax.devices()[0]
    log("device", d.platform, d.device_kind, "count", len(jax.devices()))
    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    log("compile cache", cache_dir)
    log("dump parser", "native" if _native._load() is not None else "python")


def phase1(jax, jnp):
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import oracle

    from mdproptools_tpu.ops import pair_kernel
    from mdproptools_tpu.ops import pairs as P

    log("== phase 1: pair kernel against the plain XLA path and the "
        "NumPy reference loop")
    with jax.enable_x64(True):  # the float64 kernel and reference
        _phase1(jax, jnp, pair_kernel, P, oracle)


def _phase1(jax, jnp, pair_kernel, P, oracle):
    rels = np.array(RELATIONS).T  # (R, 2) 1-based
    r_cuts = [2.5, 3.0, 3.5, 4.0]
    for n, (pos, types, L) in frame_widths().items():
        tile = pair_kernel.TILE
        n_pad = -(-n // tile) * tile
        perm = jax.jit(lambda p: P.device_sort_orb(p, n, n_pad, leaf=tile))(
            jnp.asarray(pos))
        lay = P.build_type_layout(types, 9)
        for dt in (jnp.float64, jnp.float32):
            p = jnp.asarray(pos, dt)
            Lj = jnp.asarray(L, dt)
            codes0 = jnp.asarray(types - 1, jnp.int32)

            def sides(p, perm):
                return P.orb_sorted_side(p, n, n_pad, None, codes0,
                                         leaf=tile, perm=perm)

            def hist(p, perm, L):
                pr, pm, ty = sides(p, perm)
                return pair_kernel.pair_hist_relations(
                    pr, pm, ty, pr, pm, ty, rels - 1, L, BIN, 400, R_CUT,
                    exclude_self=True, with_full=True, triangle=True)

            def count(p, perm, L):
                pr, pm, ty = sides(p, perm)
                return pair_kernel.pair_count_relations(
                    pr, pm, ty, pr, pm, ty, rels - 1, r_cuts, L,
                    exclude_self=True, triangle=True)

            def xla_hist(p, L):
                pp = P.gather_padded(p, lay)
                h = P.pair_hist(pp, pp, lay, lay, L, BIN, 400, R_CUT, True,
                                dtype=dt)
                return P.project_relations(h, rels, True)

            def xla_count(p, L):
                pp = P.gather_padded(p, lay)
                return P.pair_count_within(pp, pp, lay, lay, L, rels,
                                           r_cuts, True, dtype=dt)

            tag = f"{n} atoms {jnp.dtype(dt).name}"
            for name, fn, args in (("hist", hist, (p, perm, Lj)),
                                   ("count", count, (p, perm, Lj))):
                compiled = jax.jit(fn).lower(*args).compile()
                log(f"{tag} {name} memory_analysis:",
                    compiled.memory_analysis())
            kf, kr = jax.jit(hist)(p, perm, Lj)
            xf, xr = jax.jit(xla_hist)(p, Lj)
            kc = jax.jit(count)(p, perm, Lj)
            xc = jax.jit(xla_count)(p, Lj)
            kf, kr, xf, xr, kc, xc = map(np.asarray, (kf, kr, xf, xr, kc, xc))
            if dt == jnp.float64:
                diff = int(np.abs(kf - xf).sum() + np.abs(kr - xr).sum())
                check(diff == 0, f"{tag}: histogram counts == XLA scatter "
                                 f"(total {int(kf.sum())} ordered pairs)")
                check(np.array_equal(kc, xc),
                      f"{tag}: count mode == pair_count_within "
                      f"{kc.astype(int).tolist()}")
                continue
            # float32: the independent witness is the reference loop in
            # IEEE float32 NumPy arithmetic (correctly rounded sqrt and
            # divide, no FMA), against which the kernel must be exact
            t = time.perf_counter()
            rl = [tuple(r) for r in rels]
            of, orl = oracle.rdf_loop(pos, types, L, R_CUT, BIN, rl,
                                      dtype=np.float32)
            oc = oracle.cn_loop(pos, types, L, r_cuts, rl, dtype=np.float32)
            log(f"  {tag}: float32 reference loop took "
                f"{time.perf_counter() - t:.1f} s")
            diff = int(np.abs(kf - of).sum() + np.abs(kr - orl).sum())
            check(diff == 0, f"{tag}: histogram counts == IEEE float32 "
                             f"reference loop (total {int(kf.sum())})")
            check(np.array_equal(kc, oc),
                  f"{tag}: count mode == IEEE float32 reference loop "
                  f"{kc.astype(int).tolist()}")
            xdiff = int(np.abs(xf - of).sum() + np.abs(xr - orl).sum())
            log(f"  {tag}: XLA scatter float32 differs from the IEEE "
                f"reference in {xdiff} of {int(of.sum())} counts; count "
                f"mode {int(np.abs(xc - oc).sum())} (XLA's float32 sqrt "
                "and divide on the GPU are not correctly rounded)")


def rdf(pattern, **kw):
    from mdproptools_tpu.structural.rdf_cn import calc_atomic_rdf

    return calc_atomic_rdf(R_CUT, BIN, 9, MASS, RELATIONS, pattern,
                           save_mode=False, **kw)


def ms_per_frame(pattern, n_frames):
    """Steady-state ms/frame: (t(all frames) - t(1 frame)) / (T - 1),
    both warm, so compilation and per-call set-up cancel."""
    rdf(pattern, max_frames=1)
    rdf(pattern)
    t = time.perf_counter()
    rdf(pattern, max_frames=1)
    t1 = time.perf_counter() - t
    t = time.perf_counter()
    rdf(pattern)
    tn = time.perf_counter() - t
    return (tn - t1) / (n_frames - 1) * 1e3


def phase2():
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import oracle

    from mdproptools_tpu.structural.rdf_cn import (
        _shell_volumes,
        calc_atomic_cn,
    )

    log("== phase 2: entry points")
    pattern = os.path.join(DATA, "dump.nvt.*.dump")
    n_frames = len(glob.glob(pattern))
    fast = rdf(pattern, precision="fast")
    strict = rdf(pattern, precision="strict")
    check(np.array_equal(fast.to_numpy(), strict.to_numpy()),
          "calc_atomic_rdf fast (exact bins) == strict, bit for bit")
    # frame 0 against the float64 reference loop, normalized as the
    # reference does (rho_b = N_b / V, g = n / (N_a rho_b V_shell))
    pos, types, L = read_frame(os.path.join(DATA, "dump.nvt.0.dump"))
    rels = [tuple(r) for r in np.array(RELATIONS).T]
    full, part = oracle.rdf_loop(pos, types, L, R_CUT, BIN, rels)
    counts = np.bincount(types - 1, minlength=9).astype(np.float64)
    shell = _shell_volumes(BIN, 400)
    V = L[0] * L[1] * L[2]
    n = float(counts.sum())
    want = [full / (n * (n / V) * shell)]
    want += [part[k] / (counts[a - 1] * (counts[b - 1] / V) * shell)
             for k, (a, b) in enumerate(rels)]
    got = rdf(pattern, precision="strict", max_frames=1)
    check(np.array_equal(got.to_numpy()[:, 1:].T, np.array(want)),
          "strict frame 0 == float64 oracle rdf_loop, bit for bit")
    cn_kw = dict(r_cut=[2.5, 3.0, 3.5, 4.0], bin_size=BIN, num_types=9,
                 mass=MASS, partial_relations=RELATIONS, filename=pattern,
                 save_mode=False)
    cf = calc_atomic_cn(precision="fast", **cn_kw).to_numpy()[0]
    cs = calc_atomic_cn(precision="strict", **cn_kw).to_numpy()[0]
    # float32 cutoff tests can flip a pair within one ulp of r_cut; one
    # flip moves a CN by 1 / (N_ref * frames)
    n_ref = counts[np.array(RELATIONS[0]) - 1]
    tol = 1.0 / (n_ref * n_frames) + 1e-6 * np.abs(cs)
    check(np.all(np.abs(cf - cs) <= tol),
          f"calc_atomic_cn fast {cf.tolist()} vs strict {cs.tolist()} "
          "within one pair flip")
    pattern42 = tiled_dumps()
    g42 = rdf(pattern42, precision="fast")
    tail = float(g42["g_full(r)"].to_numpy()[-20:].mean())
    check(abs(tail - 1.0) < 0.02, f"41,916 atoms: g_full(r -> 20 A) = "
                                   f"{tail:.4f} ~ 1")
    for label, pat in (("10,479", pattern), ("41,916", pattern42)):
        log(f"  calc_atomic_rdf steady state at {label} atoms: "
            f"{ms_per_frame(pat, n_frames):.3f} ms/frame (fast, exact bins,"
            " parse included)")


def analyze_all(precision, working_dir):
    from mdproptools_tpu import analyze

    os.makedirs(working_dir, exist_ok=True)
    return analyze(
        os.path.join(DATA, "dump.nvt.*.dump"), 9, MASS, num_mols=NUM_MOLS,
        num_atoms_per_mol=NUM_ATOMS_PER_MOL,
        rdf=dict(r_cut=R_CUT, bin_size=BIN, partial_relations=RELATIONS,
                 save_mode=False),
        msd=dict(msd_type="com", calc_diff=True),
        conductivity=dict(volume=49.182349 ** 3, fit=False),
        residence_time=dict(r_cut=[(0.0, 2.8)], partial_relations=[[9], [1]]),
        hydration=dict(cation_type=3, water_type=1, r_cut=3.0),
        precision=precision, working_dir=working_dir,
    )


def close(a, b, rtol, what):
    """max |a - b| / max |b| <= rtol, reported under ``what``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    err = float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))
    check(a.shape == b.shape and np.all(np.isfinite(a)) and err <= rtol,
          f"{what}: max |diff| / max |ref| = {err:.2e} <= {rtol:g}")


def phase3():
    log("== phase 3: analyze() composite, fast against strict")
    f = analyze_all("fast", os.path.join(OUT, "analyze_fast"))
    s = analyze_all("strict", os.path.join(OUT, "analyze_strict"))
    check(np.array_equal(f["rdf"].to_numpy(), s["rdf"].to_numpy()),
          "rdf leg: fast == strict, bit for bit (exact bins)")
    # float32 legs: positions ~50 A carry ~4e-6 A of float32 rounding
    close(f["msd"].to_numpy(), s["msd"].to_numpy(), 1e-4,
          "msd(com) leg (float32 COM and displacements)")
    close(f["integral"], s["integral"], 1e-3,
          "conductivity leg (float32 flux and FFT correlation)")
    close(f["residence_corr"].to_numpy(), s["residence_corr"].to_numpy(),
          1e-4, "residence_time leg (float32 shell test and FFT)")
    hf = float(f["hydration"]["hydration_factor"].iloc[0])
    hs = float(s["hydration"]["hydration_factor"].iloc[0])
    # float32 angles can flip a cos < -0.72 decision at the threshold
    check(abs(hf - hs) <= 0.01,
          f"hydration leg: factor fast {hf:.6f} vs strict {hs:.6f}")


def phase4(jax):
    from jax.sharding import Mesh

    from mdproptools_tpu.structural import rdf_cn

    log("== phase 4: four cards against one")
    devs = np.asarray(jax.devices())
    check(len(devs) == 4, f"four devices ({len(devs)} found)")
    pattern42 = tiled_dumps()
    meshes = {
        "one card": Mesh(devs[:1], ("frames",)),
        "frames 4": Mesh(devs, ("frames",)),
        "frames x atoms 2x2": Mesh(devs.reshape(2, 2), ("frames", "atoms")),
    }
    out = {}
    for name, mesh in meshes.items():
        rdf_cn.set_mesh(mesh)
        try:
            t = time.perf_counter()
            g = rdf(pattern42, precision="fast")
            t_first = time.perf_counter() - t
            t = time.perf_counter()
            g = rdf(pattern42, precision="fast")
            t_warm = time.perf_counter() - t
            a = analyze_all("fast", os.path.join(OUT, "mesh", name[:8]))
        finally:
            rdf_cn.set_mesh(None)
        out[name] = (g, a)
        log(f"  {name}: calc_atomic_rdf 41,916 atoms x 7 frames "
            f"{t_first:.2f} s first call, {t_warm:.2f} s warm")
    g1, a1 = out["one card"]
    for name in ("frames 4", "frames x atoms 2x2"):
        g, a = out[name]
        # exact float64 counts; only the psum order of the normalized
        # float64 rows differs between meshes
        close(g.to_numpy(), g1.to_numpy(), 1e-12,
              f"{name}: calc_atomic_rdf vs one card")
        close(a["rdf"].to_numpy(), a1["rdf"].to_numpy(), 1e-12,
              f"{name}: analyze() rdf leg vs one card")
        close(a["integral"], a1["integral"], 1e-6,
              f"{name}: analyze() conductivity leg vs one card")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import jax

    from mdproptools_tpu.utilities.compile_cache import use_compile_cache

    cache_dir = use_compile_cache()
    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    import jax.numpy as jnp

    os.makedirs(OUT, exist_ok=True)
    t0 = time.perf_counter()
    phase0(jax, cache_dir)
    if args.four_cards:
        phase4(jax)
    else:
        phase1(jax, jnp)
        phase2()
        phase3()
    d = jax.devices()[0]
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
