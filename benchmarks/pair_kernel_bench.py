#!/usr/bin/env python
"""
The pair kernel against the plain XLA path on one GPU, at the shapes
that decided whether the kernel stays: one bundled frame (10,479 atoms)
and the frame tiled 2x2x1 (41,916 atoms), r_cut 20 A, 400 bins,
relations 8-1, 8-4, 8-6, 8-8.

    python benchmarks/pair_kernel_bench.py [--legs kernel,e2e,fft]

Legs (median of REPS warm calls, each ending in block_until_ready):

  kernel:
  hist_xla_scatter                     pairs.pair_hist + project_relations
  hist_kernel                          pair_kernel.pair_hist_relations
  count_xla / count_kernel             pair_count_within / count mode
  orb_sort_device                      the per-frame ORB tile sort
  e2e:
  rdf_e2e_kernel / rdf_e2e_xla         calc_atomic_rdf over the 7 bundled
                                       (or tiled) frames, the XLA side
                                       forced with ops.backend._FORCE
  cn_e2e_kernel / cn_e2e_xla           calc_atomic_cn, likewise
  gk_host / gk_device                  the Green-Kubo correlation leg with
                                       ops.acf._FORCE_DISPATCH
  fft:
  fft_{auto,cross}_{dtype}_T{T}_E{E}   ops.acf.autocorrelate / correlate
    _{host,device,device_cold}         of a host (B, T) batch padded to
                                       E points, on each route; "cold" is
                                       the device route's first call at
                                       that shape (compilation included)

Prints the card's name and power limit, then one JSON object of ms per
call; exits non-zero without a GPU.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

REPS = 5
LEGS = ("kernel", "e2e", "fft")


def timed(fn, *args, reps=REPS):
    """Median ms of ``reps`` warm calls (after one call that compiles)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return float(np.median(ts)) * 1e3


def kernel_legs(jax, jnp, out):
    from mdproptools_tpu.ops import pair_kernel
    from mdproptools_tpu.ops import pairs as P

    rels = np.array(cs.RELATIONS).T
    r_cuts = [2.5, 3.0, 3.5, 4.0]
    for n, (pos, types, L) in cs.frame_widths().items():
        tile = pair_kernel.TILE
        n_pad = -(-n // tile) * tile
        sort = jax.jit(
            lambda p, L: P.device_sort_orb(p, n, n_pad, L, leaf=tile))
        perm = sort(jnp.asarray(pos), jnp.asarray(L))
        lay = P.build_type_layout(types, 9)
        codes0 = jnp.asarray(types - 1, jnp.int32)
        out[f"orb_sort_device_{n}_ms"] = timed(
            sort, jnp.asarray(pos), jnp.asarray(L))
        for dt in (jnp.float32, jnp.float64):
            tag = f"{n}_{jnp.dtype(dt).name}"
            p, Lj = jnp.asarray(pos, dt), jnp.asarray(L, dt)

            def side(p):
                return P.orb_sorted_side(p, n, n_pad, None, codes0,
                                         leaf=tile, perm=perm)

            def hist_kernel(p, L):
                s = side(p)
                return pair_kernel.pair_hist_relations(
                    *s, *s, rels - 1, L, cs.BIN, 400, cs.R_CUT,
                    exclude_self=True, with_full=True, triangle=True)

            def count_kernel(p, L):
                s = side(p)
                return pair_kernel.pair_count_relations(
                    *s, *s, rels - 1, r_cuts, L, exclude_self=True,
                    triangle=True)

            def hist_xla(p, L):
                pp = P.gather_padded(p, lay)
                h = P.pair_hist(pp, pp, lay, lay, L, cs.BIN, 400, cs.R_CUT,
                                True, dtype=dt)
                return P.project_relations(h, rels, True)

            def count_xla(p, L):
                pp = P.gather_padded(p, lay)
                return P.pair_count_within(pp, pp, lay, lay, L, rels,
                                           r_cuts, True, dtype=dt)

            legs = {"hist_kernel": hist_kernel, "count_kernel": count_kernel,
                    "hist_xla_scatter": hist_xla, "count_xla": count_xla}
            for name, fn in legs.items():
                out[f"{name}_{tag}_ms"] = timed(jax.jit(fn), p, Lj)
                cs.log(f"{name} {tag}: {out[f'{name}_{tag}_ms']:.3f} ms")


def e2e_legs(out):
    from mdproptools_tpu.dynamical.conductivity import Conductivity
    from mdproptools_tpu.ops import acf, backend
    from mdproptools_tpu.structural.rdf_cn import calc_atomic_cn

    patterns = {10479: os.path.join(cs.DATA, "dump.nvt.*.dump"),
                41916: cs.tiled_dumps()}
    for force, label in ((None, "kernel"), ("cpu", "xla")):
        backend._FORCE = force
        try:
            for n, pat in patterns.items():
                out[f"rdf_e2e_{label}_{n}_ms"] = timed(
                    lambda: cs.rdf(pat, precision="fast"))
                out[f"cn_e2e_{label}_{n}_ms"] = timed(
                    lambda: calc_atomic_cn(
                        [2.5, 3.0, 3.5, 4.0], cs.BIN, 9, cs.MASS,
                        cs.RELATIONS, pat, save_mode=False))
        finally:
            backend._FORCE = None
    cond = Conductivity(
        "dump.nvt.*.dump", cs.NUM_MOLS, cs.NUM_ATOMS_PER_MOL,
        volume=49.182349 ** 3, mass=cs.MASS, temp=298.15, timestep=1,
        units="real", working_dir=cs.DATA, precision="fast")
    flux = cond.get_charge_flux()
    for route in ("host", "device"):
        acf._FORCE_DISPATCH = route
        try:
            out[f"gk_{route}_ms"] = timed(cond.correlate_charge_flux, flux)
        finally:
            acf._FORCE_DISPATCH = None
    for k, v in out.items():
        if "e2e" in k or k.startswith(("gk_", "orb_")):
            cs.log(f"{k}: {v:.3f}")


def fft_legs(out):
    """Host pocketfft against the device FFT for one correlation batch
    at growing sizes: where the routes of ``ops.acf`` cross."""
    from mdproptools_tpu.ops import acf

    rng = np.random.default_rng(0)
    sweep = [(np.float32, 4096, e) for e in (16, 18, 20, 22, 24)]
    sweep += [(np.float64, 4096, e) for e in (16, 20, 24)]
    sweep += [(np.float32, 131072, e) for e in (20, 22, 24)]
    for dt, T, e in sweep:
        m = 1 << (2 * T - 1).bit_length()
        x = rng.normal(size=(max((1 << e) // m, 1), T)).astype(dt)
        for kind, fn, args in (("auto", acf.autocorrelate, (x,)),
                               ("cross", acf.correlate, (x, x[::-1]))):
            tag = f"fft_{kind}_{np.dtype(dt).name}_T{T}_E{e}"
            for route in ("device", "host"):
                acf._FORCE_DISPATCH = route
                try:
                    if route == "device":
                        t = time.perf_counter()
                        np.asarray(fn(*args))
                        out[f"{tag}_device_cold_ms"] = \
                            (time.perf_counter() - t) * 1e3
                    out[f"{tag}_{route}_ms"] = timed(
                        lambda: np.asarray(fn(*args)), reps=3)
                finally:
                    acf._FORCE_DISPATCH = None
            cs.log(tag, {k[len(tag) + 1:]: round(v, 3) for k, v in
                         out.items() if k.startswith(tag)})


def main():
    import argparse

    import jax
    import jax.numpy as jnp

    from mdproptools_tpu.utilities.compile_cache import use_compile_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--legs", default=",".join(LEGS),
                    help="comma-separated subset of " + ", ".join(LEGS))
    legs = set(ap.parse_args().legs.split(","))
    use_compile_cache()
    if jax.default_backend() != "gpu":
        sys.exit(f"no GPU: JAX backend is {jax.default_backend()!r}")
    d = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cs.log(card)
    out = {}
    with jax.enable_x64(True):
        if "kernel" in legs:
            kernel_legs(jax, jnp, out)
        if "fft" in legs:
            fft_legs(out)
    if "e2e" in legs:
        e2e_legs(out)
    print(json.dumps({"device": d.device_kind, "card": card, "reps": REPS,
                      "ms": out}))


if __name__ == "__main__":
    main()
