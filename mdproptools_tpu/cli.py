"""
Thin command-line interface over the property modules (the reference is
import-only; this CLI covers the benchmarked workloads: RDF/CN,
MSD + diffusion, GK conductivity, GK viscosity, residence time, clusters,
number density, hydration).

Usage: ``python -m mdproptools_tpu <command> [options]``; every command
writes the same CSV/PNG artifacts as the library call it wraps.
"""

import argparse
import sys


def _floats(s):
    return [float(v) for v in s.split(",")]


def _ints(s):
    return [int(v) for v in s.split(",")]


def _relations(s):
    """'8-1,8-4' -> [[8, 8], [1, 4]] (reference partial_relations shape)."""
    pairs = [p.split("-") for p in s.split(",")]
    return [[int(p[0]) for p in pairs], [int(p[1]) for p in pairs]]


def _shells(s):
    """'0:2.6,1:3' -> [(0.0, 2.6), (1.0, 3.0)]."""
    return [tuple(float(v) for v in p.split(":")) for p in s.split(",")]


def build_parser():
    ap = argparse.ArgumentParser(
        prog="mdproptools_tpu",
        description="LAMMPS trajectory analysis on the GPU (JAX)",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    def common(p, mols=False):
        p.add_argument("--dumps", required=True,
                       help="dump file or glob pattern")
        p.add_argument("--precision", default="fast",
                       choices=["fast", "strict"])
        if mols:
            p.add_argument("--num-mols", type=_ints, required=True)
            p.add_argument("--num-atoms-per-mol", type=_ints, required=True)

    p = sub.add_parser("rdf", help="full + partial atomic RDF")
    common(p)
    p.add_argument("--r-cut", type=float, required=True)
    p.add_argument("--bin-size", type=float, required=True)
    p.add_argument("--num-types", type=int, required=True)
    p.add_argument("--mass", type=_floats, required=True)
    p.add_argument("--relations", type=_relations, required=True,
                   help="e.g. 8-1,8-4 (refType-otherType pairs)")
    p.add_argument("--num-mols", type=_ints)
    p.add_argument("--num-atoms-per-mol", type=_ints)
    p.add_argument("--out", default="rdf.csv")

    p = sub.add_parser("cn", help="coordination numbers")
    common(p)
    p.add_argument("--r-cut", type=_floats, required=True,
                   help="one cutoff per relation, comma separated")
    p.add_argument("--bin-size", type=float, default=0.05)
    p.add_argument("--num-types", type=int, required=True)
    p.add_argument("--mass", type=_floats, required=True)
    p.add_argument("--relations", type=_relations, required=True)
    p.add_argument("--num-mols", type=_ints)
    p.add_argument("--num-atoms-per-mol", type=_ints)
    p.add_argument("--out", default="cn.csv")

    p = sub.add_parser("msd", help="MSD + Einstein diffusion coefficients")
    common(p)
    p.add_argument("--msd-type", default="com", choices=["com", "allatom"])
    p.add_argument("--num-mols", type=_ints)
    p.add_argument("--num-atoms-per-mol", type=_ints)
    p.add_argument("--mass", type=_floats)
    p.add_argument("--timestep", type=float, default=1)
    p.add_argument("--units", default="real")
    p.add_argument("--com-drift", action="store_true")
    p.add_argument("--outputs-dir", default=".")
    p.add_argument("--diff-dir", default=".")
    p.add_argument("--diff-names", default=None,
                   help="comma-separated labels")

    p = sub.add_parser("conductivity", help="Green-Kubo ionic conductivity")
    common(p, mols=True)
    p.add_argument("--volume", type=float, required=True,
                   help="box volume in LAMMPS units")
    p.add_argument("--mass", type=_floats)
    p.add_argument("--temp", type=float, default=298.15)
    p.add_argument("--timestep", type=float, default=1)
    p.add_argument("--units", default="real")
    p.add_argument("--tol", type=float, default=1e-4)
    p.add_argument("--working-dir", default=".")

    p = sub.add_parser("viscosity", help="Green-Kubo viscosity from logs")
    p.add_argument("--logs", required=True, help="log glob pattern")
    p.add_argument("--cutoff-time", type=int, required=True)
    p.add_argument("--volume", type=float, required=True)
    p.add_argument("--temp", type=float, default=298.15)
    p.add_argument("--timestep", type=float, default=1)
    p.add_argument("--units", default="real")
    p.add_argument("--working-dir", default=".")
    p.add_argument("--plot", action="store_true")

    p = sub.add_parser("residence", help="residence times")
    common(p)
    p.add_argument("--shells", type=_shells, required=True,
                   help="rin:rout per relation, e.g. 0:2.6,1:3.2")
    p.add_argument("--relations", type=_relations, required=True)
    p.add_argument("--dt", type=float, default=1)
    p.add_argument("--working-dir", default=".")

    p = sub.add_parser("clusters", help="solvation-shell cluster extraction")
    common(p, mols=True)
    p.add_argument("--atom-type", type=int, required=True)
    p.add_argument("--r-cut", type=float, required=True)
    p.add_argument("--frame", type=int, default=None)
    p.add_argument("--full-trajectory", action="store_true")
    p.add_argument("--elements", default=None,
                   help="comma-separated element names per atom type")
    p.add_argument("--max-force", type=float, default=0.75)
    p.add_argument("--working-dir", default=".")

    p = sub.add_parser("density", help="number-density profile")
    common(p)
    p.add_argument("--surface-atom", type=int, required=True)
    p.add_argument("--atom-types", type=_ints, required=True)
    p.add_argument("--bin-size", type=float, required=True)
    p.add_argument("--dist", type=float, required=True,
                   help="dist_from_interface")
    p.add_argument("--axis", required=True, choices=["x", "y", "z"])
    p.add_argument("--working-dir", default=".")
    p.add_argument("--out", default="number_density.csv")

    p = sub.add_parser("hydration", help="hydration number / angles")
    common(p, mols=True)
    p.add_argument("--cation-type", type=int, required=True)
    p.add_argument("--water-type", type=int, required=True)
    p.add_argument("--r-cut", type=float, required=True)
    p.add_argument("--working-dir", default=".")

    p = sub.add_parser(
        "analyze",
        help="shared-parse composite: RDF + MSD + GK conductivity + "
             "residence time from ONE pass over the trajectory")
    common(p, mols=True)
    p.add_argument("--num-types", type=int, required=True)
    p.add_argument("--mass", type=_floats, required=True)
    p.add_argument("--r-cut", type=float, required=True)
    p.add_argument("--bin-size", type=float, required=True)
    p.add_argument("--relations", type=_relations, required=True)
    p.add_argument("--volume", type=float, default=None,
                   help="box volume (LAMMPS units) — enables the GK leg")
    p.add_argument("--no-msd", action="store_true")
    p.add_argument("--temp", type=float, default=298.15)
    p.add_argument("--timestep", type=float, default=1)
    p.add_argument("--units", default="real")
    p.add_argument("--tol", type=float, default=1e-4)
    p.add_argument("--working-dir", default=".")
    p.add_argument("--rdf-out", default="rdf.csv")
    p.add_argument("--residence-shells", type=_shells, default=None,
                   help="per-relation r_in:r_out shells, e.g. "
                        "'0:2.8,0:3.5' — enables the residence leg")
    p.add_argument("--residence-relations", type=_relations, default=None,
                   help="[[ref types], [other types]] like --relations")

    p = sub.add_parser(
        "cache",
        help="build the columnar trajectory cache: parse the dumps once, "
             "then every later analysis pass reads per-column binary "
             "blocks at page-cache speed (io.cache)")
    p.add_argument("--dumps", required=True, help="dump glob pattern")
    p.add_argument("--columns", type=lambda s: s.split(","), default=None,
                   help="dump columns to cache (default: all numeric)")
    p.add_argument("--cache-dir", default=None,
                   help="cache directory (default: <data>/.mdpt_cache/...)")
    p.add_argument("--block-frames", type=int, default=128)

    p = sub.add_parser(
        "sweep",
        help="batched RDF over many same-system trajectories (one "
             "compiled program, parse/compute overlap)")
    p.add_argument("--dumps", required=True, nargs="+",
                   help="one glob pattern per trajectory")
    p.add_argument("--precision", default="fast",
                   choices=["fast", "strict"])
    p.add_argument("--r-cut", type=float, required=True)
    p.add_argument("--bin-size", type=float, required=True)
    p.add_argument("--num-types", type=int, required=True)
    p.add_argument("--mass", type=_floats, required=True)
    p.add_argument("--relations", type=_relations, required=True)
    p.add_argument("--labels", type=lambda s: s.split(","), default=None)
    p.add_argument("--out", default="rdf_sweep.csv")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    cmd = args.command
    from mdproptools_tpu.utilities.compile_cache import use_compile_cache

    use_compile_cache()

    if cmd == "rdf":
        from mdproptools_tpu.structural.rdf_cn import calc_atomic_rdf

        df = calc_atomic_rdf(
            args.r_cut, args.bin_size, args.num_types, args.mass,
            args.relations, args.dumps, num_mols=args.num_mols,
            num_atoms_per_mol=args.num_atoms_per_mol,
            path_or_buff=args.out, precision=args.precision,
        )
        print(f"wrote {args.out} ({len(df)} bins)")
    elif cmd == "cn":
        from mdproptools_tpu.structural.rdf_cn import calc_atomic_cn

        df = calc_atomic_cn(
            args.r_cut, args.bin_size, args.num_types, args.mass,
            args.relations, args.dumps, num_mols=args.num_mols,
            num_atoms_per_mol=args.num_atoms_per_mol,
            path_or_buff=args.out, precision=args.precision,
        )
        print(df.to_string(index=False))
    elif cmd == "msd":
        from mdproptools_tpu.dynamical.diffusion import Diffusion

        d = Diffusion(timestep=args.timestep, units=args.units,
                      outputs_dir=args.outputs_dir, diff_dir=args.diff_dir)
        msd, _ = d.get_msd_from_dump(
            args.dumps, msd_type=args.msd_type, num_mols=args.num_mols,
            num_atoms_per_mol=args.num_atoms_per_mol, mass=args.mass,
            com_drift=args.com_drift, precision=args.precision,
        )
        names = args.diff_names.split(",") if args.diff_names else None
        out = d.calc_diff(msd, diff_names=names, save=True)
        print(out.to_string())
    elif cmd == "cache":
        from mdproptools_tpu.io.cache import build_cache

        d = build_cache(args.dumps, cache_dir=args.cache_dir,
                        columns=args.columns,
                        block_frames=args.block_frames, progress=True)
        print(f"cache built at {d}")
    elif cmd == "conductivity":
        from mdproptools_tpu.dynamical.conductivity import Conductivity

        c = Conductivity(
            args.dumps, args.num_mols, args.num_atoms_per_mol, args.volume,
            mass=args.mass, temp=args.temp, timestep=args.timestep,
            units=args.units, working_dir=args.working_dir,
            precision=args.precision,
        )
        cond = c.calc_cond(tol=args.tol, save=True)
        print("conductivity (S/m), per mol type + total:", cond)
    elif cmd == "viscosity":
        from mdproptools_tpu.dynamical.viscosity import Viscosity

        v = Viscosity(args.logs, args.cutoff_time, args.volume,
                      temp=args.temp, timestep=args.timestep,
                      units=args.units, working_dir=args.working_dir)
        eta = v.fit_avg_visc(v.calc_avg_visc(), plot=args.plot)
        print(f"viscosity (Pa.s): {eta:.6e}")
    elif cmd == "residence":
        from mdproptools_tpu.dynamical.residence_time import ResidenceTime

        rt = ResidenceTime(args.shells, args.relations, args.dumps,
                           dt=args.dt, working_dir=args.working_dir,
                           precision=args.precision)
        rt.calc_auto_correlation()
        res = rt.fit_auto_correlation(plot=False)
        for pair, vals in res.items():
            print(f"{pair}: residence time = {vals[4]:.3f} ps")
    elif cmd == "clusters":
        from mdproptools_tpu.structural.cluster_analysis import get_clusters

        n = get_clusters(
            args.dumps, args.atom_type, args.r_cut, args.num_mols,
            args.num_atoms_per_mol,
            full_trajectory=args.full_trajectory, frame=args.frame,
            elements=args.elements.split(",") if args.elements else None,
            max_force=args.max_force, working_dir=args.working_dir,
        )
        print(f"wrote {n} cluster xyz files to {args.working_dir}")
    elif cmd == "density":
        from mdproptools_tpu.structural.number_density import (
            calc_number_density,
        )

        df = calc_number_density(
            args.dumps, args.surface_atom, args.atom_types, args.bin_size,
            args.dist, args.axis, working_dir=args.working_dir,
            results_file=args.out,
        )
        print(f"wrote {args.out} ({len(df)} bins)")
    elif cmd == "hydration":
        from mdproptools_tpu.structural.hydration_number import (
            get_hydration_number,
        )

        df = get_hydration_number(
            args.dumps, args.cation_type, args.water_type, args.r_cut,
            num_mols=args.num_mols,
            num_atoms_per_mol=args.num_atoms_per_mol,
            working_dir=args.working_dir,
        )
        print(f"hydration factor: {df['hydration_factor'].iloc[0]:.4f} "
              f"({len(df)} angles)")
    elif cmd == "analyze":
        from mdproptools_tpu.pipeline import analyze

        out = analyze(
            args.dumps, args.num_types, args.mass,
            num_mols=args.num_mols,
            num_atoms_per_mol=args.num_atoms_per_mol,
            rdf=dict(r_cut=args.r_cut, bin_size=args.bin_size,
                     partial_relations=args.relations,
                     path_or_buff=f"{args.working_dir}/{args.rdf_out}",
                     save_mode=True),
            msd=None if args.no_msd else dict(msd_type="com"),
            conductivity=(dict(volume=args.volume, temp=args.temp,
                               tol=args.tol)
                          if args.volume else None),
            residence_time=(
                dict(r_cut=args.residence_shells,
                     partial_relations=args.residence_relations)
                if args.residence_shells else None),
            timestep=args.timestep, units=args.units,
            precision=args.precision, working_dir=args.working_dir,
        )
        print(f"wrote {args.rdf_out} ({len(out['rdf'])} bins)")
        if "diffusion" in out:
            print(out["diffusion"].to_string())
        if "sigma" in out:
            print("conductivity (S/m), per mol type + total:",
                  out["sigma"])
        if "residence_corr" in out:
            print(f"residence C(t): {len(out['residence_corr'])} frames x "
                  f"{len(out['residence_corr'].columns) - 1} relations "
                  "(auto_correlation.csv)")
    elif cmd == "sweep":
        from mdproptools_tpu.parallel.sweep import sweep_rdf

        df = sweep_rdf(
            args.dumps, args.r_cut, args.bin_size, args.num_types,
            args.mass, args.relations, precision=args.precision,
            labels=args.labels,
        )
        df.to_csv(args.out, index=False)
        print(f"wrote {args.out} ({df['trajectory'].nunique()} "
              f"trajectories x {len(df) // df['trajectory'].nunique()} bins)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
