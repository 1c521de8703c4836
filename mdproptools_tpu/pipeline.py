"""
Shared-parse composite analysis: ONE streamed pass over a dump glob
feeds several property streams at once (RDF + MSD + Green-Kubo charge
flux + residence time + hydration + number density), instead of each
entry point re-parsing the trajectory.

Why (beyond-reference; the reference re-parses per property): parsing
is the dominant cost of the MSD and charge-flux legs — on the bundled
trajectory their warm end-to-end times are parse-bound, and on the
north-star 10k-frame workload each extra pass over the files costs
minutes. The property math is UNCHANGED: the pipeline folds the same
parsed blocks into the same push-model streams the individual entry
points use (``rdf_cn._make_rdf_mean_stream``, ``Diffusion.msd_stream``,
``Conductivity.flux_stream``, ``ResidenceTime.residence_stream``,
``hydration_stream``, ``number_density_stream``), so each result is
identical to the separate call (pinned by tests/test_pipeline.py).
"""

import os

import numpy as np

from mdproptools_tpu.io.lammps_dump import (
    iter_trajectory_blocks,
    peek_dump_columns,
    prefetch_iter,
)
from mdproptools_tpu.utilities.tracing import stage


def analyze(
    filename,
    num_types,
    mass,
    num_mols=None,
    num_atoms_per_mol=None,
    rdf=None,
    msd=None,
    conductivity=None,
    residence_time=None,
    hydration=None,
    number_density=None,
    timestep=1,
    units="real",
    precision="fast",
    working_dir=None,
):
    """Run any subset of {RDF, MSD, GK conductivity, residence time,
    hydration, number density} from ONE parse.

    ``rdf``: dict(r_cut, bin_size, partial_relations[, path_or_buff,
    save_mode=False, spatial_sort="auto", alter_atom_types=False]) ->
    result["rdf"] DataFrame (identical to ``calc_atomic_rdf``;
    ``alter_atom_types=True`` applies the per-molecule type remap the
    reference triggers by passing num_mols — explicit here because
    num_mols is shared with the MSD/conductivity legs).

    ``msd``: dict([msd_type="com", com_drift=False, avg_interval=False,
    tao_coeff=4, calc_diff=True, initial_time=None, final_time=None])
    -> result["msd"], result["msd_all"] (and "msd_int", "diffusion")
    (identical to ``Diffusion.get_msd_from_dump`` / ``calc_diff``).

    ``conductivity``: dict(volume[, temp=298.15, tol=1e-4]) ->
    result["sigma"] plus "charge_flux_corr", "integral"
    (identical to the ``Conductivity`` pipeline).

    ``residence_time``: dict(r_cut, partial_relations[, dt=1,
    alter_atom_types=False, fit=False, cut_percent=0.9]) ->
    result["residence_corr"] (and "residence_time" with fit=True)
    (identical to ``ResidenceTime.calc_auto_correlation`` /
    ``fit_auto_correlation``; ``r_cut`` is the per-relation
    (r_in, r_out) shell list; ``alter_atom_types=True`` applies the
    per-molecule type remap, which the standalone class triggers by
    passing num_mols — explicit here because num_mols is shared).

    ``hydration``: dict(cation_type, water_type, r_cut) ->
    result["hydration"] (identical to ``get_hydration_number``;
    cation/water are 1-based MOLECULE types, so num_mols/
    num_atoms_per_mol are required).

    ``number_density``: dict(surface_atom, atom_types, bin_size,
    dist_from_interface, axis_norm_interface[, results_file,
    save_mode=True, alter_atom_types=False]) ->
    result["number_density"] (identical to ``calc_number_density``).

    Shared args (``num_types``/``mass``/``num_mols``/
    ``num_atoms_per_mol``/``timestep``/``units``/``precision``) follow
    the reference conventions.
    """
    legs = (rdf, msd, conductivity, residence_time, hydration,
            number_density)
    if all(v is None for v in legs):
        raise ValueError(
            "nothing to analyze: pass rdf=, msd=, conductivity=, "
            "residence_time=, hydration= and/or number_density=")
    if conductivity is not None and "volume" not in conductivity:
        raise ValueError("conductivity= requires a 'volume' entry")
    if rdf is not None:
        missing = [k for k in ("r_cut", "bin_size", "partial_relations")
                   if k not in rdf]
        if missing:
            raise ValueError(f"rdf= requires {missing} entries")
    if residence_time is not None:
        missing = [k for k in ("r_cut", "partial_relations")
                   if k not in residence_time]
        if missing:
            raise ValueError(f"residence_time= requires {missing} entries")
    if hydration is not None:
        missing = [k for k in ("cation_type", "water_type", "r_cut")
                   if k not in hydration]
        if missing:
            raise ValueError(f"hydration= requires {missing} entries")
    if number_density is not None:
        missing = [k for k in ("surface_atom", "atom_types", "bin_size",
                               "dist_from_interface",
                               "axis_norm_interface")
                   if k not in number_density]
        if missing:
            raise ValueError(f"number_density= requires {missing} entries")
    working_dir = working_dir or os.getcwd()
    pattern = filename if os.path.isabs(filename) \
        else f"{working_dir}/{filename}"
    available = peek_dump_columns(pattern)
    wanted = {"id", "type"}
    if rdf is not None:
        wanted |= {"x", "y", "z"}
    if msd is not None:
        # parse is the MSD leg's dominant cost at scale: skip the
        # wrapped x/y/z + image fallback whenever xu/yu/zu exist
        # (mass comes from the shared ``mass`` arg when given)
        if {"xu", "yu", "zu"} <= set(available):
            wanted |= {"xu", "yu", "zu"}
        else:
            wanted |= {"x", "y", "z", "xu", "yu", "zu", "ix", "iy", "iz"}
        if mass is None:
            wanted |= {"mass"}
    if conductivity is not None:
        wanted |= {"q", "vx", "vy", "vz"}
        if mass is None:
            wanted |= {"mass"}
    if (residence_time is not None or hydration is not None
            or number_density is not None):
        wanted |= {"x", "y", "z"}  # same columns the RDF leg reads
    columns = [c for c in ["id", "mol", "type", "q", "mass", "x", "y",
                           "z", "xu", "yu", "zu", "ix", "iy", "iz",
                           "vx", "vy", "vz"]
               if c in wanted and c in available]

    blocks = prefetch_iter(
        iter_trajectory_blocks(pattern, columns=columns), depth=2)

    rdf_stream = msd_stream = flux_stream = res_stream = None
    hyd_stream = nd_stream = None
    rdf_meta = None
    diff = cond = res = None
    result = {}

    for blk in blocks:
        if rdf_stream is None and rdf is not None:
            rdf_stream, rdf_meta = _make_rdf(blk, num_types, mass,
                                             num_mols, num_atoms_per_mol,
                                             precision, rdf)
        if msd_stream is None and msd is not None:
            from mdproptools_tpu.dynamical.diffusion import Diffusion

            diff = Diffusion(timestep=timestep, units=units,
                             outputs_dir=working_dir,
                             diff_dir=working_dir)
            msd_stream = diff.msd_stream(
                msd_type=msd.get("msd_type", "com"), num_mols=num_mols,
                num_atoms_per_mol=num_atoms_per_mol, mass=mass,
                tao_coeff=msd.get("tao_coeff", 4), precision=precision,
                msd_all_path=msd.get("msd_all_path"),
            )
        if flux_stream is None and conductivity is not None:
            from mdproptools_tpu.dynamical.conductivity import (
                Conductivity,
            )

            cond = Conductivity(
                filename, num_mols, num_atoms_per_mol,
                volume=conductivity["volume"], mass=mass,
                temp=conductivity.get("temp", 298.15),
                timestep=timestep, units=units, working_dir=working_dir,
                precision=precision,
            )
            flux_stream = cond.flux_stream()
        if res_stream is None and residence_time is not None:
            from mdproptools_tpu.dynamical.residence_time import (
                ResidenceTime,
            )

            alter = residence_time.get("alter_atom_types", False)
            res = ResidenceTime(
                residence_time["r_cut"],
                residence_time["partial_relations"], filename,
                dt=residence_time.get("dt", 1),
                num_mols=num_mols if alter else None,
                num_atoms_per_mol=num_atoms_per_mol if alter else None,
                working_dir=working_dir, precision=precision,
            )
            res_stream = res.residence_stream()
        if hyd_stream is None and hydration is not None:
            from mdproptools_tpu.structural.hydration_number import (
                hydration_stream,
            )

            hyd_stream = hydration_stream(
                hydration["cation_type"], hydration["water_type"],
                hydration["r_cut"], num_mols=num_mols,
                num_atoms_per_mol=num_atoms_per_mol,
                working_dir=working_dir)
        if nd_stream is None and number_density is not None:
            from mdproptools_tpu.structural.number_density import (
                number_density_stream,
            )

            nd_alter = number_density.get("alter_atom_types", False)
            nd_stream = number_density_stream(
                number_density["surface_atom"],
                number_density["atom_types"],
                number_density["bin_size"],
                number_density["dist_from_interface"],
                number_density["axis_norm_interface"],
                num_mols=num_mols if nd_alter else None,
                num_atoms_per_mol=(num_atoms_per_mol if nd_alter
                                   else None),
                working_dir=working_dir,
                results_file=number_density.get(
                    "results_file", "number_density.csv"),
                save_mode=number_density.get("save_mode", True))
        with stage("pipeline_block", frames=blk.data.shape[0]):
            if rdf_stream is not None:
                rdf_stream.fold(blk.cols(["x", "y", "z"]), None,
                                blk.box_lengths)
            if msd_stream is not None:
                msd_stream.fold(blk)
            if flux_stream is not None:
                flux_stream.fold(blk)
            if res_stream is not None:
                res_stream.fold(blk)
            if hyd_stream is not None:
                hyd_stream.fold(blk)
            if nd_stream is not None:
                nd_stream.fold(blk)

    if rdf_stream is not None:
        from mdproptools_tpu.structural.rdf_cn import _radii, _save_rdf

        rdf_full, rdf_part = rdf_stream.result()
        result["rdf"] = _save_rdf(
            _radii(rdf["bin_size"], rdf_meta["num_bins"]),
            rdf_meta["relation_matrix"],
            rdf.get("path_or_buff", f"{working_dir}/rdf.csv"),
            rdf.get("save_mode", False), rdf_part, rdf_full)
    if msd_stream is not None:
        out = msd_stream.finalize(
            com_drift=msd.get("com_drift", False),
            avg_interval=msd.get("avg_interval", False))
        if msd.get("avg_interval", False):
            result["msd"], result["msd_all"], result["msd_int"] = out
        else:
            result["msd"], result["msd_all"] = out
        if msd.get("calc_diff", True):
            result["diffusion"] = diff.calc_diff(
                result["msd"], initial_time=msd.get("initial_time"),
                final_time=msd.get("final_time"))
    if flux_stream is not None:
        j = flux_stream.finalize()
        tot = cond.correlate_charge_flux(j)
        integral = cond.integrate_charge_flux_correlation(tot)
        result["charge_flux_corr"] = tot
        result["integral"] = integral
        if conductivity.get("fit", True):
            # fit=False stops before the plateau fit (short/sparse
            # trajectories where detect_time_range cannot find a window)
            ave, time_range = cond.fit_curve(
                tot, integral, conductivity.get("tol", 1e-4))
            result["sigma"] = cond.green_kubo(ave)
            result["sigma_time_range"] = time_range
    if hyd_stream is not None:
        result["hydration"] = hyd_stream.finalize()
    if nd_stream is not None:
        result["number_density"] = nd_stream.finalize()
    if res_stream is not None:
        result["residence_corr"] = res_stream.finalize()
        if residence_time.get("fit", False):
            # fit=False default: the stretched-exp fit needs enough
            # decay to converge (same reason conductivity's fit gates)
            result["residence_time"] = res.fit_auto_correlation(
                cut_percent=residence_time.get("cut_percent", 0.9),
                plot=residence_time.get("plot", False))
    return result


def _make_rdf(first_blk, num_types, mass, num_mols, num_atoms_per_mol,
              precision, rdf):
    """Configure the RDF stream from the first parsed block, exactly as
    ``calc_atomic_rdf`` does."""
    from mdproptools_tpu.ops.precision import resolve_dtype
    from mdproptools_tpu.structural import rdf_cn

    dtype = resolve_dtype(precision)
    alter = rdf.get("alter_atom_types", False)
    codes, n_codes, _ = rdf_cn._atom_codes(
        first_blk, num_types,
        num_mols if alter else None,
        num_atoms_per_mol if alter else None)
    num_bins = int(rdf["r_cut"] / rdf["bin_size"])
    relation_matrix = np.asarray(rdf["partial_relations"]).T
    lengths = first_blk.box_lengths
    code_counts = np.bincount(codes - 1,
                              minlength=n_codes).astype(np.float64)
    rdf_cn._check_relations(relation_matrix, code_counts, n_codes,
                            lengths.prod(axis=1), "atom")
    stream = rdf_cn._make_rdf_mean_stream(
        first_blk.cols(["x", "y", "z"]), codes, n_codes, lengths,
        rdf["bin_size"], num_bins, float(rdf["r_cut"]), relation_matrix,
        code_counts, code_counts, exclude_self=True, with_full=True,
        dtype=dtype, spatial_sort=rdf.get("spatial_sort", "auto"),
        exact_bins=rdf.get("exact_bins", "auto"),
    )
    return stream, {"num_bins": num_bins,
                    "relation_matrix": relation_matrix}
