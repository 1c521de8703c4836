"""
High-throughput multi-trajectory sweeps (batched RDF/MSD/GK over 100+
trajectories).

A sweep amortizes ONE compiled device program across many trajectories
of the same system (same atom count/types — the replicate/ensemble
setting): ``sweep_rdf`` builds the per-frame step once
(``rdf_cn._make_rdf_step``) and streams every trajectory's frame blocks
through the same jitted block runner, with host-side parsing prefetched
on a background thread so parse and device compute overlap. Without the
sweep, each ``calc_atomic_rdf`` call retraces and recompiles its own
program. ``rdf_cn._trace_log`` records block-program traces (the tests
assert exactly one per block shape across the whole sweep).

Multi-chip: the sweep composes with the ``frames``-axis mesh in
``mdproptools_tpu.parallel.mesh`` by sharding each block's frames
(see ``sharded_rdf_hist``); the single-controller sweep itself is
device-count-agnostic.
"""

from typing import Optional, Sequence

import numpy as np
import pandas as pd

from mdproptools_tpu.io.lammps_dump import prefetch_iter
from mdproptools_tpu.utilities.tracing import stage


def sweep_rdf(
    filenames: Sequence[str],
    r_cut,
    bin_size,
    num_types,
    mass,
    partial_relations,
    num_mols=None,
    num_atoms_per_mol=None,
    precision="fast",
    labels: Optional[Sequence[str]] = None,
) -> pd.DataFrame:
    """Atomic RDF for many same-system trajectories through ONE compiled
    block program, with parse/compute overlap.

    Returns a long-format DataFrame with a ``trajectory`` column
    prepended to the per-trajectory RDF columns.
    """
    from mdproptools_tpu.ops.precision import resolve_dtype
    from mdproptools_tpu.structural import rdf_cn

    labels = list(labels) if labels is not None else [
        str(f) for f in filenames
    ]
    dtype = resolve_dtype(precision)

    # shared metadata + ONE step/block program from the first trajectory
    first, _ = rdf_cn._open_stream(filenames[0])
    codes, n_codes, _ = rdf_cn._atom_codes(first, num_types, num_mols,
                                           num_atoms_per_mol)
    num_bins = int(r_cut / bin_size)
    relation_matrix = np.asarray(partial_relations).T
    code_counts = np.bincount(codes - 1,
                              minlength=n_codes).astype(np.float64)
    rdf_cn._check_relations(relation_matrix, code_counts, n_codes,
                            first.box_lengths.prod(axis=1), "atom")
    step, nrows = rdf_cn._make_rdf_step(
        codes, n_codes, first.n_atoms, first.box_lengths, bin_size,
        num_bins, float(r_cut), relation_matrix, code_counts, code_counts,
        exclude_self=True, with_full=True, dtype=dtype,
    )
    # the sweep's ONE block program frame-shards over the active/auto
    # mesh (several GPUs sweep data-parallel; None on one device)
    mesh = rdf_cn._auto_frames_mesh()
    run_block = rdf_cn._make_block_runner(step, (nrows, num_bins), dtype,
                                          mesh=mesh)
    n_pad_to = 1 if mesh is None else mesh.size

    def traj_blocks(f):
        def gen():
            _, blocks = rdf_cn._open_stream(f)
            for blk in blocks():
                yield blk.cols(["x", "y", "z"]), None, blk.box_lengths

        # background parse thread: next block parses while the device
        # runs the current one
        return prefetch_iter(gen(), depth=2)

    radii = rdf_cn._radii(bin_size, num_bins)
    # queue trajectories' device work asynchronously: single-block
    # trajectories keep their running sum on device and a BATCHED fetch
    # replaces per-trajectory synchronizing transfers; multi-block
    # trajectories already fetched per block
    # inside _accumulate_stream_device (host-f64 totals, bounded
    # in-flight memory). A flush every FLUSH_EVERY pending results
    # bounds the queued device input buffers for very large sweeps.
    import jax.numpy as jnp

    FLUSH_EVERY = 64

    totals: list = []
    counts = []
    pending: list = []  # indices into totals still holding device arrays

    def flush():
        if not pending:
            return
        fetched = np.asarray(
            jnp.stack([totals[k] for k in pending]), np.float64)
        for j, k in enumerate(pending):
            totals[k] = fetched[j]
        pending.clear()

    for name, f in zip(labels, filenames):
        with stage("sweep_rdf", trajectory=name):
            tot, T = rdf_cn._accumulate_stream_device(
                run_block, traj_blocks(f), dtype, n_pad_to=n_pad_to)
            if not isinstance(tot, np.ndarray):
                pending.append(len(totals))
            totals.append(tot)
            counts.append(T)
            if len(pending) >= FLUSH_EVERY:
                flush()
    flush()

    out = []
    for k, name in enumerate(labels):
        rows = np.asarray(totals[k], np.float64) / counts[k]
        df = rdf_cn._save_rdf(radii, relation_matrix, None, False,
                              rows[1:], rows[0])
        df.insert(0, "trajectory", name)
        out.append(df)
    return pd.concat(out, ignore_index=True)


def sweep_msd(
    filenames: Sequence[str],
    msd_type="com",
    num_mols=None,
    num_atoms_per_mol=None,
    mass=None,
    timestep=1,
    units="real",
    precision="fast",
    labels: Optional[Sequence[str]] = None,
    dimension=3,
):
    """MSD + diffusion coefficients for many trajectories.

    Returns (msd_long, diffusion_long) DataFrames with a ``trajectory``
    column.
    """
    import os
    import tempfile

    from mdproptools_tpu.dynamical.diffusion import Diffusion

    labels = list(labels) if labels is not None else [
        str(f) for f in filenames
    ]
    msd_out, diff_out = [], []
    for name, f in zip(labels, filenames):
        outputs_dir, fname = os.path.split(f)
        d = Diffusion(timestep=timestep, units=units,
                      outputs_dir=outputs_dir or ".",
                      diff_dir=tempfile.mkdtemp(prefix="mdpt_sweep_"))
        with stage("sweep_msd", trajectory=name):
            msd, _ = d.get_msd_from_dump(
                fname, msd_type=msd_type, num_mols=num_mols,
                num_atoms_per_mol=num_atoms_per_mol, mass=mass,
                precision=precision,
            )
            diff = d.calc_diff(msd, dimension=dimension)
        msd.insert(0, "trajectory", name)
        diff = diff.reset_index(names="species")
        diff.insert(0, "trajectory", name)
        msd_out.append(msd)
        diff_out.append(diff)
    return (pd.concat(msd_out, ignore_index=True),
            pd.concat(diff_out, ignore_index=True))


def sweep_conductivity(
    filenames: Sequence[str],
    num_mols,
    num_atoms_per_mol,
    volume,
    mass=None,
    temp=298.15,
    timestep=1,
    units="real",
    tol=1e-4,
    precision="fast",
    labels: Optional[Sequence[str]] = None,
) -> pd.DataFrame:
    """Green-Kubo conductivity for many trajectories (replicates).

    Returns a DataFrame: one row per trajectory, sigma per molecule type
    plus total, and the ensemble mean/std rows appended.
    """
    import os

    from mdproptools_tpu.dynamical.conductivity import Conductivity

    labels = list(labels) if labels is not None else [
        str(f) for f in filenames
    ]
    rows = []
    for name, f in zip(labels, filenames):
        working_dir, fname = os.path.split(f)
        cond = Conductivity(
            fname, num_mols, num_atoms_per_mol, volume, mass=mass,
            temp=temp, timestep=timestep, units=units,
            working_dir=working_dir or ".", precision=precision,
        )
        with stage("sweep_cond", trajectory=name):
            j = cond.get_charge_flux()
            tot = cond.correlate_charge_flux(j)
            integ = cond.integrate_charge_flux_correlation(tot)
            ave, _ = cond.fit_curve(tot, integ, tol)
            sigma = cond.green_kubo(ave)
        rows.append([name] + list(sigma))
    cols = ["trajectory"] + [
        f"sigma_{i + 1}" for i in range(len(num_mols))
    ] + ["sigma_total"]
    df = pd.DataFrame(rows, columns=cols)
    stats = df.drop(columns="trajectory")
    df = pd.concat(
        [
            df,
            pd.DataFrame(
                [["mean"] + stats.mean().tolist(),
                 ["std"] + stats.std().tolist()],
                columns=cols,
            ),
        ],
        ignore_index=True,
    )
    return df
