"""
Mean-square displacement and Einstein-relation diffusion coefficients.

API-compatible with the reference ``mdproptools/dynamical/diffusion.py``
(class ``Diffusion``: ``get_msd_from_dump:101``, ``get_msd_from_log:241``,
``calc_diff:267``, ``get_diff_dist:410``) — same argument names, same
output DataFrame layouts (including the reference's pivoted
``dx21/dy21/.../msd1`` column convention for per-type COM MSD), same CSV
and plot artifacts.

Internals are array-first: the whole-trajectory pandas concat + groupby
pipeline (``diffusion.py:207-238``) becomes fixed-shape (T, N, 3)
displacement math with a segment-sum molecular COM on device.

Reference quirks preserved (parity-verified by tests):
- displacement reference is the frame at time 0 (``diffusion.py:213``);
- msd_int: the t=0 all-NaN row sums to msd=0 and is *included* in the
  per-particle time average, while per-axis means skip NaN
  (``diffusion.py:229-237`` — its ``drop(0, level=0)`` result is
  discarded);
- OLS without intercept; D = slope / (2 * dimension)
  (``diffusion.py:323-326``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pandas as pd

from mdproptools_tpu.common import constants
from mdproptools_tpu.common.system import System
from mdproptools_tpu.io.lammps_dump import (
    iter_trajectory_blocks,
    peek_dump_columns,
    prefetch_iter,
)
from mdproptools_tpu.ops import com as com_ops
from mdproptools_tpu.ops.fits import ols_no_intercept
from mdproptools_tpu.ops.precision import resolve_dtype
from mdproptools_tpu.utilities.log import concat_log

DISPS = ["dx2", "dy2", "dz2"]


class Diffusion:
    """Diffusion coefficients from MSD (Einstein relation), from LAMMPS
    dumps or thermo logs."""

    def __init__(self, timestep=1, units="real", outputs_dir=None,
                 diff_dir=None):
        self.units = units
        if self.units not in constants.SUPPORTED_UNITS:
            raise KeyError(
                "Unit type not supported. Supported units are: "
                + str(constants.SUPPORTED_UNITS)
            )
        self.outputs_dir = outputs_dir or os.getcwd()
        self.diff_dir = diff_dir or os.getcwd()
        self.timestep = timestep

    # -- trajectory -> unwrapped coordinates ---------------------------------
    @staticmethod
    def _unwrapped_coords(traj, dtype=np.float64):
        """(T, N, 3) unwrapped coordinates: prefer xu/yu/zu, else
        x + i * L (``diffusion.py:63-81``). ``dtype`` fuses the device
        cast into the column copy (one pass; value-identical to casting
        the f64 copy afterwards)."""
        if all(traj.has(c) for c in ("xu", "yu", "zu")):
            return traj.cols_as(["xu", "yu", "zu"], dtype)
        missing_w = [c for c in ("x", "y", "z") if not traj.has(c)]
        if missing_w:
            raise AssertionError(
                "Missing wrapped and unwrapped coordinates (x y z xu yu zu)"
            )
        if not all(traj.has(c) for c in ("ix", "iy", "iz")):
            raise AssertionError(
                "Missing unwrapped coordinates (xu yu zu) and box location "
                "(ix iy iz) for converting wrapped coordinates (x y z) into "
                "unwrapped coordinates."
            )
        pos = traj.cols(["x", "y", "z"])
        img = traj.cols(["ix", "iy", "iz"])
        out = pos + img * traj.box_lengths[:, None, :]
        return out if dtype == np.float64 else out.astype(dtype)

    @staticmethod
    def _msd_columns(available, msd_type, mass):
        """Minimal dump columns for the MSD path — the parse is the MSD
        leg's dominant cost at scale (the native parser converts only
        the requested columns), so skip x/y/z + images whenever xu/yu/zu
        are present and type/mass unless the COM mass lookup needs them.
        When unwrapped coords are incomplete, request every fallback
        column that exists so ``_unwrapped_coords`` raises its specific
        missing-column error rather than a generic one."""
        wanted = ["id"]
        if msd_type == "com":
            if mass is not None:
                wanted.append("type")  # map mass[type - 1]
            else:
                wanted.append("mass")
        avail = set(available)
        if {"xu", "yu", "zu"} <= avail:
            wanted += ["xu", "yu", "zu"]
        else:
            wanted += ["x", "y", "z", "xu", "yu", "zu", "ix", "iy", "iz"]
        return wanted

    def get_msd_from_dump(
        self,
        filename,
        msd_type="com",
        num_mols=None,
        num_atoms_per_mol=None,
        mass=None,
        com_drift=False,
        avg_interval=False,
        tao_coeff=4,
        precision="strict",
        msd_all_path=None,
    ):
        """MSD vs time from dumps; see the reference docstring
        (``diffusion.py:112-170``) for semantics. Returns (msd, msd_all)
        or (msd, msd_all, msd_int) DataFrames with the reference layouts.

        ``msd_all_path`` (beyond-reference, for long allatom runs): when
        set, the O(T x N)-row msd_all table is APPENDED to this CSV in
        block-sized chunks as frames stream instead of being
        materialized, and the returned ``msd_all`` is the path string.
        With it, the ``allatom`` path runs in O(block x N) host memory
        for any trajectory length (``msd``/``msd_int`` are streaming
        reductions either way).
        """
        pattern = f"{self.outputs_dir}/{filename}"
        available = peek_dump_columns(pattern)
        wanted = self._msd_columns(available, msd_type, mass)

        # Streamed ingestion: the (T, N, 3) unwrapped block is reduced
        # per block — for msd_type="com" to (T, M, 3) molecular COMs
        # (host memory O(block x N) + O(T x M)); "allatom" accumulates
        # every output as a per-block streaming reduction against frame
        # 0 (displacements, per-frame means, msd_int running sums, and
        # the msd_all rows either appended to ``msd_all_path`` or
        # collected in memory when the DataFrame was asked for).
        stream = self.msd_stream(
            msd_type=msd_type, num_mols=num_mols,
            num_atoms_per_mol=num_atoms_per_mol, mass=mass,
            tao_coeff=tao_coeff, precision=precision,
            msd_all_path=msd_all_path,
        )
        # prefetch depth 2: the background thread parses block k+1 while
        # fold(k)'s host copies and device transfers run (the C parser
        # releases the GIL) — at the 10k-frame scale the parse wait
        # otherwise serializes with the fold
        for blk in prefetch_iter(
            iter_trajectory_blocks(
                pattern, columns=[c for c in wanted if c in available]),
            depth=2,
        ):
            stream.fold(blk)
        return stream.finalize(com_drift=com_drift,
                               avg_interval=avg_interval)

    def msd_stream(self, msd_type="com", num_mols=None,
                   num_atoms_per_mol=None, mass=None, tao_coeff=4,
                   precision="strict", msd_all_path=None, fold="host"):
        """(beyond-reference) push-model MSD: ``fold(frame_block)`` one
        parsed block at a time, then ``finalize(...)`` for the same
        DataFrames ``get_msd_from_dump`` returns. Lets the shared-parse
        composite pipeline (``mdproptools_tpu.pipeline``) feed one parse
        into several property streams.

        ``fold="host"`` (default) reduces each block to molecular COMs
        on the host in float64 (``ops/host_fold.py`` — the reduction is
        bandwidth-trivial, so the per-atom block never needs uploading);
        ``fold="device"`` keeps
        the jitted segment-sum program per block (the mesh-sharded
        path)."""
        return _MsdStream(self, msd_type, num_mols, num_atoms_per_mol,
                          mass, tao_coeff, resolve_dtype(precision),
                          msd_all_path, fold)

    def _com_finalize(self, coords, time_s, system, masses, com_drift,
                      avg_interval, tao_coeff):
        """COM-path post-processing shared by the pull and push APIs:
        drift correction, msd/msd_all layouts, msd_int quirk."""
        T = coords.shape[0]

        mol_types = system.mol_type_of_molecule  # (M,) 1-based
        mol_ids = np.concatenate(
            [np.arange(1, n + 1) for n in system.num_mols]
        )
        # molecular mass in SI, used for drift weighting
        mol_mass = np.zeros(system.n_molecules)
        np.add.at(mol_mass, system.mol_index, masses)
        mol_mass = mol_mass * constants.MASS_CONVERSION[self.units]
        id_cols = {"type": mol_types, "mol_id": mol_ids}

        if com_drift:
            # subtract per-type mass-weighted COM drift vs t=0
            # (diffusion.py:91-96)
            n_types = int(mol_types.max())
            w = mol_mass
            drift = np.zeros((T, n_types, 3))
            for k in range(1, n_types + 1):
                sel = mol_types == k
                ws = w[sel] / w[sel].sum()
                com_t = np.einsum("tmc,m->tc", coords[:, sel, :], ws)
                drift[:, k - 1] = com_t - com_t[0]
            coords = coords - drift[:, mol_types - 1, :]

        # Displacement math sized T x M x 3: on the virtualized target
        # hosts fresh pages fault in ~100x slower than warm ones (see
        # utilities/host.py), so at the 10k-frame scale every avoidable
        # temporary costs real wall-clock. When ``coords`` is not needed
        # again (no msd_int sampling), square the displacements in
        # place; either way the msd_all table is assembled directly into
        # ONE preallocated block that the DataFrame adopts without the
        # usual per-column copy + consolidation pass. Values and layout
        # are identical to the straightforward construction (pinned by
        # the oracle-parity tests).
        M = coords.shape[1]
        if avg_interval:
            disp2 = (coords - coords[0][None]) ** 2  # (T, M, 3)
        else:
            c0 = coords[0].copy()
            np.subtract(coords, c0[None], out=coords)
            disp2 = np.square(coords, out=coords)
        msd_vals = disp2.sum(axis=2)  # (T, M)

        # ---- msd_all: per-entity rows, reference row order --------------
        # sort by (type, mol_id) — already in that order
        fblock = np.empty((5, T * M), np.float64)
        fblock[0].reshape(T, M)[:] = time_s[:, None]  # Time repeated
        for a in range(3):
            np.copyto(fblock[1 + a].reshape(T, M), disp2[:, :, a])
        fblock[4] = msd_vals.reshape(-1)
        msd_all = pd.DataFrame(
            fblock.T, columns=["Time (s)"] + DISPS + ["msd"], copy=False)
        tile_i = np.empty((2, T * M), np.int64)
        tile_i[0].reshape(T, M)[:] = mol_types[None, :]
        tile_i[1].reshape(T, M)[:] = mol_ids[None, :]
        msd_all.insert(1, "type", tile_i[0])
        msd_all.insert(2, "mol_id", tile_i[1])

        # ---- msd: averaged over entities ---------------------------------
        # pivoted per-type columns: dx2{k} dy2{k} dz2{k} msd{k}
        # sorted by type then column name (diffusion.py:220-222)
        n_types = int(mol_types.max())
        data = {}
        for k in range(1, n_types + 1):
            sel = mol_types == k
            for a, c in enumerate(DISPS):
                data[f"{c}{k}"] = disp2[:, sel, a].mean(axis=1)
            data[f"msd{k}"] = msd_vals[:, sel].mean(axis=1)
        cols_sorted = [
            f"{c}{k}"
            for k in range(1, n_types + 1)
            for c in sorted(DISPS + ["msd"])
        ]
        msd = pd.DataFrame({"Time (s)": time_s, **{c: data[c]
                                                   for c in cols_sorted}})

        if not avg_interval:
            return msd, msd_all

        # ---- msd_int: interval-averaged per-entity MSD -------------------
        # sample every tao_coeff-th frame; diff vs previous sample
        # (diffusion.py:225-238)
        sample = np.arange(0, T, tao_coeff)
        cs = coords[sample]  # (S, M, 3)
        dd = np.empty_like(cs)
        dd[0] = np.nan
        dd[1:] = (cs[1:] - cs[:-1]) ** 2
        # per-axis means skip the NaN first sample; the per-sample msd sums
        # NaNs to 0 (pandas skipna) and that 0 IS included in the mean —
        # faithful to diffusion.py:229-237
        with np.errstate(invalid="ignore"):
            axis_mean = np.nanmean(dd, axis=0)  # (M, 3)
        per_sample_msd = np.nan_to_num(dd).sum(axis=2)  # (S, M), row 0 = 0
        msd_mean = per_sample_msd.sum(axis=0) / len(sample)
        data = {k: np.asarray(v, np.float64) for k, v in id_cols.items()}
        for a, c in enumerate(DISPS):
            data[c] = axis_mean[:, a]
        data["msd"] = msd_mean
        msd_int = pd.DataFrame(data)
        return msd, msd_all, msd_int

    # -- streaming allatom reduction (O(block x N) host memory) ------------
    def _allatom_stream_block(self, aa, xu_b, timesteps_b, ids, tao_coeff,
                              msd_all_path):
        """Fold one (block, N, 3) SI-coordinate block into the running
        allatom state ``aa``: per-frame means for ``msd``, msd_all rows
        (appended to ``msd_all_path`` or collected), and the msd_int
        running sums. Operation-for-operation identical to the previous
        whole-trajectory math (each frame's row only depends on that
        frame and frame 0), so results are bit-equal to the in-memory
        path (pinned by tests)."""
        if aa is None:
            aa = {
                "x0": xu_b[0].copy(),
                "order": np.argsort(ids, kind="stable"),
                "t": 0,
                "mean_parts": [],
                "all_parts": [] if msd_all_path is None else None,
                "wrote_header": False,
                "prev_sample": None,
                "n_samples": 0,
                "sum_dd": np.zeros_like(xu_b[0]),
            }
        disp2 = (xu_b - aa["x0"][None]) ** 2  # (block, N, 3)
        msd_vals = disp2.sum(axis=2)  # (block, N)
        nb, N = msd_vals.shape
        aa["mean_parts"].append(np.concatenate(
            [disp2.mean(axis=1), msd_vals.mean(axis=1)[:, None]], axis=1))

        # msd_all rows: frame-major, id ascending (diffusion.py:207-218)
        time_b = (timesteps_b.astype(np.float64) * self.timestep
                  * constants.TIME_CONVERSION[self.units])
        order = aa["order"]
        rows = {
            "Time (s)": np.repeat(time_b, N),
            "id": np.tile(ids[order], nb).astype(np.float64),
        }
        d_sorted = disp2[:, order, :]
        for a, c in enumerate(DISPS):
            rows[c] = d_sorted[:, :, a].reshape(-1)
        rows["msd"] = msd_vals[:, order].reshape(-1)
        df_b = pd.DataFrame(rows)
        if msd_all_path is None:
            aa["all_parts"].append(df_b)
        else:
            df_b.to_csv(msd_all_path,
                        mode="a" if aa["wrote_header"] else "w",
                        header=not aa["wrote_header"], index=False)
            aa["wrote_header"] = True

        # msd_int running sums: samples at global frames 0, tao, 2tao, ...
        for j in range(nb):
            if (aa["t"] + j) % tao_coeff == 0:
                cs = xu_b[j]
                if aa["prev_sample"] is not None:
                    dd = (cs - aa["prev_sample"]) ** 2
                    aa["sum_dd"] += dd
                    # per-sample msd summed over axes BEFORE the sample
                    # sum (the reference's association order)
                    aa.setdefault("sum_msd", np.zeros(N))
                    aa["sum_msd"] += dd.sum(axis=1)
                aa["prev_sample"] = cs.copy()
                aa["n_samples"] += 1
        aa["t"] += nb
        return aa

    def _allatom_finalize(self, aa, time_s, ids, avg_interval,
                          msd_all_path):
        means = np.concatenate(aa["mean_parts"])  # (T, 4)
        msd = pd.DataFrame({
            "Time (s)": time_s,
            **{c: means[:, a] for a, c in enumerate(DISPS)},
            "msd": means[:, 3],
        })
        if msd_all_path is None:
            msd_all = pd.concat(aa["all_parts"], ignore_index=True)
        else:
            msd_all = msd_all_path
        if not avg_interval:
            return msd, msd_all
        # msd_int semantics (diffusion.py:225-238): the t=0 sample row is
        # NaN; per-axis means skip it (mean over S-1 diffs), the
        # per-sample msd sums it to 0 and that 0 IS included (/S)
        S = aa["n_samples"]
        if S > 1:
            axis_mean = aa["sum_dd"] / (S - 1)
        else:
            axis_mean = np.full_like(aa["sum_dd"], np.nan)
        msd_mean = aa.get("sum_msd",
                          np.zeros(aa["sum_dd"].shape[0])) / S
        data = {"id": ids.astype(np.float64)}
        for a, c in enumerate(DISPS):
            data[c] = axis_mean[:, a]
        data["msd"] = msd_mean
        return msd, msd_all, pd.DataFrame(data)

    def get_msd_from_log(self, log_pattern):
        """MSD columns from LAMMPS thermo logs, converted to SI
        (``diffusion.py:241-265``)."""
        full_log = concat_log(log_pattern, step=None,
                              working_dir=self.outputs_dir)
        msd = full_log.filter(regex="msd").copy()
        for col in msd:
            msd[col] = msd[col] * constants.DISTANCE_CONVERSION[self.units] ** 2
        msd["Time (s)"] = (
            full_log["Step"] * self.timestep
            * constants.TIME_CONVERSION[self.units]
        )
        return msd

    def detect_linear_region(self, msd, tol=0.2, min_points=5):
        """Detect the diffusive (Fickian) regime of each MSD column: the
        longest contiguous window where the local log-log slope
        beta = dlog(MSD)/dlog(t) stays within ``tol`` of 1 (beta ~ 2 is
        early-time ballistic motion, beta < 1 is caged/subdiffusive).
        Returns (initial_time, final_time) dicts keyed by MSD column in
        seconds — directly usable as ``calc_diff`` arguments:

            d.calc_diff(msd, *d.detect_linear_region(msd))

        The reference declares this method as an empty stub
        (``diffusion.py:98-99``); implemented here (beyond-reference,
        like ``Conductivity.einstein``/``nernst``). Raises ValueError if
        no window of at least ``min_points`` samples qualifies."""
        t = np.asarray(msd["Time (s)"], np.float64)
        cols = [c for c in msd.columns if "msd" in c.lower()]
        initial, final = {}, {}
        for c in cols:
            y = np.asarray(msd[c], np.float64)
            ok = (t > 0) & (y > 0) & np.isfinite(y)
            lt, ly = np.log(t[ok]), np.log(y[ok])
            if len(lt) < max(min_points, 3):
                raise ValueError(
                    f"not enough positive MSD samples for {c!r}")
            if np.any(np.diff(lt) <= 0):
                raise ValueError(
                    "MSD 'Time (s)' values must be strictly increasing; "
                    "repeated or out-of-order timestamps would produce "
                    "divide-by-zero log-log slopes"
                )
            beta = np.gradient(ly, lt)
            good = np.abs(beta - 1.0) <= tol
            best = (0, 0)
            run = None
            for i, g in enumerate(list(good) + [False]):
                if g and run is None:
                    run = i
                elif not g and run is not None:
                    if i - run > best[1] - best[0]:
                        best = (run, i)
                    run = None
            if best[1] - best[0] < min_points:
                raise ValueError(
                    f"no linear region of >= {min_points} points found "
                    f"for {c!r} within tol={tol} of slope 1")
            ts = t[ok]
            initial[c] = float(ts[best[0]])
            final[c] = float(ts[best[1] - 1])
        return initial, final

    def calc_diff(self, msd, initial_time=None, final_time=None, dimension=3,
                  diff_names=None, save=False, plot=False):
        """Einstein-relation D from OLS slope of MSD vs time
        (``diffusion.py:267-408``). Writes diffusion.csv; optionally
        diff_*.txt summaries and msd.png / msd_log.png."""
        if initial_time is None:
            initial_time = {}
        if final_time is None:
            final_time = {}
        min_t = msd["Time (s)"].min()
        max_t = msd["Time (s)"].max()
        msd_col_names = [c for c in msd.columns if "msd" in c.lower()]
        diff = np.zeros((len(msd_col_names), 3))
        models = []
        windows = []
        for ind, col in enumerate(msd_col_names):
            # reference keys the window dicts by integer column position
            # (diffusion.py:319-320); column-NAME keys are also accepted
            # so detect_linear_region's return composes directly
            lo = initial_time.get(col, initial_time.get(ind, min_t))
            hi = final_time.get(col, final_time.get(ind, max_t))
            win = msd[(msd["Time (s)"] >= lo) & (msd["Time (s)"] <= hi)]
            windows.append(win)
            model = ols_no_intercept(win["Time (s)"].to_numpy(),
                                     win[col].to_numpy())
            models.append(model)
            diff[ind] = [
                model.slope / (2 * dimension),
                model.bse / (2 * dimension),
                model.rsquared,
            ]
            if save:
                name = diff_names[ind] if diff_names else ind + 1
                with open(f"{self.diff_dir}/diff_{name}.txt", "w") as f:
                    f.write(model.summary())
        index = diff_names or [i + 1 for i in range(len(msd_col_names))]
        diffusion = pd.DataFrame(
            diff, columns=["diffusion (m2/s)", "std", "R2"], index=index
        )
        if plot:
            self._plot_msd(msd, msd_col_names, models, windows, index)
        diffusion.to_csv(f"{self.diff_dir}/diffusion.csv")
        return diffusion

    def _plot_msd(self, msd, msd_col_names, models, windows, labels):
        """PARITY-PINNED TRANSLITERATION (``diffusion.py:344-408``): the
        msd.png / msd_log.png figure structure, Paired colormap, fit
        overlays and log-log guide line mirror the reference so outputs
        are visually comparable artifact-for-artifact; only the Agg
        backend and odd-panel cleanup differ."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.ticker import ScalarFormatter

        from mdproptools_tpu.utilities.plots import set_axis

        paired = plt.get_cmap("Paired")
        colors = iter(paired(np.linspace(0, 1, 10)))
        ncols = 2
        nrows = int(np.ceil(len(msd_col_names) / ncols))
        fig, axes = plt.subplots(nrows, ncols, figsize=(12, 8), squeeze=False)
        fig_log, axes_log = plt.subplots(nrows, ncols, figsize=(12, 8),
                                         squeeze=False)
        time_data = msd["Time (s)"] * 1e9
        for i, (ax, ax_log, col) in enumerate(
            zip(axes.flatten(), axes_log.flatten(), msd_col_names)
        ):
            color = next(colors)
            pred = models[i].predict(windows[i]["Time (s)"].to_numpy())
            ax.plot(time_data, msd[col], color=color, linewidth=2,
                    label=str(labels[i]))
            ax.plot(windows[i]["Time (s)"] * 1e9, pred, color="k", ls="--",
                    linewidth=2)
            with np.errstate(divide="ignore"):
                st_line = 10 ** (np.log10(msd[col].max())
                                 - np.log10(time_data.max()))
            ax_log.plot(time_data, msd[col], color=color, linewidth=2,
                        label=str(labels[i]))
            ax_log.plot(time_data, time_data * st_line, color="k", ls="--",
                        linewidth=2)
            ax_log.set(xscale="log", yscale="log")
            for axis in (ax, ax_log):
                set_axis(axis, axis="both")
                axis.legend(fontsize=16, frameon=False)
                axis.set_xlabel(r"$\mathrm{Time, 10^9 (s)}$", fontsize=18)
                axis.set_ylabel(r"$\mathrm{MSD\ (m^2)}$", fontsize=18)
                fmt = ScalarFormatter(useOffset=False)
                axis.yaxis.set_major_formatter(fmt)
        for figure, axis, name in zip(
            [fig, fig_log], [axes, axes_log], ["msd.png", "msd_log.png"]
        ):
            if len(msd_col_names) % 2 != 0:
                figure.delaxes(ax=axis.flatten()[-1])
            figure.tight_layout()
            figure.savefig(f"{self.diff_dir}/{name}", bbox_inches="tight",
                           pad_inches=0.1)
        plt.close(fig)
        plt.close(fig_log)

    def get_diff_dist(self, msd_int, dump_freq, dimension=3, tao_coeff=4,
                      plot=False, diff_names=None):
        """Per-particle diffusivity distribution from msd_int
        (``diffusion.py:410-516``); D = msd / (2 * dim * tao * delta)."""
        delta = (dump_freq * self.timestep
                 * constants.TIME_CONVERSION[self.units])
        msd_int = msd_int.copy()
        msd_int["diff"] = msd_int["msd"] / (2 * dimension * tao_coeff * delta)
        if plot:
            # PARITY-PINNED TRANSLITERATION (diffusion.py:445-516): the
            # per-type seaborn histogram grid (bins="sqrt", kde, density)
            # and diff_dist.png naming mirror the reference artifact.
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            import seaborn as sns
            from matplotlib.ticker import ScalarFormatter

            from mdproptools_tpu.utilities.plots import set_axis

            paired = plt.get_cmap("Paired")
            colors = iter(paired(np.linspace(0, 1, 10)))
            if "type" in msd_int.columns:
                groups = msd_int.groupby("type")
                labels = diff_names or [i + 1 for i in range(len(groups))]
                ncols = 2
                nrows = int(np.ceil(groups.ngroups / ncols))
                fig, axes = plt.subplots(nrows, ncols, figsize=(12, 8),
                                         squeeze=False)
                for ax, (key, grp) in zip(axes.flatten(), groups):
                    color = next(colors)
                    set_axis(ax, axis="both")
                    sns.histplot(grp["diff"] * 1e9, bins="sqrt", color=color,
                                 edgecolor="k", label=str(labels[int(key) - 1]),
                                 kde=True, stat="density", ax=ax)
                    ax.legend(fontsize=16, frameon=False)
                    ax.set_xlabel(
                        r"$\mathrm{Diffusivity, 10^{-9}\ (m^2/s)}$",
                        fontsize=18,
                    )
                    ax.set_ylabel("Frequency", fontsize=18)
                    ax.xaxis.set_major_formatter(ScalarFormatter())
                if groups.ngroups % 2 != 0:
                    fig.delaxes(ax=axes.flatten()[-1])
            else:
                fig, ax = plt.subplots(figsize=(8, 6))
                set_axis(ax, axis="both")
                sns.histplot(msd_int["diff"] * 1e9, bins="sqrt",
                             color=next(colors), edgecolor="k", kde=True,
                             stat="density", ax=ax)
                ax.set_xlabel(r"$\mathrm{Diffusivity, 10^{-9}\ (m^2/s)}$",
                              fontsize=18)
                ax.set_ylabel("Frequency", fontsize=18)
            fig.tight_layout()
            fig.savefig(f"{self.diff_dir}/diff_dist.png", bbox_inches="tight",
                        pad_inches=0.1)
            plt.close(fig)
        return msd_int


class _MsdStream:
    """Push-model MSD accumulator (built by ``Diffusion.msd_stream``):
    ``fold(frame_block)`` reduces each parsed block (segment-sum COMs
    for the com path; the O(block)-memory displacement reduction for
    allatom), ``finalize(...)`` returns exactly what
    ``get_msd_from_dump`` returns."""

    def __init__(self, diff, msd_type, num_mols, num_atoms_per_mol, mass,
                 tao_coeff, dtype, msd_all_path, fold="host"):
        if msd_type not in ("allatom", "com"):
            raise ValueError("msd_type must be 'allatom' or 'com'.")
        if fold not in ("host", "device"):
            raise ValueError("fold must be 'host' or 'device'.")
        if msd_all_path is not None and msd_type != "allatom":
            raise ValueError(
                "msd_all_path streams the allatom per-atom table; the "
                "com path's msd_all is O(T x M) and always in memory")
        self.d = diff
        self.msd_type = msd_type
        self.num_mols = num_mols
        self.num_atoms_per_mol = num_atoms_per_mol
        self.mass = mass
        self.tao_coeff = tao_coeff
        self.dtype = dtype
        self.msd_all_path = msd_all_path
        self.dist = constants.DISTANCE_CONVERSION[diff.units]
        self.fold_mode = fold
        self.ids = self.masses = self.system = None
        self.coords_parts = []
        self.ts_parts = []
        self.aa = None
        self._com_fn = None  # jitted per-block COM program (com path)
        self._host_fold = None  # host reduceat layout (fold="host")

    def fold(self, blk):
        if self.ids is None:  # frame-0 metadata
            if not blk.has("id"):
                raise AssertionError("Missing atom id's in dump file.")
            self.ids = blk.col("id")[0].astype(np.int64)
            if self.msd_type == "com":
                self.system = System(self.num_mols, self.num_atoms_per_mol)
                if self.mass is not None:
                    types = blk.col("type")[0].astype(np.int64)
                    self.masses = np.asarray(self.mass,
                                             np.float64)[types - 1]
                elif blk.has("mass"):
                    # copy: col() is a view into the recycled
                    # block buffer (io._BlockBufferPool)
                    self.masses = blk.col("mass")[0].copy()
                else:
                    raise AssertionError("Missing atom masses in dump file.")
        if self.msd_type == "com" and self.fold_mode == "host":
            # Host float64 reduceat fold (ops/host_fold.py): the
            # (block, N, 3) copy is weighted in place and reduced to
            # (block, M, 3) without touching the device — no upload,
            # and the few-ms/frame host cost hides under the composite's RDF
            # device fold. f64 regardless of ``precision`` (strictly
            # tighter than the fast-mode device fold it replaces).
            if self._host_fold is None:
                from ..ops.host_fold import MolecularFold

                self._host_fold = MolecularFold(self.system, self.masses)
            xu_b = Diffusion._unwrapped_coords(blk, np.float64)
            self.coords_parts.append(self._host_fold.segment_com(xu_b))
        elif self.msd_type == "com":
            # fused f64->dtype column copy (one pass, no f64 temporary)
            xu_b = Diffusion._unwrapped_coords(blk, self.dtype)
            if self._com_fn is None:
                # jit ONCE with masses/segments as captured device
                # constants: the unjitted segment_com dispatches ~10
                # eager ops per block
                import jax

                masses_d = jnp.asarray(self.masses, self.dtype)
                mol_index_d = jnp.asarray(self.system.mol_index)
                n_mol = self.system.n_molecules
                self._com_fn = jax.jit(
                    lambda xu: com_ops.segment_com(
                        xu, masses_d, mol_index_d, n_mol))
            com_b = self._com_fn(jnp.asarray(xu_b))
            # Accumulate the (block, M, 3) COM shards ON DEVICE and
            # fetch once at finalize: one synchronizing fetch instead
            # of one per block. The resident total is T x M x 3 f32
            # (~335 MB at 10,100 frames x 41,916 atoms), far below the
            # device memory.
            self.coords_parts.append(com_b)
        else:
            xu_b = Diffusion._unwrapped_coords(blk)  # f64 host math
            self.aa = self.d._allatom_stream_block(
                self.aa, xu_b * self.dist, blk.timesteps, self.ids,
                self.tao_coeff, self.msd_all_path)
        self.ts_parts.append(blk.timesteps)

    def finalize(self, com_drift=False, avg_interval=False):
        if not self.ts_parts:
            raise ValueError("no frames folded")
        time_s = (
            np.concatenate(self.ts_parts).astype(np.float64)
            * self.d.timestep
            * constants.TIME_CONVERSION[self.d.units]
        )
        if self.msd_type == "allatom":
            return self.d._allatom_finalize(self.aa, time_s, self.ids,
                                            avg_interval,
                                            self.msd_all_path)
        if self.fold_mode == "host":
            coords = np.concatenate(self.coords_parts)  # f64 already
        else:
            # one device concatenate + ONE fetch for the whole
            # trajectory's COM history (see fold); f64 promotion
            # happens host-side
            coords = np.asarray(
                jnp.concatenate(self.coords_parts), np.float64)
        self.coords_parts.clear()
        if coords.flags.writeable:
            coords *= self.dist  # SI, in place (no T x M x 3 temporary)
        else:  # same-dtype fetches can be read-only zero-copy views
            coords = coords * self.dist
        return self.d._com_finalize(coords, time_s, self.system,
                                    self.masses, com_drift, avg_interval,
                                    self.tao_coeff)
