"""
Residence time from neighbor-shell survival autocorrelation.

API-compatible with the reference
``mdproptools/dynamical/residence_time.py`` (class ``ResidenceTime``:
``calc_auto_correlation:70``, ``fit_auto_correlation:150``): boolean
h-matrix (pair inside the radial shell [r_in, r_out]) per frame, per-pair
ACF (unbiased, non-demeaned — statsmodels ``acovf`` semantics,
``residence_time.py:134-137``), normalized C(t), stretched-exponential
fit, residence time = a tau_res Gamma(1 + 1/beta) + (1-a) tau_short.

Device internals: the h-matrices for all frames are built by a
vmapped minimum-image shell kernel; ALL pair columns autocorrelate in a
single batched FFT instead of a Python loop per column
(``residence_time.py:121-139``).

``Displacement`` in the reference is dead code (its ``calc_dist`` raises
TypeError at ``residence_time.py:239``); here it is implemented to do
what its structure intends: per-atom-type displacement distributions over
a time window close to each type's residence time. Divergence documented.
"""

import os
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
from scipy.optimize import curve_fit
from scipy.special import gamma

from mdproptools_tpu.common.system import altered_atom_types
from mdproptools_tpu.io.lammps_dump import (
    iter_trajectory_blocks,
)
from mdproptools_tpu.ops import acf as acf_ops
from mdproptools_tpu.ops import pairs as pair_ops
from mdproptools_tpu.ops.precision import resolve_dtype


# Per-relation cap on in-memory h-matrix bytes before the boolean shell
# matrices spill to a disk-backed memmap (the survival ACF fundamentally
# needs every frame's h-matrix; spilling bounds HOST memory at
# O(block x N) + O(acf_chunk x T) for any trajectory length). Tests
# monkeypatch this to force the spill path.
H_SPILL_BYTES = 512 * 2**20


class _SpillStore:
    """Accumulates (block, Na, Nb) bool h-matrix blocks; stays in memory
    until ``cap_bytes``, then transparently spills everything to a temp
    file consumed as a read-only memmap (bit-identical contents)."""

    def __init__(self, cap_bytes):
        self.cap = cap_bytes
        self.parts: list = []
        self.nbytes = 0
        self.fh = None
        self.path = None
        self.inner_shape = None
        self.T = 0

    def append(self, arr):
        arr = np.ascontiguousarray(arr, dtype=np.bool_)
        self.T += arr.shape[0]
        self.inner_shape = arr.shape[1:]
        if self.fh is None and self.nbytes + arr.nbytes > self.cap:
            import tempfile

            fd, self.path = tempfile.mkstemp(prefix="mdpt_hmat_",
                                             suffix=".bin")
            self.fh = os.fdopen(fd, "wb")
            for p in self.parts:
                self.fh.write(p.tobytes())
            self.parts = []
            self.nbytes = 0
        if self.fh is not None:
            self.fh.write(arr.tobytes())
        else:
            self.parts.append(arr)
            self.nbytes += arr.nbytes

    def finalize(self):
        """(T, Na, Nb) bool ndarray (in-memory) or read-only memmap."""
        if self.fh is not None:
            self.fh.flush()
            self.fh.close()
            self.fh = None
            return np.memmap(self.path, dtype=np.bool_, mode="r",
                             shape=(self.T, *self.inner_shape))
        return np.concatenate(self.parts)

    def cleanup(self):
        if self.fh is not None:
            self.fh.close()
            self.fh = None
        if self.path is not None:
            try:
                os.unlink(self.path)
            except OSError:
                pass
            self.path = None


def find_intersection(a, b):
    """Sum of ``b[i, j]`` over the index pairs in ``a`` — a working
    version of the reference's dead njit helper
    (``residence_time.py:31-36``, defined but never called there); kept
    for API parity."""
    a = np.asarray(a)
    if a.size == 0:
        return 0
    b = np.asarray(b)
    return b[a[:, 0].astype(np.int64), a[:, 1].astype(np.int64)].sum()


class ResidenceTime:
    def __init__(
        self,
        r_cut,
        partial_relations,
        filename,
        dt=1,
        num_mols=None,
        num_atoms_per_mol=None,
        working_dir=None,
        precision="strict",
    ):
        """``r_cut``: list of (r_in, r_out) shell bounds per relation;
        ``partial_relations``: [[ref types], [other types]] as in the
        reference (``residence_time.py:41-60``)."""
        self.r_cut = r_cut
        self.relation_matrix = np.asarray(partial_relations).T
        self.atom_pairs: List[str] = []
        self.filename = filename
        self.dt = dt * 10**-3  # fs -> ps
        self.corr_df: Optional[pd.DataFrame] = None
        self.res_time_df: Optional[pd.DataFrame] = None
        self.num_mols = num_mols
        self.num_atoms_per_mol = num_atoms_per_mol
        self.working_dir = working_dir or os.getcwd()
        self.precision = precision

    @staticmethod
    def _stretched_exp_function(x, a, tau_res, tau_short, beta):
        return a * np.exp(-((x / tau_res) ** beta)) + (1 - a) * np.exp(
            -x / tau_short
        )

    @staticmethod
    def _integrate_sum_exp(a, tau_res, tau_short, beta):
        return (a * tau_res * gamma(1 + 1 / beta)) + (1 - a) * tau_short

    def calc_auto_correlation(self):
        """C(t) per relation: h-matrices on device, batched FFT ACF,
        normalized by C(0) (``residence_time.py:70-148``). Saves
        auto_correlation.csv and returns the DataFrame."""
        from mdproptools_tpu.io.lammps_dump import prefetch_iter

        stream = self.residence_stream()
        for blk in prefetch_iter(
            iter_trajectory_blocks(
                self.filename, columns=["id", "type", "x", "y", "z"]),
            depth=2,
        ):
            stream.fold(blk)
        return stream.finalize()

    def residence_stream(self):
        """(beyond-reference) push-model survival ACF:
        ``fold(frame_block)`` reduces each parsed block to the boolean
        shell matrices, ``finalize()`` -> the auto-correlation DataFrame
        ``calc_auto_correlation`` returns. Lets the shared-parse
        composite pipeline (``mdproptools_tpu.analyze``) feed ONE parse
        into this plus the RDF/MSD/flux streams (positions are the same
        x/y/z columns the RDF leg reads)."""
        return _ResidenceStream(self)

    def _acf_finalize(self, h_parts, rel_meta, ts_parts, dtype):
        timesteps = np.concatenate(ts_parts)
        T = timesteps.shape[0]
        correlation = {"Time (ps)": timesteps.astype(np.float64) * self.dt}
        np_dtype = np.dtype(jnp.dtype(dtype).name)
        try:
            for kl, (k, l, atom_pair, sel_k, sel_l) in enumerate(rel_meta):
                h_src = h_parts[kl].finalize()  # (T, Na, Nb) ndarray|memmap
                flat = h_src.reshape(T, -1)  # column index = i * Nb + j
                eye_flat = (np.equal.outer(sel_k, sel_l).reshape(-1)
                            if k == l else None)
                # batched ACF over all (central atom, partner) columns,
                # in bounded chunks so the zero-padded complex FFT never
                # materializes more than ~chunk x 2T at once; each chunk
                # is read from the (possibly disk-backed) source and the
                # self-pair columns zeroed (residence_time.py:103-104)
                n_cols = flat.shape[1]
                chunk = max(1, 8_388_608 // (2 * T))  # ~8M elems per FFT
                # Disk-backed (spilled) sources are read in SLABS of many
                # columns before the per-chunk FFTs: slicing the row-major
                # (T, n_cols) memmap column-wise in chunk-wide pieces reads
                # every 4 KB page once per chunk that touches it —
                # 4096/chunk x the file size of redundant I/O (~10x at
                # T=10k), and the spill only engages when the data is too
                # big to page-cache. A slab of >= 8192 columns consumes
                # each fetched page fully; in-memory sources skip slabbing.
                slab = (max(chunk, min(8192, max(1, 268_435_456 // T)))
                        if isinstance(h_src, np.memmap) else chunk)
                cov_sum = np.zeros(T, np.float64)
                for s0 in range(0, n_cols, slab):
                    sblock = np.ascontiguousarray(
                        flat[:, s0:s0 + slab].T)  # (cols, T)
                    for s in range(0, sblock.shape[0], chunk):
                        sub = sblock[s:s + chunk].astype(np_dtype)
                        if eye_flat is not None:
                            sub *= ~eye_flat[s0 + s:s0 + s + chunk, None]
                        # ops.acf dispatches host vs device by size/dtype
                        cov_sum += np.asarray(
                            acf_ops.autocorrelate(sub),
                            np.float64,
                        ).sum(axis=0)
                corr_array = cov_sum / n_cols
                corr_array = corr_array / corr_array[0]
                correlation[atom_pair] = corr_array
        finally:
            for store in h_parts:
                store.cleanup()

        self.corr_df = pd.DataFrame.from_dict(correlation)
        self.corr_df.to_csv(self.working_dir + "/auto_correlation.csv")
        return self.corr_df

    def fit_auto_correlation(self, cut_percent=0.9, plot=True):
        """Stretched-exponential fit of C(t) -> residence times
        (``residence_time.py:150-208``). Saves residence_time.csv."""
        residence_time: Dict[str, list] = {}
        corr_data = self.corr_df.head(int(len(self.corr_df) * cut_percent))
        for col in corr_data:
            if col == "Time (ps)":
                continue
            x = corr_data["Time (ps)"].values
            y = corr_data[col].values
            popt, _ = curve_fit(
                self._stretched_exp_function,
                x,
                y,
                bounds=([0, 0, 0, 0.1], [np.inf, np.inf, np.inf, 1]),
                maxfev=5000,
            )
            a, tau_res, tau_short, beta = popt
            residence_time[col] = [
                a, tau_res, tau_short, beta,
                self._integrate_sum_exp(a, tau_res, tau_short, beta),
            ]
            if plot:
                self._plot_fit(corr_data, col, popt)
        self.res_time_df = pd.DataFrame(residence_time)
        self.res_time_df.index = ["a", "tau_res", "tau_short", "beta",
                                  "r (ps)"]
        self.res_time_df.to_csv(self.working_dir + "/residence_time.csv")
        return residence_time

    def _plot_fit(self, corr_data, col, popt):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from mdproptools_tpu.utilities.plots import set_axis

        fig, ax = plt.subplots(figsize=(8, 6))
        set_axis(ax)
        ax.scatter(corr_data["Time (ps)"], corr_data[col], color="red",
                   label="original")
        fit_data = self._stretched_exp_function(
            corr_data["Time (ps)"].values, *popt
        )
        ax.plot(corr_data["Time (ps)"], fit_data, color="black", label="fit")
        ax.legend(frameon=False, fontsize=20)
        ax.set_xlabel("Time (ps)", fontsize=20)
        ax.set_ylabel("C(t)", fontsize=20)
        fig.savefig(self.working_dir + f"/{col}_fit.png",
                    bbox_inches="tight", pad_inches=0.1)
        plt.close(fig)


class Displacement:
    """Displacement magnitudes of selected atom types over a window of
    frames matching each type's residence time.

    The reference's ``Displacement.calc_dist`` (``residence_time.py:228-254``)
    is unfinished and raises TypeError; this implementation realizes its
    documented intent: for each atom type, the distribution of
    displacement magnitudes between frames separated by (approximately)
    the residence time.
    """

    def __init__(self, atom_types, residence_time, filename, dt=1,
                 save_mode=True, working_dir=None):
        self.atom_types = atom_types
        self.residence_time = residence_time  # {atom_type: ps}
        self.filename = filename
        self.dt = dt * 10**-3  # fs -> ps
        self.save_mode = save_mode
        self.working_dir = working_dir or os.getcwd()

    def calc_dist(self):
        # streamed: only the selected types' positions are retained
        # (host memory O(block x N) + O(T x n_selected))
        pos_parts, len_parts, ts_parts = [], [], []
        types = sel_union = None
        for blk in iter_trajectory_blocks(
            self.filename, columns=["id", "type", "x", "y", "z"]
        ):
            if types is None:
                types = blk.col("type")[0].astype(np.int64)
                sel_union = np.isin(types, list(self.atom_types))
                types = types[sel_union]
            pos_parts.append(blk.cols(["x", "y", "z"])[:, sel_union, :])
            len_parts.append(blk.box_lengths)
            ts_parts.append(blk.timesteps)
        pos = np.concatenate(pos_parts)
        lengths = np.concatenate(len_parts)  # (T, 3)
        times_ps = np.concatenate(ts_parts).astype(np.float64) * self.dt
        n_frames = pos.shape[0]
        frame_dt = times_ps[1] - times_ps[0] if len(times_ps) > 1 else self.dt
        out = {}
        for atom_type in self.atom_types:
            tau = self.residence_time[atom_type]
            lag = max(1, int(round(tau / frame_dt)))
            lag = min(lag, n_frames - 1)
            sel = types == atom_type
            d = pos[lag:, sel, :] - pos[:-lag, sel, :]
            # wrapped input coordinates: apply minimum image so boundary
            # crossings do not appear as box-sized displacements
            L = lengths[lag:, None, :]
            d = d - L * np.round(d / L)
            out[atom_type] = pd.DataFrame({
                "displacement": np.linalg.norm(d, axis=2).reshape(-1),
                "lag (ps)": lag * frame_dt,
            })
            if self.save_mode:
                out[atom_type].to_csv(
                    os.path.join(self.working_dir,
                                 f"displacement_{atom_type}.csv"),
                    index=False,
                )
        return out


class _ResidenceStream:
    """Push-model h-matrix accumulator built by
    ``ResidenceTime.residence_stream``: ``fold(frame_block)`` reduces a
    parsed block to the per-relation boolean shell matrices (device
    kernel, spill-backed store), ``finalize()`` runs the batched
    survival ACF and returns exactly what ``calc_auto_correlation``
    returns (and saves auto_correlation.csv).

    Streamed ingestion: the (T, N, 3) positions are reduced per block to
    the boolean shell matrices (T, Na, Nb) per relation — the minimum
    the survival ACF fundamentally needs. Each relation's matrices
    accumulate in a ``_SpillStore``: in memory up to ``H_SPILL_BYTES``,
    then on disk as a memmap, so HOST memory is O(block x N) +
    O(acf_chunk x T) for any trajectory length."""

    def __init__(self, rt: ResidenceTime):
        self.rt = rt
        self.dtype = resolve_dtype(rt.precision)
        self._np_dtype = np.dtype(jnp.dtype(self.dtype).name)
        self.h_fns = None
        self.h_parts: list = []
        self.ts_parts: list = []
        self.rel_meta: list = []

    def fold(self, blk):
        rt = self.rt
        if self.h_fns is None:  # frame-0 metadata + per-relation setup
            types = blk.col("type")[0].astype(np.int64)
            if rt.num_mols and rt.num_atoms_per_mol:
                ids = blk.col("id")[0].astype(np.int64)
                codes = altered_atom_types(ids, rt.num_mols,
                                           rt.num_atoms_per_mol)
            else:
                codes = types
            self.h_fns = []
            for kl in range(len(rt.relation_matrix)):
                k, l = (int(v) for v in rt.relation_matrix[kl])
                atom_pair = f"{k}-{l}"
                rt.atom_pairs.append(atom_pair)
                sel_k = np.nonzero(codes == k)[0]
                sel_l = np.nonzero(codes == l)[0]
                if sel_k.size == 0 or sel_l.size == 0:
                    raise ValueError(
                        f"relation {atom_pair}: no atoms of type "
                        f"{k if not sel_k.size else l}"
                    )
                r_in, r_out = rt.r_cut[kl]

                @jax.jit
                def h_fn(pos_d, len_d, ik=jnp.asarray(sel_k),
                         il=jnp.asarray(sel_l), r_in=float(r_in),
                         r_out=float(r_out)):
                    def per_frame(p, L):
                        return pair_ops.shell_mask(
                            p[ik], p[il], L, r_in, r_out)

                    mask = jax.vmap(per_frame)(pos_d, len_d)  # (B,Na,Nb)
                    # bit-pack 8 FRAMES per byte ON DEVICE before the
                    # fetch: the raw (block, Na, Nb) bool crosses the
                    # host<->device link at one byte per pair (a 42k-atom
                    # relation is ~160 MB per 128-frame block); packing
                    # along the LEADING (frame) axis keeps the minor
                    # dims' layout untouched. Frames
                    # are padded to a multiple of 8; little-endian bit
                    # order matches np.unpackbits(axis=0,
                    # bitorder="little") on the host.
                    b = mask.shape[0]
                    pad_b = (-b) % 8
                    if pad_b:
                        mask = jnp.pad(mask,
                                       ((0, pad_b), (0, 0), (0, 0)))
                    w = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128],
                                    jnp.float32)
                    packed = jnp.einsum(
                        "gknw,k->gnw",
                        mask.reshape((b + pad_b) // 8, 8,
                                     *mask.shape[1:]).astype(jnp.float32),
                        w)
                    return packed.astype(jnp.uint8)

                self.h_fns.append(h_fn)
                self.rel_meta.append((k, l, atom_pair, sel_k, sel_l))
                self.h_parts.append(_SpillStore(H_SPILL_BYTES))
        # fused f64->dtype column copy (one pass, no f64 temporary)
        pos_b = jnp.asarray(blk.cols_as(["x", "y", "z"], self._np_dtype))
        len_b = jnp.asarray(blk.box_lengths, self.dtype)
        n_frames = blk.data.shape[0]
        for kl, fn in enumerate(self.h_fns):
            packed = np.asarray(fn(pos_b, len_b))  # (ceil(B/8), Na, Nb)
            mask = np.unpackbits(
                packed, axis=0, count=n_frames,
                bitorder="little").astype(bool)
            self.h_parts[kl].append(mask)
        self.ts_parts.append(blk.timesteps)

    def finalize(self):
        if not self.ts_parts:
            raise ValueError("no frames folded")
        return self.rt._acf_finalize(self.h_parts, self.rel_meta,
                                     self.ts_parts, self.dtype)
