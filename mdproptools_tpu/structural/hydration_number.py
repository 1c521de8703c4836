"""
Cation-water orientation angles and hydration factor.

API-compatible with the reference
``mdproptools/structural/hydration_number.py`` (``get_angle:13``,
``get_all_angles:35``, ``get_hydration_number:78``): for every cation
(by molecule type) and every water molecule whose first atom (oxygen)
lies within ``r_cut``, the cosine of the angle between the O->cation
vector and the water bisector vector (H1 + H2 - 2 O); the hydration
factor is the per-cation fraction of cosines < -0.72, averaged over
cations then frames.

Device internals: the reference's per-frame ``mp.Pool`` fan-out
(hydration_number.py:86-89) with a per-cation pandas loop becomes ONE
jitted device program per frame block — a (frames, cations, waters)
minimum-image cosine tensor plus the fully on-device hydration factor —
streamed through ``iter_trajectory_blocks`` (bounded host memory). Only
the ragged angles_distribution extraction (variable count of in-shell
cosines per frame, a filesystem artifact) runs on host.

Fixes vs the reference (documented divergences):
- the reference module cannot be imported as packaged (its ``from rdf_cn
  import ...`` at hydration_number.py:8 is not package-relative);
- a cation with no waters inside ``r_cut`` raises ZeroDivisionError in
  the reference (hydration_number.py:32); here it contributes 0 to the
  hydration factor and no angles.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from mdproptools_tpu.common.system import System
from mdproptools_tpu.io.lammps_dump import iter_trajectory_blocks
from mdproptools_tpu.ops.pbc import minimum_image


def get_angle(data_head, water_df, r_cut, lx, ly, lz):
    """Cosines between one cation's minimum-image vectors to each
    in-shell water oxygen and that water's bisector, plus the fraction
    of cosines < -0.72 (reference ``hydration_number.py:13-33``; same
    outputs). ``data_head``: mapping/Series with x, y, z; ``water_df``:
    DataFrame with x, y, z (oxygen) and x_v, y_v, z_v (bisector).
    Documented divergence: an empty shell returns ([], 0.0) instead of
    the reference's ZeroDivisionError."""
    head = np.array(
        [data_head["x"], data_head["y"], data_head["z"]], np.float64)
    ow = water_df[["x", "y", "z"]].to_numpy(np.float64)
    vec = water_df[["x_v", "y_v", "z_v"]].to_numpy(np.float64)
    L = np.array([lx, ly, lz], np.float64)
    d = head[None, :] - ow
    d -= np.round(d / L) * L  # minimum image (reference single-wrap)
    rsq = (d * d).sum(axis=1)
    keep = rsq < float(r_cut) ** 2
    d, vec, rsq = d[keep], vec[keep], rsq[keep]
    if len(rsq) == 0:
        return [], 0.0
    denom = np.sqrt(rsq) * np.linalg.norm(vec, axis=1)
    cos = (d * vec).sum(axis=1) / np.where(denom == 0, 1.0, denom)
    return list(cos), float((cos < -0.72).sum() / len(cos))


def get_all_angles(counter, dump, alter_atom_ids, num_mols,
                   num_atoms_per_mol, cation_type, water_type, r_cut):
    """Per-frame angle analysis (reference ``hydration_number.py:35-76``;
    same outputs): returns (all in-shell cosines, mean per-cation
    hydration factor) for one parsed frame. ``dump`` is an
    ``io.lammps_dump.Frame`` (or anything with ``.box.bounds`` and a
    ``to_dataframe()``/``.data`` DataFrame). ``counter`` is accepted for
    signature parity (the reference prints it); ``alter_atom_ids`` is
    accepted but has no effect on the outputs (the reference remaps
    ``type`` and then never uses it — only ``mol_type`` selects rows)."""
    del counter, alter_atom_ids
    bounds = np.asarray(dump.box.bounds, np.float64)
    lx, ly, lz = bounds[:, 1] - bounds[:, 0]
    if hasattr(dump, "to_dataframe"):
        df = dump.to_dataframe()
    else:
        df = dump.data
    df = df.sort_values(by=["id"]).reset_index(drop=True)
    system = System(num_mols, num_atoms_per_mol)
    pos = df[["x", "y", "z"]].to_numpy(np.float64)
    cation_sel = np.nonzero(system.mol_type == cation_type)[0]
    water_sel = np.nonzero(system.mol_type == water_type)[0]
    napm = system.num_atoms_per_mol[water_type - 1]
    if napm < 3:
        raise ValueError("water molecule type must have >= 3 atoms")
    w_atoms = water_sel.reshape(-1, napm)
    ow = pos[w_atoms[:, 0]]
    vec = pos[w_atoms[:, 1]] + pos[w_atoms[:, 2]] - 2.0 * ow
    water_df = pd.DataFrame(
        np.concatenate([ow, vec], axis=1),
        columns=["x", "y", "z", "x_v", "y_v", "z_v"])
    cosines = []
    factor = 0.0
    for i in cation_sel:
        cos, f = get_angle(
            {"x": pos[i, 0], "y": pos[i, 1], "z": pos[i, 2]},
            water_df, r_cut, lx, ly, lz)
        cosines += cos
        factor += f
    return cosines, factor / max(len(cation_sel), 1)


def get_hydration_number(
    dump_pattern,
    cation_type,
    water_type,
    r_cut,
    alter_atom_ids=False,
    num_mols=None,
    num_atoms_per_mol=None,
    working_dir=None,
):
    """Angle distribution + hydration factor; saves angles_df.csv.

    ``cation_type`` / ``water_type`` are 1-based MOLECULE types (the
    reference selects on its ``mol_type`` column,
    hydration_number.py:54-55)."""
    working_dir = working_dir or os.getcwd()
    stream = hydration_stream(cation_type, water_type, r_cut,
                              num_mols=num_mols,
                              num_atoms_per_mol=num_atoms_per_mol,
                              working_dir=working_dir)
    for blk in iter_trajectory_blocks(
        os.path.join(working_dir, dump_pattern),
        columns=["id", "type", "x", "y", "z"],
    ):
        stream.fold(blk)
    return stream.finalize()


def hydration_stream(cation_type, water_type, r_cut, num_mols=None,
                     num_atoms_per_mol=None, working_dir=None):
    """(beyond-reference) push-model hydration analysis:
    ``fold(frame_block)`` one parsed block at a time, ``finalize()`` ->
    the angles DataFrame ``get_hydration_number`` returns (and saves
    angles_df.csv). Lets the shared-parse composite pipeline
    (``mdproptools_tpu.analyze``) feed one parse into this plus the
    other property streams (same x/y/z columns as the RDF leg)."""
    return _HydrationStream(cation_type, water_type, r_cut, num_mols,
                            num_atoms_per_mol,
                            working_dir or os.getcwd())


class _HydrationStream:
    def __init__(self, cation_type, water_type, r_cut, num_mols,
                 num_atoms_per_mol, working_dir):
        self.working_dir = working_dir
        system = System(num_mols, num_atoms_per_mol)
        mol_type = system.mol_type
        cation_sel = np.nonzero(mol_type == cation_type)[0]
        water_sel = np.nonzero(mol_type == water_type)[0]
        if cation_sel.size == 0 or water_sel.size == 0:
            raise ValueError("no atoms match cation_type/water_type")
        # water atoms grouped per molecule; first atom = coordinating
        # (O), atoms 2 and 3 define the bisector
        # (hydration_number.py:60-67)
        napm = system.num_atoms_per_mol[water_type - 1]
        if napm < 3:
            raise ValueError("water molecule type must have >= 3 atoms")
        w_atoms = water_sel.reshape(-1, napm)  # (n_waters, per_water)

        ik = jnp.asarray(cation_sel)
        io = jnp.asarray(w_atoms[:, 0])
        ih1 = jnp.asarray(w_atoms[:, 1])
        ih2 = jnp.asarray(w_atoms[:, 2])
        rc2 = float(r_cut) ** 2

        @jax.jit
        def block_fn(pos_b, len_b):
            """(B, N, 3) -> per-frame (cos (C, W), within, factor)."""

            def frame(p, L):
                cat = p[ik]  # (C, 3)
                o = p[io]  # (W, 3)
                vec = p[ih1] + p[ih2] - 2.0 * o  # (W, 3)
                # minimum-image cation - O displacement (reference
                # _calc_rsq order: head - others)
                d = minimum_image(cat[:, None, :] - o[None, :, :], L)
                rsq = jnp.sum(d * d, axis=2)  # (C, W)
                within = rsq < rc2
                # elementwise, not einsum: a float32 contraction may run
                # in TF32 on a GPU and flip the cos < -0.72 decisions
                dot = jnp.sum(d * vec[None, :, :], axis=2)
                denom = (jnp.sqrt(rsq)
                         * jnp.linalg.norm(vec, axis=1)[None, :])
                cos = dot / jnp.where(denom == 0, 1.0, denom)
                hits = jnp.sum(within & (cos < -0.72), axis=1)
                totals = jnp.sum(within, axis=1)
                per_cation = jnp.where(
                    totals > 0, hits / jnp.maximum(totals, 1), 0.0)
                return cos, within, per_cation.mean()

            return jax.vmap(frame)(pos_b, len_b)

        self._block_fn = block_fn
        self._all_cos: list = []
        self._factors: list = []

    def fold(self, blk):
        cos_b, within_b, fac_b = self._block_fn(
            jnp.asarray(blk.cols(["x", "y", "z"])),
            jnp.asarray(blk.box_lengths),
        )
        cos_b = np.asarray(cos_b)
        within_b = np.asarray(within_b)
        self._factors.extend(np.asarray(fac_b, np.float64).tolist())
        # ragged artifact extraction (reference row order: frame, cation)
        for t in range(cos_b.shape[0]):
            for c in range(cos_b.shape[1]):
                self._all_cos.extend(cos_b[t, c, within_b[t, c]].tolist())

    def finalize(self):
        if not self._factors:
            raise ValueError("no frames folded")
        angles_df = pd.DataFrame(self._all_cos,
                                 columns=["angles_distribution"])
        angles_df["hydration_factor"] = (sum(self._factors)
                                         / len(self._factors))
        angles_df.to_csv(os.path.join(self.working_dir, "angles_df.csv"))
        return angles_df
