"""
1-D number-density profiles vs distance from a surface.

API-compatible with the reference
``mdproptools/structural/number_density.py`` (``calc_number_density:30``):
per frame, bin the coordinates of each requested atom type along the
axis normal to the interface (defined by the min/max extent of the
surface atom type), normalize by slab volume, average over frames.

Fixes vs the reference (documented divergences):
- ``np.int`` (number_density.py:49) and ``np.product``
  (number_density.py:118) break on NumPy >= 1.24; replaced with ``int``
  / ``np.prod`` — semantics unchanged;
- the reference's negative bin indices (for ``dist_from_interface > 0``
  it shifts by the surface thickness, so in-surface atoms get negative
  bins that *wrap to the array tail* via Python indexing,
  number_density.py:93-96) are reproduced exactly with an explicit
  modulo, and like the reference an atom whose bin falls outside
  [-num_bins, num_bins) raises IndexError.

Altitude decision (deliberate): the per-frame work is ONE O(N) masked
binning pass with data-dependent failure semantics (the IndexError
above) and no reuse across frames — there is no device win to harvest,
and porting the wraparound/IndexError quirks into lax control flow
would only obscure them. It therefore stays host NumPy per frame, but
ingestion streams through ``iter_trajectory_blocks`` so host memory is
O(block x N) for any trajectory length.
"""

import os

import numpy as np

from mdproptools_tpu.common.system import altered_atom_types
from mdproptools_tpu.io.lammps_dump import iter_trajectory_blocks
from mdproptools_tpu.structural.rdf_cn import _radii, _save_rdf


def calc_number_density(
    dump_pattern,
    surface_atom,
    atom_types,
    bin_size,
    dist_from_interface,
    axis_norm_interface,
    num_mols=None,
    num_atoms_per_mol=None,
    working_dir=None,
    results_file="number_density.csv",
    save_mode=True,
):
    """Density profiles of ``atom_types`` vs distance from the
    ``surface_atom`` slab along x/y/z. Assumes a one-atom-type surface,
    like the reference (number_density.py:43)."""
    working_dir = working_dir or os.getcwd()
    stream = number_density_stream(
        surface_atom, atom_types, bin_size, dist_from_interface,
        axis_norm_interface, num_mols=num_mols,
        num_atoms_per_mol=num_atoms_per_mol, working_dir=working_dir,
        results_file=results_file, save_mode=save_mode)
    for blk in iter_trajectory_blocks(
        os.path.join(working_dir, dump_pattern),
        columns=["id", "type", "x", "y", "z"],
    ):
        stream.fold(blk)
    return stream.finalize()


def number_density_stream(surface_atom, atom_types, bin_size,
                          dist_from_interface, axis_norm_interface,
                          num_mols=None, num_atoms_per_mol=None,
                          working_dir=None,
                          results_file="number_density.csv",
                          save_mode=True):
    """(beyond-reference) push-model density profile:
    ``fold(frame_block)`` one parsed block at a time, ``finalize()`` ->
    the DataFrame ``calc_number_density`` returns. Lets the shared-parse
    composite pipeline (``mdproptools_tpu.analyze``) feed one parse into
    this plus the other property streams."""
    return _NumberDensityStream(
        surface_atom, list(atom_types), bin_size, dist_from_interface,
        axis_norm_interface, num_mols, num_atoms_per_mol,
        working_dir or os.getcwd(), results_file, save_mode)


class _NumberDensityStream:
    def __init__(self, surface_atom, atom_types, bin_size,
                 dist_from_interface, axis_norm_interface, num_mols,
                 num_atoms_per_mol, working_dir, results_file, save_mode):
        self.surface_atom = surface_atom
        self.atom_types = atom_types
        self.bin_size = bin_size
        self.dist = dist_from_interface
        self.axis = axis_norm_interface
        self.axis_idx = {"x": 0, "y": 1, "z": 2}[axis_norm_interface]
        self.num_mols = num_mols
        self.num_atoms_per_mol = num_atoms_per_mol
        self.working_dir = working_dir
        self.results_file = results_file
        self.save_mode = save_mode
        self.num_bins = int(abs(dist_from_interface) / bin_size)
        self.rho_part_sum = np.zeros((len(atom_types), self.num_bins))
        self.codes = None
        self.T = 0

    def fold(self, blk):
        if self.codes is None:  # frame-0 metadata
            if self.num_mols and self.num_atoms_per_mol:
                ids = blk.col("id")[0].astype(np.int64)
                self.codes = altered_atom_types(
                    ids, self.num_mols, self.num_atoms_per_mol)
            else:
                self.codes = blk.col("type")[0].astype(np.int64)
        codes = self.codes
        num_bins = self.num_bins
        coord_blk = blk.col(self.axis)  # (B, N)
        for t in range(blk.n_frames):
            coord = coord_blk[t].copy()
            surface = coord[codes == self.surface_atom]
            if surface.size == 0:
                raise ValueError(
                    f"no atoms of surface type {self.surface_atom} in "
                    f"frame {self.T}"
                )
            min_dist = surface.min()
            max_dist = surface.max()
            dist_range = max_dist - min_dist
            coord -= min_dist
            rho_part = np.zeros((len(self.atom_types), num_bins))
            for i, j in enumerate(self.atom_types):
                if self.dist > 0:
                    b = coord[(codes == j) & (coord < self.dist)]
                    b = b - dist_range
                else:
                    b = coord[(codes == j) & (coord > self.dist)]
                bins = np.trunc(b / self.bin_size).astype(np.int64)
                if bins.size and (bins.min() < -num_bins or
                                  bins.max() >= num_bins):
                    raise IndexError(
                        f"bin index out of range for atom type {j} (the "
                        "reference fails identically here); check "
                        "dist_from_interface/bin_size"
                    )
                np.add.at(rho_part[i], bins % num_bins, 1)
            box_lengths = blk.box_lengths[t]
            cross_section = np.prod(
                [box_lengths[a] for a in range(3) if a != self.axis_idx]
            )
            self.rho_part_sum += rho_part / (cross_section * self.bin_size)
            self.T += 1

    def finalize(self):
        if self.T == 0:
            raise ValueError("no frames folded")
        partial_relations = np.array(
            [np.full(len(self.atom_types), self.surface_atom,
                     dtype=np.int64), self.atom_types]
        )
        return _save_rdf(
            _radii(self.bin_size, self.num_bins),
            partial_relations.T,
            os.path.join(self.working_dir, self.results_file),
            self.save_mode,
            self.rho_part_sum / self.T,
        )
