"""
Host-side per-frame molecular reductions for the streaming folds.

The per-frame MSD/GK reductions (molecular COM, (T, N, 3) -> (T, M, 3);
charge flux, (T, N, 3) -> (T, K, 3)) are memory-bandwidth-trivial: a
42k-atom frame reduces to ~65 KB of output, so shipping the full
per-atom block to the device to compute it costs a host->device upload
(~2 MB/frame for these two folds) that the RDF pair kernel, the one
device-bound leg, competes with. Folding on the host in float64 removes
those uploads and hides under the RDF device fold wall-clock. Whether
that still pays on a GPU host is not measured yet. The device
implementations
(``ops/com.py``) remain the mesh-sharded path and the single-shot APIs.

Segments are contiguous by construction — ``System.mol_index`` is
``repeat(arange(M), atoms_per_mol)`` with molecules type-major
(``common/system.py``) — so the reductions are ``np.add.reduceat`` on
mass-weighted coordinate blocks, weighting done in place on the block
copy the device feed would have materialized anyway (no extra
(T, N, 3) temporaries; see the host first-touch fault note in
CLAUDE.md).

Reference semantics reproduced in float64: mass-weighted molecular COM
(``common/com_mols.py:58-60``), per-molecule-type charge flux
(``conductivity.py:190-214``).
"""

import numpy as np

__all__ = ["MolecularFold"]


class MolecularFold:
    """Precomputed contiguous-segment layout for host-side per-frame
    molecular reductions.

    Args:
      system: ``common.system.System`` (defines the molecule blocks).
      masses: (N,) per-atom masses, float64.
    """

    def __init__(self, system, masses):
        apm = np.repeat(
            np.asarray(system.num_atoms_per_mol, np.int64),
            np.asarray(system.num_mols, np.int64),
        )
        if int(apm.sum()) != len(masses):
            raise ValueError(
                f"system describes {int(apm.sum())} atoms, got "
                f"{len(masses)} masses"
            )
        starts = np.zeros(len(apm), np.int64)
        np.cumsum(apm[:-1], out=starts[1:])
        self.mol_starts = starts
        self.masses = np.ascontiguousarray(masses, np.float64)
        self.inv_mol_mass = 1.0 / np.add.reduceat(self.masses, starts)
        nm = np.asarray(system.num_mols, np.int64)
        tstarts = np.zeros(len(nm), np.int64)
        np.cumsum(nm[:-1], out=tstarts[1:])
        self.type_starts = tstarts

    def molecular_charges(self, q):
        """(N,) per-atom charges -> (M,) per-molecule charges."""
        return np.add.reduceat(np.ascontiguousarray(q, np.float64),
                               self.mol_starts)

    def segment_com(self, coords):
        """Mass-weighted per-molecule mean, float64 on host.

        Args:
          coords: (T, N, 3) float64 block copy. CONSUMED — weighted in
            place (callers pass the fresh per-block copy the device
            feed would have uploaded).
        Returns:
          (T, M, 3) float64 per-molecule centers of mass.
        """
        coords *= self.masses[None, :, None]
        out = np.add.reduceat(coords, self.mol_starts, axis=1)
        out *= self.inv_mol_mass[None, :, None]
        return out

    def charge_flux(self, vel, qmol, vconv=1.0):
        """Per-molecule-type charge flux, float64 on host.

        Args:
          vel: (T, N, 3) float64 per-atom velocities. CONSUMED (in-place
            weighting, see ``segment_com``).
          qmol: (M,) per-molecule charges, already unit-converted.
          vconv: velocity unit conversion applied to the molecular COM
            velocities (matches the device program's placement).
        Returns:
          (T, n_mol_types, 3) float64 charge flux.
        """
        vcom = self.segment_com(vel)
        if vconv != 1.0:
            vcom *= vconv
        vcom *= qmol[None, :, None]
        return np.add.reduceat(vcom, self.type_starts, axis=1)
