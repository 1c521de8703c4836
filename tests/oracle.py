"""
Float64 NumPy oracles re-implementing the *reference's* loop semantics
(upper-triangle iteration, count-2-per-pair full RDF, both-orientation
partial counting, exact CN cutoffs, per-frame normalize-then-average).

These are written from the documented behavior of
``/root/reference/mdproptools/structural/rdf_cn.py`` (SURVEY.md section
2.2/3.1) and serve as the parity target for this implementation: the
reference itself cannot run here (pymatgen/numba are not installed), so
tests assert device results == oracle results in float64.
"""

import numpy as np


def min_image(d, L, dtype=np.float64):
    """Single-wrap minimum image, the reference's branch semantics
    (rdf_cn.py:50-55): wrap by +-L only when |d| > L/2. ``dtype``
    float32 gives the same rule in IEEE float32 arithmetic."""
    d = np.array(d, dtype)
    L = dtype(L)
    over = d > L / 2
    under = d < -L / 2
    d[over] -= L
    d[under] += L
    return d


def rsq_row(head, others, lengths):
    """Squared minimum-image distances from one atom to many."""
    d = head[None, :] - others
    for ax in range(3):
        d[:, ax] = min_image(d[:, ax], lengths[ax])
    return np.sum(d * d, axis=1)


def _block_rsq(pos_block, pos, lengths, dtype=np.float64):
    """(B, N) squared min-image distances; elementwise ops identical to
    the per-row form, so results are bit-equal to the reference loop.
    Summed (dx^2 + dy^2) + dz^2, each operation rounded in ``dtype``."""
    d = (np.asarray(pos_block, dtype)[:, None, :]
         - np.asarray(pos, dtype)[None, :, :])
    for ax in range(3):
        d[:, :, ax] = min_image(d[:, :, ax], lengths[ax], dtype)
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def rdf_loop(pos, codes, lengths, r_cut, bin_size, relations, block=256,
             dtype=np.float64):
    """Upper-triangle RDF loop: full histogram counts 2 per pair, partial
    counts both orientations (rdf_cn.py:73-97). Vectorized in row blocks;
    float64 math identical to the reference's per-row loop (``dtype``
    float32: the same loop in IEEE float32, the reference for the
    float32 pair paths; a pair whose float32 bin rounds up to n_bins is
    dropped). Returns float64 counts (full (K,), part (R, K))."""
    n_bins = int(r_cut / bin_size)
    full = np.zeros(n_bins)
    part = np.zeros((len(relations), n_bins))
    n = pos.shape[0]
    idx = np.arange(n)
    for s in range(0, n, block):
        e = min(s + block, n)
        # columns from s on: the upper triangle never looks further left
        rsq = _block_rsq(pos[s:e], pos[s:], lengths, dtype)
        upper = idx[None, s:] > idx[s:e, None]
        keep = (rsq < dtype(r_cut**2)) & upper
        bi, bj = np.nonzero(keep)
        bins = (np.sqrt(rsq[bi, bj]) / dtype(bin_size)).astype(np.int64)
        ok = bins < n_bins
        bins, ci, cj = bins[ok], codes[s + bi[ok]], codes[s + bj[ok]]
        full += 2 * np.bincount(bins, minlength=n_bins)
        for r, (a, b) in enumerate(relations):
            m = ((ci == a) & (cj == b)) | ((ci == b) & (cj == a))
            # a == b: both orientations match, so 2 per pair
            part[r] += (1 + (a == b)) * np.bincount(bins[m], minlength=n_bins)
    return full, part


def cn_loop(pos, codes, lengths, r_cuts, relations, block=256,
            dtype=np.float64):
    """Upper-triangle CN loop with per-relation exact cutoffs
    (rdf_cn.py:100-119), in float64 or IEEE float32 (``dtype``).
    Returns (R,) counts."""
    counts = np.zeros(len(relations))
    n = pos.shape[0]
    idx = np.arange(n)
    for s in range(0, n, block):
        e = min(s + block, n)
        rsq = _block_rsq(pos[s:e], pos[s:], lengths, dtype)
        upper = idx[None, s:] > idx[s:e, None]
        ci = codes[s:e, None]
        cj = codes[None, s:]
        for r, (a, b) in enumerate(relations):
            keep = (rsq < dtype(r_cuts[r] ** 2)) & upper
            counts[r] += np.sum(keep & (ci == a) & (cj == b))
            counts[r] += np.sum(keep & (ci == b) & (cj == a))
    return counts


def rdf_mol_loop(pos_atoms, codes_atoms, pos_mols, codes_mols, lengths,
                 r_cut, bin_size, relations, block=512):
    """Atom-vs-COM one-directional RDF loop (rdf_cn.py:122-141)."""
    n_bins = int(r_cut / bin_size)
    part = np.zeros((len(relations), n_bins))
    n = pos_atoms.shape[0]
    for s in range(0, n, block):
        e = min(s + block, n)
        rsq = _block_rsq(pos_atoms[s:e], pos_mols, lengths)
        keep = rsq < r_cut**2
        bi, bj = np.nonzero(keep)
        bins = (np.sqrt(rsq[bi, bj]) / bin_size).astype(np.int64)
        ci = codes_atoms[s + bi]
        cj = codes_mols[bj]
        for r, (a, b) in enumerate(relations):
            np.add.at(part[r], bins[(ci == a) & (cj == b)], 1)
    return part


def cn_mol_loop(pos_atoms, codes_atoms, pos_mols, codes_mols, lengths,
                r_cuts, relations, block=512):
    """Atom-vs-COM one-directional CN loop (rdf_cn.py:144-162)."""
    counts = np.zeros(len(relations))
    n = pos_atoms.shape[0]
    for s in range(0, n, block):
        e = min(s + block, n)
        rsq = _block_rsq(pos_atoms[s:e], pos_mols, lengths)
        ci = codes_atoms[s:e, None]
        cj = codes_mols[None, :]
        for r, (a, b) in enumerate(relations):
            counts[r] += np.sum((rsq < r_cuts[r] ** 2) & (ci == a) & (cj == b))
    return counts


def normalize_rdf_full(counts, n_atoms, volume, bin_size):
    n_bins = counts.shape[-1]
    k = np.arange(n_bins, dtype=np.float64)
    shell = 4.0 / 3.0 * np.pi * bin_size**3 * ((k + 1) ** 3 - k**3)
    rho = n_atoms / volume
    return counts / (n_atoms * rho * shell)


def normalize_rdf_part(counts, n_ref, n_other, volume, bin_size):
    n_bins = counts.shape[-1]
    k = np.arange(n_bins, dtype=np.float64)
    shell = 4.0 / 3.0 * np.pi * bin_size**3 * ((k + 1) ** 3 - k**3)
    rho_b = n_other / volume
    return counts / (n_ref * rho_b * shell)


def com_per_molecule(pos, masses, mol_index, n_molecules):
    """Mass-weighted molecular COM, float64."""
    out = np.zeros((n_molecules, 3))
    mtot = np.zeros(n_molecules)
    np.add.at(mtot, mol_index, masses)
    for ax in range(3):
        np.add.at(out[:, ax], mol_index, masses * pos[:, ax])
    return out / mtot[:, None]
