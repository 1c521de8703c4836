"""End-to-end RDF/CN parity on a real bundled frame: the public API in
strict (float64) mode must reproduce the reference's math exactly, as
re-derived by the NumPy oracle (upper-triangle loops + per-frame
normalization). The bundled CSV goldens are unmaterialized git-LFS
pointers, so the oracle is the parity target (see tests/oracle.py)."""

import os
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import oracle  # noqa: E402

from mdproptools_tpu.common.system import System, altered_atom_types  # noqa: E402
from mdproptools_tpu.io.lammps_dump import read_trajectory  # noqa: E402
from mdproptools_tpu.structural import rdf_cn  # noqa: E402

MASS = [16.0, 12.01, 1.008, 14.01, 32.06, 16.0, 12.01, 19.0, 24.305]
NUM_MOLS = [591, 66, 33]
NUM_ATOMS_PER_MOL = [16, 15, 1]
NUM_TYPES = 9


@pytest.fixture(scope="module")
def frame0(mg_tfsi_dme_dir):
    f = os.path.join(mg_tfsi_dme_dir, "dump.nvt.0.dump")
    traj = read_trajectory(f, columns=["id", "type", "x", "y", "z"])
    pos = traj.cols(["x", "y", "z"])[0]
    types = traj.col("type")[0].astype(np.int64)
    lengths = traj.box_lengths[0]
    return f, pos, types, lengths


def test_atomic_rdf_default_ids(frame0, tmp_path):
    f, pos, types, lengths = frame0
    r_cut, bin_size = 10.0, 0.1
    relations = [[8, 9], [1, 8]]  # [[ref types], [other types]]
    out = rdf_cn.calc_atomic_rdf(
        r_cut, bin_size, NUM_TYPES, MASS, relations, f,
        path_or_buff=str(tmp_path / "rdf.csv"), precision="strict",
    )
    rel_pairs = list(zip(relations[0], relations[1]))
    full_c, part_c = oracle.rdf_loop(pos, types, lengths, r_cut, bin_size,
                                     rel_pairs)
    vol = float(np.prod(lengths))
    n = pos.shape[0]
    full_want = oracle.normalize_rdf_full(full_c, n, vol, bin_size)
    np.testing.assert_allclose(out["g_full(r)"].to_numpy(), full_want,
                               rtol=1e-12, atol=0)
    counts = np.bincount(types - 1, minlength=NUM_TYPES)
    for r, (a, b) in enumerate(rel_pairs):
        want = oracle.normalize_rdf_part(
            part_c[r], counts[a - 1], counts[b - 1], vol, bin_size
        )
        np.testing.assert_allclose(
            out[f"g_{a}-{b}"].to_numpy(), want, rtol=1e-12, atol=0
        )
    radii = (np.arange(int(r_cut / bin_size)) + 0.5) * bin_size
    np.testing.assert_allclose(out["r ($\\AA$)"].to_numpy(), radii)
    assert (tmp_path / "rdf.csv").exists()


def test_atomic_rdf_altered_ids(frame0, tmp_path):
    f, pos, types, lengths = frame0
    r_cut, bin_size = 8.0, 0.05
    relations = [[32, 32], [17, 32]]
    out = rdf_cn.calc_atomic_rdf(
        r_cut, bin_size, NUM_TYPES, MASS, relations, f,
        num_mols=NUM_MOLS, num_atoms_per_mol=NUM_ATOMS_PER_MOL,
        path_or_buff=str(tmp_path / "rdf2.csv"), precision="strict",
    )
    ids = np.arange(1, pos.shape[0] + 1)
    codes = altered_atom_types(ids, NUM_MOLS, NUM_ATOMS_PER_MOL)
    rel_pairs = list(zip(relations[0], relations[1]))
    full_c, part_c = oracle.rdf_loop(pos, codes, lengths, r_cut, bin_size,
                                     rel_pairs)
    vol = float(np.prod(lengths))
    counts = np.bincount(codes - 1, minlength=32)
    for r, (a, b) in enumerate(rel_pairs):
        want = oracle.normalize_rdf_part(
            part_c[r], counts[a - 1], counts[b - 1], vol, bin_size
        )
        np.testing.assert_allclose(
            out[f"g_{a}-{b}"].to_numpy(), want, rtol=1e-12, atol=0
        )


def test_atomic_cn(frame0, tmp_path):
    f, pos, types, lengths = frame0
    relations = [[8, 9], [1, 8]]
    r_cuts = [2.325, 4.375]
    out = rdf_cn.calc_atomic_cn(
        r_cuts, 0.05, NUM_TYPES, MASS, relations, f,
        path_or_buff=str(tmp_path / "cn.csv"), precision="strict",
    )
    rel_pairs = list(zip(relations[0], relations[1]))
    counts_w = oracle.cn_loop(pos, types, lengths, r_cuts, rel_pairs)
    tc = np.bincount(types - 1, minlength=NUM_TYPES)
    for r, (a, b) in enumerate(rel_pairs):
        np.testing.assert_allclose(
            out[f"cn_{a}-{b}"].iloc[0], counts_w[r] / tc[a - 1], rtol=1e-12
        )


def test_molecular_rdf_and_cn(frame0, tmp_path):
    f, pos, types, lengths = frame0
    system = System(NUM_MOLS, NUM_ATOMS_PER_MOL, mass=MASS)
    masses = np.asarray(MASS)[types - 1]
    mol_pos = oracle.com_per_molecule(pos, masses, system.mol_index,
                                      system.n_molecules)
    mol_codes = system.mol_type_of_molecule
    relations = [[8, 8, 4], [1, 2, 3]]
    rel_pairs = list(zip(relations[0], relations[1]))

    r_cut, bin_size = 10.0, 0.1
    out = rdf_cn.calc_molecular_rdf(
        r_cut, bin_size, NUM_TYPES, MASS, relations, f,
        num_mols=NUM_MOLS, num_atoms_per_mol=NUM_ATOMS_PER_MOL,
        path_or_buff=str(tmp_path / "rdf_mol.csv"), precision="strict",
    )
    part_c = oracle.rdf_mol_loop(pos, types, mol_pos, mol_codes, lengths,
                                 r_cut, bin_size, rel_pairs)
    vol = float(np.prod(lengths))
    at_counts = np.bincount(types - 1, minlength=NUM_TYPES)
    mol_counts = np.bincount(mol_codes - 1, minlength=3)
    for r, (a, b) in enumerate(rel_pairs):
        want = oracle.normalize_rdf_part(
            part_c[r], at_counts[a - 1], mol_counts[b - 1], vol, bin_size
        )
        np.testing.assert_allclose(
            out[f"g_{a}-{b}"].to_numpy(), want, rtol=1e-10, atol=1e-14
        )

    r_cuts = [2.325, 3.775, 4.375]
    out_cn = rdf_cn.calc_molecular_cn(
        r_cuts, 0.05, NUM_TYPES, MASS, relations, f,
        num_mols=NUM_MOLS, num_atoms_per_mol=NUM_ATOMS_PER_MOL,
        path_or_buff=str(tmp_path / "cn_mol.csv"), precision="strict",
    )
    cn_w = oracle.cn_mol_loop(pos, types, mol_pos, mol_codes, lengths,
                              r_cuts, rel_pairs)
    for r, (a, b) in enumerate(rel_pairs):
        np.testing.assert_allclose(
            out_cn[f"cn_{a}-{b}"].iloc[0], cn_w[r] / at_counts[a - 1],
            rtol=1e-10,
        )


def test_consistency_check_raises(frame0):
    f, *_ = frame0
    with pytest.raises(ValueError, match="Consistency check failed"):
        rdf_cn.calc_atomic_rdf(5.0, 0.1, 4, MASS, [[8], [1]], f,
                               precision="strict")


def test_frame_averaging_multi_frame(mg_tfsi_dme_dir, tmp_path):
    """Two-frame run must equal the mean of per-frame normalized RDFs."""
    import shutil

    f0 = os.path.join(mg_tfsi_dme_dir, "dump.nvt.0.dump")
    f1 = os.path.join(mg_tfsi_dme_dir, "dump.nvt.50000.dump")
    shutil.copy(f0, tmp_path / "dump.nvt.0.dump")
    shutil.copy(f1, tmp_path / "dump.nvt.50000.dump")
    out0 = rdf_cn.calc_atomic_rdf(6.0, 0.1, NUM_TYPES, MASS, [[8], [9]], f0,
                                  save_mode=False, precision="strict")
    out1 = rdf_cn.calc_atomic_rdf(6.0, 0.1, NUM_TYPES, MASS, [[8], [9]], f1,
                                  save_mode=False, precision="strict")
    both = rdf_cn.calc_atomic_rdf(
        6.0, 0.1, NUM_TYPES, MASS, [[8], [9]],
        str(tmp_path / "dump.nvt.*.dump"), save_mode=False, precision="strict",
    )
    np.testing.assert_allclose(
        both["g_8-9"].to_numpy(),
        (out0["g_8-9"].to_numpy() + out1["g_8-9"].to_numpy()) / 2,
        rtol=1e-12,
    )


def test_spatial_sort_identical_results(frame0, tmp_path):
    """spatial_sort=True must not change any output value."""
    f, *_ = frame0
    kw = dict(save_mode=False, precision="strict")
    a = rdf_cn.calc_atomic_rdf(6.0, 0.1, NUM_TYPES, MASS, [[8], [9]], f, **kw)
    b = rdf_cn.calc_atomic_rdf(6.0, 0.1, NUM_TYPES, MASS, [[8], [9]], f,
                               spatial_sort=True, **kw)
    import pandas as pd

    pd.testing.assert_frame_equal(a, b)


def test_intermolecular_rdf(frame0, tmp_path):
    """COM-vs-COM RDF including self pairs (reference rdf_cn.py:857-903)."""
    f, pos, types, lengths = frame0
    system = System(NUM_MOLS, NUM_ATOMS_PER_MOL, mass=MASS)
    masses = np.asarray(MASS)[types - 1]
    mol_pos = oracle.com_per_molecule(pos, masses, system.mol_index,
                                      system.n_molecules)
    mol_codes = system.mol_type_of_molecule
    relations = [[3, 1], [2, 1]]
    rel_pairs = list(zip(relations[0], relations[1]))
    r_cut, bin_size = 10.0, 0.2
    out = rdf_cn.calc_intermolecular_rdf(
        r_cut, bin_size, NUM_TYPES, MASS, relations, f,
        num_mols=NUM_MOLS, num_atoms_per_mol=NUM_ATOMS_PER_MOL,
        save_mode=False, precision="strict",
    )
    part_c = oracle.rdf_mol_loop(mol_pos, mol_codes, mol_pos, mol_codes,
                                 lengths, r_cut, bin_size, rel_pairs)
    vol = float(np.prod(lengths))
    mol_counts = np.bincount(mol_codes - 1, minlength=3)
    for r, (a, b) in enumerate(rel_pairs):
        want = oracle.normalize_rdf_part(
            part_c[r], mol_counts[a - 1], mol_counts[b - 1], vol, bin_size
        )
        np.testing.assert_allclose(
            out[f"g_{a}-{b}"].to_numpy(), want, rtol=1e-9, atol=1e-14
        )
    # self-pairs included: for the (1,1)-style relation of a type with
    # itself at bin 0, the reference counts the molecule against itself
    out_self = rdf_cn.calc_intermolecular_rdf(
        10.0, 0.2, NUM_TYPES, MASS, [[3], [3]], f,
        num_mols=NUM_MOLS, num_atoms_per_mol=NUM_ATOMS_PER_MOL,
        save_mode=False, precision="strict",
    )
    assert out_self["g_3-3"].iloc[0] > 0  # self count lands in bin 0


def test_streaming_blocks_identical_results(dump_pattern, tmp_path,
                                            monkeypatch):
    """Multi-block streamed ingestion must reproduce single-block results
    exactly (the running sum is order-identical)."""
    import glob as globmod
    import os
    import pandas as pd

    from mdproptools_tpu.structural import rdf_cn as mod

    files = sorted(globmod.glob(dump_pattern))[:6]
    for i, f in enumerate(files):
        os.symlink(f, tmp_path / f"dump.{i}.dump")
    pattern = str(tmp_path / "dump.*.dump")
    kw = dict(r_cut=8.0, bin_size=0.4, num_types=9, mass=MASS,
              partial_relations=[[8], [9]], save_mode=False,
              precision="strict")
    df_one = mod.calc_atomic_rdf(filename=pattern, **kw)
    monkeypatch.setattr(mod, "FRAME_BLOCK", 2)
    df_blocks = mod.calc_atomic_rdf(filename=pattern, **kw)
    pd.testing.assert_frame_equal(df_one, df_blocks)
    # trailing partial block (4 + 2): the remainder pads to the steady
    # shape with zero-weight frames and must stay exact
    monkeypatch.setattr(mod, "FRAME_BLOCK", 4)
    df_rem = mod.calc_atomic_rdf(filename=pattern, **kw)
    pd.testing.assert_frame_equal(df_one, df_rem)


def test_pad_block_targets_steady_shape():
    """A partial trailing block pads up to the steady block shape
    (zero-weight frames) so the compiled program is reused; the frames
    mesh multiple is still honored on top of the target."""
    import numpy as np

    from mdproptools_tpu.structural.rdf_cn import _pad_block

    pos = np.arange(2 * 5 * 3, dtype=np.float64).reshape(2, 5, 3)
    lens = np.ones((2, 3))
    out, _, lens_p, w = _pad_block(pos, None, lens, 1, target=7)
    assert out.shape[0] == 7 and lens_p.shape[0] == 7
    assert w.tolist() == [1, 1, 0, 0, 0, 0, 0]
    assert (out[2:] == pos[:1]).all()
    # target rounds up to the mesh multiple
    out, _, _, w = _pad_block(pos, None, lens, 4, target=7)
    assert out.shape[0] == 8 and w.sum() == 2
    # no target, no mesh: unchanged
    out, _, _, w = _pad_block(pos, None, lens, 1)
    assert out.shape[0] == 2 and w.sum() == 2


def test_density_diagnostic_logged(frame0, tmp_path, caplog):
    """The per-frame density report of the reference's _calc_props
    (rdf_cn.py:281-286): total_mass = sum_i mass[i]*count(type i+1),
    density = total_mass/V * CON_CONSTANT, logged once per frame."""
    import logging

    f, pos, types, lengths = frame0
    counts = np.bincount(types - 1, minlength=NUM_TYPES)
    vol = float(np.prod(lengths))
    want = (
        sum(MASS[i] * counts[i] for i in range(NUM_TYPES))
        / vol * rdf_cn.CON_CONSTANT
    )
    # pin the bundled frame's density to the hand-derived value
    got = rdf_cn._total_density(counts, MASS, NUM_TYPES, vol)
    assert got == pytest.approx(want, rel=1e-12)
    assert 0.5 < got < 3.0  # a liquid electrolyte in g/cm^3

    caplog.set_level(logging.INFO, logger="mdproptools_tpu")
    rdf_cn.calc_atomic_rdf(
        5.0, 0.5, NUM_TYPES, MASS, [[8], [9]], f,
        path_or_buff=str(tmp_path / "rdf.csv"), precision="strict",
    )
    lines = [r.getMessage() for r in caplog.records
             if "Average density=" in r.getMessage()]
    assert len(lines) == 1  # one frame -> one report
    assert lines[0] == "Average density=%10.8f" % want


def test_density_diagnostic_altered_ids_quirk(frame0):
    """With recalculated per-molecule ids the reference indexes the
    FIRST num_types altered-id codes with the per-LAMMPS-type masses
    (its atom_types dict counts the id column, rdf_cn.py:263,281) —
    quirk reproduced, so the value differs from the type-counts one."""
    f, pos, types, lengths = frame0
    ids = np.arange(1, pos.shape[0] + 1)
    codes = altered_atom_types(ids, NUM_MOLS, NUM_ATOMS_PER_MOL)
    code_counts = np.bincount(codes - 1, minlength=sum(NUM_ATOMS_PER_MOL))
    vol = float(np.prod(lengths))
    want = (
        sum(MASS[i] * code_counts[i] for i in range(NUM_TYPES))
        / vol * rdf_cn.CON_CONSTANT
    )
    got = rdf_cn._total_density(code_counts, MASS, NUM_TYPES, vol)
    assert got == pytest.approx(want, rel=1e-12)
    type_counts = np.bincount(types - 1, minlength=NUM_TYPES)
    assert got != pytest.approx(
        rdf_cn._total_density(type_counts, MASS, NUM_TYPES, vol), rel=1e-3)


def test_density_mass_consistency_raises(frame0, tmp_path):
    """Too few masses for num_types raises at entry-point call time
    (the reference dies with an IndexError inside _calc_props)."""
    f, pos, types, lengths = frame0
    with pytest.raises(ValueError, match="mass must list one value"):
        rdf_cn.calc_atomic_rdf(
            5.0, 0.5, NUM_TYPES, MASS[:4], [[8], [9]], f,
            path_or_buff=str(tmp_path / "x.csv"), precision="strict",
        )
    with pytest.raises(ValueError, match="mass must list one value"):
        rdf_cn.calc_atomic_cn(
            [3.0], 0.5, NUM_TYPES, MASS[:4], [[8], [9]], f,
            path_or_buff=str(tmp_path / "y.csv"), precision="strict",
        )
