"""Diffusion/MSD parity and physics tests.

The reference's golden CSVs are unmaterialized git-LFS pointers, so
parity is asserted against in-test float64 oracles implementing the
reference math (displacements vs t=0, per-type pivoted columns, the
msd_int NaN-row quirk), plus a synthetic-random-walk physics test for
calc_diff.
"""

import os
import shutil

import numpy as np
import pandas as pd
import pytest

from mdproptools_tpu.common import constants
from mdproptools_tpu.dynamical.diffusion import Diffusion
from mdproptools_tpu.io.lammps_dump import read_trajectory

MASS = [16.0, 12.01, 1.008, 14.01, 32.06, 16.0, 12.01, 19.0, 24.305]
NUM_MOLS = [591, 66, 33]
NUM_APM = [16, 15, 1]


@pytest.fixture(scope="module")
def five_frame_dir(mg_tfsi_dme_dir, tmp_path_factory):
    d = tmp_path_factory.mktemp("dumps")
    for ts in [0, 50000, 100000, 150000, 200000]:
        shutil.copy(os.path.join(mg_tfsi_dme_dir, f"dump.nvt.{ts}.dump"), d)
    return str(d)


@pytest.fixture(scope="module")
def traj5(five_frame_dir):
    return read_trajectory(f"{five_frame_dir}/dump.nvt.*.dump")


def test_msd_allatom_matches_oracle(five_frame_dir, traj5, tmp_path,
                                    benchmark):
    d = Diffusion(timestep=1, units="real", outputs_dir=five_frame_dir,
                  diff_dir=str(tmp_path))
    msd, msd_all, msd_int = benchmark(
        d.get_msd_from_dump,
        "dump.nvt.*.dump", msd_type="allatom", avg_interval=True, tao_coeff=2,
    )
    # oracle: unwrapped coords straight off the dump, SI conversion
    xu = traj5.cols(["xu", "yu", "zu"]) * constants.DISTANCE_CONVERSION["real"]
    disp2 = (xu - xu[0][None]) ** 2
    want_msd = disp2.sum(axis=2).mean(axis=1)
    np.testing.assert_allclose(msd["msd"].to_numpy(), want_msd, rtol=1e-12)
    want_t = traj5.timesteps * 1 * constants.TIME_CONVERSION["real"]
    np.testing.assert_allclose(msd["Time (s)"].to_numpy(), want_t)
    assert list(msd.columns) == ["Time (s)", "dx2", "dy2", "dz2", "msd"]
    assert list(msd_all.columns) == ["Time (s)", "id", "dx2", "dy2", "dz2",
                                     "msd"]
    assert len(msd_all) == 5 * traj5.n_atoms
    # msd_all rows: time-major, id ascending
    np.testing.assert_allclose(
        msd_all["msd"].to_numpy()[: traj5.n_atoms],
        disp2[0].sum(axis=1),
    )
    # msd_int: samples at frames [0, 2, 4]; axis means skip NaN row,
    # msd mean includes a 0 for it (reference quirk)
    cs = xu[[0, 2, 4]]
    dd = (cs[1:] - cs[:-1]) ** 2
    want_dx2 = dd[:, :, 0].mean(axis=0)
    want_msd_int = dd.sum(axis=2).sum(axis=0) / 3
    np.testing.assert_allclose(msd_int["dx2"].to_numpy(), want_dx2,
                               rtol=1e-12)
    np.testing.assert_allclose(msd_int["msd"].to_numpy(), want_msd_int,
                               rtol=1e-12)


def test_msd_allatom_streamed_csv_parity(five_frame_dir, tmp_path,
                                         monkeypatch):
    """The O(block)-memory allatom path (msd_all appended to CSV in
    block chunks) must be BIT-identical to the
    in-memory path, including across block boundaries (forced 2-frame
    blocks)."""
    import functools

    from mdproptools_tpu.dynamical import diffusion as diff_mod
    from mdproptools_tpu.io.lammps_dump import iter_trajectory_blocks

    d = Diffusion(timestep=1, units="real", outputs_dir=five_frame_dir,
                  diff_dir=str(tmp_path))
    msd_mem, all_mem, int_mem = d.get_msd_from_dump(
        "dump.nvt.*.dump", msd_type="allatom", avg_interval=True,
        tao_coeff=2)
    # force multi-block streaming (5 frames -> 3 blocks of <= 2)
    monkeypatch.setattr(
        diff_mod, "iter_trajectory_blocks",
        functools.partial(iter_trajectory_blocks, block_frames=2))
    out_csv = str(tmp_path / "msd_all_stream.csv")
    msd_st, all_path, int_st = d.get_msd_from_dump(
        "dump.nvt.*.dump", msd_type="allatom", avg_interval=True,
        tao_coeff=2, msd_all_path=out_csv)
    assert all_path == out_csv
    pd.testing.assert_frame_equal(msd_st, msd_mem)
    pd.testing.assert_frame_equal(int_st, int_mem)
    streamed = pd.read_csv(out_csv)
    np.testing.assert_allclose(streamed.to_numpy(), all_mem.to_numpy(),
                               rtol=1e-12, atol=0)
    assert list(streamed.columns) == list(all_mem.columns)
    # com path rejects the kwarg (its msd_all is O(T x M), in memory)
    with pytest.raises(ValueError, match="msd_all_path"):
        d.get_msd_from_dump("dump.nvt.*.dump", msd_type="com",
                            num_mols=NUM_MOLS, num_atoms_per_mol=NUM_APM,
                            mass=MASS, msd_all_path=out_csv)


def test_msd_com_matches_oracle(five_frame_dir, traj5, tmp_path, benchmark):
    d = Diffusion(timestep=1, units="real", outputs_dir=five_frame_dir,
                  diff_dir=str(tmp_path))
    msd, msd_all = benchmark(
        d.get_msd_from_dump,
        "dump.nvt.*.dump", msd_type="com", num_mols=NUM_MOLS,
        num_atoms_per_mol=NUM_APM, mass=MASS, com_drift=True,
    )
    # oracle COM in float64
    types = traj5.col("type")[0].astype(np.int64)
    masses = np.asarray(MASS)[types - 1]
    apm = np.repeat(NUM_APM, NUM_MOLS)
    mol_index = np.repeat(np.arange(apm.size), apm)
    xu = traj5.cols(["xu", "yu", "zu"])
    M = apm.size
    com = np.zeros((5, M, 3))
    mtot = np.zeros(M)
    np.add.at(mtot, mol_index, masses)
    for t in range(5):
        for ax in range(3):
            w = np.zeros(M)
            np.add.at(w, mol_index, masses * xu[t, :, ax])
            com[t, :, ax] = w / mtot
    com *= constants.DISTANCE_CONVERSION["real"]
    mol_types = np.repeat([1, 2, 3], NUM_MOLS)
    # drift correction vs t=0, mass-weighted per type
    mol_mass = mtot * constants.MASS_CONVERSION["real"]
    for k in (1, 2, 3):
        sel = mol_types == k
        ct = np.einsum("tmc,m->tc", com[:, sel, :], mol_mass[sel]) / \
            mol_mass[sel].sum()
        com[:, sel, :] -= (ct - ct[0])[:, None, :]
    disp2 = (com - com[0][None]) ** 2
    msd_vals = disp2.sum(axis=2)
    for k in (1, 2, 3):
        sel = mol_types == k
        np.testing.assert_allclose(
            msd[f"msd{k}"].to_numpy(), msd_vals[:, sel].mean(axis=1),
            rtol=1e-12,
        )
    # reference pivot ordering: dx2k dy2k dz2k msdk per type
    assert list(msd.columns) == ["Time (s)"] + [
        f"{c}{k}" for k in (1, 2, 3) for c in ("dx2", "dy2", "dz2", "msd")
    ]
    assert list(msd_all.columns) == ["Time (s)", "type", "mol_id", "dx2",
                                     "dy2", "dz2", "msd"]


def test_msd_com_host_fold_matches_device_fold(five_frame_dir, tmp_path):
    """The host float64 reduceat COM fold (ops/host_fold.py, the
    streaming default) must match the jitted device
    segment-sum fold at the stream surface, across forced block
    boundaries (2-frame blocks)."""
    from mdproptools_tpu.io.lammps_dump import iter_trajectory_blocks

    d = Diffusion(timestep=1, units="real", outputs_dir=five_frame_dir,
                  diff_dir=str(tmp_path))
    outs = {}
    for fold in ("host", "device"):
        stream = d.msd_stream(
            msd_type="com", num_mols=NUM_MOLS, num_atoms_per_mol=NUM_APM,
            mass=MASS, fold=fold)
        for blk in iter_trajectory_blocks(
                f"{five_frame_dir}/dump.nvt.*.dump", block_frames=2):
            stream.fold(blk)
        outs[fold] = stream.finalize(com_drift=True)
    msd_h, all_h = outs["host"]
    msd_d, all_d = outs["device"]
    assert list(msd_h.columns) == list(msd_d.columns)
    np.testing.assert_allclose(msd_h.to_numpy(), msd_d.to_numpy(),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(all_h["msd"].to_numpy(),
                               all_d["msd"].to_numpy(), rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="fold"):
        d.msd_stream(msd_type="com", num_mols=NUM_MOLS,
                     num_atoms_per_mol=NUM_APM, mass=MASS, fold="gpu")


def test_calc_diff_recovers_synthetic_D(tmp_path):
    """Random walk with known diffusion coefficient: MSD = 6 D t."""
    rng = np.random.default_rng(11)
    D_true = 2.5e-9  # m^2/s
    dt = 1e-12
    T, n = 400, 800
    steps = rng.normal(0, np.sqrt(2 * D_true * dt), size=(T, n, 3))
    pos = np.cumsum(steps, axis=0)
    msd_vals = ((pos - pos[0][None]) ** 2).sum(axis=2).mean(axis=1)
    msd = pd.DataFrame({
        "Time (s)": np.arange(T) * dt,
        "msd": msd_vals,
    })
    d = Diffusion(timestep=1, units="real", diff_dir=str(tmp_path))
    out = d.calc_diff(msd, save=True, plot=True, diff_names=["rw"])
    got = out.loc["rw", "diffusion (m2/s)"]
    assert abs(got - D_true) / D_true < 0.05
    assert (tmp_path / "diffusion.csv").exists()
    assert (tmp_path / "diff_rw.txt").exists()
    assert (tmp_path / "msd.png").exists()
    assert (tmp_path / "msd_log.png").exists()
    assert 0.9 < out.loc["rw", "R2"] <= 1.0


def test_detect_linear_region_finds_fickian_window(tmp_path):
    """Synthetic MSD: ballistic (t^2) up to 1 ns then linear — the
    detected window must cover (only) the linear part and compose with
    calc_diff to recover the slope's D."""
    import pandas as pd

    from mdproptools_tpu.dynamical.diffusion import Diffusion

    t = np.linspace(1e-10, 1e-8, 200)
    t0 = 1e-9
    D, dim = 1e-9, 3
    msd_lin = 2 * dim * D * t
    msd_ball = (2 * dim * D / t0) * t ** 2
    msd = pd.DataFrame({
        "Time (s)": t,
        "msd (m2/s)": np.where(t < t0, msd_ball, msd_lin),
    })
    d = Diffusion(timestep=1, units="real", outputs_dir=str(tmp_path),
                  diff_dir=str(tmp_path))
    initial, final = d.detect_linear_region(msd, tol=0.05)
    assert initial["msd (m2/s)"] >= t0 * 0.9
    assert final["msd (m2/s)"] == pytest.approx(t[-1], rel=0.05)
    diff = d.calc_diff(msd, initial, final, dimension=dim, save=False,
                       plot=False)
    # a WINDOWED fit of the purely-linear region recovers D exactly and
    # R2 = 1; a full-range fit (window ignored) gives 9.9975e-10 and
    # R2 = 0.9999 on this data — tight tolerances catch that regression
    assert diff["diffusion (m2/s)"].iloc[0] == pytest.approx(D, rel=1e-9)
    assert diff["R2"].iloc[0] == pytest.approx(1.0, abs=1e-9)


def test_find_intersection_helper():
    """Working version of the reference's dead njit helper."""
    from mdproptools_tpu.dynamical.residence_time import find_intersection

    b = np.arange(12).reshape(3, 4)
    a = np.array([[0, 1], [2, 3], [1, 0]])
    assert find_intersection(a, b) == 1 + 11 + 4
    assert find_intersection(np.empty((0, 2)), b) == 0


def test_get_diff_dist(tmp_path):
    msd_int = pd.DataFrame({
        "type": [1.0, 1.0, 2.0, 2.0],
        "mol_id": [1.0, 2.0, 1.0, 2.0],
        "msd": [6.0e-18, 1.2e-17, 2.4e-17, 4.8e-17],
    })
    d = Diffusion(timestep=1, units="real", diff_dir=str(tmp_path))
    out = d.get_diff_dist(msd_int, dump_freq=50000, dimension=3, tao_coeff=4,
                          plot=True, diff_names=["a", "b"])
    delta = 50000 * 1 * constants.TIME_CONVERSION["real"]
    np.testing.assert_allclose(
        out["diff"].to_numpy(),
        msd_int["msd"].to_numpy() / (2 * 3 * 4 * delta),
    )
    assert (tmp_path / "diff_dist.png").exists()


def test_get_msd_from_log(tmp_path):
    from mdproptools_tpu.io.lammps_log import write_lammps_log

    steps = np.arange(0, 5000, 500)
    df = pd.DataFrame({
        "Step": steps,
        "Temp": np.full(steps.size, 298.0),
        "c_msd_1": steps * 0.002,
        "c_msd_2": steps * 0.004,
    })
    write_lammps_log(str(tmp_path / "log.test"), [df])
    d = Diffusion(timestep=1, units="real", outputs_dir=str(tmp_path))
    msd = d.get_msd_from_log("log.test")
    conv = constants.DISTANCE_CONVERSION["real"] ** 2
    np.testing.assert_allclose(msd["c_msd_1"].to_numpy(),
                               steps * 0.002 * conv)
    np.testing.assert_allclose(
        msd["Time (s)"].to_numpy(),
        steps * constants.TIME_CONVERSION["real"],
    )
    assert "Temp" not in msd.columns


def test_get_msd_from_log_realistic_restart_fixture(tmp_path):
    """get_msd_from_log + calc_diff on the genuine LAMMPS-format restart
    logs (compute msd columns planted with D = 1e-9 m^2/s): the msd
    columns survive the banner/WARNING/truncated-row noise, concat
    across the restart drops the duplicated row, and the Einstein fit
    recovers the planted diffusivity."""
    from pathlib import Path

    fixtures = Path(__file__).parents[1] / "io" / "test_files"
    d = Diffusion(timestep=1, units="real", outputs_dir=str(fixtures),
                  diff_dir=str(tmp_path))
    msd = d.get_msd_from_log("log.mixture_*")
    assert list(msd.columns) == ["c_msd[1]", "c_msd[2]", "c_msd[3]",
                                 "c_msd[4]", "Time (s)"]
    assert len(msd) == 52  # steps 0..51000 (dup dropped, truncated dropped)
    diff_df = d.calc_diff(msd, dimension=3)
    # c_msd[4] is the total msd: 6*D*t with D = 1e-9 m^2/s and 2% noise
    d_total = diff_df.loc[diff_df.index[-1], "diffusion (m2/s)"]
    assert d_total == pytest.approx(1e-9, rel=0.02)
    # per-axis columns carry 2*D*t -> same D when dimension=1
    diff_1d = d.calc_diff(msd[["c_msd[1]", "Time (s)"]], dimension=1)
    assert diff_1d["diffusion (m2/s)"].iloc[0] == pytest.approx(1e-9,
                                                                rel=0.03)
