"""Residence time: h-matrix + batched ACF vs a direct float64 oracle on a
synthetic two-species trajectory; stretched-exp fit recovery."""

import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import oracle  # noqa: E402
from helpers import write_traj  # noqa: E402

from mdproptools_tpu.dynamical.residence_time import (  # noqa: E402
    Displacement,
    ResidenceTime,
)
from mdproptools_tpu.ops.acf import autocorrelate_brute  # noqa: E402


@pytest.fixture(scope="module")
def synthetic_traj(tmp_path_factory):
    """4 type-1 'cations' fixed at sites; 12 type-2 'waters' oscillating
    radially so they enter/leave the [1, 3] A shell deterministically."""
    d = tmp_path_factory.mktemp("res_dumps")
    rng = np.random.default_rng(10)
    box = 24.0
    n1, n2 = 4, 12
    cations = rng.uniform(4, 20, size=(n1, 3))
    anchors = np.repeat(cations, 3, axis=0)  # 3 waters near each cation
    dirs = rng.normal(size=(n2, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    T = 32
    ts_list = list(range(0, T * 500, 500))
    frames = []
    cols = ["id", "type", "x", "y", "z"]
    for t in range(T):
        radius = 2.0 + 1.8 * np.sin(2 * np.pi * t / 16 + np.arange(n2))
        waters = anchors + dirs * radius[:, None]
        allpos = np.vstack([cations, waters]) % box
        data = np.zeros((n1 + n2, 5))
        data[:, 0] = np.arange(1, n1 + n2 + 1)
        data[:, 1] = [1] * n1 + [2] * n2
        data[:, 2:5] = allpos
        frames.append(data)
    pattern = write_traj(str(d), ts_list, 0.0, box, cols, frames)
    return pattern, frames, box, ts_list


def test_auto_correlation_matches_oracle(synthetic_traj, tmp_path):
    pattern, frames, box, ts_list = synthetic_traj
    rt = ResidenceTime(
        r_cut=[(1.0, 3.0)], partial_relations=[[1], [2]], filename=pattern,
        dt=1, working_dir=str(tmp_path),
    )
    corr = rt.calc_auto_correlation()

    # oracle: explicit h-matrix + per-column unbiased ACF
    T = len(frames)
    n1 = 4
    lengths = np.array([box] * 3)
    h = np.zeros((T, 4, 12), bool)
    for t, data in enumerate(frames):
        pos = data[:, 2:5]
        for i in range(n1):
            rsq = oracle.rsq_row(pos[i], pos[n1:], lengths)
            h[t, i] = (rsq > 1.0) & (rsq <= 9.0)
    cov = np.zeros(T)
    for i in range(4):
        for j in range(12):
            cov += autocorrelate_brute(h[:, i, j].astype(np.float64))
    want = cov / 48
    want = want / want[0]
    np.testing.assert_allclose(corr["1-2"].to_numpy(), want, rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(
        corr["Time (ps)"].to_numpy(), np.array(ts_list) * 1e-3
    )
    assert (tmp_path / "auto_correlation.csv").exists()


def test_self_pair_masked_for_same_type(synthetic_traj, tmp_path):
    pattern, frames, box, ts_list = synthetic_traj
    rt = ResidenceTime(
        r_cut=[(0.0, 5.0)], partial_relations=[[2], [2]], filename=pattern,
        dt=1, working_dir=str(tmp_path),
    )
    corr = rt.calc_auto_correlation()
    # with self pairs masked, C(0) is finite and normalized to 1
    assert corr["2-2"].iloc[0] == pytest.approx(1.0)


def test_spilled_h_matrices_bit_identical(synthetic_traj, tmp_path,
                                          monkeypatch):
    """Forcing the disk-spill path (H_SPILL_BYTES=1: every h-matrix goes
    through the memmap) must reproduce the in-memory
    C(t) bit-for-bit, including the self-pair-masked relation."""
    from mdproptools_tpu.dynamical import residence_time as rt_mod

    pattern, frames, box, ts_list = synthetic_traj
    kw = dict(r_cut=[(1.0, 3.0), (0.0, 5.0)],
              partial_relations=[[1, 2], [2, 2]], filename=pattern,
              dt=1, working_dir=str(tmp_path))
    want = ResidenceTime(**kw).calc_auto_correlation()
    monkeypatch.setattr(rt_mod, "H_SPILL_BYTES", 1)
    got = ResidenceTime(**kw).calc_auto_correlation()
    pd.testing.assert_frame_equal(got, want)
    # no temp spill files left behind
    import glob as _glob
    import tempfile

    assert not _glob.glob(f"{tempfile.gettempdir()}/mdpt_hmat_*.bin")


def test_fit_recovers_stretched_exp(tmp_path):
    t = np.linspace(0, 40, 200)
    a, tau_res, tau_short, beta = 0.7, 8.0, 1.2, 0.8
    y = ResidenceTime._stretched_exp_function(t, a, tau_res, tau_short, beta)
    rt = ResidenceTime(r_cut=[(0, 1)], partial_relations=[[1], [2]],
                       filename="unused", working_dir=str(tmp_path))
    rt.corr_df = pd.DataFrame({"Time (ps)": t, "1-2": y})
    res = rt.fit_auto_correlation(cut_percent=1.0, plot=True)
    got = res["1-2"]
    assert got[0] == pytest.approx(a, rel=0.05)
    assert got[1] == pytest.approx(tau_res, rel=0.05)
    assert got[3] == pytest.approx(beta, rel=0.05)
    from scipy.special import gamma
    want_r = a * tau_res * gamma(1 + 1 / beta) + (1 - a) * tau_short
    assert got[4] == pytest.approx(want_r, rel=0.05)
    assert (tmp_path / "residence_time.csv").exists()
    assert (tmp_path / "1-2_fit.png").exists()


def test_displacement_working(synthetic_traj, tmp_path):
    pattern, frames, box, ts_list = synthetic_traj
    disp = Displacement(
        atom_types=[2], residence_time={2: 2.0}, filename=pattern, dt=1,
        working_dir=str(tmp_path),
    )
    out = disp.calc_dist()
    assert 2 in out
    assert len(out[2]) > 0
    assert (out[2]["displacement"] >= 0).all()
    assert (tmp_path / "displacement_2.csv").exists()


def test_displacement_pbc_wrap(tmp_path):
    """An atom crossing the periodic boundary must not produce a
    box-sized displacement (review finding)."""
    box = 10.0
    # one atom moving +0.4/frame crossing the boundary at x ~ 10
    xs = [9.7, 0.1, 0.5]  # wrapped positions; true steps are +0.4
    frames = []
    for x in xs:
        d = np.zeros((1, 5))
        d[0] = [1, 1, x, 5.0, 5.0]
        frames.append(d)
    pattern = write_traj(str(tmp_path), [0, 1000, 2000], 0.0, box,
                         ["id", "type", "x", "y", "z"], frames)
    disp = Displacement(atom_types=[1], residence_time={1: 0.001},
                        filename=pattern, dt=1, working_dir=str(tmp_path))
    out = disp.calc_dist()
    assert (out[1]["displacement"] < 1.0).all()
    np.testing.assert_allclose(out[1]["displacement"], 0.4, atol=1e-9)
