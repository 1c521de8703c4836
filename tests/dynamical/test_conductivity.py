"""Green-Kubo conductivity parity: charge flux vs pandas-free oracle on
real data; correlation pipeline vs manual loops; plateau detector on a
synthetic curve; full calc_cond on a synthetic trajectory with known
analytic conductivity."""

import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from helpers import write_traj  # noqa: E402

from mdproptools_tpu.common import constants  # noqa: E402
from mdproptools_tpu.dynamical.conductivity import Conductivity  # noqa: E402
from mdproptools_tpu.io.lammps_dump import read_trajectory  # noqa: E402
from mdproptools_tpu.ops import acf as acf_ops  # noqa: E402

MASS = [16.0, 12.01, 1.008, 14.01, 32.06, 16.0, 12.01, 19.0, 24.305]
NUM_MOLS = [591, 66, 33]
NUM_APM = [16, 15, 1]


@pytest.fixture(scope="module")
def five_frame_dir(mg_tfsi_dme_dir, tmp_path_factory):
    d = tmp_path_factory.mktemp("cond_dumps")
    for ts in [0, 50000, 100000, 150000, 200000]:
        shutil.copy(os.path.join(mg_tfsi_dme_dir, f"dump.nvt.{ts}.dump"), d)
    return str(d)


def test_charge_flux_matches_oracle(five_frame_dir):
    cond = Conductivity(
        "dump.test.*.dump" if False else "dump.nvt.*.dump",
        NUM_MOLS, NUM_APM, volume=49.0**3, mass=MASS,
        working_dir=five_frame_dir,
    )
    j = cond.get_charge_flux()
    assert j.shape == (3, 3, 5)

    traj = read_trajectory(f"{five_frame_dir}/dump.nvt.*.dump")
    types = traj.col("type")[0].astype(np.int64)
    masses = np.asarray(MASS)[types - 1]
    q = traj.col("q")[0]
    apm = np.repeat(NUM_APM, NUM_MOLS)
    mol_index = np.repeat(np.arange(apm.size), apm)
    mol_types = np.repeat([0, 1, 2], NUM_MOLS)
    vconv = constants.VELOCITY_CONVERSION["real"]
    qconv = constants.CHARGE_CONVERSION["real"]
    M = apm.size
    mtot = np.zeros(M)
    np.add.at(mtot, mol_index, masses)
    qmol = np.zeros(M)
    np.add.at(qmol, mol_index, q)
    qmol *= qconv
    vel = traj.cols(["vx", "vy", "vz"])
    for t in range(5):
        vcom = np.zeros((M, 3))
        for ax in range(3):
            w = np.zeros(M)
            np.add.at(w, mol_index, masses * vel[t, :, ax])
            vcom[:, ax] = w / mtot
        vcom *= vconv
        for k in range(3):
            sel = mol_types == k
            want = (vcom[sel] * qmol[sel, None]).sum(axis=0)
            np.testing.assert_allclose(j[:, k, t], want, rtol=1e-9,
                                       atol=1e-30)
    # time vector in seconds
    np.testing.assert_allclose(
        cond.time, traj.timesteps * constants.TIME_CONVERSION["real"]
    )


def test_charge_flux_host_fold_matches_device_fold(five_frame_dir):
    """The host float64 reduceat flux fold (ops/host_fold.py, the
    streaming default) must match the jitted device
    segment-sum program at the stream surface, across forced block
    boundaries (2-frame blocks)."""
    from mdproptools_tpu.io.lammps_dump import iter_trajectory_blocks

    outs = {}
    for fold in ("host", "device"):
        cond = Conductivity(
            "dump.nvt.*.dump", NUM_MOLS, NUM_APM, volume=49.0**3,
            mass=MASS, working_dir=five_frame_dir)
        stream = cond.flux_stream(fold=fold)
        for blk in iter_trajectory_blocks(
                f"{five_frame_dir}/dump.nvt.*.dump",
                columns=["id", "type", "q", "vx", "vy", "vz"],
                block_frames=2):
            stream.fold(blk)
        outs[fold] = (stream.finalize(), list(cond.time))
    j_h, t_h = outs["host"]
    j_d, t_d = outs["device"]
    assert j_h.shape == j_d.shape == (3, 3, 5)
    np.testing.assert_allclose(j_h, j_d, rtol=1e-12, atol=1e-30)
    np.testing.assert_allclose(t_h, t_d)
    with pytest.raises(ValueError, match="fold"):
        Conductivity("dump.nvt.*.dump", NUM_MOLS, NUM_APM,
                     volume=49.0**3, mass=MASS,
                     working_dir=five_frame_dir).flux_stream(fold="gpu")


def test_correlate_charge_flux_matches_loop():
    rng = np.random.default_rng(4)
    flux = rng.normal(size=(3, 2, 50))
    cond = Conductivity.__new__(Conductivity)
    cond.num_mols = [10, 20]
    tot = cond.correlate_charge_flux(flux)
    want = np.zeros((3, 50))
    for i in range(2):
        for jj in range(2):
            for k in range(3):
                c = acf_ops.correlate_brute(flux[k, i], flux[k, jj])
                want[i] += c
                want[2] += c
    np.testing.assert_allclose(tot, want, rtol=1e-8, atol=1e-12)


def test_detect_time_range_finds_plateau():
    rng = np.random.default_rng(5)
    t = np.arange(20000)
    decay = 5.0 * np.exp(-t / 500.0) * np.cos(t / 50.0)
    noise = rng.normal(0, 1e-4, size=t.size)
    flux = decay + noise
    s, e = Conductivity.detect_time_range(flux, tol=0.05)
    assert s > 2000  # past the decaying region
    assert e - s > 5000  # long plateau


def test_calc_cond_synthetic_known_sigma(tmp_path):
    """Two monatomic species with exactly anticorrelated constant
    velocities: J(t) = const => correlation = J^2 (const) => integral
    linear => sigma = J^2 * t_avg / (3 kB T V). We verify the pipeline
    runs end-to-end and the sign/scale of the total conductivity."""
    n1, n2 = 8, 8
    n = n1 + n2
    T_frames = 40
    box = 20.0
    rng = np.random.default_rng(6)
    pos = rng.uniform(0, box, size=(n, 3))
    v = np.zeros((n, 3))
    v[:n1, 0] = 1e-4  # cation drift (LAMMPS real: A/fs)
    v[n1:, 0] = -1e-4  # anion drift
    cols = ["id", "type", "q", "mass", "x", "y", "z", "vx", "vy", "vz"]
    frames = []
    ts_list = list(range(0, T_frames * 1000, 1000))
    for ts in ts_list:
        d = np.zeros((n, len(cols)))
        d[:, 0] = np.arange(1, n + 1)
        d[:, 1] = [1] * n1 + [2] * n2
        d[:, 2] = [1.0] * n1 + [-1.0] * n2
        d[:, 3] = [22.99] * n1 + [35.45] * n2
        d[:, 4:7] = pos
        d[:, 7:10] = v
        frames.append(d)
    pattern = write_traj(str(tmp_path), ts_list, 0.0, box, cols, frames)
    cond = Conductivity(
        os.path.basename(pattern), [n1, n2], [1, 1], volume=box**3,
        mass=[22.99, 35.45], temp=300.0, timestep=1, units="real",
        working_dir=str(tmp_path),
    )
    sigma = cond.calc_cond(tol=0.5, save=True)
    assert sigma.shape == (3,)
    # constant flux: every species and the total must be positive
    # (J_total^2 > 0); J1.J2 < 0 cross-terms reduce per-species rows
    assert sigma[2] > 0
    # analytic total: J = sum q_i v_i = (8*1*1e-4 + 8*(-1)*(-1e-4)) e*A/fs
    e = constants.ELEMENTARY_CHARGE
    Jx = 16 * 1e-4 * e * constants.VELOCITY_CONVERSION["real"]
    # correlation (only x nonzero) = Jx^2, integral at mean detected time
    # sigma ~ Jx^2 * t / (3 kB T V): check order of magnitude at t_mid
    V = box**3 * constants.DISTANCE_CONVERSION["real"] ** 3
    t_mid = np.mean(cond.time)
    approx = Jx**2 * t_mid / (3 * constants.BOLTZMANN * 300.0 * V)
    assert 0.2 < sigma[2] / approx < 5.0
    assert (tmp_path / "charge_flux.csv").exists()
    assert (tmp_path / "integral.csv").exists()
    assert (tmp_path / "conductivity.csv").exists()


def test_einstein_helfand_synthetic(tmp_path):
    """Ions drifting ballistically: P(t) = J*t exactly, so the
    translocation MSD is (J t)^2 ... for a linear-in-t check use a
    diffusive synthetic instead: charges on independent random walks
    give <|dP|^2> = 2 * sum q_i^2 * D * ... ; here we verify the exact
    quadratic for constant drift analytically."""
    n1 = 4
    T_frames = 30
    box = 20.0
    rng = np.random.default_rng(12)
    pos0 = rng.uniform(0, box, size=(2 * n1, 3))
    v = np.zeros((2 * n1, 3))
    v[:n1, 0] = 1e-3
    v[n1:, 0] = -1e-3
    cols = ["id", "type", "q", "x", "y", "z", "ix", "iy", "iz"]
    frames, ts_list = [], list(range(0, T_frames * 1000, 1000))
    for k, ts in enumerate(ts_list):
        d = np.zeros((2 * n1, len(cols)))
        d[:, 0] = np.arange(1, 2 * n1 + 1)
        d[:, 1] = [1] * n1 + [2] * n1
        d[:, 2] = [1.0] * n1 + [-1.0] * n1
        p = pos0 + v * ts
        d[:, 3:6] = p % box
        d[:, 6:9] = np.floor(p / box)
        frames.append(d)
    pattern = write_traj(str(tmp_path), ts_list, 0.0, box, cols, frames)
    cond = Conductivity(
        os.path.basename(pattern), [n1, n1], [1, 1], volume=box**3,
        mass=[22.99, 35.45], temp=300.0, units="real",
        working_dir=str(tmp_path),
    )
    sigma = cond.einstein()
    # P(t) = sum q_i v_i t = (n1*1e-3 + n1*1e-3) e*A/fs * t -> |dP|^2 = C t^2
    # OLS slope of C t^2 vs t over [0, T]: slope = C * sum(t^3)/sum(t^2)
    e = constants.ELEMENTARY_CHARGE
    Jx = 2 * n1 * 1e-3 * e * (constants.DISTANCE_CONVERSION["real"]
                              / constants.TIME_CONVERSION["real"])
    t = np.array(ts_list) * constants.TIME_CONVERSION["real"]
    C = Jx**2
    slope = C * np.sum(t**3) / np.sum(t**2)
    want = slope / (6 * constants.BOLTZMANN * 300.0
                    * box**3 * constants.DISTANCE_CONVERSION["real"]**3)
    np.testing.assert_allclose(sigma, want, rtol=1e-6)


def test_nernst_einstein():
    cond = Conductivity.__new__(Conductivity)
    cond.volume = 1e-25  # m^3
    cond.temp = 300.0
    D = [1e-9, 2e-10]
    z = [1, -1]
    n = [100, 100]
    got = cond.nernst(D, z, n)
    e = constants.ELEMENTARY_CHARGE
    want = (100 * e**2 * 1e-9 + 100 * e**2 * 2e-10) / (
        1e-25 * constants.BOLTZMANN * 300.0
    )
    np.testing.assert_allclose(got, want, rtol=1e-12)
