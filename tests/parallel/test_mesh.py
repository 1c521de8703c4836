"""Multi-device sharding on the virtual 8-device CPU mesh: sharded
results must equal the single-device path exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from mdproptools_tpu.ops import pairs as pair_ops
from mdproptools_tpu.parallel import (
    make_mesh,
    sharded_charge_flux,
    sharded_msd_per_type,
    sharded_rdf_hist,
)


@pytest.fixture(scope="module")
def synthetic():
    rng = np.random.default_rng(21)
    T, n, box = 8, 256, 12.0
    pos = rng.uniform(0, box, size=(T, n, 3))
    codes = rng.integers(1, 4, size=n)
    lengths = np.full((T, 3), box)
    return pos, codes, lengths


def test_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_rdf_matches_single(synthetic):
    pos, codes, lengths = synthetic
    lay = pair_ops.build_type_layout(codes, 3)
    pp = pair_ops.gather_padded(jnp.asarray(pos), lay)  # (T, Np, 3)
    mesh = make_mesh(n_frames_axis=4, n_atoms_axis=2)
    got = np.asarray(
        sharded_rdf_hist(pp, lengths, lay, 0.1, 50, 5.0, mesh,
                         dtype=jnp.float64)
    )
    want = np.zeros_like(got)
    for t in range(pos.shape[0]):
        want += np.asarray(
            pair_ops.pair_hist(pp[t], pp[t], lay, lay,
                               jnp.asarray(lengths[t]), 0.1, 50, 5.0,
                               exclude_self=True, dtype=jnp.float64)
        )
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_sharded_msd_matches_single(synthetic):
    pos, codes, lengths = synthetic
    mesh = make_mesh(n_frames_axis=8, n_atoms_axis=1)
    tidx = jnp.asarray(codes - 1)
    got = np.asarray(
        sharded_msd_per_type(jnp.asarray(pos), jnp.asarray(pos[0]),
                             tidx, 3, mesh)
    )
    disp2 = ((pos - pos[0]) ** 2).sum(axis=2)
    for k in range(3):
        sel = codes - 1 == k
        np.testing.assert_allclose(got[:, k], disp2[:, sel].mean(axis=1),
                                   rtol=1e-12)


def test_sharded_charge_flux_matches_single(synthetic):
    pos, codes, lengths = synthetic
    rng = np.random.default_rng(22)
    T, n = pos.shape[:2]
    vel = rng.normal(size=(T, n, 3))
    masses = rng.uniform(1, 20, size=n)
    # molecules of 4 atoms each
    mol_index = np.repeat(np.arange(n // 4), 4)
    qmol = rng.normal(size=n // 4)
    type_index = np.tile([0, 1], n // 8)
    mesh = make_mesh(n_frames_axis=4, n_atoms_axis=2)
    got = np.asarray(
        sharded_charge_flux(
            jnp.asarray(vel), (jnp.asarray(masses), jnp.asarray(qmol)),
            jnp.asarray(mol_index), jnp.asarray(type_index), n // 4, 2,
            mesh,
        )
    )
    # oracle
    want = np.zeros((T, 2, 3))
    for t in range(T):
        M = n // 4
        mtot = np.zeros(M)
        np.add.at(mtot, mol_index, masses)
        vcom = np.zeros((M, 3))
        for ax in range(3):
            w = np.zeros(M)
            np.add.at(w, mol_index, masses * vel[t, :, ax])
            vcom[:, ax] = w / mtot
        for k in range(2):
            want[t, k] = (vcom[type_index == k]
                          * qmol[type_index == k, None]).sum(axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def _kernel_want(pos, codes, lengths, relations, dtype, with_full=True):
    lay = pair_ops.build_type_layout(codes, 3)
    pp = pair_ops.gather_padded(jnp.asarray(pos), lay)
    want_full = want_rels = 0
    for t in range(pos.shape[0]):
        hist = pair_ops.pair_hist(
            pp[t], pp[t], lay, lay, jnp.asarray(lengths[t]), 0.1, 128,
            6.0, True, dtype=dtype)
        wf, wr = pair_ops.project_relations(hist, relations, with_full)
        if with_full:
            want_full = want_full + np.asarray(wf)
        want_rels = want_rels + np.asarray(wr)
    return want_full, want_rels


def test_sharded_triangle_matches_single():
    """Row-sharded TRIANGLE kernel (row tile <= column tile across
    shards, Pallas interpret mode) in float64 on a (frames, atoms) =
    (2, 4) mesh must equal the single-device float64 XLA histogram
    exactly, without the full g(r) block."""
    from mdproptools_tpu.parallel import sharded_rdf_relations

    rng = np.random.default_rng(31)
    T, n, box = 2, 700, 14.0
    pos = rng.uniform(0, box, (T, n, 3))
    codes = rng.integers(1, 4, n)
    lengths = np.full((T, 3), box)
    relations = np.array([[1, 2], [2, 1], [3, 3]])
    mesh = make_mesh(n_frames_axis=2, n_atoms_axis=4)
    full, rels = sharded_rdf_relations(
        jnp.asarray(pos), codes - 1, relations - 1, lengths,
        bin_size=0.1, n_bins=128, r_cut=6.0, mesh=mesh, with_full=False,
        dtype=jnp.float64, interpret=True,
    )
    assert full is None
    _, want_rels = _kernel_want(pos, codes, lengths, relations,
                                jnp.float64, with_full=False)
    np.testing.assert_array_equal(np.asarray(rels), want_rels)


def test_sharded_rdf_relations_matches_single():
    """Frame+row-sharded kernel path (ORB sort + tile cull + triangle,
    interpret mode) on the virtual mesh must equal the single-device
    scatter projection exactly."""
    from mdproptools_tpu.parallel import sharded_rdf_relations

    rng = np.random.default_rng(33)
    T, n, box = 4, 700, 14.0
    pos = rng.uniform(0, box, (T, n, 3)).astype(np.float32)
    codes = rng.integers(1, 4, n)
    lengths = np.full((T, 3), box, np.float32)
    relations = np.array([[1, 2], [3, 3]])
    mesh = make_mesh(n_frames_axis=4, n_atoms_axis=2)
    full, rels = sharded_rdf_relations(
        jnp.asarray(pos), codes - 1, relations - 1, lengths,
        bin_size=0.1, n_bins=128, r_cut=6.0, mesh=mesh, with_full=True,
        dtype=jnp.float32, interpret=True,
    )
    want_full, want_rels = _kernel_want(pos, codes, lengths, relations,
                                        jnp.float32)
    np.testing.assert_array_equal(np.asarray(full), want_full)
    np.testing.assert_array_equal(np.asarray(rels), want_rels)


def test_entry_point_frame_mesh(dump_pattern, monkeypatch):
    """calc_atomic_rdf with a forced ("frames",) device mesh (the
    transparent multi-chip path) must match the single-device result to
    summation-reorder tolerance."""
    import glob
    import os

    import numpy as np
    from jax.sharding import Mesh

    from mdproptools_tpu.structural import rdf_cn

    files = sorted(glob.glob(dump_pattern))[:6]
    base = os.path.commonprefix(files).rsplit("/", 1)[0]
    pattern = files[0].replace(".0.dump", ".*.dump") if False else None
    # use a 6-file subset via symlinks
    import tempfile
    d = tempfile.mkdtemp(prefix="meshrdf_")
    for i, f in enumerate(files):
        os.symlink(f, f"{d}/dump.{i}.dump")
    kw = dict(r_cut=8.0, bin_size=0.4, num_types=9,
              mass=[16.0, 12.01, 1.008, 14.01, 32.06, 16.0, 12.01, 19.0,
                    24.305],
              partial_relations=[[8], [9]], save_mode=False,
              precision="strict")
    want = rdf_cn.calc_atomic_rdf(filename=f"{d}/dump.*.dump", **kw)
    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("frames",))
    monkeypatch.setattr(rdf_cn, "_FORCE_FRAMES_MESH", mesh)
    got = rdf_cn.calc_atomic_rdf(filename=f"{d}/dump.*.dump", **kw)
    # 6 frames pad to 8 (zero-weight); psum reorders f64 sums
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (4, 2)])
def test_entry_point_2d_mesh_rel_kernel(tmp_path, monkeypatch, shape):
    """calc_atomic_rdf pinned to a ("frames",) or ("frames", "atoms")
    mesh on the kernel path (interpret mode on the virtual CPU devices)
    must match the single-device kernel result; with an atoms axis it
    must route through the frame+row-sharded runner."""
    from helpers import write_traj

    from mdproptools_tpu.ops import backend
    from mdproptools_tpu.structural import rdf_cn

    rng = np.random.default_rng(61)
    n, box, T = 1500, 16.0, 4
    codes = rng.integers(1, 4, n)
    frames = []
    for t in range(T):
        xyz = rng.uniform(0, box, (n, 3))
        frames.append(np.column_stack(
            [np.arange(1, n + 1), codes, xyz]))
    pattern = write_traj(str(tmp_path), list(range(T)), 0.0, box,
                         ["id", "type", "x", "y", "z"], frames)
    kw = dict(r_cut=6.0, bin_size=0.1, num_types=3, mass=[1.0, 2.0, 3.0],
              partial_relations=[[1, 3], [2, 3]], save_mode=False,
              precision="fast")
    monkeypatch.setattr(backend, "_FORCE", "gpu")
    rdf_cn._STEP_CACHE.clear()
    want = rdf_cn.calc_atomic_rdf(filename=pattern, **kw)

    frames_ax, atoms_ax = shape
    devs = np.asarray(jax.devices()[:frames_ax * atoms_ax])
    if atoms_ax == 1:
        mesh = Mesh(devs, axis_names=("frames",))
    else:
        mesh = Mesh(devs.reshape(frames_ax, atoms_ax),
                    axis_names=("frames", "atoms"))
    rdf_cn.set_mesh(mesh)
    try:
        rdf_cn._STEP_CACHE.clear()
        got = rdf_cn.calc_atomic_rdf(filename=pattern, **kw)
        engaged = any(
            any(isinstance(k, tuple) and k and k[0] == "rel-sharded"
                for k in entry[-1])
            for entry in rdf_cn._STEP_CACHE.values())
        assert engaged == (atoms_ax > 1), "wrong runner for the mesh"
    finally:
        rdf_cn.set_mesh(None)
        rdf_cn._STEP_CACHE.clear()
    # float64 exact-bins counts; only the psum order of the normalized
    # float64 rows differs
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(),
                               rtol=1e-12, atol=0)


def test_set_mesh_validates_axes():
    from jax.sharding import Mesh

    from mdproptools_tpu.structural import rdf_cn

    bad = Mesh(np.asarray(jax.devices()[:2]), axis_names=("rows",))
    with pytest.raises(ValueError, match="mesh axes"):
        rdf_cn.set_mesh(bad)
    ok = Mesh(np.asarray(jax.devices()[:2]), axis_names=("frames",))
    rdf_cn.set_mesh(ok)
    try:
        assert rdf_cn._auto_mesh(1000, 4) is ok
    finally:
        rdf_cn.set_mesh(None)


def test_sweep_rdf_frames_mesh(tmp_path, monkeypatch):
    """sweep_rdf's single compiled block program must frame-shard over
    the active mesh with exact f64 parity."""
    from helpers import write_traj

    from mdproptools_tpu.parallel.sweep import sweep_rdf
    from mdproptools_tpu.structural import rdf_cn

    rng = np.random.default_rng(67)
    n, box = 300, 12.0
    codes = rng.integers(1, 4, n)
    patterns = []
    for k in range(2):
        d = tmp_path / f"traj{k}"
        d.mkdir()
        frames = [
            np.column_stack([np.arange(1, n + 1), codes,
                             rng.uniform(0, box, (n, 3))])
            for _ in range(3)
        ]
        patterns.append(write_traj(str(d), list(range(3)), 0.0, box,
                                   ["id", "type", "x", "y", "z"], frames))
    kw = dict(r_cut=5.0, bin_size=0.1, num_types=3, mass=[1.0, 2.0, 3.0],
              partial_relations=[[1], [2]], precision="strict")
    want = sweep_rdf(patterns, **kw)
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("frames",))
    monkeypatch.setattr(rdf_cn, "_FORCE_FRAMES_MESH", mesh)
    got = sweep_rdf(patterns, **kw)
    np.testing.assert_allclose(got.drop(columns="trajectory").to_numpy(),
                               want.drop(columns="trajectory").to_numpy(),
                               rtol=1e-12, atol=0)
