"""Dump parser validated against raw file text of the bundled dataset."""

import glob
import os

import numpy as np
import pytest

from mdproptools_tpu.io.lammps_dump import (
    parse_lammps_dumps,
    read_trajectory,
)


def test_single_frame_fields(mg_tfsi_dme_dir):
    f = os.path.join(mg_tfsi_dme_dir, "dump.nvt.0.dump")
    frames = list(parse_lammps_dumps(f))
    assert len(frames) == 1
    fr = frames[0]
    assert fr.timestep == 0
    assert fr.natoms == 10479
    np.testing.assert_allclose(
        fr.box.bounds[0], [4.0882558190751794e-01, 4.9591174418091420e01]
    )
    assert fr.columns[:5] == ["id", "mol", "type", "mass", "q"]
    # rows sorted by id
    ids = fr.col("id")
    assert ids[0] == 1 and ids[-1] == 10479
    assert np.all(np.diff(ids) == 1)
    # spot-check one raw line: atom id 3429 from the file head
    i = int(np.where(ids == 3429)[0][0])
    assert fr.col("mol")[i] == 215
    assert fr.col("type")[i] == 2
    np.testing.assert_allclose(fr.col("mass")[i], 12.01)
    np.testing.assert_allclose(
        fr.cols(["x", "y", "z"])[i], [5.82479, 3.77447, 4.46724]
    )
    np.testing.assert_allclose(
        fr.cols(["ix", "iy", "iz"])[i], [1, 0, 1]
    )


def test_glob_sorted_by_timestep(mg_tfsi_dme_dir):
    pattern = os.path.join(mg_tfsi_dme_dir, "dump.nvt.*.dump")
    gen = parse_lammps_dumps(pattern)
    t0 = next(gen).timestep
    t1 = next(gen).timestep
    t2 = next(gen).timestep
    assert (t0, t1, t2) == (0, 50000, 100000)


def test_read_trajectory_stack(mg_tfsi_dme_dir):
    pattern = os.path.join(mg_tfsi_dme_dir, "dump.nvt.*.dump")
    traj = read_trajectory(pattern, columns=["id", "type", "x", "y", "z"],
                           max_frames=3)
    assert traj.data.shape == (3, 10479, 5)
    assert traj.timesteps.tolist() == [0, 50000, 100000]
    assert traj.box_lengths.shape == (3, 3)
    np.testing.assert_allclose(traj.box_lengths[0, 0],
                               4.9591174418091420e01 - 4.0882558190751794e-01)
    # types constant across frames after id sort
    assert np.array_equal(traj.col("type")[0], traj.col("type")[2])


def test_unknown_column_filter_raises(mg_tfsi_dme_dir):
    """A typo in the requested columns must fail at parse time with the
    offending names, not later as a KeyError far from the cause."""
    pattern = os.path.join(mg_tfsi_dme_dir, "dump.nvt.0.dump")
    with pytest.raises(ValueError, match=r"\['xq'\].*not present"):
        read_trajectory(pattern, columns=["id", "xq"])


def test_column_masked_parse_bit_exact(mg_tfsi_dme_dir):
    """The column-masked native parse (skipped tokens byte-scanned, kept
    tokens converted) must be BIT-identical to full parse + select, in
    any requested order, with the pandas fallback agreeing too."""
    pattern = os.path.join(mg_tfsi_dme_dir, "dump.nvt.0.dump")
    full = read_trajectory(pattern)
    for cols in (["id", "type", "x", "y", "z"], ["vx", "id"], ["q"]):
        pruned = read_trajectory(pattern, columns=cols)
        np.testing.assert_array_equal(pruned.data, full.cols(cols))
        assert pruned.columns == list(cols)
    # the ctypes wrapper path directly vs numpy select
    from mdproptools_tpu.io import _native

    with open(pattern) as fh:
        text = fh.read()
    body = text.split("ITEM: ATOMS")[1].split("\n", 1)[1]
    got = _native.parse_floats_cols(body, 19, [0, 2, 5, 6, 7])
    if got is not None:  # native lib present
        full_tab = _native.parse_floats(body, 19)
        np.testing.assert_array_equal(got, full_tab[:, [0, 2, 5, 6, 7]])
        # requested (non-file) order is honored; duplicates rejected
        np.testing.assert_array_equal(
            _native.parse_floats_cols(body, 19, [5, 0]),
            full_tab[:, [5, 0]])
        import pytest as _pytest
        with _pytest.raises(ValueError):
            _native.parse_floats_cols(body, 19, [1, 1])


def test_multi_frame_single_file(tmp_path):
    """Several frames concatenated into ONE dump file (LAMMPS default)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from helpers import write_dump

    import numpy as np

    rng = np.random.default_rng(0)
    parts = []
    for ts in (0, 100, 200):
        data = np.zeros((4, 5))
        data[:, 0] = np.arange(1, 5)
        data[:, 1] = [1, 1, 2, 2]
        data[:, 2:5] = rng.uniform(0, 5, (4, 3))
        p = tmp_path / f"part{ts}"
        write_dump(str(p), ts, 0.0, 5.0, ["id", "type", "x", "y", "z"], data)
        parts.append(p.read_text())
    combined = tmp_path / "multi.dump"
    combined.write_text("".join(parts))
    traj = read_trajectory(str(combined))
    assert traj.n_frames == 3
    assert traj.timesteps.tolist() == [0, 100, 200]


def test_triclinic_box_rejected(tmp_path):
    """Triclinic dumps must fail loudly (min-image math assumes
    orthogonal cells; LAMMPS tilt-inflates the bounds)."""
    text = (
        "ITEM: TIMESTEP\n0\nITEM: NUMBER OF ATOMS\n1\n"
        "ITEM: BOX BOUNDS xy xz yz pp pp pp\n"
        "0.0 10.0 1.0\n0.0 10.0 0.0\n0.0 10.0 0.0\n"
        "ITEM: ATOMS id type x y z \n1 1 1.0 1.0 1.0 \n"
    )
    p = tmp_path / "tri.dump"
    p.write_text(text)
    import pytest as _pytest

    with _pytest.raises(ValueError, match="triclinic"):
        read_trajectory(str(p))


def test_block_byte_cap():
    """Wide-column / large-N streams shrink frames-per-block so one
    stacked buffer stays under BLOCK_TARGET_BYTES (floor 8 frames);
    small systems keep the requested block size."""
    from mdproptools_tpu.io.lammps_dump import (
        BLOCK_TARGET_BYTES,
        _block_frames_for,
    )

    assert _block_frames_for(10_479, 5, 128) == 128  # bundled: under cap
    b = _block_frames_for(41_916, 12, 128)  # composite at north star
    assert 8 <= b < 128
    assert b * 41_916 * 12 * 8 <= BLOCK_TARGET_BYTES
    assert _block_frames_for(10_000_000, 13, 128) == 8  # floor


def test_iter_trajectory_blocks_matches_read(dump_pattern):
    from mdproptools_tpu.io.lammps_dump import (
        iter_trajectory_blocks,
        read_trajectory,
    )

    n_avail = len(glob.glob(dump_pattern))
    n_want = min(10, n_avail)  # bundled subset has 7 frames
    full = read_trajectory(dump_pattern, columns=["id", "type", "x"],
                           max_frames=n_want)
    blocks = []
    seen = 0
    for blk in iter_trajectory_blocks(dump_pattern,
                                      columns=["id", "type", "x"],
                                      block_frames=3, max_frames=n_want):
        assert blk.n_frames <= 3
        blocks.append(blk)
        seen += blk.n_frames
    assert seen == n_want
    data = np.concatenate([b.data for b in blocks])
    ts = np.concatenate([b.timesteps for b in blocks])
    np.testing.assert_array_equal(data, full.data)
    np.testing.assert_array_equal(ts, full.timesteps)


def test_element_string_column(tmp_path):
    """Dumps with a non-numeric ``element`` column parse into Frame
    string data (pymatgen parity; reference consumer
    cluster_analysis.py:132-133); numeric Trajectory stacking refuses
    string columns with a clear error."""
    import pytest

    from helpers import write_dump_mixed
    from mdproptools_tpu.io.lammps_dump import (
        parse_lammps_dumps,
        read_trajectory,
    )

    p = tmp_path / "dump.el.0.dump"
    # deliberately unsorted ids to exercise string-row reordering
    rows = [
        [2, 1, "C", 1.0, 2.0, 3.0],
        [1, 2, "O", 4.0, 5.0, 6.0],
        [3, 1, "C", 7.0, 8.0, 9.0],
    ]
    write_dump_mixed(str(p), 0, 0.0, 10.0,
                     ["id", "type", "element", "x", "y", "z"], rows)
    fr = next(parse_lammps_dumps(str(p)))
    assert fr.has("element")
    np.testing.assert_array_equal(fr.col("element"),
                                  np.array(["O", "C", "C"]))
    np.testing.assert_array_equal(fr.col("id"), [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(fr.col("x"), [4.0, 1.0, 7.0])
    assert "element" not in fr.columns  # numeric columns only
    df = fr.to_dataframe()
    assert list(df["element"]) == ["O", "C", "C"]
    # numeric-only trajectory stacking works; requesting the string
    # column is a clear error
    traj = read_trajectory(str(p), columns=["id", "x"])
    assert traj.data.shape == (1, 3, 2)
    with pytest.raises(ValueError, match="string-valued"):
        read_trajectory(str(p), columns=["element", "x"])


def test_block_buffer_pool_reuse_and_pinning():
    """The stacked-block buffer pool reuses a buffer only when nothing
    outside the pool references it; a retained Trajectory (or any view
    into it) pins its buffer and a fresh one is allocated instead."""
    from mdproptools_tpu.io.lammps_dump import _BlockBufferPool

    pool = _BlockBufferPool()
    a = pool.get((4, 8, 3))
    a.fill(1.0)
    b = pool.get((4, 8, 3))  # `a` is alive -> must not be recycled
    assert b is not a
    view = a[0]  # a view keeps the base pinned even after `a` dies
    del a
    c = pool.get((4, 8, 3))
    assert c is not view.base
    del view, b, c
    d = pool.get((4, 8, 3))
    e = pool.get((2, 8, 3))  # different shape never matches
    assert e.shape == (2, 8, 3) and d.shape == (4, 8, 3)


def test_malloc_tuning_applied_or_opted_out(monkeypatch):
    """tune_malloc_for_streaming applies on glibc hosts (the package
    import already ran it) and respects the opt-out env var in a fresh
    state."""
    from mdproptools_tpu.utilities import host

    assert host._applied  # package import tuned this process
    monkeypatch.setattr(host, "_applied", False)
    monkeypatch.setenv("MDPT_NO_MALLOC_TUNING", "1")
    assert host.tune_malloc_for_streaming() is False


def test_shuffled_ids_sort_matches_ordered(tmp_path):
    """The parser skips the argsort+gather when ids arrive ascending
    (the fast path for post-processed/replicated dumps); a row-shuffled
    copy of the same frame must parse to the IDENTICAL Trajectory
    through the gather path."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from helpers import write_dump

    import numpy as np

    rng = np.random.default_rng(3)
    n = 37
    data = np.zeros((n, 5))
    data[:, 0] = np.arange(1, n + 1)
    data[:, 1] = rng.integers(1, 4, n)
    data[:, 2:5] = rng.uniform(0, 5, (n, 3))
    write_dump(str(tmp_path / "sorted.dump"), 0, 0.0, 5.0,
               ["id", "type", "x", "y", "z"], data)
    write_dump(str(tmp_path / "shuffled.dump"), 0, 0.0, 5.0,
               ["id", "type", "x", "y", "z"],
               data[rng.permutation(n)])
    a = read_trajectory(str(tmp_path / "sorted.dump"))
    b = read_trajectory(str(tmp_path / "shuffled.dump"))
    np.testing.assert_array_equal(a.data, b.data)


def test_cols_as_matches_cols_astype(dump_pattern):
    """Trajectory.cols_as fuses select+cast in one pass; values must be
    bit-identical to .cols(...).astype(...)."""
    import numpy as np

    traj = read_trajectory(dump_pattern, columns=["id", "x", "y", "z"],
                           max_frames=3)
    fused = traj.cols_as(["x", "y", "z"], np.float32)
    two_pass = traj.cols(["x", "y", "z"]).astype(np.float32)
    assert fused.dtype == np.float32
    np.testing.assert_array_equal(fused, two_pass)


def test_prefetch_iter_early_exit_stops_feeder():
    """Abandoning a prefetch_iter mid-stream (consumer break/exception)
    must stop the feed thread instead of leaving it blocked on q.put
    holding parsed blocks."""
    import threading
    import time

    from mdproptools_tpu.io.lammps_dump import prefetch_iter

    n_before = threading.active_count()
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    it = prefetch_iter(gen(), depth=2)
    assert next(it) == 0
    it.close()  # GeneratorExit -> finally: stop + drain
    deadline = time.time() + 5.0
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= n_before
    assert len(produced) < 1000  # feeder stopped early, not exhausted


def test_native_parser_unterminated_ndarray_view():
    """A uint8 ndarray view whose final token ends exactly at the view
    boundary (no trailing NUL) must parse the strtod-fallback token
    (exponent form) correctly and not scan past the end."""
    import numpy as np

    from mdproptools_tpu.io import _native

    raw = np.frombuffer(b"1.0 2.5e-3GARBAGE4.0 5.0", np.uint8)
    view = raw[:10]  # exactly "1.0 2.5e-3"
    out = _native.parse_floats(view, 2)
    if out is None:  # native lib unavailable: nothing to pin
        return
    np.testing.assert_array_equal(out, [[1.0, 2.5e-3]])
