"""The ``skip_frames``/``max_frames`` stream window: text and cached
block seeks, and the entry point over a window."""

import os

import numpy as np
import pandas as pd
import pytest

from mdproptools_tpu.io.lammps_dump import (
    iter_trajectory_blocks,
    read_trajectory,
)
from mdproptools_tpu.structural.rdf_cn import calc_atomic_rdf

MASS = [16.0, 12.01, 1.008, 14.01, 32.06, 16.0, 12.01, 19.0, 24.305]
RELATIONS = [[8, 8], [1, 4]]


def test_skip_frames_text_matches_slice(dump_pattern):
    full = read_trajectory(dump_pattern, columns=["id", "type", "x"])
    blocks = list(iter_trajectory_blocks(
        dump_pattern, columns=["id", "type", "x"], skip_frames=3,
        max_frames=2, cache=False))
    got = np.concatenate([b.data for b in blocks])
    np.testing.assert_array_equal(got, full.data[3:5])
    ts = np.concatenate([b.timesteps for b in blocks])
    np.testing.assert_array_equal(ts, full.timesteps[3:5])


def test_skip_frames_past_end_is_empty(dump_pattern):
    blocks = list(iter_trajectory_blocks(
        dump_pattern, columns=["id", "type", "x"], skip_frames=99,
        cache=False))
    assert blocks == []


def test_skip_frames_cache_matches_text(dump_pattern, tmp_path):
    from mdproptools_tpu.io.cache import build_cache, load_meta

    cdir = str(tmp_path / "cache")
    build_cache(dump_pattern, cdir, columns=["id", "type", "x", "y", "z"])
    meta = load_meta(dump_pattern, cdir)
    assert meta is not None
    from mdproptools_tpu.io.cache import iter_cached_blocks

    got = np.concatenate([
        b.data for b in iter_cached_blocks(
            meta, columns=["id", "type", "x", "y", "z"], skip_frames=2,
            max_frames=3)
    ])
    full = read_trajectory(dump_pattern,
                           columns=["id", "type", "x", "y", "z"])
    np.testing.assert_array_equal(got, full.data[2:5])


def test_entry_point_frame_window(dump_pattern, tmp_path):
    """calc_atomic_rdf over a [skip, skip+max) window == the same
    entry point over a trajectory holding only those frames."""
    import glob

    df_win = calc_atomic_rdf(
        8.0, 0.1, 9, MASS, RELATIONS, dump_pattern,
        save_mode=False, skip_frames=2, max_frames=3)
    files = sorted(glob.glob(dump_pattern),
                   key=lambda f: int(f.split(".")[-2]))[2:5]
    for f in files:
        os.symlink(f, tmp_path / os.path.basename(f))
    df_sub = calc_atomic_rdf(
        8.0, 0.1, 9, MASS, RELATIONS, str(tmp_path / "dump.nvt.*.dump"),
        save_mode=False)
    pd.testing.assert_frame_equal(df_win, df_sub)
