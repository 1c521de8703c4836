"""Kernel-level parity: the ordered-pair histogram/count reformulation
must reproduce the reference's upper-triangle loop semantics exactly
(float64, strict mode)."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import oracle  # noqa: E402

from mdproptools_tpu.ops import pairs as pair_ops  # noqa: E402
from mdproptools_tpu.ops.pbc import minimum_image  # noqa: E402


@pytest.fixture(scope="module")
def synthetic():
    rng = np.random.default_rng(7)
    n, box = 257, 11.0
    pos = rng.uniform(0, box, size=(n, 3))
    codes = rng.integers(1, 4, size=n)  # 3 types, 1-based
    lengths = np.array([box, box, box])
    return pos, codes, lengths


@pytest.fixture(scope="module")
def dense():
    """1,500 atoms, 10 A cutoff: at fine bins enough pairs sit within a
    float32 rounding of a bin edge that an FMA-contracted r^2 (XLA's CPU
    default) moves some of them."""
    rng = np.random.default_rng(1)
    lengths = np.array([25.0, 23.0, 27.0])
    pos = rng.uniform(0, 1, (1500, 3)) * lengths
    return pos, rng.integers(1, 4, 1500), lengths


def test_minimum_image_matches_reference_wrap():
    rng = np.random.default_rng(0)
    d = rng.uniform(-14.9, 14.9, size=(1000, 3))
    L = np.array([10.0, 12.0, 8.0])
    got = np.asarray(minimum_image(jnp.asarray(d), jnp.asarray(L)))
    want = np.stack([oracle.min_image(d[:, a], L[a]) for a in range(3)], axis=1)
    np.testing.assert_array_equal(got, want)


def test_type_layout_roundtrip(synthetic):
    pos, codes, _ = synthetic
    lay = pair_ops.build_type_layout(codes, 3)
    assert lay.n_padded % pair_ops.LANE == 0
    # every original atom appears exactly once
    real = lay.perm[lay.perm >= 0]
    assert sorted(real.tolist()) == list(range(len(codes)))
    # slots carry the right code
    for slot, orig in enumerate(lay.perm):
        if orig >= 0:
            assert lay.codes[slot] == codes[orig] - 1
    # chunks are single-typed
    cc = lay.codes.reshape(-1, pair_ops.LANE)
    for row in cc:
        vals = set(row.tolist()) - {-1}
        assert len(vals) <= 1


def test_pair_hist_matches_rdf_loop(synthetic):
    pos, codes, lengths = synthetic
    r_cut, bin_size = 5.0, 0.1
    n_bins = int(r_cut / bin_size)
    relations = [(1, 2), (2, 2), (3, 1)]

    lay = pair_ops.build_type_layout(codes, 3)
    pp = pair_ops.gather_padded(jnp.asarray(pos), lay)
    hist = np.asarray(
        pair_ops.pair_hist(
            pp, pp, lay, lay, jnp.asarray(lengths), bin_size, n_bins, r_cut,
            exclude_self=True, dtype=jnp.float64,
        )
    )
    full_got = hist.sum(axis=(0, 1))
    part_got = np.stack([hist[a - 1, b - 1] for a, b in relations])

    full_want, part_want = oracle.rdf_loop(
        pos, codes, lengths, r_cut, bin_size, relations
    )
    np.testing.assert_array_equal(full_got, full_want)
    np.testing.assert_array_equal(part_got, part_want)


@pytest.mark.parametrize("bin_size", [0.1, 0.01])
def test_pair_hist_float32_matches_rdf_loop(dense, bin_size):
    """The float32 XLA path bins as the IEEE float32 reference loop does
    (no FMA contraction)."""
    pos, codes, lengths = dense
    relations = [(1, 2), (2, 2), (3, 1)]
    n_bins = int(10.0 / bin_size)
    lay = pair_ops.build_type_layout(codes, 3)
    pp = pair_ops.gather_padded(jnp.asarray(pos, jnp.float32), lay)
    hist = np.asarray(pair_ops.pair_hist(
        pp, pp, lay, lay, jnp.asarray(lengths, jnp.float32), bin_size,
        n_bins, 10.0, True, dtype=jnp.float32))
    full_want, part_want = oracle.rdf_loop(
        pos, codes, lengths, 10.0, bin_size, relations, dtype=np.float32)
    np.testing.assert_array_equal(hist.sum(axis=(0, 1)), full_want)
    np.testing.assert_array_equal(
        np.stack([hist[a - 1, b - 1] for a, b in relations]), part_want)


def test_pair_count_float32_matches_cn_loop(dense):
    pos, codes, lengths = dense
    relations = [(1, 2), (2, 2), (3, 1)]
    r_cuts = [2.5, 3.5, 4.5]
    lay = pair_ops.build_type_layout(codes, 3)
    pp = pair_ops.gather_padded(jnp.asarray(pos, jnp.float32), lay)
    got = np.asarray(pair_ops.pair_count_within(
        pp, pp, lay, lay, jnp.asarray(lengths, jnp.float32),
        np.asarray(relations), np.asarray(r_cuts), exclude_self=True,
        dtype=jnp.float32))
    want = oracle.cn_loop(pos, codes, lengths, r_cuts, relations,
                          dtype=np.float32)
    np.testing.assert_array_equal(got, want)


def test_pair_count_matches_cn_loop(synthetic):
    pos, codes, lengths = synthetic
    relations = [(1, 2), (2, 2), (3, 1)]
    r_cuts = [2.5, 3.5, 4.5]
    lay = pair_ops.build_type_layout(codes, 3)
    pp = pair_ops.gather_padded(jnp.asarray(pos), lay)
    got = np.asarray(
        pair_ops.pair_count_within(
            pp, pp, lay, lay, jnp.asarray(lengths),
            np.asarray(relations), np.asarray(r_cuts),
            exclude_self=True, dtype=jnp.float64,
        )
    )
    want = oracle.cn_loop(pos, codes, lengths, r_cuts, relations)
    np.testing.assert_array_equal(got, want)


def test_cross_hist_matches_mol_loop(synthetic):
    pos, codes, lengths = synthetic
    rng = np.random.default_rng(3)
    n_mols = 41
    mpos = rng.uniform(0, lengths[0], size=(n_mols, 3))
    mcodes = rng.integers(1, 3, size=n_mols)
    r_cut, bin_size = 4.0, 0.05
    n_bins = int(r_cut / bin_size)
    relations = [(1, 1), (2, 2), (3, 1)]

    lay_a = pair_ops.build_type_layout(codes, 3)
    lay_m = pair_ops.build_type_layout(mcodes, 2)
    pa = pair_ops.gather_padded(jnp.asarray(pos), lay_a)
    pm = pair_ops.gather_padded(jnp.asarray(mpos), lay_m)
    hist = np.asarray(
        pair_ops.pair_hist(
            pa, pm, lay_a, lay_m, jnp.asarray(lengths), bin_size, n_bins,
            r_cut, exclude_self=False, dtype=jnp.float64,
        )
    )
    part_got = np.stack([hist[a - 1, b - 1] for a, b in relations])
    part_want = oracle.rdf_mol_loop(
        pos, codes, mpos, mcodes, lengths, r_cut, bin_size, relations
    )
    np.testing.assert_array_equal(part_got, part_want)

    r_cuts = [1.5, 2.5, 3.5]
    got = np.asarray(
        pair_ops.pair_count_within(
            pa, pm, lay_a, lay_m, jnp.asarray(lengths),
            np.asarray(relations), np.asarray(r_cuts),
            exclude_self=False, dtype=jnp.float64,
        )
    )
    # reference cn_mol_loop counts one direction only (head == nta1)
    want = oracle.cn_mol_loop(pos, codes, mpos, mcodes, lengths, r_cuts, relations)
    np.testing.assert_array_equal(got, want)


def test_shell_mask(synthetic):
    pos, codes, lengths = synthetic
    a = pos[codes == 1]
    b = pos[codes == 2]
    got = np.asarray(
        pair_ops.shell_mask(jnp.asarray(a), jnp.asarray(b),
                            jnp.asarray(lengths), 1.0, 3.0)
    )
    want = np.zeros_like(got, bool)
    for i in range(a.shape[0]):
        rsq = oracle.rsq_row(a[i], b, lengths)
        want[i] = (rsq > 1.0) & (rsq <= 9.0)
    np.testing.assert_array_equal(got, want)
