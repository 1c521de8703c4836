"""Dispatch of the ``rdf_cn`` pair paths, driven on CPU.

The GPU pair kernel normally engages only on a card; forcing
``ops.backend._FORCE = "gpu"`` runs it in Pallas interpret mode, so the
kernel-path wiring (per-frame ORB sort, relation projection, per-frame
normalization, float64 exact binning) is pinned against the plain XLA
path bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest

from mdproptools_tpu.ops import backend
from mdproptools_tpu.structural import rdf_cn

RELS = np.array([[1, 2], [3, 3]])


@pytest.fixture
def system():
    rng = np.random.default_rng(41)
    T, n, box = 3, 700, 14.0
    pos = rng.uniform(0, box, (T, n, 3))
    codes = rng.integers(1, 4, n)
    lengths = np.full((T, 3), box)
    counts = np.bincount(codes - 1, minlength=3).astype(np.float64)
    return pos, codes, lengths, counts


def _run(pos, codes, lengths, counts, **kw):
    return rdf_cn._rdf_mean(
        pos, codes, 3, lengths, 0.1, 128, 6.0, RELS, counts, counts,
        exclude_self=True, with_full=True, dtype=jnp.float32, **kw)


@pytest.mark.parametrize("spatial_sort", [True, False])
def test_forced_kernel_matches_scatter(system, spatial_sort, monkeypatch):
    # exact_bins=False: the float32 kernel is bit-equal to the float32
    # XLA path (the exact-bins upgrade is pinned separately by
    # test_forced_rel_exact_bins_matches_strict)
    pos, codes, lengths, counts = system
    want_full, want_rels = _run(pos, codes, lengths, counts)
    monkeypatch.setattr(backend, "_FORCE", "gpu")
    got_full, got_rels = _run(pos, codes, lengths, counts,
                              spatial_sort=spatial_sort, exact_bins=False)
    np.testing.assert_array_equal(np.asarray(got_full),
                                  np.asarray(want_full))
    np.testing.assert_array_equal(np.asarray(got_rels),
                                  np.asarray(want_rels))


def test_forced_rel_exact_bins_matches_strict(system, monkeypatch):
    """The exactness contract: fast mode through the kernel's exact-bins
    path returns BIT-EQUAL g(r) to strict (float64) mode — every pair
    binned as the float64 reference loop, normalization in float64."""
    pos, codes, lengths, counts = system
    strict_full, strict_rels = rdf_cn._rdf_mean(
        pos, codes, 3, lengths, 0.1, 128, 6.0, RELS, counts, counts,
        exclude_self=True, with_full=True, dtype=jnp.float64)
    monkeypatch.setattr(backend, "_FORCE", "gpu")
    got_full, got_rels = _run(pos, codes, lengths, counts,
                              exact_bins=True)
    np.testing.assert_array_equal(np.asarray(got_full),
                                  np.asarray(strict_full))
    np.testing.assert_array_equal(np.asarray(got_rels),
                                  np.asarray(strict_rels))
    # the plain f32 path does NOT reach strict bit-equality (vacuity)
    got32_full, _ = _run(pos, codes, lengths, counts, exact_bins=False)
    assert np.any(np.asarray(got32_full) != np.asarray(strict_full))


def test_exact_bins_true_raises_off_path(system):
    """exact_bins=True must refuse paths it cannot make exact (here:
    the plain XLA path on the CPU backend)."""
    pos, codes, lengths, counts = system
    with pytest.raises(ValueError, match="exact_bins"):
        _run(pos, codes, lengths, counts, exact_bins=True)


def test_forced_rel_cross_layout_matches_scatter(system, monkeypatch):
    """Cross-layout (atom vs COM-like columns) kernel dispatch."""
    pos, codes, lengths, counts = system
    rng = np.random.default_rng(43)
    m = 300
    pos_cols = rng.uniform(0, 14.0, (3, m, 3))
    codes_cols = rng.integers(1, 3, m)
    counts_cols = np.bincount(codes_cols - 1, minlength=2).astype(
        np.float64)
    kw = dict(pos_cols=pos_cols, codes_cols=codes_cols, n_codes_cols=2)
    rels = np.array([[1, 2], [3, 1]])

    def run(**extra):
        return rdf_cn._rdf_mean(
            pos, codes, 3, lengths, 0.1, 128, 6.0, rels, counts,
            counts_cols, exclude_self=False, with_full=False,
            dtype=jnp.float32, **kw, **extra)

    _, want = run()
    monkeypatch.setattr(backend, "_FORCE", "gpu")
    _, got = run(exact_bins=False)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_program_cache_reuses_block_runner(system):
    """A second entry-point call on the same system must reuse the
    cached block program (no re-trace) yet still see the new frame data
    (positions are traced arguments, never baked constants)."""
    pos, codes, lengths, counts = system
    rng = np.random.default_rng(47)
    pos2 = rng.uniform(0, 14.0, pos.shape)

    rdf_cn._STEP_CACHE.clear()  # earlier tests may have warmed it
    rdf_cn._trace_log.clear()
    full_a, _ = _run(pos, codes, lengths, counts)
    n_traces = len(rdf_cn._trace_log)
    assert n_traces >= 1
    full_b, _ = _run(pos2, codes, lengths, counts)
    assert len(rdf_cn._trace_log) == n_traces, "second call re-traced"
    assert not np.array_equal(np.asarray(full_a), np.asarray(full_b)), (
        "cached program returned stale data"
    )
    # same data through the cached program reproduces exactly
    full_c, _ = _run(pos, codes, lengths, counts)
    np.testing.assert_array_equal(np.asarray(full_c), np.asarray(full_a))


def test_npt_policy_switch_streaming(monkeypatch):
    """An NPT-style stream whose box volume drifts across blocks must
    bin every block against its own box on the kernel path (per-frame
    ORB sort, cull and minimum image) — bit-identical to the plain XLA
    reference (integer counts, shared normalizer)."""
    rng = np.random.default_rng(53)
    n = 700
    codes = rng.integers(1, 4, n)
    counts = np.bincount(codes - 1, minlength=3).astype(np.float64)
    pos1 = rng.uniform(0, 14.0, (2, n, 3))
    len1 = np.full((2, 3), 14.0)
    pos2 = rng.uniform(0, 12.0, (2, n, 3))
    len2 = np.full((2, 3), 12.0)

    def blocks():
        yield pos1, None, len1
        yield pos2, None, len2

    def run(**extra):
        return rdf_cn._rdf_mean(
            pos1, codes, 3, len1, 0.1, 128, 6.0, RELS, counts, counts,
            exclude_self=True, with_full=True, dtype=jnp.float32,
            blocks=blocks(), **extra)

    want_full, want_rels = run()
    monkeypatch.setattr(backend, "_FORCE", "gpu")
    got_full, got_rels = run(exact_bins=False)
    np.testing.assert_array_equal(np.asarray(got_full),
                                  np.asarray(want_full))
    np.testing.assert_array_equal(np.asarray(got_rels),
                                  np.asarray(want_rels))


def test_periodic_tiling_preserves_rdf(system):
    """g(r) of a 2x2x1 periodic replication equals the original g(r)
    exactly (each atom's periodic environment is unchanged, counts and
    N scale together) — validates the PBC/minimum-image handling and
    the benchmark methodology that tiles the bundled box to the
    north-star atom count."""
    pos, codes, lengths, counts = system
    L = lengths[0]
    want_full, want_rels = rdf_cn._rdf_mean(
        pos, codes, 3, lengths, 0.1, 40, 4.0, RELS, counts, counts,
        exclude_self=True, with_full=True, dtype=jnp.float64)
    shifts = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0)]
    pos4 = np.concatenate(
        [pos + (np.array(s) * L)[None, None, :] for s in shifts], axis=1)
    codes4 = np.tile(codes, 4)
    len4 = np.broadcast_to(L * np.array([2.0, 2.0, 1.0]),
                           lengths.shape).copy()
    counts4 = counts * 4
    got_full, got_rels = rdf_cn._rdf_mean(
        pos4, codes4, 3, len4, 0.1, 40, 4.0, RELS, counts4, counts4,
        exclude_self=True, with_full=True, dtype=jnp.float64)
    np.testing.assert_allclose(got_full, want_full, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got_rels, want_rels, rtol=1e-12, atol=0)


def test_forced_cn_kernel_matches_dense(system, monkeypatch):
    pos, codes, lengths, counts = system
    r_cuts = np.array([3.0, 4.5])
    want = rdf_cn._cn_mean(pos, codes, 3, lengths, RELS, r_cuts, counts,
                           exclude_self=True, dtype=jnp.float32)
    monkeypatch.setattr(backend, "_FORCE", "gpu")
    got = rdf_cn._cn_mean(pos, codes, 3, lengths, RELS, r_cuts, counts,
                          exclude_self=True, dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.gpu
def test_card_fast_rdf_bit_equal_to_strict(dump_pattern, gpu):
    """On the card, fast calc_atomic_rdf (default exact bins) returns the
    strict float64 g(r) bit for bit."""
    kw = dict(r_cut=10.0, bin_size=0.05, num_types=9,
              mass=[16.0, 12.01, 1.008, 14.01, 32.06, 16.0, 12.01, 19.0,
                    24.305],
              partial_relations=[[8, 8], [1, 8]], filename=dump_pattern,
              save_mode=False)
    fast = rdf_cn.calc_atomic_rdf(precision="fast", **kw)
    strict = rdf_cn.calc_atomic_rdf(precision="strict", **kw)
    np.testing.assert_array_equal(fast.to_numpy(), strict.to_numpy())
