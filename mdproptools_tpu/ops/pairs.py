"""
Plain-XLA pair-distance paths: histograms, cutoff counts, shell masks,
plus the spatial sorts and layout helpers the GPU pair kernel
(``ops.pair_kernel``) uses.

The reference's numba pair loops (``rdf_cn.py:35-162``) count 2 per
unordered pair for the full RDF and both orientations for partials
(``rdf_cn.py:85-96``): that is exactly an *ordered*-pair count —

    hist[ta, tb, k] = #{(p, q) : p != q, type_p = ta, type_q = tb,
                         bin(r_pq) = k, r_pq < r_cut}

so full(k) = sum_{ta,tb} hist[ta,tb,k] and partial (a,b) = hist[a,b,:].
That removes all data-dependent branching:

- atoms are sorted by type code on host once per system (type codes are
  frame-invariant), each type block padded to a multiple of the row
  chunk (``TypeLayout``);
- a ``lax.scan`` over 128-row chunks (each chunk single-typed) computes
  minimum-image r^2 against every column type block (static slices) in
  the reference's operation order;
- each chunk's bins are accumulated by a segment-sum scatter.

This is the "cpu" path of ``ops.backend.pair_backend`` and the reference
the GPU kernel is tested against. Precision: positions/dtype are
parameters; float64 reproduces the reference's NumPy math bit for bit.
"""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from mdproptools_tpu.ops.pbc import minimum_image

LANE = 128  # row-chunk size of the XLA scan


@dataclass(frozen=True)
class TypeLayout:
    """Host-precomputed type-sorted, block-padded atom layout.

    - ``perm``: (n_padded,) original atom index per padded slot, -1 = pad
    - ``codes``: (n_padded,) 0-based type code per slot, -1 = pad
    - ``block_start`` / ``block_size``: (n_codes,) padded block geometry
    - ``counts``: (n_codes,) true atom count per code
    """

    n_codes: int
    n_padded: int
    perm: np.ndarray
    codes: np.ndarray
    block_start: np.ndarray
    block_size: np.ndarray
    counts: np.ndarray

    @property
    def chunk_codes(self) -> np.ndarray:
        """(n_chunks,) type code of each LANE-row chunk (single-typed by
        construction)."""
        return self.codes[:: LANE]


def build_type_layout(codes_1based, n_codes: int, pad: int = LANE) -> TypeLayout:
    """Sort atoms by 1-based type code; pad each block to a multiple of
    ``pad`` slots (pad slots get perm = code = -1)."""
    codes0 = np.asarray(codes_1based, np.int64) - 1
    if codes0.min() < 0 or codes0.max() >= n_codes:
        raise ValueError("type codes out of range")
    order = np.argsort(codes0, kind="stable")
    counts = np.bincount(codes0, minlength=n_codes)
    padded_sizes = ((counts + pad - 1) // pad * pad).astype(np.int64)
    padded_sizes = np.maximum(padded_sizes, 0)
    starts = np.concatenate([[0], np.cumsum(padded_sizes)])[:-1]
    n_padded = int(padded_sizes.sum())
    perm = np.full(n_padded, -1, np.int64)
    ccodes = np.full(n_padded, -1, np.int64)
    true_starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    for c in range(n_codes):
        s, n = starts[c], counts[c]
        perm[s : s + n] = order[true_starts[c] : true_starts[c] + n]
        ccodes[s : s + n] = c
    return TypeLayout(
        n_codes, n_padded, perm, ccodes, starts, padded_sizes, counts
    )


def gather_padded_perm(values, perm):
    """Gather with an explicit (possibly per-frame) padded permutation."""
    idx = jnp.maximum(perm, 0)
    mask = perm >= 0
    out = jnp.take(values, idx, axis=-2)
    return jnp.where(mask[..., :, None], out, jnp.zeros_like(out))


def gather_padded(values, layout: TypeLayout):
    """Gather per-atom ``values`` (..., N, C) into the padded layout
    (..., n_padded, C); pad slots get zeros (they are masked by index
    validity inside the kernels)."""
    idx = jnp.asarray(np.maximum(layout.perm, 0))
    mask = jnp.asarray(layout.perm >= 0)
    out = jnp.take(values, idx, axis=-2)
    return jnp.where(mask[..., :, None], out, jnp.zeros_like(out))


def _pair_rsq(pos_r, pos_c, lengths):
    """Minimum-image squared distances between row tile (CR, 3) and
    column block (NC, 3) -> (CR, NC), summed (dx^2 + dy^2) + dz^2 as the
    reference does (a reduce over the axis would let XLA choose its own
    order). XLA's CPU and GPU backends contract ``a*b + c`` into an FMA;
    a runtime zero added to each square (at worst fma(d, d, 0), the
    correctly rounded square) keeps every operation IEEE-rounded."""
    d = pos_r[:, None, :] - pos_c[None, :, :]
    d = minimum_image(d, lengths)
    zero = lengths[0] - lengths[0]
    sq = [d[..., k] * d[..., k] + zero for k in range(3)]
    return (sq[0] + sq[1]) + sq[2]


def _divisor(value, dtype):
    """A divisor XLA cannot see as a constant: XLA rewrites division by a
    constant into multiplication by its rounded reciprocal, which bins
    some pairs differently from the reference's true division."""
    return jax.lax.optimization_barrier(jnp.asarray(value, dtype))


def pair_hist(
    pos_r,
    pos_c,
    layout_r: TypeLayout,
    layout_c: TypeLayout,
    lengths,
    bin_size: float,
    n_bins: int,
    r_cut: float,
    exclude_self: bool,
    dtype=jnp.float32,
):
    """Ordered-pair distance histogram per (row code, col code).

    Args:
      pos_r: (n_padded_r, 3) padded row positions (``gather_padded``).
      pos_c: (n_padded_c, 3) padded column positions.
      lengths: (3,) box lengths.
      bin_size, n_bins, r_cut: binning; bin = floor(sqrt(rsq)/bin_size),
        kept when rsq < r_cut^2 and bin < n_bins (``rdf_cn.py:62-69``).
      exclude_self: drop pairs with identical original atom index (the
        atom-atom case where pos_r and pos_c are the same set).
    Returns:
      (n_codes_r, n_codes_c, n_bins) histogram, dtype float32/float64.
    """
    nr_chunks = layout_r.n_padded // LANE
    pos_r = pos_r.astype(dtype).reshape(nr_chunks, LANE, 3)
    idx_r = jnp.asarray(layout_r.perm).reshape(nr_chunks, LANE)
    chunk_codes = jnp.asarray(layout_r.chunk_codes)
    return pair_hist_rows(
        pos_r, idx_r, chunk_codes, pos_c, layout_c,
        n_codes_r=layout_r.n_codes, lengths=lengths, bin_size=bin_size,
        n_bins=n_bins, r_cut=r_cut, exclude_self=exclude_self, dtype=dtype,
    )


def pair_hist_rows(
    pos_r,  # (n_chunks, LANE, 3) row chunks (may be a shard of the rows)
    idx_r,  # (n_chunks, LANE) original atom indices, -1 = pad
    chunk_codes,  # (n_chunks,) 0-based row code per chunk
    pos_c,  # (n_padded_c, 3) full padded column set
    layout_c: TypeLayout,
    n_codes_r: int,
    lengths=None,
    bin_size: float = 0.1,
    n_bins: int = 100,
    r_cut: float = 10.0,
    exclude_self: bool = False,
    dtype=jnp.float32,
):
    """Row-chunk-level ordered-pair histogram. ``pair_hist`` wraps this
    with the full row set; the sharded path (``mdproptools_tpu.parallel``)
    feeds each device its row-chunk shard and psums the result. Each
    chunk's bins are summed by a segment-sum over bin ids, with every
    invalid pair sent to one overflow bin that is dropped.
    """
    pos_c = pos_c.astype(dtype)
    lengths = jnp.asarray(lengths, dtype)
    idx_c = jnp.asarray(layout_c.perm)
    r_cut_sq = jnp.asarray(r_cut * r_cut, dtype)

    # static column-block geometry
    col_blocks = [
        (tb, int(layout_c.block_start[tb]), int(layout_c.block_size[tb]))
        for tb in range(layout_c.n_codes)
        if layout_c.block_size[tb] > 0
    ]

    def body(hist, inputs):
        p_r, i_r, ta = inputs
        for tb, start, size in col_blocks:
            p_c = jax.lax.dynamic_slice_in_dim(pos_c, start, size, axis=0)
            i_c = jax.lax.dynamic_slice_in_dim(idx_c, start, size, axis=0)
            rsq = _pair_rsq(p_r, p_c, lengths)
            # bin = trunc(sqrt(rsq) / ddr), the reference's binning rule
            # (rdf_cn.py:68); division kept (not reciprocal-multiply) so the
            # strict float64 path is bit-identical to the NumPy oracle.
            b = (jnp.sqrt(rsq) / _divisor(bin_size, dtype)).astype(jnp.int32)
            valid = (rsq < r_cut_sq) & (b < n_bins)
            valid &= (i_r[:, None] >= 0) & (i_c[None, :] >= 0)
            if exclude_self:
                valid &= i_r[:, None] != i_c[None, :]
            ids = jnp.where(valid, b, n_bins).reshape(-1)
            h1d = jax.ops.segment_sum(
                jnp.ones(ids.shape, hist.dtype), ids,
                num_segments=n_bins + 1,
            )[:n_bins]
            hist = hist.at[ta, tb].add(h1d.astype(hist.dtype))
        return hist, None

    acc_dtype = jnp.float32 if dtype == jnp.float32 else dtype
    hist0 = jnp.zeros((n_codes_r, layout_c.n_codes, n_bins), acc_dtype)
    # derive the carry from an input so its varying-manual-axes tag matches
    # under shard_map (a bare zeros carry is 'unvarying' and scan rejects
    # the mismatch); folds to zeros outside shard_map
    hist0 = hist0 + (pos_r[0, 0, 0] * 0).astype(acc_dtype)
    hist, _ = jax.lax.scan(body, hist0, (pos_r, idx_r, chunk_codes))
    return hist


def pair_count_within(
    pos_r,
    pos_c,
    layout_r: TypeLayout,
    layout_c: TypeLayout,
    lengths,
    relations,  # (R, 2) 1-based (row code, col code)
    r_cuts,  # (R,) cutoffs
    exclude_self: bool,
    dtype=jnp.float32,
):
    """Per-relation count of ordered pairs with rsq < r_cut^2 (the
    coordination-number kernel, ``rdf_cn.py:100-119``). Returns (R,)."""
    nr_chunks = layout_r.n_padded // LANE
    pos_r = pos_r.astype(dtype).reshape(nr_chunks, LANE, 3)
    pos_c = pos_c.astype(dtype)
    lengths = jnp.asarray(lengths, dtype)
    idx_r = jnp.asarray(layout_r.perm).reshape(nr_chunks, LANE)
    idx_c = jnp.asarray(layout_c.perm)
    codes_c = jnp.asarray(layout_c.codes)
    chunk_codes = jnp.asarray(layout_r.chunk_codes)
    relations = np.asarray(relations, np.int64)
    r_cuts_sq = np.asarray(r_cuts, np.float64) ** 2

    def body(counts, inputs):
        p_r, i_r, ta = inputs
        rsq = _pair_rsq(p_r, pos_c, lengths)
        base_valid = (i_r[:, None] >= 0) & (i_c_valid[None, :])
        if exclude_self:
            base_valid &= i_r[:, None] != idx_c[None, :]
        for rel in range(relations.shape[0]):
            a, b = int(relations[rel, 0]) - 1, int(relations[rel, 1]) - 1
            w = (
                (ta == a)
                & (codes_c[None, :] == b)
                & (rsq < jnp.asarray(r_cuts_sq[rel], dtype))
                & base_valid
            )
            counts = counts.at[rel].add(jnp.sum(w, dtype=counts.dtype))
        return counts, None

    i_c_valid = idx_c >= 0
    acc_dtype = jnp.float32 if dtype == jnp.float32 else dtype
    counts0 = jnp.zeros((relations.shape[0],), acc_dtype)
    counts, _ = jax.lax.scan(body, counts0, (pos_r, idx_r, chunk_codes))
    return counts


def rsq_one_to_all(head, pos, lengths):
    """Minimum-image squared distance from one point to all points
    (cluster extraction / hydration helper, ``rdf_cn.py:36-58``)."""
    d = minimum_image(head[None, :] - pos, lengths)
    return jnp.sum(d * d, axis=-1)


def shell_mask(pos_a, pos_b, lengths, r_in, r_out):
    """(Na, Nb) bool: r_in^2 < rsq <= r_out^2 (residence-time h-matrix,
    ``residence_time.py:101-106``)."""
    d = minimum_image(pos_a[:, None, :] - pos_b[None, :, :], lengths)
    rsq = jnp.sum(d * d, axis=-1)
    return (rsq > r_in * r_in) & (rsq <= r_out * r_out)


def device_sort_orb(pos, n_atoms: int, n_padded: int, lengths=None,
                    leaf: int = LANE):
    """On-device GLOBAL balanced-ORB permutation (recursive
    ``leaf``-aligned median bisection): returns (n_padded,) int32, pad
    slots -1.

    Each level sorts every segment along its own longest axis and splits
    at the real-atom median rounded to a ``leaf`` multiple, so (a) the
    ``leaf``-atom tiles are axis-aligned BOXES, which keeps the bounding
    spheres the pair kernel's cull sees tight (a single fat tile makes
    every tile pair touching it kept), and (b) pads sink to the
    rightmost leaf, keeping every other tile fully dense. ``lengths`` is
    unused (ORB boxes never straddle the periodic boundary; the cull's
    torus metric covers cross-boundary proximity). Reordering only
    changes the summation order of exact integer counts: results are
    bit-identical to any other layout.
    """
    del lengths
    n_tiles = max(n_padded // leaf, 1)
    levels = max(int(np.ceil(np.log2(n_tiles))), 0)
    qlev = jnp.int32(1 << 20)  # within-segment key quantization
    pos32 = pos[:, :3].astype(jnp.float32)
    p_all = jnp.concatenate(
        [pos32, jnp.zeros((n_padded - n_atoms, 3), jnp.float32)])
    idx = jnp.arange(n_padded, dtype=jnp.int32)
    seg = jnp.zeros(n_padded, jnp.int32)
    big = jnp.float32(3.4e38)
    for level in range(levels):
        nseg = 1 << level
        p = jnp.take(p_all, idx, axis=0)
        valid = idx < n_atoms
        lo = jax.ops.segment_min(
            jnp.where(valid[:, None], p, big), seg, num_segments=nseg)
        hi = jax.ops.segment_max(
            jnp.where(valid[:, None], p, -big), seg, num_segments=nseg)
        ext = hi - lo  # (nseg, 3)
        ax = jnp.argmax(ext, axis=1)[seg]  # longest axis, per atom
        kc = jnp.take_along_axis(p, ax[:, None], axis=1)[:, 0]
        lo_a = jnp.take_along_axis(lo[seg], ax[:, None], axis=1)[:, 0]
        ext_a = jnp.maximum(
            jnp.take_along_axis(ext[seg], ax[:, None], axis=1)[:, 0],
            jnp.float32(1e-30))
        q = jnp.clip(((kc - lo_a) / ext_a * (qlev - 1)).astype(jnp.int32),
                     0, qlev - 1)
        q = jnp.where(valid, q, qlev)  # pads last within their segment
        seg, q, idx = jax.lax.sort((seg, q, idx), num_keys=2)
        # leaf-aligned split at the real-atom median; reals sort before
        # pads, so a split <= real count gives an all-real left child
        ones = jnp.ones(n_padded, jnp.int32)
        slots = jax.ops.segment_sum(ones, seg, num_segments=nseg)
        reals = jax.ops.segment_sum(
            (idx < n_atoms).astype(jnp.int32), seg, num_segments=nseg)
        half = (reals.astype(jnp.float32) / (2 * leaf)
                + 0.5).astype(jnp.int32) * leaf
        split = jnp.clip(half, leaf, jnp.maximum(slots - leaf, leaf))
        starts = jnp.concatenate(
            [jnp.zeros(1, jnp.int32),
             jnp.cumsum(slots)[:-1].astype(jnp.int32)])
        rank = jnp.arange(n_padded, dtype=jnp.int32) - starts[seg]
        right = (slots[seg] >= 2 * leaf) & (rank >= split[seg])
        seg = 2 * seg + right.astype(jnp.int32)
    return jnp.where(idx < n_atoms, idx, -1)


def orb_sorted_side(pos, n_atoms: int, n_padded: int, lengths, codes0,
                    leaf: int = LANE, perm=None):
    """ORB-sort one side for the pair kernel: returns (positions
    (n_padded, 3) gathered in ORB order, perm (pads -1), int32 type codes
    with -1 at pad slots). ``codes0`` is the (n_atoms,) 0-based int32
    code array; ``perm`` a precomputed (n_padded,) permutation to use
    instead of sorting on the device."""
    pm = device_sort_orb(pos, n_atoms, n_padded, lengths, leaf) \
        if perm is None else perm
    pr = gather_padded_perm(pos, pm)
    ty = jnp.where(pm >= 0, codes0[jnp.maximum(pm, 0)], -1)
    return pr, pm, ty


def project_relations(hist, relations, with_full: bool):
    """Project a (n_codes_r, n_codes_c, n_bins) ordered-pair histogram
    onto (full, (R, n_bins)) rows — what the pair kernel returns.
    ``relations`` is (R, 2) 1-based."""
    rels = jnp.stack([hist[int(a) - 1, int(b) - 1] for a, b in relations])
    full = hist.sum(axis=(0, 1)) if with_full else None
    return full, rels
