"""
GPU pair kernel (Pallas through Triton): relation-projected ordered-pair
distance histograms and per-relation cutoff counts over spatially sorted
atom tiles.

Layout: each side is a padded array of ``tile``-atom tiles in balanced-ORB
order (``pairs.device_sort_orb`` with ``leaf=tile``), so every tile is a
compact box. Plain JAX computes each tile's bounding sphere and a
conservative (n_row_tiles, n_col_tiles) keep mask (``keep_mask``): a
tile pair is kept iff some atom pair in it can lie within r_cut. The kernel's grid runs over all tile pairs; a culled
program exits at once. In the self case (``triangle``) only tile pairs
with row tile <= column tile are kept and the diagonal tile keeps its
strictly-upper slot half, so each unordered pair is seen once.

Each kept program does the minimum-image pair math for its (tile, tile)
block and bins it:

- histogram mode adds 1 per valid pair into the flat float32 histogram
  ``[copy, block, bin]`` in device memory with ``atomic_add``. A pair's
  block is its relation's (unordered, in the self case), or block 0 for
  pairs matching no relation (only kept when the full g(r) is wanted);
  the full histogram is the sum over blocks. Programs spread their
  atomics over ``copies`` histogram copies to thin out same-address
  contention; the wrapper sums the copies. (float32, not int32: the
  installed Pallas lowers a vector atomic add of integers to a float
  add. Increments of 1 stay exact while a cell is below 2^24; a
  histogram with a cell at 2^24 comes back as NaN rather than wrong.)
- count mode (coordination numbers) sums, per relation, the valid pairs
  with rsq < r_cut[rel]^2 inside the program and adds one integer per
  relation.

Exactness: pair math runs in the positions' dtype (float32 or float64)
with every multiply, add, subtract, divide and square root issued as a
round-to-nearest PTX instruction (``mul.rn`` ...), which the compiler may
not contract into FMAs. The binning is therefore the reference's
``trunc(sqrt(rsq) / bin_size)`` in IEEE arithmetic, operation for
operation; in float64 every pair bins exactly as the float64 reference
loop does. Counts are integers, so the summation order (atomics, copies)
cannot change them.

Interpret mode (CPU tests only) runs the same kernel body with plain jnp
arithmetic and a read-modify-write in place of the atomics (programs run
one after another there). XLA's CPU backend contracts every ``a*b + c``
into an FMA, so there each product gets a runtime zero added
(``a*b + z``): at worst that is fma(a, b, 0), the correctly rounded
product, and no product then feeds an add directly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from mdproptools_tpu.ops.pbc import minimum_image

TILE = 32  # atoms per tile (power of two; measured, see PERF.md)
COPIES = 32  # histogram copies the programs spread their atomics over
NUM_WARPS = 4
CULL_MARGIN = 0.1  # Angstrom slack for the keep mask's rounding


# --------------------------------------------------------------------------
# keep mask (plain JAX)
# --------------------------------------------------------------------------
def tile_spheres(pos, idx, lengths, tile: int):
    """Bounding spheres (torus metric) of the ``tile``-atom tiles of a
    padded side: returns (centers (n_tiles, 3), radii (n_tiles,),
    has_atoms (n_tiles,) bool). Pad slots (idx < 0) are ignored."""
    p = pos.reshape(-1, tile, 3)
    ok = (idx.reshape(-1, tile) >= 0)
    valid = ok.astype(p.dtype)[..., None]
    ref = p[:, :1, :]
    d = minimum_image(p - ref, lengths) * valid
    m = d.sum(axis=1) / jnp.maximum(valid.sum(axis=1), 1.0)
    rad2 = (((d - m[:, None, :]) ** 2).sum(-1) * valid[..., 0]).max(axis=1)
    return ref[:, 0, :] + m, jnp.sqrt(rad2), ok.any(axis=1)


def keep_mask(pos_r, idx_r, pos_c, idx_c, lengths, r_cut: float, tile: int,
              triangle: bool, row_tiles=None):
    """(n_row_tiles, n_col_tiles) int32 conservative keep mask: 1 where a
    pair of the two tiles can be within ``r_cut`` (center distance <=
    r_cut + both radii + margin, in the torus metric). ``triangle``
    additionally keeps only row tile <= column tile, with ``row_tiles``
    the rows' GLOBAL tile indices in the column order (default arange:
    rows are the whole column set)."""
    cr, rr, okr = tile_spheres(pos_r, idx_r, lengths, tile)
    cc, rc, okc = tile_spheres(pos_c, idx_c, lengths, tile)
    d = minimum_image(cr[:, None, :] - cc[None, :, :], lengths)
    dist = jnp.sqrt((d * d).sum(-1))
    keep = dist <= (r_cut + CULL_MARGIN) + rr[:, None] + rc[None, :]
    keep &= okr[:, None] & okc[None, :]
    if triangle:
        if row_tiles is None:
            row_tiles = jnp.arange(keep.shape[0])
        keep &= (jnp.asarray(row_tiles)[:, None]
                 <= jnp.arange(keep.shape[1])[None, :])
    return keep.astype(jnp.int32)


# --------------------------------------------------------------------------
# kernel
# --------------------------------------------------------------------------
def _rn_ops(dtype, interpret: bool, zero=None):
    """(sub, add, mul, div, sqrt) in IEEE round-to-nearest. On the card
    each is one ``.rn`` PTX instruction (never fused into an FMA). In
    interpret mode plain jnp arithmetic: ``zero`` is a runtime 0 added to
    every product so the CPU backend cannot contract it into the next
    add (see the module docstring), and the divisor is hidden behind a
    barrier, or XLA turns division by a constant into multiplication by
    its reciprocal."""
    if interpret:
        def mul(a, b):
            return a * b + zero

        def div(a, b):
            return a / jax.lax.optimization_barrier(b)

        return (jnp.subtract, jnp.add, mul, div, jnp.sqrt)
    suffix, c = ("f64", "d") if dtype == jnp.float64 else ("f32", "f")

    def asm(op, n_args):
        operands = ", ".join(f"${k + 1}" for k in range(n_args))
        text = f"{op}.rn.{suffix} $0, {operands};"
        cons = ",".join([f"={c}"] + [c] * n_args)

        def f(*args):
            return plgpu.elementwise_inline_asm(
                text, args=list(args), constraints=cons, pack=1,
                result_shape_dtypes=[
                    jax.ShapeDtypeStruct(args[0].shape, args[0].dtype)])[0]

        return f

    return (asm("sub", 2), asm("add", 2), asm("mul", 2), asm("div", 2),
            asm("sqrt", 1))


def _kernel(keep_ref, rt_ref, len_ref, xr_ref, yr_ref, zr_ref, ir_ref,
            tr_ref, xc_ref, yc_ref, zc_ref, ic_ref, tc_ref, _zero_ref,
            out_ref, *, tile, n_col_tiles, copies, triangle, exclude_self,
            interpret, emit):
    i = pl.program_id(0)
    j = pl.program_id(1)

    @pl.when(keep_ref[i, j] != 0)
    def _():
        dtype = xr_ref.dtype
        zero = len_ref[0] - len_ref[0] if interpret else None
        sub, add, mul, _, _ = _rn_ops(dtype, interpret, zero)
        shape = (tile, tile)

        def axis(r_ref, c_ref, k):
            a = jnp.broadcast_to(r_ref[...][:, None], shape)
            b = jnp.broadcast_to(c_ref[...][None, :], shape)
            L = jnp.broadcast_to(len_ref[k], shape)
            d = sub(a, b)
            # the reference's single wrap (ops.pbc.minimum_image)
            half = L * jnp.asarray(0.5, dtype)
            return jnp.where(d > half, sub(d, L),
                             jnp.where(d < -half, add(d, L), d))

        dx = axis(xr_ref, xc_ref, 0)
        dy = axis(yr_ref, yc_ref, 1)
        dz = axis(zr_ref, zc_ref, 2)
        rsq = add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz))

        ir = ir_ref[...][:, None]
        ic = ic_ref[...][None, :]
        valid = (ir >= 0) & (ic >= 0)
        if exclude_self:
            valid &= ir != ic
        if triangle:
            # diagonal tile: strictly-upper slot half only
            upper = (jax.lax.broadcasted_iota(jnp.int32, shape, 1)
                     > jax.lax.broadcasted_iota(jnp.int32, shape, 0))
            valid &= upper | (rt_ref[i] != j)
        copy = (i * n_col_tiles + j) % copies
        emit(out_ref, copy, rsq, valid, tr_ref[...][:, None],
             tc_ref[...][None, :], interpret)


def _emit_hist(out_ref, copy, rsq, valid, tr, tc, interpret, *, relations,
               triangle, with_full, n_bins, bin_size, r_cut, stride):
    """Histogram mode: one count per valid pair at [copy, block, bin]."""
    dtype = rsq.dtype
    _, _, _, div, sqrt = _rn_ops(dtype, interpret)
    u = div(sqrt(rsq), jnp.broadcast_to(jnp.asarray(bin_size, dtype),
                                        rsq.shape))
    b = u.astype(jnp.int32)
    valid &= (rsq < jnp.asarray(r_cut * r_cut, dtype)) & (b < n_bins)
    blk = jnp.zeros(rsq.shape, jnp.int32)
    for k, (a_r, b_r) in enumerate(relations):
        m = (tr == a_r) & (tc == b_r)
        if triangle and a_r != b_r:
            m |= (tr == b_r) & (tc == a_r)
        blk += jnp.int32(k + 1) * m.astype(jnp.int32)
    if not with_full:
        valid &= blk > 0
    flat = copy * stride + blk * n_bins + b
    _scatter_add(out_ref, flat, valid, interpret)


def _emit_count(out_ref, copy, rsq, valid, tr, tc, interpret, *, relations,
                r_cuts_sq, triangle):
    """Count mode: per relation, the valid pairs within its cutoff."""
    n_rel = len(relations)
    for k, (a_r, b_r) in enumerate(relations):
        w = ((tr == a_r) & (tc == b_r)).astype(jnp.int32)
        if triangle:  # both orientations of each unordered pair
            w += ((tr == b_r) & (tc == a_r)).astype(jnp.int32)
        ok = valid & (rsq < jnp.asarray(r_cuts_sq[k], rsq.dtype))
        cnt = jnp.sum(jnp.where(ok, w, 0), dtype=jnp.int32)
        _scatter_add(out_ref, copy * n_rel + k, None, interpret, cnt)


def _scatter_add(out_ref, flat, valid, interpret, value=None):
    """out[flat] += value (default 1) where ``valid``: global atomics on
    the card; an in-place read-modify-write in interpret mode."""
    dt = out_ref.dtype
    if not interpret:
        if value is None:
            plgpu.atomic_add(out_ref, (flat,), jnp.ones(flat.shape, dt),
                             mask=valid)
        else:
            plgpu.atomic_add(out_ref, (flat,), value)
        return
    size = out_ref.shape[0]
    if value is None:
        tgt = jnp.where(valid, flat, size).reshape(-1)
        add = jnp.zeros(size, dt).at[tgt].add(1, mode="drop")
    else:
        add = jnp.zeros(size, dt).at[flat].add(value)
    out_ref[...] = out_ref[...] + add


def _check_tiles(pos_r, pos_c, tile):
    for n in (pos_r.shape[0], pos_c.shape[0]):
        if n % tile:
            raise ValueError(f"padded side length {n} is not a multiple "
                             f"of the tile size {tile}")


def _pad_side(pos, idx, types):
    return (pos[:, 0], pos[:, 1], pos[:, 2], jnp.asarray(idx, jnp.int32),
            jnp.asarray(types).astype(jnp.int32))


def _launch(emit, size, out_dtype, pos_r, idx_r, types_r, pos_c, idx_c,
            types_c, lengths, keep, row_tiles, *, tile, copies, triangle,
            exclude_self, interpret, name):
    dtype = pos_r.dtype
    rows = _pad_side(pos_r, idx_r, types_r)
    cols = _pad_side(pos_c.astype(dtype), idx_c, types_c)
    n_tr, n_tc = pos_r.shape[0] // tile, pos_c.shape[0] // tile
    kernel = functools.partial(
        _kernel, tile=tile, n_col_tiles=n_tc, copies=copies,
        triangle=triangle, exclude_self=exclude_self, interpret=interpret,
        emit=emit)
    anywhere = pl.BlockSpec(memory_space=pl.ANY)
    row = pl.BlockSpec((tile,), lambda i, j: (i,))
    col = pl.BlockSpec((tile,), lambda i, j: (j,))
    out = pl.pallas_call(
        kernel,
        grid=(n_tr, n_tc),
        in_specs=[anywhere] * 3 + [row] * 5 + [col] * 5 + [anywhere],
        out_specs=anywhere,
        out_shape=jax.ShapeDtypeStruct((size,), out_dtype),
        input_output_aliases={13: 0},
        interpret=interpret,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        backend="triton",
        name=name,
    )(keep, row_tiles, jnp.asarray(lengths, dtype), *rows, *cols,
      jnp.zeros((size,), out_dtype))
    return out


def _row_tiles(row_tiles, n_tr):
    if row_tiles is None:
        return jnp.arange(n_tr, dtype=jnp.int32)
    return jnp.asarray(row_tiles, jnp.int32)


def pair_hist_relations(
    pos_r,  # (n_pad_r, 3) row positions in tile order (pads anywhere)
    idx_r,  # (n_pad_r,) original atom indices, -1 = pad
    types_r,  # (n_pad_r,) 0-based type codes (value at pads ignored)
    pos_c,  # (n_pad_c, 3) columns (the same arrays as rows in the self case)
    idx_c,
    types_c,
    relations,  # (R, 2) 0-based (a, b) pairs
    lengths,  # (3,) box lengths
    bin_size: float,
    n_bins: int,
    r_cut: float,
    exclude_self: bool,
    with_full: bool,
    triangle: bool = False,
    counts_r=None,  # (n_types_r,) true atom counts (self-pair re-add)
    row_tiles=None,
    interpret: bool = False,
    tile: int = TILE,
    copies: int = COPIES,
):
    """Relation-projected ordered-pair histogram: returns (full (n_bins,)
    or None, rels (R, n_bins)) in the positions' dtype, equal to
    ``pairs.project_relations`` of the dense ordered-pair histogram
    (``pairs.pair_hist_rows``).

    ``triangle`` (self case: rows are the columns, or a row shard of
    them with ``row_tiles`` its GLOBAL tile indices) counts each
    unordered pair once and rebuilds the ordered counts by exact integer
    scaling; r = 0 self pairs, which the strictly-upper diagonal drops,
    are re-added from ``counts_r`` when exclude_self=False (a sharded
    triangle needs exclude_self=True, so the re-add happens once)."""
    relations = [(int(a), int(b)) for a, b in np.asarray(relations)]
    _check_tiles(pos_r, pos_c, tile)
    if triangle and row_tiles is None and pos_r.shape[0] != pos_c.shape[0]:
        raise ValueError("triangle mode needs rows == columns or row_tiles")
    if triangle and row_tiles is not None and not exclude_self:
        raise ValueError("a sharded triangle needs exclude_self=True")
    # kernel blocks: distinct (unordered, in triangle mode) relations
    blocks, rel_blk = {}, []
    for a_r, b_r in relations:
        key = (min(a_r, b_r), max(a_r, b_r)) if triangle else (a_r, b_r)
        rel_blk.append(blocks.setdefault(key, len(blocks)))
    dtype = pos_r.dtype
    n_tr = pos_r.shape[0] // tile
    row_tiles = _row_tiles(row_tiles, n_tr)
    keep = keep_mask(pos_r, idx_r, pos_c.astype(dtype), idx_c, lengths,
                     float(r_cut), tile, triangle, row_tiles)
    stride = (1 + len(blocks)) * n_bins
    emit = functools.partial(
        _emit_hist, relations=tuple(blocks), triangle=triangle,
        with_full=with_full, n_bins=int(n_bins), bin_size=float(bin_size),
        r_cut=float(r_cut), stride=stride)
    out = _launch(emit, copies * stride, jnp.float32, pos_r, idx_r, types_r,
                  pos_c, idx_c, types_c, lengths, keep, row_tiles, tile=tile,
                  copies=copies, triangle=triangle,
                  exclude_self=exclude_self, interpret=interpret,
                  name="pair_hist")
    out = jnp.where(out.max() < 2.0 ** 24, out, jnp.nan)  # exactness guard
    hist = out.reshape(copies, 1 + len(blocks), n_bins).astype(dtype).sum(0)
    scale = [2.0 if triangle and a == b else 1.0 for a, b in relations]
    rels = jnp.stack([hist[1 + k] * s for k, s in zip(rel_blk, scale)]) \
        if relations else jnp.zeros((0, n_bins), dtype)
    full = hist.sum(0) * (2.0 if triangle else 1.0) if with_full else None
    if triangle and not exclude_self:
        if counts_r is None:
            raise ValueError("counts_r required for triangle + "
                             "exclude_self=False")
        counts_r = np.asarray(counts_r, np.float64)
        if full is not None:
            full = full.at[0].add(jnp.asarray(counts_r.sum(), dtype))
        adds = np.array([counts_r[a] if a == b else 0.0
                         for a, b in relations])
        if relations:
            rels = rels.at[:, 0].add(jnp.asarray(adds, dtype))
    return full, rels


def pair_count_relations(
    pos_r, idx_r, types_r, pos_c, idx_c, types_c,
    relations,  # (R, 2) 0-based (a, b) pairs
    r_cuts,  # (R,) per-relation cutoffs
    lengths,
    exclude_self: bool,
    triangle: bool = False,
    counts_r=None,
    interpret: bool = False,
    tile: int = TILE,
    copies: int = COPIES,
):
    """Per-relation count of ordered pairs with rsq < r_cut[rel]^2 (the
    coordination-number mode of the kernel): returns (R,) in the
    positions' dtype, equal to ``pairs.pair_count_within``."""
    relations = [(int(a), int(b)) for a, b in np.asarray(relations)]
    r_cuts = [float(v) for v in np.asarray(r_cuts).reshape(-1)]
    _check_tiles(pos_r, pos_c, tile)
    if triangle and pos_r.shape[0] != pos_c.shape[0]:
        raise ValueError("triangle mode needs rows == columns")
    dtype = pos_r.dtype
    n_tr = pos_r.shape[0] // tile
    row_tiles = _row_tiles(None, n_tr)
    keep = keep_mask(pos_r, idx_r, pos_c.astype(dtype), idx_c, lengths,
                     max(r_cuts), tile, triangle, row_tiles)
    emit = functools.partial(
        _emit_count, relations=tuple(relations),
        r_cuts_sq=tuple(v * v for v in r_cuts), triangle=triangle)
    out = _launch(emit, copies * len(relations), jnp.int32, pos_r, idx_r,
                  types_r, pos_c, idx_c, types_c, lengths, keep, row_tiles,
                  tile=tile, copies=copies, triangle=triangle,
                  exclude_self=exclude_self, interpret=interpret,
                  name="pair_count")
    counts = out.reshape(copies, len(relations)).sum(0).astype(dtype)
    if triangle and not exclude_self:
        if counts_r is None:
            raise ValueError("counts_r required for triangle + "
                             "exclude_self=False")
        counts_r = np.asarray(counts_r, np.float64)
        adds = np.array([counts_r[a] if a == b and rc > 0 else 0.0
                         for (a, b), rc in zip(relations, r_cuts)])
        counts = counts + jnp.asarray(adds, dtype)
    return counts
