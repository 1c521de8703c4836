"""
Device-mesh helpers and the frame+atom-sharded analysis step.

The reference's only parallelism is a fork-based process pool over frames
(``conductivity.py:190-191``, ``hydration_number.py:86-89``); here the
equivalents are a 2-D ``jax.sharding.Mesh``:

- axis ``"frames"`` — data parallelism over trajectory frames (the
  reference's pool axis);
- axis ``"atoms"`` — intra-frame parallelism over the pair kernel's row
  chunks (the reference intended numba ``parallel=True`` here but ships
  it commented out, ``rdf_cn.py:35``).

Inside ``shard_map`` each device holds a (frames-shard, row-chunk-shard)
block of positions, all-gathers the frame's full atom set along the
``atoms`` axis (columns), computes its partial ordered-pair histogram,
and the result is ``psum``-reduced over both axes — collectives stay
on the devices (NCCL between cards), never the host. MSD reductions and
charge-flux segment sums shard over ``frames`` only.
"""

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from mdproptools_tpu.ops import pair_kernel
from mdproptools_tpu.ops import pairs as pair_ops

import inspect

try:  # jax >= 0.6: the public, non-deprecated home
    from jax import shard_map as _shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map as _shard_map

# replication-check kwarg renamed check_rep -> check_vma across JAX
# versions; a pallas_call inside shard_map cannot declare its varying
# mesh axes, so the sharded kernel runners need the check off
_CHECK_KW = ("check_vma" if "check_vma"
             in inspect.signature(_shard_map).parameters else "check_rep")


def shard_map(*args, **kwargs):
    if "check_vma" in kwargs:
        kwargs[_CHECK_KW] = kwargs.pop("check_vma")
    return _shard_map(*args, **kwargs)


def make_mesh(n_frames_axis: Optional[int] = None,
              n_atoms_axis: int = 1,
              devices=None) -> Mesh:
    """2-D mesh over (frames, atoms). Defaults to all devices on the
    frames axis."""
    devices = devices if devices is not None else jax.devices()
    if n_frames_axis is None:
        n_frames_axis = len(devices) // n_atoms_axis
    dev = np.asarray(devices[: n_frames_axis * n_atoms_axis]).reshape(
        n_frames_axis, n_atoms_axis
    )
    return Mesh(dev, axis_names=("frames", "atoms"))


def sharded_rdf_hist(
    pos,  # (T, n_padded, 3) padded positions (gather_padded output)
    lengths,  # (T, 3)
    layout: pair_ops.TypeLayout,
    bin_size: float,
    n_bins: int,
    r_cut: float,
    mesh: Mesh,
    exclude_self: bool = True,
    dtype=jnp.float32,
):
    """Frame- and row-sharded dense (plain XLA) ordered-pair histogram
    sum over all frames: returns the fully-reduced (n_codes, n_codes,
    n_bins) histogram (already summed over frames), replicated on every
    device.

    Sharding: pos rows are viewed as (T, n_chunks, LANE, 3); T shards
    over ``frames``, n_chunks over ``atoms``. Each device all-gathers the
    frame's columns along ``atoms`` and computes its row-chunk partial
    histogram; psum over both axes reduces.
    """
    T, n_padded, _ = pos.shape
    n_chunks = n_padded // pair_ops.LANE
    pos4 = pos.astype(dtype).reshape(T, n_chunks, pair_ops.LANE, 3)
    idx_r = jnp.asarray(layout.perm).reshape(n_chunks, pair_ops.LANE)
    chunk_codes = jnp.asarray(layout.chunk_codes)
    # pad row chunks to a multiple of the atoms axis with inert chunks
    # (idx -1 -> every pair invalid); frames axis must divide T
    n_atoms_axis = mesh.devices.shape[1]
    pad = (-n_chunks) % n_atoms_axis
    if pad:
        pos4 = jnp.concatenate(
            [pos4, jnp.zeros((T, pad, pair_ops.LANE, 3), pos4.dtype)], axis=1
        )
        idx_r = jnp.concatenate(
            [idx_r, jnp.full((pad, pair_ops.LANE), -1, idx_r.dtype)], axis=0
        )
        chunk_codes = jnp.concatenate(
            [chunk_codes, jnp.zeros(pad, chunk_codes.dtype)], axis=0
        )
    if T % mesh.devices.shape[0]:
        raise ValueError(
            f"frame count {T} must be divisible by the frames mesh axis "
            f"size {mesh.devices.shape[0]}; pad or trim the frame block"
        )

    in_specs = (
        P("frames", "atoms", None, None),  # pos4
        P("frames", None),  # lengths
        P("atoms", None),  # idx_r
        P("atoms"),  # chunk_codes
    )

    @partial(shard_map, mesh=mesh, in_specs=in_specs, out_specs=P())
    def run(pos_local, len_local, idx_local, codes_local):
        # columns: full frame = all row shards gathered along 'atoms'
        cols = jax.lax.all_gather(pos_local, "atoms", axis=1, tiled=True)
        cols = cols.reshape(pos_local.shape[0], -1, 3)

        def frame_step(acc, xs):
            p_loc, p_cols, L = xs
            h = pair_ops.pair_hist_rows(
                p_loc, idx_local, codes_local, p_cols, layout,
                n_codes_r=layout.n_codes, lengths=L, bin_size=bin_size,
                n_bins=n_bins, r_cut=r_cut, exclude_self=exclude_self,
                dtype=dtype,
            )
            return acc + h, None

        acc_dtype = jnp.float32 if dtype == jnp.float32 else dtype
        acc0 = jnp.zeros((layout.n_codes, layout.n_codes, n_bins), acc_dtype)
        acc0 = acc0 + (pos_local[0, 0, 0, 0] * 0).astype(acc_dtype)
        acc, _ = jax.lax.scan(frame_step, acc0,
                              (pos_local, cols, len_local))
        acc = jax.lax.psum(acc, "atoms")
        return jax.lax.psum(acc, "frames")

    return run(pos4, jnp.asarray(lengths, dtype), idx_r, chunk_codes)


def _sharded_kernel_frame(n_atoms, codes0, relations0, bin_size, n_bins,
                          r_cut, with_full, mesh, interpret):
    """Per-frame body of the row-sharded kernel runners: every device
    runs the SAME deterministic ORB sort on the replicated frame (cheap
    beside the kernel), takes the row tiles the ``atoms`` axis assigns
    it and passes their GLOBAL tile indices as ``row_tiles``, so the
    triangle rule (row tile <= column tile) counts every unordered tile
    pair exactly once across shards. Returns ``frame(p, L) -> (full,
    rels)`` partial counts, to be psummed over both axes."""
    tile = pair_kernel.TILE
    n_atoms_axis = mesh.devices.shape[1]
    n_tiles = -(-n_atoms // tile)
    n_tiles += (-n_tiles) % n_atoms_axis
    n_pad = n_tiles * tile
    per_shard = n_tiles // n_atoms_axis
    codes0 = jnp.asarray(np.asarray(codes0), jnp.int32)
    relations0 = np.asarray(relations0, np.int64)

    def frame(p, L):
        a_idx = jax.lax.axis_index("atoms")
        start = a_idx * per_shard * tile
        row_tiles = a_idx * per_shard + jnp.arange(per_shard, dtype=jnp.int32)
        pr, pm, ty = pair_ops.orb_sorted_side(p, n_atoms, n_pad, L, codes0,
                                              leaf=tile)

        def rows(x):
            return jax.lax.dynamic_slice_in_dim(x, start, per_shard * tile,
                                                axis=0)

        return pair_kernel.pair_hist_relations(
            rows(pr), rows(pm), rows(ty), pr, pm, ty, relations0, L,
            bin_size, n_bins, r_cut, exclude_self=True, with_full=with_full,
            triangle=True, row_tiles=row_tiles, interpret=interpret)

    return frame


def sharded_rdf_relations(
    pos,  # (T, N, 3) raw per-frame positions (unsorted, N real atoms)
    codes0,  # (N,) 0-based type codes (frame-invariant)
    relations0,  # (R, 2) 0-based relations
    lengths,  # (T, 3)
    bin_size: float,
    n_bins: int,
    r_cut: float,
    mesh: Mesh,
    with_full: bool = True,
    dtype=jnp.float32,
    interpret: bool = False,
):
    """Frame- and row-sharded pair-kernel histogram (ORB sort + tile
    cull + triangle), summed over all frames. Returns (full (n_bins,) or
    None, rels (R, n_bins)), already reduced over both mesh axes and
    replicated. Atom-atom self case, exclude_self=True (the sharded
    triangle rule requires it)."""
    T, n_atoms, _ = pos.shape
    n_frames_axis = mesh.devices.shape[0]
    if T % n_frames_axis:
        raise ValueError(
            f"frame count {T} must be divisible by the frames mesh axis "
            f"size {n_frames_axis}; pad or trim the frame block")
    frame = _sharded_kernel_frame(n_atoms, codes0, relations0, bin_size,
                                  n_bins, r_cut, with_full, mesh, interpret)
    n_rel = int(np.asarray(relations0).shape[0])

    @partial(shard_map, mesh=mesh,
             in_specs=(P("frames", None, None), P("frames", None)),
             out_specs=(P(), P()), check_vma=False)
    def run(pos_local, len_local):
        def frame_step(acc, xs):
            full, rels = frame(*xs)
            acc_full, acc_rels = acc
            if with_full:
                acc_full = acc_full + full
            return (acc_full, acc_rels + rels), None

        acc0 = (jnp.zeros(n_bins, dtype), jnp.zeros((n_rel, n_bins), dtype))
        (acc_full, acc_rels), _ = jax.lax.scan(
            frame_step, acc0, (pos_local, len_local))
        for ax in ("atoms", "frames"):
            acc_full = jax.lax.psum(acc_full, ax)
            acc_rels = jax.lax.psum(acc_rels, ax)
        return acc_full, acc_rels

    full, rels = run(pos.astype(dtype), jnp.asarray(lengths, dtype))
    return (full if with_full else None), rels


def make_sharded_relations_runner(
    codes0,  # (N,) 0-based type codes (frame-invariant)
    relations0,  # (R, 2) 0-based relations
    n_atoms: int,
    bin_size: float,
    n_bins: int,
    r_cut: float,
    mesh: Mesh,
    with_full: bool,
    normalize,  # (full, rels, L) -> (nrows, n_bins) per-frame rows
    dtype=jnp.float32,
    interpret: bool = False,
):
    """Jitted, reusable frame+row-sharded RDF block runner for the entry
    points: ``run(pos_b (T, N, 3), lengths_b (T, 3), w_b (T,)) ->
    (nrows, n_bins)`` — the weighted SUM over the block's frames of the
    per-frame NORMALIZED rows, reduced over both mesh axes and
    replicated (same contract as ``rdf_cn._make_block_runner``, so
    ``rdf_cn._rdf_mean`` streams blocks through it unchanged).

    Same kernel/sharding as :func:`sharded_rdf_relations`, but per-frame
    normalization happens INSIDE the scan — valid under sharding because
    the normalization is linear in the counts, so normalize-then-psum
    equals psum-then-normalize. Padded frames carry weight 0. Self case,
    exclude_self=True only."""
    frame = _sharded_kernel_frame(n_atoms, codes0, relations0, bin_size,
                                  n_bins, r_cut, with_full, mesh, interpret)
    nrows_out = int(np.asarray(relations0).shape[0]) + (1 if with_full else 0)

    @jax.jit
    @partial(shard_map, mesh=mesh,
             in_specs=(P("frames", None, None), P("frames", None),
                       P("frames")),
             out_specs=P(), check_vma=False)
    def run(pos_local, len_local, w_local):
        def frame_step(acc, xs):
            p, L, w = xs
            full, rels = frame(p, L)
            return acc + w * normalize(full, rels, L), None

        acc0 = jnp.zeros((nrows_out, n_bins), dtype)
        acc, _ = jax.lax.scan(
            frame_step, acc0,
            (pos_local.astype(dtype), len_local.astype(dtype), w_local))
        for ax in ("atoms", "frames"):
            acc = jax.lax.psum(acc, ax)
        return acc

    return run


def sharded_msd_per_type(coords, ref_coords, type_index, n_types, mesh):
    """Per-type MSD vs a replicated reference frame, frames sharded.
    coords: (T, M, 3); returns (T, n_types) (sharded over frames)."""
    in_specs = (P("frames", None, None), P(None, None), P(None))
    out_spec = P("frames", None)

    @partial(shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_spec)
    def run(c_local, ref, tidx):
        disp2 = ((c_local - ref[None]) ** 2).sum(axis=2)  # (T_loc, M)
        ones = jnp.ones(disp2.shape[1], disp2.dtype)
        counts = jax.ops.segment_sum(ones, tidx, num_segments=n_types)
        sums = jax.vmap(
            lambda v: jax.ops.segment_sum(v, tidx, num_segments=n_types)
        )(disp2)
        return sums / counts

    return run(coords, ref_coords, type_index)


def sharded_charge_flux(vel, q_mol_weighted_mass, mol_index, type_index,
                        n_molecules, n_types, mesh):
    """Charge flux per molecule type, frames sharded: returns
    (T, n_types, 3) sharded over frames. ``q_mol_weighted_mass`` =
    (masses, qmol) tuple of per-atom masses and per-molecule charges."""
    masses, qmol = q_mol_weighted_mass
    in_specs = (P("frames", None, None),)
    out_spec = P("frames", None, None)

    @partial(shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_spec)
    def run(v_local):
        w = v_local * masses[None, :, None]
        vcom_num = jax.vmap(
            lambda x: jax.ops.segment_sum(x, mol_index,
                                          num_segments=n_molecules)
        )(w)
        mtot = jax.ops.segment_sum(masses, mol_index,
                                   num_segments=n_molecules)
        vcom = vcom_num / mtot[None, :, None]
        weighted = vcom * qmol[None, :, None]
        return jax.vmap(
            lambda x: jax.ops.segment_sum(x, type_index,
                                          num_segments=n_types)
        )(weighted)

    return run(vel)
