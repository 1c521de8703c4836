"""
Radial distribution functions and coordination numbers from LAMMPS dumps.

API-compatible with the reference module ``mdproptools/structural/rdf_cn.py``
(entry points ``calc_atomic_rdf:385``, ``calc_atomic_cn:533``,
``calc_molecular_rdf:654``, ``calc_molecular_cn:759``,
``calc_intermolecular_rdf:857`` — same argument names/defaults, same output
DataFrame labels and CSV artifacts), but the per-frame numba pair loops are
replaced by one jit-compiled ordered-pair histogram kernel
(``mdproptools_tpu.ops.pairs``) scanned over frames entirely on device,
and the pandas groupby-apply COM (``rdf_cn.py:218-241``) by a segment-sum
COM.

Streaming architecture: frames are shipped to the device in fixed-size
blocks; a ``lax.scan`` inside one compiled program computes each frame's
histogram, applies the reference's *per-frame* normalization in the
reference's exact operation order, and accumulates the running sum on
device. Only one small array returns to host per block.

Math preserved exactly (verified by the float64 oracle tests):
- bin = trunc(sqrt(rsq)/bin_size), pairs kept when rsq < r_cut^2
  (``rdf_cn.py:62-69``);
- full histogram counts 2 per unordered pair, partials count both
  orientations (``rdf_cn.py:85-96``) == ordered-pair counting;
- per-frame normalization then frame averaging (``rdf_cn.py:297-338,
  502-521``): g_full = counts / (N * rho * Vshell),
  g_ab = counts / (N_a * rho_b * Vshell);
- CN cutoff is exact (rsq < r_cut[rel]^2), not binned (``rdf_cn.py:112``).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from mdproptools_tpu.common.system import System, altered_atom_types
from mdproptools_tpu.io.lammps_dump import (
    Trajectory,
    iter_trajectory_blocks,
    read_trajectory,
)
from mdproptools_tpu.ops import com as com_ops
from mdproptools_tpu.ops import pair_kernel
from mdproptools_tpu.ops import pairs as pair_ops
from mdproptools_tpu.ops.backend import (
    kernel_interpret,
    pair_backend,
    platform,
)
from mdproptools_tpu.ops.precision import resolve_dtype
from mdproptools_tpu.utilities.tracing import stage

CON_CONSTANT = 1.660538921  # g/mol/A^3 -> g/cm^3, as in rdf_cn.py:30

FRAME_BLOCK = 128  # frames per device program (one transfer, one fetch)


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------
def _load(filename, columns=("id", "type", "x", "y", "z")):
    return read_trajectory(filename, columns=list(columns))


def _open_stream(filename, columns=("id", "type", "x", "y", "z"),
                 skip_frames=0, max_frames=None):
    """Open a dump pattern as a bounded-memory block stream. Returns
    (first_block, blocks_fn) where blocks_fn() iterates ALL blocks
    including the first — the first block supplies frame-0 metadata
    (codes, counts, consistency checks, shapes)."""
    from mdproptools_tpu.io.lammps_dump import prefetch_iter

    it = prefetch_iter(
        iter_trajectory_blocks(filename, columns=list(columns),
                               block_frames=FRAME_BLOCK,
                               skip_frames=skip_frames,
                               max_frames=max_frames),
        depth=2,  # next block parses while the device runs this one
    )
    try:
        first = next(it)
    except StopIteration:
        raise ValueError(f"no frames parsed from {filename!r}")

    def blocks():
        yield first
        yield from it

    return first, blocks


def _atom_codes(traj: Trajectory, num_types, num_mols, num_atoms_per_mol):
    """1-based per-atom codes: LAMMPS types, or recalculated per-molecule
    ids when num_mols/num_atoms_per_mol are given (``rdf_cn.py:462-470``).
    Also runs the reference's consistency checks (``rdf_cn.py:266-279``)."""
    types = traj.data[0, :, traj.columns.index("type")].astype(np.int64)
    if num_mols and num_atoms_per_mol:
        ids = traj.data[0, :, traj.columns.index("id")].astype(np.int64)
        codes = altered_atom_types(ids, num_mols, num_atoms_per_mol)
        n_codes = int(sum(num_atoms_per_mol))
        observed = len(np.unique(codes))
        if observed != n_codes:
            raise ValueError(
                "Consistency check failed: Number of specified atomic types is "
                f"different from the calculated value specified= "
                f"{num_atoms_per_mol}, calculated= {observed}"
            )
    else:
        codes = types
        n_codes = int(num_types)
        observed = len(np.unique(types))
        if num_types != observed:
            raise ValueError(
                "Consistency check failed: Number of specified atomic types is "
                f"different from the calculated value specified= {num_types}, "
                f"calculated= {observed}"
            )
    return codes, n_codes, types


def _check_relations(relation_matrix, code_counts, n_codes, volumes, kind):
    """Range + zero-density guards (``rdf_cn.py:290-293``)."""
    for a, b in relation_matrix:
        if not (1 <= int(a) <= n_codes and 1 <= int(b) <= len(code_counts)):
            raise ValueError(
                f"partial relation ({a}, {b}) references a type outside "
                f"1..{n_codes} ({kind})"
            )
    for _, b in relation_matrix:
        if code_counts[int(b) - 1] / volumes.max() < 1.0e-22:
            raise ValueError("Error: Density is zero for mol type: " + str(b))


def _total_density(code_counts, mass, num_types, volume):
    """Per-frame total mass density in g/cm^3 — the reference's
    ``_calc_props`` diagnostic (``rdf_cn.py:281-286``):
    ``total_mass = sum_i mass[i] * count(code i+1)`` for i in
    ``range(num_types)``, ``density = total_mass / V * CON_CONSTANT``.
    Quirk reproduced: with recalculated per-molecule ids the reference
    indexes the FIRST ``num_types`` altered-id codes with the
    per-LAMMPS-type masses (its ``atom_types`` dict counts the id
    column there, ``rdf_cn.py:263,281``)."""
    mass = np.asarray(mass, np.float64).reshape(-1)
    if mass.size < num_types:
        raise ValueError(
            f"mass must list one value per atom type: got {mass.size} "
            f"masses for num_types={num_types}")
    counts = np.asarray(code_counts, np.float64)[:num_types]
    if counts.size < num_types or np.any(counts == 0):
        # the reference dies with a KeyError on the missing count
        # (``rdf_cn.py:281``); diverge to a clear ValueError
        raise ValueError(
            f"density diagnostic: no atoms with a code in 1..{num_types}"
            " (atom types must be numbered contiguously from 1)")
    total_mass = float((mass[:num_types] * counts).sum())
    return total_mass / volume * CON_CONSTANT


def _density_reporter(code_counts, mass, num_types):
    """Returns ``report(lengths_b)`` logging each frame's total density
    exactly as the reference prints it per frame (``rdf_cn.py:283-286``,
    logger instead of print). The mass-consistency ValueError raises
    eagerly (at entry-point call time) even when the logger is silent;
    the per-frame loop costs nothing when INFO is not enabled."""
    import logging

    from mdproptools_tpu.utilities.tracing import logger

    _total_density(code_counts, mass, num_types, 1.0)  # validate now

    def report(lengths_b):
        if not logger.isEnabledFor(logging.INFO):
            return
        for L in np.asarray(lengths_b, np.float64):
            dens = _total_density(code_counts, mass, num_types,
                                  float(np.prod(L)))
            logger.info("Average density=%10.8f", dens)

    return report


def _shell_volumes(bin_size, num_bins):
    k = np.arange(num_bins, dtype=np.float64)
    return 4.0 / 3.0 * np.pi * bin_size**3 * ((k + 1) ** 3 - k**3)


def _radii(bin_size, num_bins):
    return (np.arange(num_bins) + 0.5) * bin_size


def _save_rdf(radii, relation_matrix, path_or_buff, save_mode, rdf_part,
              rdf_full=None):
    """DataFrame/CSV writer with the reference's exact labels
    (``rdf_cn.py:341-365``)."""
    if rdf_full is not None:
        arrays = (radii, rdf_full) + tuple(rdf_part)
        labels = ["r ($\\AA$)", "g_full(r)"]
    else:
        arrays = (radii,) + tuple(rdf_part)
        labels = ["r ($\\AA$)"]
    labels += [f"g_{int(p[0])}-{int(p[1])}" for p in relation_matrix]
    df = pd.DataFrame(np.vstack(arrays).T, columns=labels)
    if save_mode:
        df.to_csv(path_or_buff, index=False)
    return df


def _save_cn(relation_matrix, path_or_buff, cn, save_mode):
    labels = [f"cn_{int(p[0])}-{int(p[1])}" for p in relation_matrix]
    df = pd.DataFrame(np.asarray(cn)[None, :], columns=labels)
    if save_mode:
        df.to_csv(path_or_buff, index=False)
    return df


# --------------------------------------------------------------------------
# device frame loop
# --------------------------------------------------------------------------
def _array_blocks(pos, lengths, pos_cols=None):
    """Slice already-materialized arrays into FRAME_BLOCK-sized blocks
    (the non-streaming path used by tests and small workloads)."""
    T = pos.shape[0]
    for s in range(0, T, FRAME_BLOCK):
        e = min(s + FRAME_BLOCK, T)
        yield (pos[s:e],
               None if pos_cols is None else pos_cols[s:e],
               lengths[s:e])


_trace_log: list = []  # appended at block-program trace time (test hook)

_FORCE_FRAMES_MESH = None  # test hook: force a mesh for _scan_frame_mean

# Step/runner program cache: without it every `_rdf_mean`/`_cn_mean`
# call would rebuild its step closure and block runner, so a SECOND call
# on the same system would re-trace the block program and re-load the
# executable even though nothing changed. Entries key on every static
# that shapes the traced program (codes/counts/relations bytes, shapes,
# binning, pair path); positions/lengths stay traced arguments, so a
# cache hit can never change results.
_STEP_CACHE: "dict" = {}
_STEP_CACHE_MAX = 8


def _step_cache_get(key, build):
    entry = _STEP_CACHE.pop(key, None)  # pop+reinsert = LRU order
    if entry is None:
        entry = build()
        entry = (*entry, {})  # trailing dict: per-(shape, mesh) runners
        while len(_STEP_CACHE) >= _STEP_CACHE_MAX:
            _STEP_CACHE.pop(next(iter(_STEP_CACHE)))
    _STEP_CACHE[key] = entry
    return entry


def _mesh_key(mesh):
    if mesh is None:
        return None
    return (mesh.axis_names, mesh.devices.shape,
            tuple(d.id for d in mesh.devices.flat))


_ACTIVE_MESH = None  # set via set_mesh(): user-pinned device mesh


def set_mesh(mesh):
    """Pin the device mesh every rdf_cn entry point runs on (product
    surface for pod slices). Accepts None (restore auto), a 1-axis
    ("frames",) mesh, or a 2-axis ("frames", "atoms") mesh — with an
    atoms axis, ``calc_atomic_rdf`` routes its large-N fast path through
    the row-sharded relation kernel (``parallel.sharded_rdf_relations``
    semantics) and every other path frame-shards over the flattened
    devices. Results are exact either way (integer pair counts;
    normalization is linear, so psum order cannot change them)."""
    global _ACTIVE_MESH
    if mesh is not None and tuple(mesh.axis_names) not in (
            ("frames",), ("frames", "atoms")):
        raise ValueError(
            "mesh axes must be ('frames',) or ('frames', 'atoms'), got "
            f"{mesh.axis_names}")
    _ACTIVE_MESH = mesh


def _auto_mesh(n_atoms=None, n_frames_hint=None):
    """The device mesh entry points run on: the pinned ``set_mesh``
    mesh, else (on a host with several GPUs) an automatic mesh over all
    of them — frames-only data parallelism when the frame blocks can
    fill the cards, with the leftover cards moved to an ``atoms``
    (row-tile) axis when frames are few and the system is large enough
    that each row shard keeps >= 32 tiles of work. CPU devices (the
    test backend's virtual ones included) never get an automatic mesh,
    so float64 oracle results keep their exact summation order
    (_FORCE_FRAMES_MESH / set_mesh override for the sharding tests)."""
    if _FORCE_FRAMES_MESH is not None:
        return _FORCE_FRAMES_MESH
    if _ACTIVE_MESH is not None:
        return _ACTIVE_MESH
    devs = jax.devices()
    if len(devs) <= 1 or platform() != "gpu":
        return None
    from jax.sharding import Mesh

    D = len(devs)
    atoms_ax = 1
    if n_atoms is not None and n_frames_hint is not None:
        n_chunks = -(-int(n_atoms) // pair_kernel.TILE)
        while (atoms_ax * 2 <= D and D % (atoms_ax * 2) == 0
               and n_chunks // (atoms_ax * 2) >= 32
               and n_frames_hint <= D // (atoms_ax * 2)):
            atoms_ax *= 2
    if atoms_ax == 1:
        return Mesh(np.asarray(devs), axis_names=("frames",))
    return Mesh(np.asarray(devs).reshape(D // atoms_ax, atoms_ax),
                axis_names=("frames", "atoms"))


def _frames_only(mesh):
    """Collapse any mesh to a 1-axis ("frames",) mesh over the same
    devices (the generic block runner shards frames only)."""
    if mesh is None or len(mesh.axis_names) == 1:
        return mesh
    from jax.sharding import Mesh

    return Mesh(mesh.devices.reshape(-1), axis_names=("frames",))


def _auto_frames_mesh():
    """Frames-only view of the active/auto mesh (used by the generic
    ``_scan_frame_mean`` path — CN, molecular RDF, etc.)."""
    return _frames_only(_auto_mesh())


def _make_block_runner(step_fn, out_shape, dtype, mesh=None):
    """One jitted frame-block program: scans
    ``step_fn(pos, pos_cols, L)`` over the block (weighted per frame, so
    sharding pads carry zero weight) and returns the block's summed
    rows. Reused across trajectories by the sweep layer (compiled once
    per block shape).

    ``mesh``: optional 1-axis ("frames",) device mesh — each device
    scans its frame shard and the partial sums psum across the cards,
    making every entry point frame-data-parallel with no kernel changes
    (the reference's process-pool axis, SURVEY section 2.3)."""
    acc_dtype = jnp.float32 if dtype == jnp.float32 else dtype

    def scan_frames(pos_b, pos_cols_b, lengths_b, w_b):
        _trace_log.append(out_shape)

        def step(acc, xs):
            p, pc, L, w = xs
            rows = step_fn(p, pc, L)
            return acc + w * rows.astype(acc.dtype), None

        acc0 = jnp.zeros(out_shape, acc_dtype)
        acc0 = acc0 + (pos_b[0, 0, 0] * 0).astype(acc_dtype)
        acc, _ = jax.lax.scan(step, acc0,
                              (pos_b, pos_cols_b, lengths_b, w_b))
        return acc

    if mesh is None:
        return jax.jit(scan_frames)

    from functools import partial as _partial

    from jax.sharding import PartitionSpec as P

    from mdproptools_tpu.parallel.mesh import shard_map

    @jax.jit
    @_partial(shard_map, mesh=mesh,
              in_specs=(P("frames"),) * 4,
              out_specs=P(), check_vma=False)
    def run_block(pos_b, pos_cols_b, lengths_b, w_b):
        return jax.lax.psum(
            scan_frames(pos_b, pos_cols_b, lengths_b, w_b), "frames")

    return run_block


def _pad_rows(arr, extra):
    """One-allocation pad: copy ``arr`` into a fresh buffer with
    ``extra`` trailing copies of row 0 (``np.concatenate``+``np.repeat``
    would allocate an intermediate per input)."""
    out = np.empty((arr.shape[0] + extra,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    out[arr.shape[0]:] = arr[:1]
    return out


def _pad_block(pos_b, pc_b, len_b, n_pad_to, target=0):
    """Pad a frame block to a multiple of the frames-mesh size with
    zero-weight copies of the first frame (equal shards requirement).

    ``target``: additionally pad up to this frame count — the streaming
    loops pass the steady block shape so a trailing partial block reuses
    the already-compiled program instead of compiling a fresh shape."""
    nb = pos_b.shape[0]
    w = np.ones(nb)
    tgt = max(nb, int(target))
    if n_pad_to > 1 and tgt % n_pad_to:
        tgt += n_pad_to - tgt % n_pad_to
    if tgt > nb:
        extra = tgt - nb
        pos_b = _pad_rows(pos_b, extra)
        if pc_b is not None:
            pc_b = _pad_rows(pc_b, extra)
        len_b = _pad_rows(len_b, extra)
        w = np.concatenate([w, np.zeros(extra)])
    return pos_b, pc_b, len_b, w


def _accumulate_stream_device(run_block, blocks, dtype, n_pad_to=1):
    """Stream host blocks through ``run_block`` and return the running
    SUM plus the frame count. A trajectory that fits ONE frame block
    returns the UNFETCHED device array — the sweep fast path, letting
    many trajectories' results batch into a single synchronizing
    transfer. Longer trajectories accumulate block sums into
    a HOST float64 total exactly like ``_run_stream`` — bit-identical
    cross-block precision to the entry points, and the per-block fetch
    bounds in-flight device buffers regardless of trajectory length."""
    total_host = None
    pending = None
    T = 0
    steady = 0
    for pos_b, pc_b, len_b in blocks:
        with stage("frame_block", start=T, frames=pos_b.shape[0]):
            nb = pos_b.shape[0]
            pos_b, pc_b, len_b, w = _pad_block(pos_b, pc_b, len_b,
                                               n_pad_to, target=steady)
            steady = max(steady, pos_b.shape[0])
            pb = jnp.asarray(pos_b, dtype)
            pcb = pb if pc_b is None else jnp.asarray(pc_b, dtype)
            cur = run_block(pb, pcb, jnp.asarray(len_b, dtype),
                            jnp.asarray(w, dtype))
            if pending is not None:
                fetched = np.asarray(pending, np.float64)
                total_host = fetched if total_host is None \
                    else total_host + fetched
            pending = cur
            T += nb
    if T == 0:
        raise ValueError("no frames to average")
    if total_host is None:
        return pending, T  # single block: still on device, unfetched
    return total_host + np.asarray(pending, np.float64), T


def _run_stream(run_block, out_shape, blocks, dtype, n_pad_to=1):
    """Stream (pos_b, pos_cols_b|None, lengths_b) host blocks through a
    block runner; returns the frame mean (running sum fetched once per
    block, divided by the streamed frame count on host — the reference's
    accumulate-then-divide order, ``rdf_cn.py:514-521``).

    Double-buffered: jax dispatch is asynchronous, so block k+1 is
    parsed, transferred and dispatched while the device still runs
    block k; the (synchronizing) host fetch of block k happens last."""
    total = np.zeros(out_shape, np.float64)
    T = 0
    pending = None  # device result of the previous block, not yet fetched
    steady = 0
    for pos_b, pc_b, len_b in blocks:
        with stage("frame_block", start=T, frames=pos_b.shape[0]):
            nb = pos_b.shape[0]
            pos_b, pc_b, len_b, w = _pad_block(pos_b, pc_b, len_b,
                                               n_pad_to, target=steady)
            steady = max(steady, pos_b.shape[0])
            pb = jnp.asarray(pos_b, dtype)
            pcb = pb if pc_b is None else jnp.asarray(pc_b, dtype)
            cur = run_block(pb, pcb, jnp.asarray(len_b, dtype),
                            jnp.asarray(w, dtype))
            if pending is not None:
                total += np.asarray(pending, np.float64)
            pending = cur
            T += nb
    if pending is not None:
        total += np.asarray(pending, np.float64)
    if T == 0:
        raise ValueError("no frames to average")
    return total / T


def _scan_frame_mean(step_fn, out_shape, blocks, dtype, runners=None):
    """Mean over frames of ``step_fn(pos_t, pos_cols_t, L_t)`` computed as
    an on-device running sum (``lax.scan`` over frame blocks from the
    ``blocks`` iterator of (pos_b, pos_cols_b|None, lengths_b) host
    arrays). Host/device memory stays O(block), independent of
    trajectory length. jit compiles exactly ONE program per stream: a
    trailing partial block pads (zero-weight) up to the steady block
    shape and reuses the compiled program (see ``_pad_block``).

    ``runners``: optional dict tied to the step's _STEP_CACHE entry;
    block runners are memoized there so repeat entry-point calls on the
    same system reuse the jitted program instead of re-tracing."""
    mesh = _auto_frames_mesh()
    rkey = (tuple(out_shape), jnp.dtype(dtype).name, _mesh_key(mesh))
    run_block = None if runners is None else runners.get(rkey)
    if run_block is None:
        run_block = _make_block_runner(step_fn, out_shape, dtype, mesh=mesh)
        if runners is not None:
            runners[rkey] = run_block
    return _run_stream(run_block, out_shape, blocks, dtype,
                       n_pad_to=1 if mesh is None else mesh.size)


def _make_normalizer(relation_matrix, code_counts_rows, code_counts_cols,
                     n_rows_total, with_full, shell):
    """Reference-exact per-frame normalization (rho_b = count_b / V
    first, then counts / (N_a * rho_b * Vshell), ``rdf_cn.py:288-329``)
    shared by the single-device step and the row-sharded runner (it is
    linear in the counts, so normalize-then-psum == psum-then-
    normalize)."""

    def normalize(full, rels, L):
        sdtype = rels.dtype
        shell_d = jnp.asarray(shell, sdtype)
        V = L[0] * L[1] * L[2]
        rows = []
        if with_full:
            rho = n_rows_total / V
            rows.append(full.astype(sdtype)
                        / (n_rows_total * rho * shell_d))
        for r, (a, b) in enumerate(relation_matrix):
            n_a = float(code_counts_rows[int(a) - 1])
            cnt_b = float(code_counts_cols[int(b) - 1])
            rho_b = cnt_b / V
            rows.append(rels[r].astype(sdtype) / (n_a * rho_b * shell_d))
        return jnp.stack(rows)

    return normalize


def _x64(dtype):
    """Scope in which ``dtype`` arrays exist: float64 runs of the pair
    kernel (exact binning in fast mode) enable x64 for their own
    programs only."""
    if jnp.dtype(dtype) == jnp.float64 and not jax.config.jax_enable_x64:
        return jax.enable_x64(True)
    return contextlib.nullcontext()


def _kernel_side(n_atoms, codes0, sort):
    """Per-frame layout of one side for the pair kernel: returns
    ``side(p, L) -> (positions (n_pad, 3) in tile order, perm (pads -1),
    int32 type codes (pads -1))``. The side is ORB-sorted on the device,
    or left in input order when ``sort`` is False (exact either way: only
    the tile cull's effectiveness changes)."""
    tile = pair_kernel.TILE
    n_pad = -(-n_atoms // tile) * tile
    ident = None if sort else jnp.asarray(np.concatenate(
        [np.arange(n_atoms, dtype=np.int32),
         np.full(n_pad - n_atoms, -1, np.int32)]))

    def side(p, L):
        return pair_ops.orb_sorted_side(p, n_atoms, n_pad, L, codes0,
                                        leaf=tile, perm=ident)

    return side, n_pad


def _make_rdf_step(
    codes, n_codes, n_atoms_rows, lengths, bin_size, n_bins, r_cut,
    relation_matrix, code_counts_rows, code_counts_cols, exclude_self,
    with_full, dtype, n_atoms_cols=None, codes_cols=None,
    n_codes_cols=None, spatial_sort="auto",
):
    """Build the per-frame RDF step function once (layouts, pair path,
    normalization constants) so the sweep layer can reuse ONE compiled
    block program across many same-system trajectories. Returns (step,
    nrows) where step(pos, pos_cols, lengths) -> the normalized
    per-frame rows and nrows = R + (1 if with_full).

    The pair path is ``ops.backend.pair_backend()``'s: on "gpu" the pair
    kernel (``ops.pair_kernel``) over ORB-sorted tiles, with triangle
    mode (each unordered pair once) in the self case; on "cpu" the plain
    XLA histogram (``pairs.pair_hist``) projected onto the relations.
    Both count the same exact integers.

    Per-frame normalization uses the reference's exact operation order:
    rho_b = count_b / V first, then counts / (N_a * rho_b * Vshell)
    (``rdf_cn.py:288-329``).
    """
    self_case = n_atoms_cols is None
    shell = _shell_volumes(bin_size, n_bins)
    n_rows_total = int(code_counts_rows.sum())
    normalize = _make_normalizer(relation_matrix, code_counts_rows,
                                 code_counts_cols, n_rows_total, with_full,
                                 shell)
    nrows = relation_matrix.shape[0] + (1 if with_full else 0)

    if pair_backend() == "cpu":
        layout_r = pair_ops.build_type_layout(codes, n_codes)
        layout_c = (layout_r if self_case
                    else pair_ops.build_type_layout(codes_cols, n_codes_cols))

        def step(p, pc, L):
            pr = pair_ops.gather_padded(p, layout_r)
            pcc = pr if self_case else pair_ops.gather_padded(pc, layout_c)
            hist = pair_ops.pair_hist(
                pr, pcc, layout_r, layout_c, L, bin_size, n_bins, r_cut,
                exclude_self, dtype=p.dtype)
            full, rels = pair_ops.project_relations(
                hist, relation_matrix, with_full)
            return normalize(full, rels, L).astype(p.dtype)

        return step, nrows

    sort = spatial_sort is not False
    rows_side, _ = _kernel_side(
        n_atoms_rows, jnp.asarray(np.asarray(codes) - 1, jnp.int32), sort)
    if not self_case:
        cols_side, _ = _kernel_side(
            n_atoms_cols, jnp.asarray(np.asarray(codes_cols) - 1, jnp.int32),
            sort)
    relations0 = np.asarray(relation_matrix, np.int64) - 1
    interpret = kernel_interpret()

    def step(p, pc, L):
        pr, pm, ty = rows_side(p, L)
        pc3, pmc, tyc = (pr, pm, ty) if self_case else cols_side(pc, L)
        full, rels = pair_kernel.pair_hist_relations(
            pr, pm, ty, pc3, pmc, tyc, relations0, L, bin_size, n_bins,
            r_cut, exclude_self=exclude_self, with_full=with_full,
            triangle=self_case, counts_r=code_counts_rows,
            interpret=interpret)
        return normalize(full, rels, L).astype(p.dtype)

    return step, nrows


def _make_rdf_mean_stream(
    pos, codes, n_codes, lengths, bin_size, n_bins, r_cut, relation_matrix,
    code_counts_rows, code_counts_cols, exclude_self, with_full, dtype,
    pos_cols=None, codes_cols=None, n_codes_cols=None, spatial_sort="auto",
    exact_bins="auto",
):
    """Configure a ``_RdfMeanStream`` (step + cached block runner) for a
    system whose shapes/codes come from ``pos``/first block — everything
    `_rdf_mean` does except consuming the blocks. When the active mesh
    has an ``atoms`` axis (kernel self case), the blocks run through the
    frame+row-sharded runner (``parallel.mesh.make_sharded_relations_
    runner``).

    ``exact_bins``: "auto" (default) runs the pair kernel's pair math
    and the normalization in float64 even in fast mode, so
    ``precision="fast"`` returns g(r) bit-equal to strict (every pair
    binned as the float64 reference loop bins it); True does the same
    and raises where there is no pair kernel (the plain XLA path on the
    CPU); False keeps float32 pair math in fast mode (a ~1e-4 bin-edge
    envelope)."""
    self_case = pos_cols is None
    kernel = pair_backend() == "gpu"
    if exact_bins is True and not kernel:
        raise ValueError(
            "exact_bins=True needs the GPU pair kernel; the plain XLA path "
            "bins in the precision's own dtype")
    run_dtype = jnp.float64 if kernel and exact_bins is not False else dtype
    nrows_out = relation_matrix.shape[0] + (1 if with_full else 0)
    out_shape = (nrows_out, n_bins)
    mesh = _auto_mesh(pos.shape[1], pos.shape[0])
    sharded = (kernel and self_case and exclude_self and mesh is not None
               and len(mesh.axis_names) == 2 and mesh.devices.shape[1] > 1)
    sort = spatial_sort is not False
    n_at = int(pos.shape[1])

    key = (
        "rdf", np.asarray(codes).tobytes(), int(n_codes), n_at,
        float(bin_size), int(n_bins), float(r_cut),
        np.asarray(relation_matrix).tobytes(),
        np.asarray(code_counts_rows).tobytes(),
        np.asarray(code_counts_cols).tobytes(),
        bool(exclude_self), bool(with_full), jnp.dtype(run_dtype).name,
        None if pos_cols is None else int(pos_cols.shape[1]),
        None if codes_cols is None else np.asarray(codes_cols).tobytes(),
        n_codes_cols, sort, pair_backend(), platform(),
    )
    with _x64(run_dtype):
        step, nrows, runners = _step_cache_get(key, lambda: _make_rdf_step(
            codes, n_codes, n_at, lengths, bin_size, n_bins, r_cut,
            relation_matrix, code_counts_rows, code_counts_cols,
            exclude_self, with_full, run_dtype,
            n_atoms_cols=None if pos_cols is None else pos_cols.shape[1],
            codes_cols=codes_cols, n_codes_cols=n_codes_cols,
            spatial_sort=spatial_sort,
        ))
        if sharded:
            rkey = ("rel-sharded", out_shape, _mesh_key(mesh))
            run = runners.get(rkey)
            if run is None:
                from mdproptools_tpu.parallel.mesh import (
                    make_sharded_relations_runner,
                )

                normalize = _make_normalizer(
                    relation_matrix, code_counts_rows, code_counts_cols,
                    int(code_counts_rows.sum()), with_full,
                    _shell_volumes(bin_size, n_bins))
                inner = make_sharded_relations_runner(
                    np.asarray(codes) - 1,
                    np.asarray(relation_matrix, np.int64) - 1,
                    n_at, bin_size, n_bins, r_cut, mesh, with_full,
                    normalize, dtype=run_dtype,
                    interpret=kernel_interpret())

                def run(pb, pcb, len_b, w_b):
                    return inner(pb, len_b, w_b)

                runners[rkey] = run
            return _RdfMeanStream(out_shape, run_dtype, run,
                                  mesh.devices.shape[0], with_full)
        fmesh = _frames_only(mesh)
        rkey = ("frames", out_shape, _mesh_key(fmesh))
        run = runners.get(rkey)
        if run is None:
            run = _make_block_runner(step, out_shape, run_dtype, mesh=fmesh)
            runners[rkey] = run
    return _RdfMeanStream(out_shape, run_dtype, run,
                          1 if fmesh is None else fmesh.size, with_full)


def _rdf_mean(
    pos, codes, n_codes, lengths, bin_size, n_bins, r_cut, relation_matrix,
    code_counts_rows, code_counts_cols, exclude_self, with_full, dtype,
    pos_cols=None, codes_cols=None, n_codes_cols=None, spatial_sort="auto",
    blocks=None, exact_bins="auto",
):
    """Frame-averaged normalized RDF: returns (g_full or None, g_part).

    ``blocks``: optional iterator of (pos_b, pos_cols_b|None, lengths_b)
    host blocks for streaming ingestion (``pos``/``lengths`` then only
    inform shapes — pass the first block). When None,
    ``pos``/``pos_cols``/``lengths`` are full arrays. See
    ``_make_rdf_mean_stream`` for the runner structure and
    ``_make_rdf_step`` for the per-frame math."""
    stream = _make_rdf_mean_stream(
        pos, codes, n_codes, lengths, bin_size, n_bins, r_cut,
        relation_matrix, code_counts_rows, code_counts_cols, exclude_self,
        with_full, dtype, pos_cols=pos_cols, codes_cols=codes_cols,
        n_codes_cols=n_codes_cols, spatial_sort=spatial_sort,
        exact_bins=exact_bins,
    )
    if blocks is None:
        blocks = _array_blocks(pos, lengths, pos_cols)
    for pos_b, pc_b, len_b in blocks:
        stream.fold(pos_b, pc_b, len_b)
    return stream.result()


class _RdfMeanStream:
    """Push-model RDF frame-mean accumulator: ``fold`` one host block at
    a time (double-buffered device dispatch), ``result()`` for the frame
    mean. Built by ``_rdf_mean`` (the pull wrapper) and by the
    shared-parse composite pipeline (``mdproptools_tpu.pipeline``),
    which folds the SAME parsed block into several property streams."""

    def __init__(self, out_shape, dtype, run_block, n_pad_to, with_full):
        self.dtype = dtype
        self._run_block = run_block
        self._n_pad_to = n_pad_to
        self.with_full = with_full
        self.total = np.zeros(out_shape, np.float64)
        self.T = 0
        self._pending = None
        self._steady = 0  # steady block shape; partial blocks pad to it

    def fold(self, pos_b, pc_b, len_b):
        with stage("frame_block", start=self.T, frames=pos_b.shape[0]), \
                _x64(self.dtype):
            nb = pos_b.shape[0]
            pos_b, pc_b, len_b, w = _pad_block(
                pos_b, pc_b, len_b, self._n_pad_to, target=self._steady)
            self._steady = max(self._steady, pos_b.shape[0])
            pb = jnp.asarray(pos_b, self.dtype)
            pcb = pb if pc_b is None else jnp.asarray(pc_b, self.dtype)
            cur = self._run_block(pb, pcb, jnp.asarray(len_b, self.dtype),
                                  jnp.asarray(w, self.dtype))
            self._flush()
            self._pending = cur
            self.T += nb

    def _flush(self):
        if self._pending is not None:
            self.total += np.asarray(self._pending, np.float64)
            self._pending = None

    def result(self):
        self._flush()
        if self.T == 0:
            raise ValueError("no frames to average")
        out = self.total / self.T
        if self.with_full:
            return out[0], out[1:]
        return None, out


def _cn_mean(
    pos, codes, n_codes, lengths, relation_matrix, r_cuts, code_counts_rows,
    exclude_self, dtype,
    pos_cols=None, codes_cols=None, n_codes_cols=None, blocks=None,
):
    """Frame-averaged coordination numbers (R,), normalized per frame by
    the reference-type count (``rdf_cn.py:332-338``). The pair path is
    ``pair_backend()``'s: the kernel's count mode (exact per-relation
    cutoffs, triangle in the self case) over ORB-sorted tiles, or the
    dense ``pair_count_within``."""
    self_case = pos_cols is None

    def build():
        n_ref = np.array(
            [code_counts_rows[int(a) - 1] for a in relation_matrix[:, 0]],
            np.float64,
        )
        if pair_backend() == "cpu":
            layout_r = pair_ops.build_type_layout(codes, n_codes)
            layout_c = (layout_r if self_case
                        else pair_ops.build_type_layout(codes_cols,
                                                        n_codes_cols))

            def count(p, pc, L):
                pr = pair_ops.gather_padded(p, layout_r)
                pcc = (pr if self_case
                       else pair_ops.gather_padded(pc, layout_c))
                return pair_ops.pair_count_within(
                    pr, pcc, layout_r, layout_c, L, relation_matrix,
                    r_cuts, exclude_self, dtype=p.dtype)
        else:
            rows_side, _ = _kernel_side(
                pos.shape[1], jnp.asarray(np.asarray(codes) - 1, jnp.int32),
                True)
            if not self_case:
                cols_side, _ = _kernel_side(
                    pos_cols.shape[1],
                    jnp.asarray(np.asarray(codes_cols) - 1, jnp.int32), True)
            relations0 = np.asarray(relation_matrix, np.int64) - 1
            interpret = kernel_interpret()

            def count(p, pc, L):
                pr, pm, ty = rows_side(p, L)
                pc3, pmc, tyc = (pr, pm, ty) if self_case else cols_side(pc, L)
                return pair_kernel.pair_count_relations(
                    pr, pm, ty, pc3, pmc, tyc, relations0, r_cuts, L,
                    exclude_self, triangle=self_case,
                    counts_r=code_counts_rows, interpret=interpret)

        def step(p, pc, L):
            counts = count(p, pc, L)
            return counts.astype(p.dtype) / jnp.asarray(n_ref, p.dtype)

        return (step,)

    key = (
        "cn", np.asarray(codes).tobytes(), int(n_codes),
        int(pos.shape[1]),
        np.asarray(relation_matrix).tobytes(),
        np.asarray(r_cuts, np.float64).tobytes(),
        np.asarray(code_counts_rows).tobytes(),
        bool(exclude_self), jnp.dtype(dtype).name,
        None if pos_cols is None else int(pos_cols.shape[1]),
        None if codes_cols is None else np.asarray(codes_cols).tobytes(),
        n_codes_cols, pair_backend(), platform(),
    )
    step, runners = _step_cache_get(key, build)
    if blocks is None:
        blocks = _array_blocks(pos, lengths, pos_cols)
    return _scan_frame_mean(step, (relation_matrix.shape[0],), blocks,
                            dtype, runners=runners)


_segment_com_jit = jax.jit(com_ops.segment_com, static_argnums=(3,))


def _mol_coms(traj: Trajectory, system: System, mass, dtype):
    """Per-frame molecular centers of mass from *wrapped* x,y,z — the
    reference's convention in ``_define_mol_cols`` (``rdf_cn.py:218-241``).
    Returns (T, M, 3) numpy float64 and 1-based mol-type codes (M,)."""
    types = traj.data[0, :, traj.columns.index("type")].astype(np.int64)
    masses = np.asarray(mass, np.float64)[types - 1]
    pos = traj.cols(["x", "y", "z"])
    # jitted (cached on shapes): the eager form dispatches ~10 ops per
    # block
    out = _segment_com_jit(
        jnp.asarray(pos, dtype),
        jnp.asarray(masses, dtype),
        jnp.asarray(system.mol_index),
        system.n_molecules,
    )
    return np.asarray(out, np.float64), system.mol_type_of_molecule


# --------------------------------------------------------------------------
# entry points (reference-parity APIs)
# --------------------------------------------------------------------------
def calc_atomic_rdf(
    r_cut,
    bin_size,
    num_types,
    mass,
    partial_relations,
    filename,
    num_mols=None,
    num_atoms_per_mol=None,
    path_or_buff="rdf.csv",
    save_mode=True,
    precision="fast",
    spatial_sort="auto",
    exact_bins="auto",
    skip_frames=0,
    max_frames=None,
):
    """Full and partial atom-atom RDF averaged over all frames matching
    ``filename`` (reference: ``rdf_cn.py:385-530``).

    ``skip_frames``/``max_frames`` select a frame window of the stream
    (cheap skip: cached blocks seek by index, text files wholly inside
    the skip are never parsed) — the restart hooks.

    ``spatial_sort``: "auto"/True (default) sorts atoms into compact
    spatial tiles per frame, so the GPU pair kernel's tile cull skips
    far tile pairs (the O(N^2) -> O(N * n_near) lever for large
    systems); False keeps the input order. Results are bit-identical
    either way (integer counts, order-independent); the plain XLA path
    ignores it.

    ``exact_bins``: "auto" (default) runs the GPU pair kernel's pair
    math and the normalization in float64 in fast mode too, so
    ``precision="fast"`` returns the SAME g(r) as ``precision="strict"``
    (bit-equal, each pair binned exactly as the reference's float64
    loop). False keeps float32 pair math in fast mode (a ~1e-4 bin-edge
    envelope); True forces exact and raises where there is no pair
    kernel (the plain XLA path on the CPU).

    Ingestion is streamed in FRAME_BLOCK-frame blocks (host memory
    O(block x N), any trajectory length); the density consistency check
    uses the first block's volumes."""
    dtype = resolve_dtype(precision)
    first, blocks = _open_stream(filename, skip_frames=skip_frames,
                                 max_frames=max_frames)
    codes, n_codes, _ = _atom_codes(first, num_types, num_mols,
                                    num_atoms_per_mol)
    num_bins = int(r_cut / bin_size)
    relation_matrix = np.asarray(partial_relations).T  # (R, 2)
    lengths = first.box_lengths
    volumes = lengths.prod(axis=1)
    code_counts = np.bincount(codes - 1, minlength=n_codes).astype(np.float64)
    _check_relations(relation_matrix, code_counts, n_codes, volumes, "atom")
    report_density = _density_reporter(code_counts, mass, num_types)

    def pos_blocks():
        for blk in blocks():
            report_density(blk.box_lengths)
            yield blk.cols(["x", "y", "z"]), None, blk.box_lengths

    out = _rdf_mean(
        first.cols(["x", "y", "z"]), codes, n_codes, lengths, bin_size,
        num_bins, float(r_cut), relation_matrix, code_counts, code_counts,
        exclude_self=True, with_full=True, dtype=dtype,
        spatial_sort=spatial_sort, blocks=pos_blocks(),
        exact_bins=exact_bins,
    )
    rdf_full, rdf_part = out
    return _save_rdf(_radii(bin_size, num_bins), relation_matrix, path_or_buff,
                     save_mode, rdf_part, rdf_full)


def calc_atomic_cn(
    r_cut,
    bin_size,
    num_types,
    mass,
    partial_relations,
    filename,
    num_mols=None,
    num_atoms_per_mol=None,
    path_or_buff="cn.csv",
    save_mode=True,
    precision="fast",
):
    """Atom-atom coordination numbers, one exact cutoff per relation
    (reference: ``rdf_cn.py:533-651``). Streamed ingestion."""
    dtype = resolve_dtype(precision)
    first, blocks = _open_stream(filename)
    codes, n_codes, _ = _atom_codes(first, num_types, num_mols,
                                    num_atoms_per_mol)
    relation_matrix = np.asarray(partial_relations).T
    lengths = first.box_lengths
    code_counts = np.bincount(codes - 1, minlength=n_codes).astype(np.float64)
    _check_relations(relation_matrix, code_counts, n_codes,
                     lengths.prod(axis=1), "atom")
    report_density = _density_reporter(code_counts, mass, num_types)

    r_cuts = np.asarray(r_cut, np.float64).reshape(-1)
    if r_cuts.size == 1:
        r_cuts = np.full(relation_matrix.shape[0], float(r_cuts[0]))

    def pos_blocks():
        for blk in blocks():
            report_density(blk.box_lengths)
            yield blk.cols(["x", "y", "z"]), None, blk.box_lengths

    cn = _cn_mean(
        first.cols(["x", "y", "z"]), codes, n_codes, lengths,
        relation_matrix, r_cuts, code_counts,
        exclude_self=True, dtype=dtype, blocks=pos_blocks(),
    )
    return _save_cn(relation_matrix, path_or_buff, cn, save_mode)


def calc_molecular_rdf(
    r_cut,
    bin_size,
    num_types,
    mass,
    partial_relations,
    filename,
    num_mols,
    num_atoms_per_mol,
    path_or_buff="rdf_mol.csv",
    save_mode=True,
    precision="fast",
):
    """Partial RDF between an atom type and molecular centers of mass
    (reference: ``rdf_cn.py:654-756``; one-directional counting as in
    ``_rdf_mol_loop``, ``rdf_cn.py:122-141``). Streamed ingestion with
    per-block segment-sum COMs."""
    dtype = resolve_dtype(precision)
    first, blocks = _open_stream(filename)
    system = System(num_mols, num_atoms_per_mol, mass=mass)
    codes, n_codes, types = _atom_codes(first, num_types, None, None)
    num_bins = int(r_cut / bin_size)
    relation_matrix = np.asarray(partial_relations).T
    lengths = first.box_lengths
    volumes = lengths.prod(axis=1)
    atom_counts = np.bincount(types - 1, minlength=num_types).astype(np.float64)
    mol_pos0, mol_codes = _mol_coms(first, system, mass, dtype)
    mol_counts = np.bincount(mol_codes - 1,
                             minlength=system.n_mol_types).astype(np.float64)
    _check_relations(relation_matrix, mol_counts, n_codes, volumes, "molecule")
    # the reference's _calc_props here counts LAMMPS types (ref_df
    # keeps "type", rdf_cn.py:718-721)
    report_density = _density_reporter(atom_counts, mass, num_types)

    def pos_blocks():
        for i, blk in enumerate(blocks()):
            report_density(blk.box_lengths)
            mp = (mol_pos0 if i == 0
                  else _mol_coms(blk, system, mass, dtype)[0])
            yield blk.cols(["x", "y", "z"]), mp, blk.box_lengths

    _, rdf_part = _rdf_mean(
        first.cols(["x", "y", "z"]), codes, n_codes, lengths, bin_size,
        num_bins, float(r_cut), relation_matrix, atom_counts, mol_counts,
        exclude_self=False, with_full=False, dtype=dtype,
        pos_cols=mol_pos0, codes_cols=mol_codes,
        n_codes_cols=system.n_mol_types, blocks=pos_blocks(),
    )
    return _save_rdf(_radii(bin_size, num_bins), relation_matrix, path_or_buff,
                     save_mode, rdf_part)


def calc_molecular_cn(
    r_cut,
    bin_size,
    num_types,
    mass,
    partial_relations,
    filename,
    num_mols,
    num_atoms_per_mol,
    path_or_buff="cn_mol.csv",
    save_mode=True,
    precision="fast",
):
    """Coordination number between an atom type and molecular COMs
    (reference: ``rdf_cn.py:759-855``). Streamed ingestion."""
    dtype = resolve_dtype(precision)
    first, blocks = _open_stream(filename)
    system = System(num_mols, num_atoms_per_mol, mass=mass)
    codes, n_codes, types = _atom_codes(first, num_types, None, None)
    relation_matrix = np.asarray(partial_relations).T
    lengths = first.box_lengths
    atom_counts = np.bincount(types - 1, minlength=num_types).astype(np.float64)
    mol_pos0, mol_codes = _mol_coms(first, system, mass, dtype)
    report_density = _density_reporter(atom_counts, mass, num_types)

    r_cuts = np.asarray(r_cut, np.float64).reshape(-1)
    if r_cuts.size == 1:
        r_cuts = np.full(relation_matrix.shape[0], float(r_cuts[0]))

    def pos_blocks():
        for i, blk in enumerate(blocks()):
            report_density(blk.box_lengths)
            mp = (mol_pos0 if i == 0
                  else _mol_coms(blk, system, mass, dtype)[0])
            yield blk.cols(["x", "y", "z"]), mp, blk.box_lengths

    cn = _cn_mean(
        first.cols(["x", "y", "z"]), codes, n_codes, lengths,
        relation_matrix, r_cuts, atom_counts,
        exclude_self=False, dtype=dtype,
        pos_cols=mol_pos0, codes_cols=mol_codes,
        n_codes_cols=system.n_mol_types, blocks=pos_blocks(),
    )
    return _save_cn(relation_matrix, path_or_buff, cn, save_mode)


def calc_intermolecular_rdf(
    r_cut,
    bin_size,
    num_types,
    mass,
    partial_relations,
    filename,
    num_mols,
    num_atoms_per_mol,
    path_or_buff="rdf_mol.csv",
    save_mode=True,
    precision="fast",
):
    """COM-COM partial RDF (reference: ``rdf_cn.py:857-903``). Note: like
    the reference, self-pairs are *included* (its ``_rdf_mol_loop`` runs
    mol_data against itself without exclusion), so g(r->0) bins contain
    the self count. Streamed ingestion (per-block segment-sum COMs).

    Divergence: the per-frame density diagnostic the other entry points
    log is skipped here — the reference's ``_calc_props`` call at
    ``rdf_cn.py:877`` counts MOLECULE types but indexes them with
    ``range(num_types)`` (LAMMPS atom types), a KeyError whenever
    num_types exceeds the molecule-type count (the function is marked
    "TODO: recheck" in the reference)."""
    dtype = resolve_dtype(precision)
    first, blocks = _open_stream(filename)
    system = System(num_mols, num_atoms_per_mol, mass=mass)
    num_bins = int(r_cut / bin_size)
    relation_matrix = np.asarray(partial_relations).T
    lengths = first.box_lengths
    volumes = lengths.prod(axis=1)
    mol_pos0, mol_codes = _mol_coms(first, system, mass, dtype)
    mol_counts = np.bincount(mol_codes - 1,
                             minlength=system.n_mol_types).astype(np.float64)
    _check_relations(relation_matrix, mol_counts, system.n_mol_types, volumes,
                     "molecule")

    def pos_blocks():
        for i, blk in enumerate(blocks()):
            mp = (mol_pos0 if i == 0
                  else _mol_coms(blk, system, mass, dtype)[0])
            yield mp, None, blk.box_lengths

    _, rdf_part = _rdf_mean(
        mol_pos0, mol_codes, system.n_mol_types, lengths, bin_size, num_bins,
        float(r_cut), relation_matrix, mol_counts, mol_counts,
        exclude_self=False, with_full=False, dtype=dtype,
        blocks=pos_blocks(),
    )
    return _save_rdf(_radii(bin_size, num_bins), relation_matrix, path_or_buff,
                     save_mode, rdf_part)
