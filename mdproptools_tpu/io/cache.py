"""
Columnar trajectory cache: parse a dump pattern ONCE, serve every later
analysis pass from per-column binary blocks at page-cache speed.

Why (beyond-reference): text parsing bounds the streaming MSD/GK legs
on a host with few cores, where neither the thread-pooled parser nor a
process pool can lift it. A LAMMPS dump stores every float as ~13 bytes
of text that cost ~100 ns each to convert; the same column read back from a binary block is a pure
page-cache memcpy. The cache stores each dump column as its own
``.npy`` per frame block, so an analysis that needs 3 of 13 columns
reads exactly 3/13 of the bytes — the reference has no equivalent
(it re-parses per property; ``parse_lammps_dumps`` at
``lammps/outputs.py`` via pymatgen).

Layout (one directory per cached pattern)::

    <cache_dir>/meta.json                 columns, timesteps, blocks,
                                          box bounds, fingerprint,
                                          per-column-block encodings
    <cache_dir>/c_<name>.<block>.npy      (B, N), one per column per
                                          frame block: int32
                                          decimal-quantized when
                                          losslessly possible, else the
                                          build float dtype

Decimal-exact quantization (format v4): LAMMPS dumps print every value
with limited decimal precision, so float columns store at roughly HALF
the float64 bytes while reconstructing BIT-EXACTLY — verified per
block at build time, with a float64 fallback wherever neither encoding
holds:

- fixed-decimal columns (``%f``-style: coordinates, charges, masses)
  sit on an exact 10^-p grid -> int32 numerators plus one p. Decode is
  one correctly-rounded f64 division of the exact numerator by the
  exact 10^p, returning the nearest-f64 of the same rational the text
  parser rounded.
- significant-digit columns (``%g``-style: velocities, forces,
  unwrapped coords — 6 significant digits, decimal count varies with
  magnitude) -> int32 mantissa plus PER-VALUE int8 exponent
  (m * 10^-p). Decode is a power-of-ten table gather + the same
  correctly-rounded exact division (~5 ns/element). An earlier v3
  format stored these as f32 + round-back-to-s-digits; bit-exact too,
  but its ~30 ns/element decode made cached reads slower than v1's
  plain-f64 memcpy — the mantissa form restores decode to memcpy
  speed at 5 bytes/value.

The build verifies every block's round trip with the same tables
decode uses, so any edge case (power-of-ten boundaries, subnormals,
NaN/inf) simply falls back to float64 storage.

Consumers never import this directly: ``iter_trajectory_blocks(...,
cache="auto")`` (the default) transparently serves from a valid cache
sitting next to the data and falls back to text parsing otherwise.
Build one explicitly with ``build_cache()`` or ``mdpt cache``.

The fingerprint pins the sorted file list plus each file's byte size,
so a changed/extended trajectory invalidates the cache instead of
serving stale frames; symlinked pseudo-trajectories resolve through
``os.path.getsize`` (contents, not link identity).
"""

import glob as _glob
import hashlib
import json
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

CACHE_DIRNAME = ".mdpt_cache"
_FORMAT_VERSION = 4  # v4: per-value mantissa/exponent for %g columns
_MAX_DECIMALS = 9  # 10^9 < 2^31: the densest grid an int32 can carry


def _try_quantize(a, p_hint=None):
    """(int32 array, p) when ``a`` is exactly an int32 grid of 10^-p
    (verified by bit-exact round trip), else (None, None). ``p_hint``
    short-circuits the search — dump columns keep one precision, so
    after block 0 the hint almost always hits on the first try."""
    order = ([p_hint] + [p for p in range(_MAX_DECIMALS + 1)
                         if p != p_hint]
             if p_hint is not None else range(_MAX_DECIMALS + 1))
    for p in order:
        scale = np.float64(10.0) ** p
        q = np.round(a * scale)
        with np.errstate(over="ignore", invalid="ignore"):
            if not np.all(np.abs(q) < 2147483648.0):
                continue
        if np.array_equal(q / scale, a):
            return q.astype(np.int32), p
    return None, None


# exact powers of ten for the mantissa decode: indexed by exponent +
# _P10_OFF. THE TABLE IS THE DEFINITION of 10^e here — the build-time
# encoder and its verification both read it, so decode can never
# disagree with a libm.
_P10_OFF = 64
_P10 = np.power(10.0, np.arange(-_P10_OFF, _P10_OFF + 2, dtype=np.float64))
_LOG10_2 = 0.30102999566398114


def _decade(az):
    """Vectorized e = max{k : _P10[k] <= az} for positive ``az`` (the
    decimal decade), from the binary exponent (``np.frexp``) plus two
    table compares — floor(log10) costs ~150 ns/element (measured; it
    made v2 cache reads SLOWER than v1's plain-f64 memcpy), this runs
    at gather speed. Zeros/NaN/inf return an in-range garbage decade;
    callers' round-trip verification rejects those values."""
    _, be = np.frexp(az)
    d = be.astype(np.float64)
    d -= 1.0
    d *= _LOG10_2  # az in [2^(be-1), 2^be): within 0.302 below log10(az)
    np.floor(d, out=d)
    d = d.astype(np.int64)
    np.clip(d, 8 - _P10_OFF, _P10_OFF - 8, out=d)  # subnormal/huge guard
    d += az >= _P10[d + (1 + _P10_OFF)]
    d -= az < _P10[d + _P10_OFF]
    return d


def _try_mantissa(a, s_hint=None):
    """((int32 mantissa, int8 exponent) arrays, s) when every value of
    ``a`` is an s-significant-digit decimal m * 10^-p with |m| < 2^31
    (verified by bit-exact round trip), else (None, None).

    This is the fixed-decimal idea with a PER-VALUE exponent, covering
    %g-printed columns (velocities, forces, unwrapped coordinates)
    whose decimal count varies with magnitude. Decode is one table
    gather + one correctly-rounded f64 division of exact operands —
    ~5 ns/element vs ~30 for the v3 round-to-s-digits expression
    (measured; that decode cost made v3 cached legs slower than v1's
    plain-f64 reads, defeating the cache's purpose)."""
    az = np.abs(a)
    d = _decade(az)
    order = ([s_hint] + [s for s in (6, 7) if s != s_hint]
             if s_hint is not None else (6, 7))
    for s in order:
        p = (s - 1) - d  # value-wise decimals so m has s digits
        np.clip(p, -_P10_OFF, _P10_OFF, out=p)
        scale = _P10[p + _P10_OFF]
        m = np.round(a * scale)
        with np.errstate(over="ignore", invalid="ignore"):
            if not np.all(np.abs(m) < 2147483648.0):
                continue
        if np.array_equal(m / scale, a):
            return (m.astype(np.int32), p.astype(np.int8)), s
    return None, None


def _pattern_files(pattern: str) -> List[str]:
    from mdproptools_tpu.io.lammps_dump import _sort_files_by_wildcard

    files = _sort_files_by_wildcard(pattern, _glob.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no dump files match {pattern!r}")
    return files


def _fingerprint(files: Sequence[str]) -> str:
    h = hashlib.sha256()
    for f in files:
        h.update(os.path.basename(f).encode())
        h.update(str(os.path.getsize(f)).encode())
    return h.hexdigest()[:16]


def default_cache_dir(pattern: str) -> str:
    """<data dir>/.mdpt_cache/<basename-pattern>: one cache per pattern
    name, fingerprint-checked at read time."""
    files = _pattern_files(pattern)
    base = os.path.dirname(os.path.abspath(files[0]))
    slug = os.path.basename(pattern).replace("*", "_STAR_")
    return os.path.join(base, CACHE_DIRNAME, slug)


def build_cache(
    pattern: str,
    cache_dir: Optional[str] = None,
    columns: Optional[Sequence[str]] = None,
    block_frames: int = 128,
    dtype=np.float64,
    progress: bool = False,
) -> str:
    """Parse ``pattern`` once and write the columnar cache. Returns the
    cache directory. ``columns=None`` caches every numeric dump column
    (any later column subset is then servable); a narrowed list makes a
    smaller, purpose-built cache. Blocks sitting on an exact decimal
    grid store as int32 (half the float64 bytes, bit-exact round trip —
    see the module docstring); ``dtype`` is the fallback for blocks
    that do not."""
    from mdproptools_tpu.io.lammps_dump import iter_trajectory_blocks

    files = _pattern_files(pattern)
    cache_dir = cache_dir or default_cache_dir(pattern)
    os.makedirs(cache_dir, exist_ok=True)

    blocks_meta = []
    cached_cols = None
    timesteps_all = []
    bounds_all = []
    encodings: dict = {}  # column -> [p per block, None = float dtype]
    p_hints: dict = {}
    periodic = (True, True, True)
    for i, blk in enumerate(iter_trajectory_blocks(
            pattern, columns=list(columns) if columns else None,
            block_frames=block_frames, cache=False)):
        if cached_cols is None:
            cached_cols = list(blk.columns)
            encodings = {name: [] for name in cached_cols}
        for j, name in enumerate(cached_cols):
            col = blk.data[:, :, j]
            hint = p_hints.get(name)
            enc = None
            out = None
            if not (isinstance(hint, str)):
                q, p = _try_quantize(col, hint)
                if q is not None:
                    p_hints[name] = enc = p
                    out = q
            if out is None:
                s_hint = int(hint[1:]) if isinstance(hint, str) else None
                me, s = _try_mantissa(col, s_hint)
                if me is not None:
                    p_hints[name] = enc = f"m{s}"
                    out, exps = me
                    np.save(os.path.join(cache_dir,
                                         f"c_{name}.{i}.e.npy"), exps)
            if out is None:
                out = np.ascontiguousarray(col, dtype)
            encodings[name].append(enc)
            np.save(os.path.join(cache_dir, f"c_{name}.{i}.npy"), out)
        blocks_meta.append({"frames": int(blk.n_frames),
                            "atoms": int(blk.n_atoms)})
        timesteps_all.append(blk.timesteps.tolist())
        bounds_all.append(blk.box_bounds.tolist())
        periodic = tuple(bool(p) for p in blk.periodic)
        if progress:
            print(f"cache: block {i} ({blk.n_frames} frames)",
                  flush=True)

    meta = {
        "version": _FORMAT_VERSION,
        "fingerprint": _fingerprint(files),
        "columns": cached_cols,
        "dtype": np.dtype(dtype).name,
        "block_frames": int(block_frames),
        "blocks": blocks_meta,
        "timesteps": timesteps_all,
        "box_bounds": bounds_all,
        "periodic": list(periodic),
        "encodings": encodings,
    }
    with open(os.path.join(cache_dir, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    return cache_dir


def load_meta(pattern: str, cache_dir: Optional[str] = None):
    """Cache metadata if a VALID cache exists for ``pattern`` (format
    version + fingerprint match), else None."""
    cache_dir = cache_dir or default_cache_dir(pattern)
    meta_path = os.path.join(cache_dir, "meta.json")
    if not os.path.exists(meta_path):
        return None
    try:
        with open(meta_path) as fh:
            meta = json.load(fh)
    except (OSError, ValueError):
        return None
    if meta.get("version") != _FORMAT_VERSION:
        return None
    try:
        files = _pattern_files(pattern)
    except FileNotFoundError:
        return None
    if meta.get("fingerprint") != _fingerprint(files):
        return None
    meta["_dir"] = cache_dir
    return meta


def iter_cached_blocks(
    meta,
    columns: Optional[Sequence[str]] = None,
    block_frames: int = 128,
    max_frames: Optional[int] = None,
    skip_frames: int = 0,
) -> Iterator["Trajectory"]:
    """Yield ``Trajectory`` blocks from a cache, reading ONLY the
    requested columns (each column is its own file — the point of the
    columnar layout). Blocks are re-chunked to ``block_frames`` when it
    differs from the cached chunking; output frame order always matches
    the text parser's.

    ``skip_frames`` drops the first frames WITHOUT reading them (whole
    cached blocks are skipped by the frame index; a partial skip starts
    mid-block) — the frame window of ``calc_atomic_rdf(skip_frames=)``.
    ``max_frames`` counts frames AFTER the skip."""
    from mdproptools_tpu.io.lammps_dump import (
        Trajectory,
        _block_frames_for,
        _block_pool,
    )

    cache_dir = meta["_dir"]
    cached_cols = meta["columns"]
    keep = list(columns) if columns is not None else list(cached_cols)
    missing = [c for c in keep if c not in cached_cols]
    if missing:
        raise ValueError(
            f"cache at {cache_dir!r} lacks columns {missing} "
            f"(cached: {cached_cols}); rebuild with build_cache()")
    periodic = tuple(meta["periodic"])
    if meta["blocks"]:
        block_frames = _block_frames_for(
            meta["blocks"][0]["atoms"], len(keep), block_frames)

    # (cached block, frame range) spans re-chunked to block_frames
    out_ts: list = []
    out_bounds: list = []
    spans: list = []  # (block_idx, lo, hi) making up the current output
    n_out = 0
    emitted = 0

    encodings = meta.get("encodings", {})

    scratch_buf = None

    def emit():
        nonlocal out_ts, out_bounds, spans, n_out, scratch_buf
        n_atoms = meta["blocks"][spans[0][0]]["atoms"]
        data = _block_pool.get((n_out, n_atoms, len(keep)))
        # decode scratch: column j of the (B, N, C) output is a STRIDED
        # view, and elementwise decode on strided memory runs ~3x
        # slower than contiguous (measured 18.3 -> ~6 ms/frame at 42k).
        # Decode contiguously here, then store into the view once —
        # the same single strided store the plain-f64 format paid.
        # The scratch is REUSED across emits: at ~43 MB it exceeds
        # glibc's 32 MiB M_MMAP_THRESHOLD cap, so a fresh buffer per
        # block would pay the ~100x first-touch fault cost every block
        # (~0.5 s/block at 42k — measured as a ~40 s leg regression).
        if (scratch_buf is None or scratch_buf.shape[1] != n_atoms
                or scratch_buf.shape[0] < n_out):
            scratch_buf = np.empty((n_out, n_atoms), np.float64)
        scratch = scratch_buf
        row = 0
        for bi, lo, hi in spans:
            for j, name in enumerate(keep):
                arr = np.load(
                    os.path.join(cache_dir, f"c_{name}.{bi}.npy"),
                    mmap_mode="r")
                tmp = scratch[:hi - lo]
                tmp[...] = arr[lo:hi]  # int32 -> f64 cast is exact
                enc = (encodings.get(name) or [None] * (bi + 1))[bi]
                if isinstance(enc, str):  # f"m{s}": per-value exponent
                    exps = np.load(
                        os.path.join(cache_dir, f"c_{name}.{bi}.e.npy"),
                        mmap_mode="r")
                    np.divide(tmp, _P10[exps[lo:hi].astype(np.int64)
                                       + _P10_OFF], out=tmp)
                elif enc:  # int p: exact numerator / exact 10^p
                    np.divide(tmp, np.float64(10.0) ** enc, out=tmp)
                data[row:row + (hi - lo), :, j] = tmp
            row += hi - lo
        traj = Trajectory(
            np.asarray(out_ts, np.int64),
            np.asarray(out_bounds, np.float64),
            keep, data, periodic)
        out_ts, out_bounds, spans, n_out = [], [], [], 0
        return traj

    to_skip = int(skip_frames)
    for bi, binfo in enumerate(meta["blocks"]):
        ts_b = meta["timesteps"][bi]
        bounds_b = meta["box_bounds"][bi]
        lo = 0
        if to_skip:
            if to_skip >= binfo["frames"]:
                to_skip -= binfo["frames"]
                continue
            lo = to_skip
            to_skip = 0
        while lo < binfo["frames"]:
            room = block_frames - n_out
            hi = min(binfo["frames"], lo + room)
            if max_frames is not None:
                hi = min(hi, lo + (max_frames - emitted - n_out))
            if hi <= lo:
                break
            spans.append((bi, lo, hi))
            out_ts.extend(ts_b[lo:hi])
            out_bounds.extend(bounds_b[lo:hi])
            n_out += hi - lo
            lo = hi
            if n_out == block_frames:
                emitted += n_out
                yield emit()
        if max_frames is not None and emitted + n_out >= max_frames:
            break
    if n_out:
        emitted += n_out
        yield emit()
