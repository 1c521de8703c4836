"""
Streaming LAMMPS dump parser (replaces the reference's pymatgen
dependency, ``requirements.txt:1`` / ``parse_lammps_dumps``).

Design goals (SURVEY.md section 7, layer 1):
- glob multi-file patterns and sort by the wildcard integer, exactly like
  the reference's parser, so frame order matches;
- parse the whole ATOMS body in one vectorized pass (C-engine CSV reader
  or the optional native C++ parser in ``mdproptools_tpu.io._native``),
  never a per-line Python loop;
- emit fixed-shape ``(frames, atoms, columns)`` float64 arrays sorted by
  atom id, ready for ``jax.device_put``.

Dump schema seen in the bundled data:
``id mol type mass q x y z xu yu zu ix iy iz vx vy vz fx fy fz``.
"""

import glob as _glob
import io as _io
import os
import re
import sys
import threading
from itertools import islice as _islice
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd


@dataclass(frozen=True)
class Box:
    """Simulation box: bounds (3, 2) [lo, hi] per axis; periodicity flags."""

    bounds: np.ndarray  # (3, 2) float64
    periodic: Tuple[bool, bool, bool] = (True, True, True)
    tilt: Optional[np.ndarray] = None  # (3,) xy xz yz for triclinic

    @property
    def lengths(self) -> np.ndarray:
        return self.bounds[:, 1] - self.bounds[:, 0]

    @property
    def volume(self) -> float:
        return float(np.prod(self.lengths))

    def to_lattice_lengths(self) -> np.ndarray:
        """Orthogonal-box lattice lengths (the reference calls
        ``dump.box.to_lattice().lengths``; for orthogonal boxes that is
        simply hi - lo per axis)."""
        return self.lengths


@dataclass
class Frame:
    """One trajectory frame. ``data`` is an (N, C) float64 array whose
    columns are named by ``columns``; rows are sorted by atom id when an
    ``id`` column exists. Non-numeric dump columns (e.g. ``element``)
    live in ``str_data`` as (N,) string arrays, row-aligned with
    ``data`` (pymatgen's parser keeps them in the DataFrame; reference
    consumer: ``cluster_analysis.py:132-133``)."""

    timestep: int
    natoms: int
    box: Box
    columns: List[str]
    data: np.ndarray  # (N, C) float64
    str_data: dict = field(default_factory=dict)

    _index: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self._index = {c: i for i, c in enumerate(self.columns)}

    def col(self, name: str) -> np.ndarray:
        if name in self.str_data:
            return self.str_data[name]
        return self.data[:, self._index[name]]

    def cols(self, names: Sequence[str]) -> np.ndarray:
        idx = [self._index[n] for n in names]
        return self.data[:, idx]

    def has(self, name: str) -> bool:
        return name in self._index or name in self.str_data

    def to_dataframe(self) -> pd.DataFrame:
        df = pd.DataFrame(self.data, columns=self.columns)
        for name, vals in self.str_data.items():
            df[name] = vals
        return df


def _sort_files_by_wildcard(pattern: str, files: List[str]) -> List[str]:
    """Sort globbed files by the integer captured at the wildcard position
    (the reference sorts dump files by timestep embedded in the name)."""
    if len(files) <= 1:
        return files
    regex = re.escape(pattern).replace(r"\*", r"([0-9]+)")
    regex = ".*" + regex

    def key(f):
        m = re.match(regex, f)
        return int(m.group(1)) if m else 0

    return sorted(files, key=key)


def _parse_body(text, ncols: int,
                max_rows: Optional[int] = None) -> np.ndarray:
    """Parse the whitespace-separated ATOMS body (bytes or a zero-copy
    uint8 ndarray view) into (N, ncols) float64. ``max_rows`` is the
    header's atom count when known (saves the native parser a
    newline-counting pass over the body)."""
    try:
        from mdproptools_tpu.io import _native

        arr = _native.parse_floats(text, ncols, max_rows=max_rows)
        if arr is not None:
            return arr
    except Exception:
        pass
    if isinstance(text, np.ndarray):
        text = text.tobytes()
    df = pd.read_csv(
        _io.BytesIO(text), sep=r"\s+", header=None, dtype=np.float64, engine="c"
    )
    return df.to_numpy()


def _sniff_str_columns(text: bytes, columns: List[str]) -> List[int]:
    """Indices of non-numeric columns, sniffed from the first body line
    (LAMMPS dump columns are homogeneously typed)."""
    # NOT text.split(b"\n", 1): that would copy the multi-MB tail
    nl = text.find(b"\n")
    first = (text if nl == -1 else text[:nl]).split()
    out = []
    for k, tok in enumerate(first[: len(columns)]):
        try:
            float(tok)
        except ValueError:
            out.append(k)
    return out


def _parse_mixed_body(text: bytes, columns: List[str], str_idx: List[int]):
    """Parse a body with string columns (e.g. ``element``): numeric
    columns -> (N, n_num) float64, string columns -> dict of (N,) str."""
    df = pd.read_csv(_io.BytesIO(text), sep=r"\s+", header=None,
                     names=columns, engine="c")
    str_names = [columns[k] for k in str_idx]
    num_names = [c for c in columns if c not in str_names]
    data = df[num_names].to_numpy(np.float64)
    str_data = {c: df[c].to_numpy(str) for c in str_names}
    return num_names, data, str_data


def parse_frames_from_text(
    text, sort_by_id: bool = True,
    columns_filter: Optional[Sequence[str]] = None,
) -> Iterator[Frame]:
    """Parse every frame in a dump file's text (str or bytes; the file
    reader passes bytes — a 4.5 MB frame costs ~7 ms of pure UTF-8
    decode as str before any parsing, a third of the whole parse).

    ``columns_filter``: when given, only these numeric columns (plus
    ``id`` when sorting) are converted — the native parser's SIMD
    tokenizer jumps past the rest, skipping ~3/4 of the conversion work
    for the usual 5-of-19-column analyses. Frames then carry just the
    kept columns. Ignored for bodies with string columns (the mixed
    path parses all)."""
    if isinstance(text, str):
        text = text.encode("utf-8", errors="strict")
    pos = 0
    n = len(text)
    while True:
        ts_at = text.find(b"ITEM: TIMESTEP", pos)
        if ts_at == -1:
            break
        # timestep value on the next line
        line_start = text.index(b"\n", ts_at) + 1
        line_end = text.index(b"\n", line_start)
        timestep = int(text[line_start:line_end].strip())

        na_at = text.index(b"ITEM: NUMBER OF ATOMS", line_end)
        line_start = text.index(b"\n", na_at) + 1
        line_end = text.index(b"\n", line_start)
        natoms = int(text[line_start:line_end].strip())

        bb_at = text.index(b"ITEM: BOX BOUNDS", line_end)
        bb_header_end = text.index(b"\n", bb_at)
        bb_header = text[bb_at:bb_header_end]
        flags = [f.decode() for f in
                 bb_header.replace(b"ITEM: BOX BOUNDS", b"").split()]
        triclinic = any(f in ("xy", "xz", "yz") for f in flags)
        periodic = tuple(f == "pp" for f in flags if f in ("pp", "ff", "sf", "fm", "p", "f"))
        if len(periodic) != 3:
            pp = [f for f in flags if f not in ("xy", "xz", "yz")]
            periodic = tuple(x.startswith("p") for x in pp[:3]) or (True,) * 3
        if triclinic:
            # LAMMPS triclinic bounds are tilt-inflated (xlo_bound = xlo +
            # min(0, xy, xz, xy+xz), ...), so hi-lo is NOT the cell length;
            # all downstream minimum-image math assumes orthogonal boxes
            # (the reference's per-axis wrap, rdf_cn.py:50-55, does too).
            raise ValueError(
                "triclinic dump boxes (xy/xz/yz tilt) are not supported; "
                "minimum-image analysis here assumes orthogonal cells"
            )
        bounds = np.zeros((3, 2))
        tilt = np.zeros(3) if triclinic else None
        cursor = bb_header_end + 1
        for ax in range(3):
            line_end = text.index(b"\n", cursor)
            parts = text[cursor:line_end].split()
            bounds[ax, 0] = float(parts[0])
            bounds[ax, 1] = float(parts[1])
            if triclinic and len(parts) > 2:
                tilt[ax] = float(parts[2])
            cursor = line_end + 1

        at_at = text.index(b"ITEM: ATOMS", cursor)
        at_header_end = text.index(b"\n", at_at)
        columns = [c.decode() for c in
                   text[at_at:at_header_end].replace(b"ITEM: ATOMS",
                                                     b"").split()]
        body_start = at_header_end + 1
        next_item = text.find(b"ITEM: TIMESTEP", body_start)
        body_end = next_item if next_item != -1 else n
        # zero-copy view of the body: slicing the multi-MB bytes object
        # per frame cost a fresh allocation + memcpy on the hot path
        body = np.frombuffer(text, np.uint8)[body_start:body_end]
        # string-column sniff reads only the first row: a small slice
        sniff = text[body_start:min(body_start + 65536, body_end)]
        if columns_filter is not None:
            missing = [c for c in columns_filter if c not in columns]
            if missing:
                raise ValueError(
                    f"columns_filter names {missing} not present in this "
                    f"dump's ATOMS columns {columns}"
                )
        str_idx = _sniff_str_columns(sniff, columns)
        if str_idx:
            num_columns, data, str_data = _parse_mixed_body(
                body.tobytes(), columns, str_idx)
        elif columns_filter is not None:
            want = set(columns_filter)
            if sort_by_id:
                want.add("id")
            keep_idx = [k for k, c in enumerate(columns) if c in want]
            num_columns, str_data = [columns[k] for k in keep_idx], {}
            data = None
            if len(keep_idx) < len(columns):
                try:
                    from mdproptools_tpu.io import _native

                    # natoms + 1, not natoms: a malformed body with
                    # EXTRA rows must overrun the expected count so the
                    # shape check below still catches it (at natoms the
                    # parser would clamp and silently drop the excess)
                    data = _native.parse_floats_cols(
                        body, len(columns), keep_idx, max_rows=natoms + 1)
                except Exception:
                    data = None
            if data is None:
                data = _parse_body(body, len(columns),
                                   max_rows=natoms + 1)[:, keep_idx]
        else:
            num_columns, str_data = columns, {}
            data = _parse_body(body, len(columns), max_rows=natoms + 1)
        if data.shape[0] != natoms:
            raise ValueError(
                f"dump frame at timestep {timestep}: expected {natoms} atoms, "
                f"parsed {data.shape[0]}"
            )
        if sort_by_id and "id" in num_columns:
            ids = data[:, num_columns.index("id")]
            # dumps written id-ordered (common for post-processed or
            # replicated trajectories) skip the argsort + 4 MB gather
            if ids.size > 1 and not np.all(ids[1:] > ids[:-1]):
                order = np.argsort(ids, kind="stable")
                data = data[order]
                str_data = {c: v[order] for c, v in str_data.items()}
        yield Frame(timestep, natoms, Box(bounds, periodic, tilt),
                    num_columns, data, str_data)
        pos = body_end


def parse_lammps_dumps(
    pattern: str, sort_by_id: bool = True, workers: Optional[int] = None,
    columns: Optional[Sequence[str]] = None, skip_frames: int = 0,
    _files: Optional[Sequence[str]] = None,
) -> Iterator[Frame]:
    """Lazily yield frames from a dump file or a ``*`` glob pattern of
    dump files (sorted by the wildcard integer), matching the reference's
    iteration order.

    Multi-file patterns parse files on a bounded thread pool (the C body
    parser and pandas release the GIL), keeping at most ~2x ``workers``
    files in flight so streaming memory stays bounded; yield order is
    unchanged. ``workers=1`` forces sequential parsing.

    ``skip_frames`` drops the first frames cheaply: files wholly inside
    the skip are counted by a raw byte scan for frame headers (IO only,
    no tokenizing) and never parsed; the boundary file parses and drops
    its prefix — the frame window of ``calc_atomic_rdf(skip_frames=)``."""
    if _files is not None:
        files = list(_files)
    else:
        files = _sort_files_by_wildcard(pattern, _glob.glob(pattern))
        if not files:
            raise FileNotFoundError(f"no dump files match {pattern!r}")
    to_skip = int(skip_frames)
    if to_skip:
        kept = []
        for i, f in enumerate(files):
            with open(f, "rb") as fh:
                n_in_file = fh.read().count(b"ITEM: TIMESTEP")
            if to_skip >= n_in_file:
                to_skip -= n_in_file
                continue
            kept = files[i:]
            break
        files = kept
        if not files:
            return

    def load(f):
        with open(f, "rb") as fh:  # bytes: skip the UTF-8 decode pass
            text = fh.read()
        return list(parse_frames_from_text(
            text, sort_by_id=sort_by_id, columns_filter=columns))

    if to_skip:
        # boundary file: parse it alone, drop the skipped prefix, then
        # continue with the pooled path over the remaining files
        first_frames = load(files[0])[to_skip:]

        def chain():
            yield from first_frames
            if len(files) > 1:
                yield from parse_lammps_dumps(
                    "", sort_by_id=sort_by_id, workers=workers,
                    columns=columns, _files=files[1:])

        yield from chain()
        return

    if workers is None:
        workers = min(8, os.cpu_count() or 1)
    if len(files) <= 1 or workers <= 1:
        for f in files:
            yield from load(f)
        return

    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as ex:
        pending: deque = deque()
        it = iter(files)
        for f in _islice(it, 2 * workers):
            pending.append(ex.submit(load, f))
        while pending:
            fut = pending.popleft()
            nxt = next(it, None)
            if nxt is not None:
                pending.append(ex.submit(load, nxt))
            yield from fut.result()


@dataclass
class Trajectory:
    """Fixed-shape trajectory: the device-feed format.

    - ``timesteps``: (T,) int64
    - ``box_bounds``: (T, 3, 2) float64
    - ``columns``: column names of the last axis of ``data``
    - ``data``: (T, N, C) float64, frames sorted by atom id
    """

    timesteps: np.ndarray
    box_bounds: np.ndarray
    columns: List[str]
    data: np.ndarray
    periodic: Tuple[bool, bool, bool] = (True, True, True)

    _index: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self._index = {c: i for i, c in enumerate(self.columns)}

    @property
    def n_frames(self) -> int:
        return self.data.shape[0]

    @property
    def n_atoms(self) -> int:
        return self.data.shape[1]

    def col(self, name: str) -> np.ndarray:
        """(T, N) slice of one column."""
        return self.data[:, :, self._index[name]]

    def cols(self, names: Sequence[str]) -> np.ndarray:
        """(T, N, len(names)) slice."""
        idx = [self._index[n] for n in names]
        return self.data[:, :, idx]

    def cols_as(self, names: Sequence[str], dtype) -> np.ndarray:
        """(T, N, len(names)) copy cast to ``dtype`` in ONE pass — the
        fancy-index select and the ``astype`` otherwise each materialize
        a (T, N, C) temporary, which costs real wall-clock at streaming
        block sizes (device feeds convert f64 blocks to f32)."""
        idx = [self._index[n] for n in names]
        out = np.empty(self.data.shape[:2] + (len(idx),), dtype)
        for j, ix in enumerate(idx):
            out[:, :, j] = self.data[:, :, ix]
        return out

    def has(self, name: str) -> bool:
        return name in self._index

    @property
    def box_lengths(self) -> np.ndarray:
        """(T, 3) box lengths."""
        return self.box_bounds[:, :, 1] - self.box_bounds[:, :, 0]

    def frame(self, t: int) -> Frame:
        return Frame(
            int(self.timesteps[t]),
            self.n_atoms,
            Box(self.box_bounds[t], self.periodic),
            list(self.columns),
            self.data[t],
        )


def peek_dump_columns(pattern: str) -> List[str]:
    """Column names of the first frame's ATOMS section without parsing
    any data (used to restrict ``read_trajectory(columns=...)`` to the
    intersection a property module actually needs)."""
    files = _sort_files_by_wildcard(pattern, _glob.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no dump files match {pattern!r}")
    with open(files[0], "r") as fh:
        for line in fh:
            if line.startswith("ITEM: ATOMS"):
                return line.replace("ITEM: ATOMS", "").split()
    raise ValueError(f"no ATOMS section in {files[0]!r}")


BLOCK_TARGET_BYTES = 256 << 20  # soft cap on one stacked block buffer
#   Wide-column streams (the 12-column composite parse at 42k atoms
#   costs 515 MB/block at 128 frames) otherwise multiply through the
#   pipeline: pool + prefetch queue + consumer + being-filled ~= 5 live
#   blocks (measured, benchmarks/memory_probe.json). Shrinking frames-
#   per-block for wide/large systems bounds that product; the extra
#   per-block device fetch (~0.25 s) stays under ~4 ms/frame at the cap.


def _block_frames_for(n_atoms: int, n_cols: int,
                      block_frames: int) -> int:
    per_frame = max(n_atoms * n_cols * 8, 1)
    return int(min(block_frames,
                   max(8, BLOCK_TARGET_BYTES // per_frame)))


class _BlockBufferPool:
    """Recycle the O(block x N x C) stacked-block buffers.

    On the virtualized hosts this package targets, first-touch page
    faults on a freshly mapped buffer can run ~100x slower than a warm
    write (see ``utilities/host.py``); glibc heap recycling alone is
    hit-or-miss for these ~200 MB chunks once the heap fragments
    (measured: the per-block stack alternated 0.2 s / 10-22 s at
    10k-frame scale). This pool makes the reuse deterministic: a buffer
    is handed out again ONLY when nothing outside the pool references
    it (refcount guard), so a consumer that legitimately retains the
    yielded ``Trajectory`` (or any view into it) simply pins that
    buffer and the pool allocates another — correctness never depends
    on consumer discipline."""

    _MAX = 8  # distinct pinned/in-flight buffers before oldest is dropped

    def __init__(self):
        self._bufs: List[np.ndarray] = []
        self._lock = threading.Lock()

    def get(self, shape) -> np.ndarray:
        with self._lock:
            for b in self._bufs:
                # refs: pool list + loop binding + getrefcount argument
                if b.shape == shape and sys.getrefcount(b) == 3:
                    return b
            b = np.empty(shape, np.float64)
            self._bufs.append(b)
            if len(self._bufs) > self._MAX:
                self._bufs.pop(0)
            return b


_block_pool = _BlockBufferPool()


def _stack_frames(frames: List[Frame],
                  columns: Optional[Sequence[str]]) -> Trajectory:
    keep = list(columns) if columns is not None else list(frames[0].columns)
    bad = [c for c in keep if c in frames[0].str_data]
    if bad:
        raise ValueError(
            f"string-valued dump columns {bad} cannot be stacked into a "
            "numeric Trajectory; iterate parse_lammps_dumps frames and "
            "read them via Frame.col()"
        )
    n_atoms = frames[0].natoms
    data = _block_pool.get((len(frames), n_atoms, len(keep)))
    timesteps = np.empty(len(frames), np.int64)
    box_bounds = np.empty((len(frames), 3, 2), np.float64)
    for t, fr in enumerate(frames):
        if fr.natoms != n_atoms:
            raise ValueError("atom count varies across frames; cannot stack")
        if fr.columns == keep:
            # column order matches the request: one straight memcpy
            data[t] = fr.data
        else:
            # per-column copies into the pooled buffer (no (N, C) temp
            # from a fancy-index select)
            src, dst = fr.data, data[t]
            for j, name in enumerate(keep):
                dst[:, j] = src[:, fr._index[name]]
        timesteps[t] = fr.timestep
        box_bounds[t] = fr.box.bounds
    return Trajectory(timesteps, box_bounds, keep, data,
                      frames[0].box.periodic)


def iter_trajectory_blocks(
    pattern: str,
    columns: Optional[Sequence[str]] = None,
    block_frames: int = 128,
    sort_by_id: bool = True,
    max_frames: Optional[int] = None,
    cache="auto",
    skip_frames: int = 0,
) -> Iterator[Trajectory]:
    """Stream a dump pattern as fixed-shape ``Trajectory`` blocks of at
    most ``block_frames`` frames each. Host memory stays O(block x N x C)
    regardless of trajectory length — the device-feed analogue of the
    reference's lazy ``parse_lammps_dumps`` generator (used lazily at
    ``diffusion.py:172``; its CHANGELOG v0.0.4 explicitly moved away
    from read-all-at-once). Frame order matches ``read_trajectory``.

    ``cache``: "auto" (default) serves the blocks from a valid columnar
    cache next to the data when one exists (``io.cache`` — per-column
    binary blocks read at page-cache speed, skipping text parsing
    entirely); a directory path forces that cache; False always parses
    text. Caches are only ever CREATED explicitly (``io.cache
    .build_cache`` / ``mdpt cache``), never as a side effect here.

    ``skip_frames`` drops the first frames cheaply (cache: indexed block
    skip; text: unparsed byte-scan file skip) — the frame window of
    ``calc_atomic_rdf(skip_frames=)``. ``max_frames`` counts after the
    skip."""
    if cache and sort_by_id:
        from mdproptools_tpu.io import cache as _cache

        meta = _cache.load_meta(
            pattern, None if cache == "auto" or cache is True else cache)
        if meta is not None:
            cols_ok = columns is None or all(
                c in meta["columns"] for c in columns)
            if cols_ok:
                yield from _cache.iter_cached_blocks(
                    meta, columns=columns, block_frames=block_frames,
                    max_frames=max_frames, skip_frames=skip_frames)
                return
            if cache != "auto" and cache is not True:
                raise ValueError(
                    f"cache at {cache!r} lacks requested columns "
                    f"{[c for c in columns if c not in meta['columns']]}")
    frames: List[Frame] = []
    seen = 0
    eff_block = block_frames
    for fr in parse_lammps_dumps(pattern, sort_by_id=sort_by_id,
                                 columns=columns,
                                 skip_frames=skip_frames):
        if not frames and seen == 0:
            # apply the block-byte cap once the first frame's (N, C)
            # is known; all consumers handle variable block sizes (the
            # remainder block already exercises that)
            eff_block = _block_frames_for(fr.natoms, len(fr.columns),
                                          block_frames)
        frames.append(fr)
        seen += 1
        if len(frames) == eff_block:
            yield _stack_frames(frames, columns)
            frames = []
        if max_frames is not None and seen >= max_frames:
            break
    if frames:
        yield _stack_frames(frames, columns)


def prefetch_iter(iterable, depth: int = 2):
    """Run an iterator in a background thread with a bounded queue so
    host-side parsing overlaps device compute (double buffering when
    depth=2). Exceptions propagate to the consumer.

    If the consumer stops early (an exception in its loop body, a
    ``break``, or generator GC), the feed thread is told to stop and the
    queue is drained — otherwise it would block forever on ``q.put``,
    leaking the thread plus the ~O(block x N x C) buffers it holds
    (every streaming entry point wraps its block iterator in this)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()

    def feed():
        try:
            it = iter(iterable)
            while not stop.is_set():
                try:
                    item = next(it)
                except StopIteration:
                    item = sentinel
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if item is sentinel:
                    return
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            while not stop.is_set():
                try:
                    q.put(exc, timeout=0.2)
                    return
                except queue.Full:
                    continue

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def read_trajectory(
    pattern: str,
    columns: Optional[Sequence[str]] = None,
    sort_by_id: bool = True,
    max_frames: Optional[int] = None,
) -> Trajectory:
    """Read a dump pattern into one fixed-shape Trajectory.

    ``columns`` restricts which dump columns are kept (saves host RAM and
    host->device bandwidth); atom count must be constant across frames.
    For long trajectories prefer ``iter_trajectory_blocks`` (bounded
    memory).
    """
    frames: List[Frame] = []
    for fr in parse_lammps_dumps(pattern, sort_by_id=sort_by_id,
                                 columns=columns):
        frames.append(fr)
        if max_frames is not None and len(frames) >= max_frames:
            break
    if not frames:
        raise ValueError(f"no frames parsed from {pattern!r}")
    return _stack_frames(frames, columns)
