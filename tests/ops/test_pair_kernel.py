"""The GPU pair kernel (``ops.pair_kernel``) in Pallas interpret mode
against the plain XLA path (``pairs.pair_hist`` / ``pair_count_within``)
and the float64 NumPy oracle; its keep mask against brute force; the
ORB tile sorts; the backend decision."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from mdproptools_tpu.ops import backend, pair_kernel
from mdproptools_tpu.ops import pairs as P

BOX = np.array([12.0, 11.0, 13.0])  # non-cubic
N = 301  # not a tile multiple
TILE = 32
RELS = np.array([[1, 2], [3, 3], [2, 1]])  # 1-based; (1,2) and (2,1) both


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(7)
    pos = rng.uniform(0, 1, (N, 3)) * BOX
    codes = rng.integers(1, 4, N)
    m = 150
    pos_c = rng.uniform(0, 1, (m, 3)) * BOX
    codes_c = rng.integers(1, 3, m)
    return pos, codes, pos_c, codes_c


def _side(pos, codes, dtype, tile=TILE, sort=True):
    n = pos.shape[0]
    n_pad = -(-n // tile) * tile
    if sort:
        perm = P.device_sort_orb(jnp.asarray(pos), n, n_pad, leaf=tile)
    else:
        perm = np.concatenate([np.arange(n), -np.ones(n_pad - n, int)])
    perm = jnp.asarray(perm, jnp.int32)
    p = P.gather_padded_perm(jnp.asarray(pos, dtype), perm)
    ty = jnp.where(perm >= 0, jnp.asarray(codes - 1)[jnp.maximum(perm, 0)],
                   -1)
    return p, perm, ty


def _dense(pos_r, codes_r, pos_c, codes_c, dtype, n_bins, exclude_self,
           relations, with_full, n_codes_c=3):
    lay_r = P.build_type_layout(codes_r, 3)
    lay_c = P.build_type_layout(codes_c, n_codes_c)
    hist = P.pair_hist(
        P.gather_padded(jnp.asarray(pos_r, dtype), lay_r),
        P.gather_padded(jnp.asarray(pos_c, dtype), lay_c), lay_r, lay_c,
        jnp.asarray(BOX, dtype), 0.1, n_bins, 5.0, exclude_self,
        dtype=dtype)
    return P.project_relations(hist, relations, with_full)


CASES = [
    # (cross, triangle, exclude_self, with_full)
    (False, True, True, True),
    (False, True, False, True),
    (False, False, True, True),
    (False, False, False, False),
    (True, False, False, False),
    (True, False, False, True),
]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("n_bins", [50, 150])
@pytest.mark.parametrize("cross,triangle,exclude_self,with_full", CASES)
def test_hist_matches_scatter(system, cross, triangle, exclude_self,
                              with_full, n_bins, dtype):
    pos, codes, pos_c, codes_c = system
    if not cross:
        pos_c, codes_c = pos, codes
    rels = np.array([[1, 2], [3, 1]]) if cross else RELS
    want_full, want_rels = _dense(pos, codes, pos_c, codes_c, dtype, n_bins,
                                  exclude_self, rels, with_full,
                                  n_codes_c=2 if cross else 3)
    pr, pm, ty = _side(pos, codes, dtype)
    pc, pmc, tyc = (pr, pm, ty) if not cross else _side(pos_c, codes_c,
                                                        dtype)
    counts = np.bincount(codes - 1, minlength=3)
    full, got = pair_kernel.pair_hist_relations(
        pr, pm, ty, pc, pmc, tyc, rels - 1, jnp.asarray(BOX, dtype), 0.1,
        n_bins, 5.0, exclude_self, with_full, triangle=triangle,
        counts_r=counts, interpret=True, tile=TILE, copies=3)
    assert got.dtype == dtype and got.shape == (len(rels), n_bins)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want_rels))
    if with_full:
        np.testing.assert_array_equal(np.asarray(full),
                                      np.asarray(want_full))
    else:
        assert full is None


@pytest.mark.parametrize("triangle", [True, False])
def test_hist_matches_oracle(system, triangle):
    """float64 kernel == the reference loop's float64 counts."""
    pos, codes, _, _ = system
    pr, pm, ty = _side(pos, codes, jnp.float64)
    full, rels = pair_kernel.pair_hist_relations(
        pr, pm, ty, pr, pm, ty, RELS - 1, jnp.asarray(BOX), 0.1, 50, 5.0,
        True, True, triangle=triangle, interpret=True, tile=TILE)
    want_full, want_rels = oracle.rdf_loop(pos, codes, BOX, 5.0, 0.1,
                                           [tuple(r) for r in RELS])
    np.testing.assert_array_equal(np.asarray(full), want_full)
    np.testing.assert_array_equal(np.asarray(rels), want_rels)


@pytest.fixture(scope="module")
def dense():
    """1,500 atoms, 10 A cutoff, 0.01 A bins: enough pairs within a
    float32 rounding of a bin edge that an FMA-contracted r^2 (XLA's CPU
    default) moves some of them."""
    rng = np.random.default_rng(1)
    box = np.array([25.0, 23.0, 27.0])
    return rng.uniform(0, 1, (1500, 3)) * box, rng.integers(1, 4, 1500), box


@pytest.mark.parametrize("triangle", [True, False])
def test_hist_float32_matches_oracle(dense, triangle):
    """float32 kernel == the reference loop in IEEE float32."""
    pos, codes, box = dense
    pr, pm, ty = _side(pos, codes, jnp.float32)
    full, rels = pair_kernel.pair_hist_relations(
        pr, pm, ty, pr, pm, ty, RELS - 1, jnp.asarray(box, jnp.float32),
        0.01, 1000, 10.0, True, True, triangle=triangle, interpret=True,
        tile=TILE)
    want_full, want_rels = oracle.rdf_loop(
        pos, codes, box, 10.0, 0.01, [tuple(r) for r in RELS],
        dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(full), want_full)
    np.testing.assert_array_equal(np.asarray(rels), want_rels)


@pytest.mark.parametrize("copies", [1, 5])
@pytest.mark.parametrize("sort", [True, False])
def test_hist_independent_of_layout(system, copies, sort):
    """Tile order and histogram copies change only the summation order
    of exact integer counts."""
    pos, codes, _, _ = system
    want_full, want_rels = _dense(pos, codes, pos, codes, jnp.float32, 50,
                                  True, RELS, True)
    pr, pm, ty = _side(pos, codes, jnp.float32, sort=sort)
    full, rels = pair_kernel.pair_hist_relations(
        pr, pm, ty, pr, pm, ty, RELS - 1, jnp.asarray(BOX, jnp.float32),
        0.1, 50, 5.0, True, True, triangle=True, interpret=True, tile=TILE,
        copies=copies)
    np.testing.assert_array_equal(np.asarray(full), np.asarray(want_full))
    np.testing.assert_array_equal(np.asarray(rels), np.asarray(want_rels))


@pytest.mark.parametrize("tile", [16, 64])
def test_hist_tile_sizes(system, tile):
    pos, codes, _, _ = system
    want_full, want_rels = _dense(pos, codes, pos, codes, jnp.float64, 50,
                                  True, RELS, True)
    pr, pm, ty = _side(pos, codes, jnp.float64, tile=tile)
    full, rels = pair_kernel.pair_hist_relations(
        pr, pm, ty, pr, pm, ty, RELS - 1, jnp.asarray(BOX), 0.1, 50, 5.0,
        True, True, triangle=True, interpret=True, tile=tile)
    np.testing.assert_array_equal(np.asarray(full), np.asarray(want_full))
    np.testing.assert_array_equal(np.asarray(rels), np.asarray(want_rels))


def test_row_shards_sum_to_dense(system):
    """Two row shards with their GLOBAL row tiles (the mesh runner's
    contract) sum to the unsharded triangle counts."""
    pos, codes, _, _ = system
    pr, pm, ty = _side(pos, codes, jnp.float64)
    n_tiles = pr.shape[0] // TILE
    half = n_tiles // 2 * TILE
    want_full, want_rels = pair_kernel.pair_hist_relations(
        pr, pm, ty, pr, pm, ty, RELS - 1, jnp.asarray(BOX), 0.1, 50, 5.0,
        True, True, triangle=True, interpret=True, tile=TILE)
    got_full = got_rels = 0
    for lo, hi in ((0, half), (half, pr.shape[0])):
        f, r = pair_kernel.pair_hist_relations(
            pr[lo:hi], pm[lo:hi], ty[lo:hi], pr, pm, ty, RELS - 1,
            jnp.asarray(BOX), 0.1, 50, 5.0, True, True, triangle=True,
            row_tiles=jnp.arange(lo // TILE, hi // TILE), interpret=True,
            tile=TILE)
        got_full = got_full + np.asarray(f)
        got_rels = got_rels + np.asarray(r)
    np.testing.assert_array_equal(got_full, np.asarray(want_full))
    np.testing.assert_array_equal(got_rels, np.asarray(want_rels))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("cross,triangle,exclude_self", [
    (False, True, True), (False, True, False), (False, False, True),
    (True, False, False),
])
def test_count_matches_pair_count_within(system, cross, triangle,
                                         exclude_self, dtype):
    pos, codes, pos_c, codes_c = system
    n_codes_c = 2 if cross else 3
    if not cross:
        pos_c, codes_c = pos, codes
    rels = np.array([[1, 2], [3, 1]]) if cross else RELS
    r_cuts = [3.0, 4.5, 2.5][:len(rels)]
    lay_r = P.build_type_layout(codes, 3)
    lay_c = P.build_type_layout(codes_c, n_codes_c)
    want = P.pair_count_within(
        P.gather_padded(jnp.asarray(pos, dtype), lay_r),
        P.gather_padded(jnp.asarray(pos_c, dtype), lay_c), lay_r, lay_c,
        jnp.asarray(BOX, dtype), rels, r_cuts, exclude_self, dtype=dtype)
    pr, pm, ty = _side(pos, codes, dtype)
    pc, pmc, tyc = (pr, pm, ty) if not cross else _side(pos_c, codes_c,
                                                        dtype)
    got = pair_kernel.pair_count_relations(
        pr, pm, ty, pc, pmc, tyc, rels - 1, r_cuts,
        jnp.asarray(BOX, dtype), exclude_self, triangle=triangle,
        counts_r=np.bincount(codes - 1, minlength=3), interpret=True,
        tile=TILE, copies=3)
    assert got.dtype == dtype and got.shape == (len(rels),)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_count_matches_cn_loop(system):
    pos, codes, _, _ = system
    r_cuts = [3.0, 4.5, 2.5]
    pr, pm, ty = _side(pos, codes, jnp.float64)
    got = pair_kernel.pair_count_relations(
        pr, pm, ty, pr, pm, ty, RELS - 1, r_cuts, jnp.asarray(BOX), True,
        triangle=True, interpret=True, tile=TILE)
    want = oracle.cn_loop(pos, codes, BOX, r_cuts, [tuple(r) for r in RELS])
    np.testing.assert_array_equal(np.asarray(got), want)


def test_count_float32_matches_cn_loop(dense):
    pos, codes, box = dense
    r_cuts = [3.0, 4.5, 2.5]
    pr, pm, ty = _side(pos, codes, jnp.float32)
    got = pair_kernel.pair_count_relations(
        pr, pm, ty, pr, pm, ty, RELS - 1, r_cuts,
        jnp.asarray(box, jnp.float32), True, triangle=True, interpret=True,
        tile=TILE)
    want = oracle.cn_loop(pos, codes, box, r_cuts, [tuple(r) for r in RELS],
                          dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("triangle", [False, True])
@pytest.mark.parametrize("tile", [16, 32, 64])
def test_keep_mask_covers_every_pair(tile, triangle):
    """Every atom pair within r_cut lies in a kept tile pair (both
    orientations without triangle; the upper orientation with it)."""
    rng = np.random.default_rng(tile)
    box = np.array([30.0, 24.0, 27.0])
    n, r_cut = 900, 4.0
    pos = rng.uniform(0, 1, (n, 3)) * box
    pr, pm, _ = _side(pos, np.ones(n, int), jnp.float64, tile=tile)
    keep = np.asarray(pair_kernel.keep_mask(
        pr, pm, pr, pm, jnp.asarray(box), r_cut, tile, triangle))
    p = np.asarray(pr)
    valid = np.asarray(pm) >= 0
    d = p[:, None, :] - p[None, :, :]
    d -= box * np.round(d / box)
    near = ((d * d).sum(-1) < r_cut * r_cut) & valid[:, None] \
        & valid[None, :]
    i, j = np.nonzero(near)
    ti, tj = i // tile, j // tile
    if triangle:
        ti, tj = np.minimum(ti, tj), np.maximum(ti, tj)
    assert keep[ti, tj].all()
    if triangle:
        assert not np.tril(keep, -1).any()


def test_keep_mask_culls_far_tiles():
    """In a box much larger than r_cut the mask keeps a small share."""
    rng = np.random.default_rng(5)
    box = np.array([60.0, 60.0, 60.0])
    n = 4000
    pos = rng.uniform(0, 1, (n, 3)) * box
    pr, pm, _ = _side(pos, np.ones(n, int), jnp.float64)
    keep = np.asarray(pair_kernel.keep_mask(
        pr, pm, pr, pm, jnp.asarray(box), 5.0, TILE, False))
    assert keep.mean() < 0.4
    assert np.diag(keep).all()


def test_tile_spheres_contain_their_atoms():
    rng = np.random.default_rng(3)
    box = np.array([20.0, 20.0, 20.0])
    n = 200
    pos = rng.uniform(0, 1, (n, 3)) * box
    pr, pm, _ = _side(pos, np.ones(n, int), jnp.float64)
    c, r, ok = pair_kernel.tile_spheres(pr, pm, jnp.asarray(box), TILE)
    p = np.asarray(pr).reshape(-1, TILE, 3)
    valid = np.asarray(pm).reshape(-1, TILE) >= 0
    d = p - np.asarray(c)[:, None, :]
    d -= box * np.round(d / box)
    dist = np.sqrt((d * d).sum(-1))
    assert (dist[valid] <= np.repeat(np.asarray(r), TILE)[valid.ravel()]
            + 1e-9).all()
    np.testing.assert_array_equal(np.asarray(ok), valid.any(axis=1))


@pytest.mark.parametrize("leaf", [32, 64])
def test_orb_sort_makes_dense_leaf_tiles(leaf):
    """Each atom appears once, every tile but the last is full, and the
    tiles are compact boxes (radius well below the box size)."""
    rng = np.random.default_rng(leaf)
    box = np.array([40.0, 40.0, 40.0])
    n = 1000
    pos = rng.uniform(0, 1, (n, 3)) * box
    n_pad = -(-n // leaf) * leaf
    perm = np.asarray(P.device_sort_orb(jnp.asarray(pos), n, n_pad,
                                        leaf=leaf))
    real = perm[perm >= 0]
    np.testing.assert_array_equal(np.sort(real), np.arange(n))
    tiles = perm.reshape(-1, leaf)
    assert (tiles[:-1] >= 0).all()
    _, rad, _ = pair_kernel.tile_spheres(
        P.gather_padded_perm(jnp.asarray(pos), jnp.asarray(perm)),
        jnp.asarray(perm), jnp.asarray(box), leaf)
    assert float(np.median(np.asarray(rad))) < 0.5 * box[0]


def test_padding_must_be_tile_multiple(system):
    pos, codes, _, _ = system
    pr, pm, ty = _side(pos, codes, jnp.float32)
    with pytest.raises(ValueError, match="multiple of the tile"):
        pair_kernel.pair_hist_relations(
            pr[:-1], pm[:-1], ty[:-1], pr, pm, ty, RELS - 1,
            jnp.asarray(BOX, jnp.float32), 0.1, 50, 5.0, True, True,
            interpret=True, tile=TILE)


def test_triangle_needs_square_or_row_tiles(system):
    pos, codes, pos_c, codes_c = system
    pr, pm, ty = _side(pos, codes, jnp.float32)
    pc, pmc, tyc = _side(pos_c, codes_c, jnp.float32)
    with pytest.raises(ValueError, match="triangle"):
        pair_kernel.pair_hist_relations(
            pr, pm, ty, pc, pmc, tyc, RELS - 1,
            jnp.asarray(BOX, jnp.float32), 0.1, 50, 5.0, False, False,
            triangle=True, interpret=True, tile=TILE)


def test_sharded_triangle_needs_exclude_self(system):
    pos, codes, _, _ = system
    pr, pm, ty = _side(pos, codes, jnp.float32)
    with pytest.raises(ValueError, match="exclude_self"):
        pair_kernel.pair_hist_relations(
            pr[:TILE], pm[:TILE], ty[:TILE], pr, pm, ty, RELS - 1,
            jnp.asarray(BOX, jnp.float32), 0.1, 50, 5.0, False, True,
            triangle=True, row_tiles=jnp.arange(1), interpret=True,
            tile=TILE)


def test_triangle_self_pairs_need_counts(system):
    pos, codes, _, _ = system
    pr, pm, ty = _side(pos, codes, jnp.float32)
    with pytest.raises(ValueError, match="counts_r"):
        pair_kernel.pair_hist_relations(
            pr, pm, ty, pr, pm, ty, RELS - 1,
            jnp.asarray(BOX, jnp.float32), 0.1, 50, 5.0, False, True,
            triangle=True, interpret=True, tile=TILE)


@pytest.mark.gpu
@pytest.mark.parametrize("cross,triangle", [(False, True), (True, False)])
def test_compiled_hist_matches_scatter(system, gpu, cross, triangle):
    """On the card: the compiled float64 kernel (round-to-nearest pair
    math, global atomics) counts exactly what the plain XLA path counts."""
    pos, codes, pos_c, codes_c = system
    if not cross:
        pos_c, codes_c = pos, codes
    rels = np.array([[1, 2], [3, 1]]) if cross else RELS
    want_full, want_rels = _dense(pos, codes, pos_c, codes_c, jnp.float64,
                                  150, True, rels, True,
                                  n_codes_c=2 if cross else 3)
    pr, pm, ty = _side(pos, codes, jnp.float64)
    pc, pmc, tyc = (pr, pm, ty) if not cross else _side(pos_c, codes_c,
                                                        jnp.float64)
    full, got = pair_kernel.pair_hist_relations(
        pr, pm, ty, pc, pmc, tyc, rels - 1, jnp.asarray(BOX), 0.1, 150, 5.0,
        True, True, triangle=triangle)
    np.testing.assert_array_equal(np.asarray(full), np.asarray(want_full))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want_rels))


@pytest.mark.gpu
def test_compiled_count_matches_pair_count_within(system, gpu):
    pos, codes, _, _ = system
    r_cuts = [3.0, 4.5, 2.5]
    lay = P.build_type_layout(codes, 3)
    pp = P.gather_padded(jnp.asarray(pos), lay)
    want = P.pair_count_within(pp, pp, lay, lay, jnp.asarray(BOX), RELS,
                               r_cuts, True, dtype=jnp.float64)
    pr, pm, ty = _side(pos, codes, jnp.float64)
    got = pair_kernel.pair_count_relations(
        pr, pm, ty, pr, pm, ty, RELS - 1, r_cuts, jnp.asarray(BOX), True,
        triangle=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.gpu
@pytest.mark.parametrize("triangle", [True, False])
def test_compiled_float32_matches_oracle(gpu, triangle):
    """On the card: the compiled float32 kernel (``.rn`` PTX arithmetic)
    bins and counts every pair exactly as the IEEE float32 reference
    loop does, at 0.01 A bins over 3,000 atoms."""
    rng = np.random.default_rng(11)
    box = np.array([30.0, 28.0, 32.0])
    n = 3000
    pos = rng.uniform(0, 1, (n, 3)) * box
    codes = rng.integers(1, 4, n)
    rels = [tuple(r) for r in RELS]
    pr, pm, ty = _side(pos, codes, jnp.float32)
    L = jnp.asarray(box, jnp.float32)
    full, got = pair_kernel.pair_hist_relations(
        pr, pm, ty, pr, pm, ty, RELS - 1, L, 0.01, 1000, 10.0, True, True,
        triangle=triangle)
    want_full, want_rels = oracle.rdf_loop(pos, codes, box, 10.0, 0.01, rels,
                                           dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(full), want_full)
    np.testing.assert_array_equal(np.asarray(got), want_rels)
    r_cuts = [3.0, 4.5, 2.5]
    cnt = pair_kernel.pair_count_relations(
        pr, pm, ty, pr, pm, ty, RELS - 1, r_cuts, L, True, triangle=triangle)
    np.testing.assert_array_equal(
        np.asarray(cnt),
        oracle.cn_loop(pos, codes, box, r_cuts, rels, dtype=np.float32))


def test_backend_default_is_the_platform(monkeypatch):
    monkeypatch.setattr(backend, "_FORCE", None)
    assert backend.pair_backend() == jax.default_backend() == "cpu"
    assert backend.kernel_interpret()


def test_backend_force_hook(monkeypatch):
    monkeypatch.setattr(backend, "_FORCE", "gpu")
    assert backend.pair_backend() == "gpu"
    # on the CPU backend the forced kernel can only run interpreted
    assert backend.kernel_interpret()


def test_backend_refuses_other_platforms(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        backend.pair_backend()
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        backend.kernel_interpret()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert backend.pair_backend() == "gpu"
    assert not backend.kernel_interpret()


def test_auto_mesh_decides_through_the_backend(monkeypatch):
    """The automatic mesh engages only where ``ops.backend.platform()``
    says "gpu"; a forced pair backend does not turn it on."""
    from mdproptools_tpu.structural import rdf_cn

    monkeypatch.setattr(rdf_cn, "_FORCE_FRAMES_MESH", None)
    monkeypatch.setattr(rdf_cn, "_ACTIVE_MESH", None)
    monkeypatch.setattr(backend, "_FORCE", "gpu")
    assert len(jax.devices()) > 1
    assert rdf_cn._auto_mesh(10_000, 4) is None  # the CPU platform
    monkeypatch.setattr(rdf_cn, "platform", lambda: "gpu")
    mesh = rdf_cn._auto_mesh(10_000, 4)
    assert mesh is not None and mesh.size == len(jax.devices())
