"""K7' (the hash-grid table gradient, ``csrc/hash_grid_train.cu``) on the
CPU: a numpy mirror of the CUDA kernel's order of work against the plain
version and against the JAX package's gradient, and the power-of-two mask
its hashed levels take in place of ``%``.

The kernel cannot run here, so the mirror repeats its structure: blocks of
one level (the last level first), warps of 32 consecutive samples, each
sample's corner c and x-neighbour c + 4 together, one 16-byte add where
their rows are the two halves of an aligned pair, and the lanes of a warp
that add into one row (or one pair) grouped as ``__match_any_sync``
groups them, the group's lowest lane summing their terms in lane order
(each term rounded to bf16 first on the packed route).

Tolerance: the grouped sums and the atomics add in another order than
``index_add_``: every entry within 1e-7 + 1e-4 * S, S the sum of the
|terms| added into it (``K7_BWD_TOL`` of chip_smoke.py); the JAX gradient
within 1e-7 + 1e-5 * S, as tests/test_torch_train.py holds the plain
version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nrc_hpm_tpu.models.nrc import encoding as jenc
from nrc_hpm_tpu_torch.config import AppConfig
from nrc_hpm_tpu_torch.models.nrc import encoding as tenc
from nrc_hpm_tpu_torch.ops import hash_grid_train as hgt

N = 512
WARP = 32
# packed: the JAX hash_grid_encode_train route (<= 2^16 entries a level);
# float32: hash_grid_encode.  Both have dense and hashed levels.
SPECS = dict(packed=dict(n_levels=4, log2_table_size=10, base_resolution=4),
             float32=dict(n_levels=4, log2_table_size=17))


def _batch(kind, seed):
    """(x (N, 3), g (N, L*2)) float32.  "clustered": eight tight clusters
    with every third position repeated, as a frame's train batch repeats
    positions, so a warp's samples share rows on every level; "smoke": the
    repeating batch chip_smoke.py holds the kernel to on the card."""
    rs = np.random.RandomState(seed)
    if kind == "random":
        x = rs.uniform(-0.1, 1.1, (N, 3))
    elif kind == "smoke":
        x = chip_smoke.repeating_positions(
            torch, N, torch.Generator().manual_seed(seed)).numpy()
    else:
        centers = rs.uniform(0.1, 0.9, (8, 3))
        x = centers[np.arange(N) // (N // 8)] + rs.uniform(-2e-3, 2e-3,
                                                           (N, 3))
        x[2::3] = x[1::3][:len(x[2::3])]
    return x.astype(np.float32), rs.normal(size=(N, 8)).astype(np.float32)


def _terms(x, g, spec, packed):
    """(rows (N, L, 8), terms (N, L, 8, 2)): each corner's row and w * g,
    rounded to bf16 on the packed route."""
    idx, w = tenc._corner_indices(torch.from_numpy(x), spec)
    v = w[..., None] * torch.from_numpy(g).reshape(x.shape[0], -1, 1, 2)
    if packed:
        v = v.to(torch.bfloat16).to(torch.float32)
    return idx.numpy(), v.numpy()


def _grouped_bwd_mirror(x, g, spec, packed):
    """The CUDA backward's order of work in numpy; returns the (P, 2)
    gradient and the number of groups of more than one lane."""
    rows, terms = _terms(x, g, spec, packed)
    out = np.zeros((spec.total_params, 2), np.float32)
    shared = 0

    def group_add(keys, at, vals):
        # keys (k,) in lane order, None for a lane with nothing to add
        nonlocal shared
        live = [i for i, k in enumerate(keys) if k is not None]
        for key in {keys[i] for i in live}:
            lanes = [i for i in live if keys[i] == key]
            s = vals[lanes[0]].copy()
            for i in lanes[1:]:
                s = s + vals[i]
            shared += len(lanes) > 1
            r = at[lanes[0]]
            out[r:r + len(s) // 2] += s.reshape(-1, 2)

    for level in reversed(range(spec.n_levels)):
        for w0 in range(0, x.shape[0], WARP):
            lanes = slice(w0, w0 + WARP)
            for c in range(4):
                r0 = rows[lanes, level, c]
                r1 = rows[lanes, level, c + 4]
                a = terms[lanes, level, c]
                b = terms[lanes, level, c + 4]
                pair = (r0 ^ r1) == 1
                odd = (r0 & 1)[:, None] == 1
                wide = np.concatenate([np.where(odd, b, a),
                                       np.where(odd, a, b)], axis=1)
                group_add([int(r >> 1) if p else None
                           for r, p in zip(r0, pair)], r0 & ~1, wide)
                group_add([None if p else int(r) for r, p in zip(r0, pair)],
                          r0, a)
                group_add([None if p else int(r) for r, p in zip(r1, pair)],
                          r1, b)
    return out, shared


def _term_scale(x, g, spec, packed):
    return hgt.hash_grid_train_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(np.abs(g)), spec,
        packed).numpy()


@pytest.mark.parametrize("kind", ["random", "clustered", "smoke"])
@pytest.mark.parametrize("route", ["packed", "float32"])
def test_grouped_backward_matches_plain_and_jax(route, kind):
    packed = route == "packed"
    jspec = jenc.HashGridSpec(**SPECS[route])
    spec = tenc.HashGridSpec(**SPECS[route])
    x, g = _batch(kind, seed=7 if packed else 8)
    got, shared = _grouped_bwd_mirror(x, g, spec, packed)
    want = hgt.hash_grid_train_bwd_plain(torch.from_numpy(x),
                                         torch.from_numpy(g), spec,
                                         packed).numpy()
    s = _term_scale(x, g, spec, packed)
    err = np.abs(got - want)
    assert (err <= 1e-7 + 1e-4 * s).all(), f"max err {err.max():.3e}"

    table = np.random.RandomState(1).uniform(
        -1, 1, (spec.total_params, 2)).astype(np.float32)
    jfn = jenc.hash_grid_encode_train if packed else jenc.hash_grid_encode
    _, vjp = jax.vjp(lambda t: jfn(t, jnp.asarray(x), jspec),
                     jnp.asarray(table))
    (jgrad,) = vjp(jnp.asarray(g))
    err = np.abs(got - np.asarray(jgrad))
    assert (err <= 1e-7 + 1e-5 * s).all(), f"max err vs JAX {err.max():.3e}"

    rows = _terms(x, g, spec, packed)[0]
    assert ((rows[:, :, :4] ^ rows[:, :, 4:]) == 1).mean() > 0.2, \
        "corner pairs must merge"
    if kind != "random":
        assert shared > 100, "warps must share rows"


@pytest.mark.parametrize("spread", [0, 1])
def test_block_order_covers_every_tile_and_level(spread):
    """The backward's block b -> (level, sample tile) in both orders: every
    pair once, the last level first; level-major without spread, the
    levels of one tile side by side with it."""
    n_levels, n_tiles = 16, 5
    blocks = n_levels * n_tiles
    pairs = []
    for b in range(blocks):
        n_t = blocks // n_levels
        level = n_levels - 1 - (b % n_levels if spread else b // n_t)
        tile = b // n_levels if spread else b % n_t
        pairs.append((level, tile))
    assert sorted(pairs) == [(lv, t) for lv in range(n_levels)
                             for t in range(n_tiles)]
    assert pairs[0] == (n_levels - 1, 0)
    first = pairs[:n_levels] if spread else pairs[:n_tiles]
    assert len({p[0] for p in first}) == (n_levels if spread else 1)


def _hash_mask(params):
    """hash_grid::hash_mask: params - 1 for a power of two, else 0."""
    return params - 1 if params & (params - 1) == 0 else 0


@pytest.mark.parametrize("config", ["default", "tpu_tuned"])
def test_power_of_two_mask_equals_modulo(config):
    """Every hashed level of both configurations has a power-of-two table,
    and its mask gives the rows of % bit for bit."""
    cfg = AppConfig() if config == "default" else AppConfig.tpu_tuned()
    spec = tenc.CompositeEncoding(cfg.encoding).grid_spec
    hsh = np.random.RandomState(3).randint(0, 2 ** 32, 4096,
                                           dtype=np.uint64)
    hsh = np.concatenate([hsh, [0, 1, 2 ** 32 - 1, 2 ** 31]]).astype(
        np.uint64)
    hashed = [lv for lv in range(spec.n_levels)
              if not spec.level_is_dense(lv)]
    assert len(hashed) >= 13
    for lv in hashed:
        params = spec.level_params(lv)
        mask = _hash_mask(params)
        assert mask == spec.table_size - 1, (lv, params)
        assert np.array_equal(hsh & np.uint64(mask), hsh % np.uint64(params))
    assert _hash_mask(1000) == 0 and _hash_mask(1 << 19) == (1 << 19) - 1


# -- K7's forward: level-uniform warps, x-neighbour corners read as one
# load where their rows pair, a block's features staged and stored as rows

@pytest.mark.parametrize("kind", ["random", "clustered"])
@pytest.mark.parametrize("route", ["packed", "float32"])
def test_forward_pair_loads_read_the_corner_rows(route, kind):
    """The forward's loads, mirrored: for corner c and its x-neighbour
    c + 4, the aligned pair of rows that holds r0 (row r0 >> 1 of the table
    seen as pairs) gives r0's value and, where the rows pair (r0 ^ r1 ==
    1), r1's; otherwise r1 is read alone.  Both are bitwise the rows of
    corner_index, pairs never straddle a level, and summed in corner order
    they give the plain forward within K7_FWD_TOL."""
    packed = route == "packed"
    spec = tenc.HashGridSpec(**SPECS[route])
    assert all(off % 8 == 0 for off in spec.level_offsets)
    x, _ = _batch(kind, seed=3 if packed else 4)
    idx, w = tenc._corner_indices(torch.from_numpy(x), spec)
    rows, w = idx.numpy(), w.numpy()
    table = np.random.RandomState(2).uniform(
        -1, 1, (spec.total_params, 2)).astype(np.float32)
    words = tenc.pack_table_bf16(torch.from_numpy(table)).numpy()
    src = words if packed else table
    pairs = src.reshape((spec.total_params // 2, 2) + src.shape[1:])
    vals = np.zeros(rows.shape + src.shape[1:], src.dtype)
    n_pairs = 0
    for c in range(4):
        r0, r1 = rows[..., c], rows[..., c + 4]
        q = pairs[r0 >> 1]                       # one 8- or 16-byte load
        odd = (r0 & 1).astype(bool)
        pair = (r0 ^ r1) == 1
        level = np.searchsorted(spec.level_offsets, r0, side="right")
        assert np.array_equal(level[pair], np.searchsorted(
            spec.level_offsets, r1, side="right")[pair])
        if src.ndim > 1:                         # a float2 a row
            odd, pair = odd[..., None], pair[..., None]
        vals[:, :, c] = np.where(odd, q[:, :, 1], q[:, :, 0])
        vals[:, :, c + 4] = np.where(pair, np.where(odd, q[:, :, 0],
                                                    q[:, :, 1]), src[r1])
        n_pairs += int(((r0 ^ r1) == 1).sum())
    assert np.array_equal(vals, src[rows])
    assert n_pairs >= 0.25 * rows[..., :4].size
    if packed:
        f = np.stack([(vals & np.int32(-65536)).view(np.float32),
                      (vals << 16).view(np.float32)], axis=-1)
    else:
        f = vals
    feats = np.zeros(rows.shape[:2] + (2,), np.float32)
    for c in range(8):                           # corner order, as the kernel
        feats = feats + f[:, :, c] * w[:, :, c, None]
    want = hgt.hash_grid_train_fwd_plain(
        torch.from_numpy(src), torch.from_numpy(x), spec, packed).numpy()
    tol = chip_smoke.K7_FWD_TOL
    assert (np.abs(feats.reshape(want.shape) - want)
            <= tol["atol"] + tol["rtol"] * np.abs(want)).all()


@pytest.mark.parametrize("n_levels", [1, 4, 16, 20, 33])
@pytest.mark.parametrize("n", [1, 33, 100])
def test_forward_blocks_store_every_feature_once(n_levels, n):
    """The forward's grid: blocks of 32 samples, min(L, 16) warps, warp w
    encoding levels w, w + warps, ...; each round staged and stored as the
    samples' rows.  Every (sample, level) of the output is written once,
    with its own feature."""
    warps = min(n_levels, 16)
    want = np.arange(n * n_levels).reshape(n, n_levels)
    out = np.full(n * n_levels, -1)
    writes = np.zeros(n * n_levels, int)
    for b in range(-(-n // 32)):
        s0 = 32 * b
        ns = min(32, n - s0)
        for l0 in range(0, n_levels, warps):
            stage = np.full((32, 17), -1)
            for warp in range(warps):
                if l0 + warp < n_levels:
                    for lane in range(32):
                        s = lane if lane < ns else 0
                        stage[lane, warp] = want[s0 + s, l0 + warp]
            g = min(warps, n_levels - l0)
            for i in range(ns * g):
                si, k = divmod(i, g)
                at = (s0 + si) * n_levels + l0 + k
                out[at] = stage[si, k]
                writes[at] += 1
    assert (writes == 1).all()
    assert np.array_equal(out.reshape(n, n_levels), want)


@pytest.mark.parametrize("route", ["packed", "float32"])
def test_twenty_levels_match_jax(route):
    """A grid of 20 levels (past the 16 of K3's level arrays): the plain
    forward and table gradient against the JAX encode and its VJP, as
    test_grouped_backward_matches_plain_and_jax holds them; the level
    records the kernels read hold every level's constants."""
    packed = route == "packed"
    kw = dict(SPECS[route], n_levels=20)
    if packed:
        kw["per_level_scale"] = 1.3
    jspec, spec = jenc.HashGridSpec(**kw), tenc.HashGridSpec(**kw)
    x, _ = _batch("random", seed=11)
    g = np.random.RandomState(12).normal(size=(N, 40)).astype(np.float32)
    table = np.random.RandomState(13).uniform(
        -1, 1, (spec.total_params, 2)).astype(np.float32)
    jfn = jenc.hash_grid_encode_train if packed else jenc.hash_grid_encode
    jfeat, vjp = jax.vjp(lambda t: jfn(t, jnp.asarray(x), jspec),
                         jnp.asarray(table))
    src = tenc.pack_table_bf16(torch.from_numpy(table)) if packed \
        else torch.from_numpy(table)
    feat = hgt.hash_grid_train_fwd_plain(src, torch.from_numpy(x), spec,
                                         packed).numpy()
    np.testing.assert_allclose(feat, np.asarray(jfeat), rtol=1e-5, atol=2e-6)
    got = hgt.hash_grid_train_bwd_plain(torch.from_numpy(x),
                                        torch.from_numpy(g), spec,
                                        packed).numpy()
    s = _term_scale(x, g, spec, packed)
    err = np.abs(got - np.asarray(vjp(jnp.asarray(g))[0]))
    assert (err <= 1e-7 + 1e-5 * s).all(), f"max err vs JAX {err.max():.3e}"

    rec = hgt.level_records(spec)
    assert rec.shape == (20, hgt.LEVEL_WORDS) and rec.dtype == np.int32
    for lv in range(20):
        assert rec[lv, 0] == np.float32(spec.level_scale(lv)).view(np.int32)
        assert tuple(rec[lv, 1:5]) == (
            spec.level_resolution(lv), spec.level_is_dense(lv),
            spec.level_params(lv), spec.level_offsets[lv])
    # the wrappers' contract takes any level count
    meta = torch.zeros((4, 3), device="meta")
    hgt._check("hash_grid_train_fwd", meta, spec, {})
