"""The plain version of kernel K3 (fused encode + MLP) and the cache's
inference path against the JAX package.

Tolerances: packing and corner indices are integer paths and agree
bitwise; encoded features within 1e-6 (summation order); network outputs
within 1e-2 absolute, the bound tests/test_fused_encode_mlp.py holds the
Pallas kernel to (one bf16 rounding of an activation can flip by one ulp
when float32 sums are taken in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu.config import AppConfig as JAppConfig
from nrc_hpm_tpu.config import EncodingConfig as JEncodingConfig
from nrc_hpm_tpu.models.nrc import encoding as jenc
from nrc_hpm_tpu.models.nrc.cache import NeuralRadianceCache as JCache
from nrc_hpm_tpu.ops.fused_encode_mlp import fused_encode_mlp_infer
from nrc_hpm_tpu_torch.config import AppConfig, EncodingConfig
from nrc_hpm_tpu_torch.models.nrc import encoding as tenc
from nrc_hpm_tpu_torch.models.nrc.cache import NeuralRadianceCache
from nrc_hpm_tpu_torch.models.nrc.mlp import mlp_apply
from nrc_hpm_tpu_torch.ops import fused_encode_mlp as fem
from nrc_hpm_tpu_torch.weights import params_from_jax


def _caches(**enc):
    kw = dict(nn_width=64, nn_depth=3)
    return (JCache(JAppConfig(encoding=JEncodingConfig(**enc), **kw)),
            NeuralRadianceCache(AppConfig(encoding=EncodingConfig(**enc),
                                          **kw)))


def _x5(n, seed):
    return np.random.RandomState(seed).uniform(
        -0.4, 1.4, (n, 5)).astype(np.float32)


def test_pack_table_bf16_bitwise():
    rs = np.random.RandomState(0)
    table = np.concatenate([
        rs.normal(size=(4000, 2)) * 10.0 ** rs.randint(-8, 3, (4000, 1)),
        [[1.0 + 2 ** -8, -(1.0 + 3 * 2 ** -8)], [0.0, -0.0],
         [3.4e38, -1e-40]]]).astype(np.float32)
    want = np.asarray(jenc.pack_table_bf16(jnp.asarray(table)))
    got = tenc.pack_table_bf16(torch.from_numpy(table)).numpy()
    assert np.array_equal(got.view(np.uint32), want), \
        "bf16 packing must agree bitwise"


def test_corner_indices_match():
    """16 levels at 2^12: dense and hashed levels, out-of-range inputs
    (negative corner coordinates wrap as two's complement)."""
    jc, tc = _caches(n_levels=16, log2_hashmap_size=12)
    spec_j, spec_t = jc.encoding.grid_spec, tc.encoding.grid_spec
    assert spec_t.level_offsets == spec_j.level_offsets
    x = _x5(1024, 1)[:, :3]
    idx_j, w_j = jenc._corner_indices(jnp.asarray(x), spec_j)
    idx_t, w_t = tenc._corner_indices(torch.from_numpy(x), spec_t)
    assert np.array_equal(idx_t.reshape(1024, -1).numpy(),
                          np.asarray(idx_j)), "table rows bitwise"
    np.testing.assert_allclose(w_t.reshape(1024, -1).numpy(),
                               np.asarray(w_j), rtol=0, atol=1e-7)


def test_encoding_features_match():
    jc, tc = _caches(n_levels=16, log2_hashmap_size=12)
    state = jc.init_state(jax.random.PRNGKey(0))
    table = np.asarray(state.ema_params["encoding"]["hash_table"]) * 1e4
    x5 = _x5(512, 2)
    want = jc.encoding({}, jnp.asarray(x5), packed={
        "hash_table_packed": jenc.pack_table_bf16(jnp.asarray(table))})
    got = tc.encoding({}, torch.from_numpy(x5),
                      packed=tenc.pack_table_bf16(torch.from_numpy(table)))
    assert got.shape == (512, tc.encoding.out_dim) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6, err_msg="features within 1e-6")


@pytest.mark.parametrize("n", [512, 1000])
def test_plain_matches_pallas_interpret(n):
    jc, _ = _caches(n_levels=8, log2_hashmap_size=12)
    state = jc.init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, state.ema_params)
    table = params["encoding"]["hash_table"] * 1e3
    x5 = _x5(n, 3)
    want = np.asarray(fused_encode_mlp_infer(
        jenc.pack_table_bf16(jnp.asarray(table)),
        [jnp.asarray(w) for w in params["mlp"]["layers"]], jnp.asarray(x5),
        jc.encoding.grid_spec, n_bins=4, blk_r=8, interpret=True))
    got = fem.fused_encode_mlp_infer(
        tenc.pack_table_bf16(torch.from_numpy(table)),
        params_from_jax(params, device="cpu")["mlp"]["layers"],
        torch.from_numpy(x5),
        tenc.HashGridSpec(n_levels=8, log2_table_size=12))
    assert got.shape == (n, 3)
    assert np.abs(got.numpy() - want).max() <= 1e-2, \
        "K3 plain vs Pallas interpret within 1e-2"


def test_cache_infer_matches_jax():
    jc, tc = _caches(n_levels=16, log2_hashmap_size=12)
    state = jc.init_state(jax.random.PRNGKey(1))
    ema = jax.tree.map(np.asarray, state.ema_params)
    ema["encoding"]["hash_table"] = ema["encoding"]["hash_table"] * 1e3
    state = state.replace(ema_params=jax.tree.map(jnp.asarray, ema))
    x5 = _x5(2048, 4)
    want = np.asarray(jc.infer(state, jnp.asarray(x5)))
    got = tc.infer(tc.state_from_params(params_from_jax(ema, device="cpu"),
                                        device="cpu"),
                   torch.from_numpy(x5)).numpy()
    err = np.abs(got - want)
    assert err.max() <= 1e-2, "cache.infer within 1e-2"
    assert (err <= 1e-4).mean() >= 0.95, "95% of outputs within 1e-4"


def test_wrapper_rejects_other_devices_and_encodings():
    """Every encoding id of the reference is taken (tests/
    test_torch_encodings.py); other ids raise, and a grid the packed
    table cannot hold is not ported."""
    with pytest.raises(ValueError, match="invalid pos"):
        tenc.CompositeEncoding(EncodingConfig(pos_id=4))
    with pytest.raises(ValueError, match="invalid dir"):
        tenc.CompositeEncoding(EncodingConfig(dir_id=3))
    with pytest.raises(NotImplementedError, match="2 features"):
        tenc.CompositeEncoding(EncodingConfig(n_features_per_level=4))
    spec = tenc.HashGridSpec(n_levels=2, log2_table_size=8)
    with pytest.raises(ValueError, match="unsupported device"):
        fem.fused_encode_mlp_infer(
            torch.zeros(spec.total_params, dtype=torch.int32, device="meta"),
            [torch.zeros((16, 64), device="meta")],
            torch.zeros((4, 5), device="meta"), spec)


def _layers(in_dim=48, depth=3, out_dim=3, seed=5):
    rs = np.random.RandomState(seed)
    dims = [in_dim] + [64] * depth + [out_dim]
    return [torch.from_numpy((rs.normal(size=(a, b)) / np.sqrt(a))
                             .astype(np.float32))
            for a, b in zip(dims[:-1], dims[1:])]


def _bits(t):
    return t.to(torch.bfloat16).view(torch.int16)


@pytest.mark.parametrize("in_dim,depth,out_dim", [(48, 3, 3), (64, 6, 8),
                                                  (16, 1, 1)])
def test_kernel_weights_unpack_to_the_layers(in_dim, depth, out_dim):
    """The kernel's weight block, unswizzled and transposed back, is each
    (in, out) layer in bf16, bitwise, with zeros in the padding."""
    layers = _layers(in_dim, depth, out_dim)
    block = fem.kernel_weights(layers)
    assert block.dtype == torch.bfloat16
    assert block.numel() == (depth * fem.WIDTH + fem.OUT_PAD) * fem.WIDTH
    rows = fem.swizzle_rows(block.reshape(-1, fem.WIDTH))
    for i, w in enumerate(layers[:-1]):
        m = rows[i * 64:(i + 1) * 64].t()
        assert torch.equal(m[:w.shape[0]].view(torch.int16), _bits(w))
        assert not m[w.shape[0]:].any()
    m = rows[depth * 64:].t()
    assert torch.equal(m[:, :out_dim].view(torch.int16), _bits(layers[-1]))
    assert not m[:, out_dim:].any()


# -- the warp's fragment walk of csrc/fused_encode_mlp.cu and mlp_mma.cuh,
# mirrored in numpy with the PTX fragment layouts of ldmatrix and
# mma.m16n8k16 (lane l: g = l // 4, t = l % 4) ---------------------------

def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _f32(u16):
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _offset(row, chunk, k):
    """mlp_mma::offset: byte offset of 16-byte chunk `chunk` of row `row`
    of k-value rows (XOR-swizzled where k % 64 == 0, else rows padded by
    one chunk)."""
    if k % 64 == 0:
        return row * 2 * k + ((chunk ^ (row & 7)) << 4)
    return row * (2 * k + 16) + (chunk << 4)


def _swz(row, chunk):
    return _offset(row, chunk, 64)


def _ldmatrix_x4(mem, addr):
    """mem: shared memory as uint16; addr(lane) the row address lane
    8i + j gives for row j of matrix i.  Returns (32, 4, 2): lane l holds
    row l // 4, columns 2 (l % 4) + (0, 1) of each matrix."""
    rows = np.stack([mem[addr(l) // 2:addr(l) // 2 + 8] for l in range(32)])
    lane = np.arange(32)
    cols = 2 * (lane % 4)[:, None] + np.arange(2)
    return np.stack([rows[8 * i + lane // 4][lane[:, None], cols]
                     for i in range(4)], axis=1)


def _mma(d, a, b0, b1):
    """d (32, 4) += A (16x16 from a (32, 4, 2)) @ B (16x8 from b0/b1)."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    A = np.zeros((16, 16), np.float32)
    B = np.zeros((16, 8), np.float32)
    for e in range(2):
        A[g, 2 * t + e] = _f32(a[:, 0, e])
        A[g + 8, 2 * t + e] = _f32(a[:, 1, e])
        A[g, 2 * t + 8 + e] = _f32(a[:, 2, e])
        A[g + 8, 2 * t + 8 + e] = _f32(a[:, 3, e])
        B[2 * t + e, g] = _f32(b0[:, e])
        B[2 * t + 8 + e, g] = _f32(b1[:, e])
    D = A.astype(np.float64) @ B
    for e in range(2):
        d[:, e] += D[g, 2 * t + e].astype(np.float32)
        d[:, 2 + e] += D[g + 8, 2 * t + e].astype(np.float32)


def _warp_mlp(feats, block, depth):
    """One warp tile of 32 samples through the kernel's index math."""
    mi, r = np.arange(32) >> 3, np.arange(32) & 7
    wbytes = block.numel() * 2
    mem = np.zeros(wbytes // 2 + 32 * 64, np.uint16)
    mem[:block.numel()] = block.view(torch.int16).numpy().view(np.uint16)
    x = _bf16(feats)                                   # (32, 64)
    for row in range(32):                              # encode_row's stores
        for c in range(8):
            at = (wbytes + _swz(row, c)) // 2
            mem[at:at + 8] = x[row, 8 * c:8 * c + 8]
    a = [[_ldmatrix_x4(mem, lambda l, mt=mt, ks=ks: wbytes + _swz(
        16 * mt + ((mi[l] & 1) << 3) + r[l], 2 * ks + (mi[l] >> 1)))
        for ks in range(4)] for mt in range(2)]
    for m in range(depth):
        w = m * 64 * 128
        acc = np.zeros((2, 8, 32, 4), np.float32)
        for ks in range(4):
            for nt in range(0, 8, 2):
                b = _ldmatrix_x4(mem, lambda l, nt=nt, ks=ks: w + _swz(
                    8 * nt + ((mi[l] >> 1) << 3) + r[l], 2 * ks + (mi[l] & 1)))
                for mt in range(2):
                    _mma(acc[mt, nt], a[mt][ks], b[:, 0], b[:, 1])
                    _mma(acc[mt, nt + 1], a[mt][ks], b[:, 2], b[:, 3])
        h = _bf16(np.maximum(acc, 0.0))                # relu_pack
        a = [[np.stack([h[mt, 2 * j][:, 0:2], h[mt, 2 * j][:, 2:4],
                        h[mt, 2 * j + 1][:, 0:2], h[mt, 2 * j + 1][:, 2:4]],
                       axis=1) for j in range(4)] for mt in range(2)]
    w = depth * 64 * 128
    o = np.zeros((2, 32, 4), np.float32)
    for ks in range(0, 4, 2):
        b = _ldmatrix_x4(mem, lambda l, ks=ks: w + _swz(r[l], 2 * ks + mi[l]))
        for mt in range(2):
            _mma(o[mt], a[mt][ks], b[:, 0], b[:, 1])
            _mma(o[mt], a[mt][ks + 1], b[:, 2], b[:, 3])
    out = np.zeros((32, 8), np.float32)                # the output stores
    g, tq = np.arange(32) >> 2, np.arange(32) & 3
    for mt in range(2):
        for h in range(2):
            for e in range(2):
                out[16 * mt + g + 8 * h, 2 * tq + e] = o[mt, :, 2 * h + e]
    return out


@pytest.mark.parametrize("in_dim,depth", [(64, 2), (48, 1)])
def test_mma_fragment_walk_computes_the_mlp(in_dim, depth):
    """The kernel's tile swizzle, ldmatrix addresses, fragment chaining
    between layers and output stores, run on the weight block, give the
    plain bf16 MLP (within 1e-2: float32 sums in another order can flip a
    bf16 activation by one ulp)."""
    layers = _layers(in_dim, depth, 3, seed=in_dim)
    feats = np.random.RandomState(depth).uniform(
        -1, 1, (32, 64)).astype(np.float32)
    feats[:, in_dim:] = 0.0
    want = mlp_apply({"layers": layers},
                     torch.from_numpy(feats[:, :in_dim])).numpy()
    got = _warp_mlp(feats, fem.kernel_weights(layers), depth)
    assert not got[:, 3:].any()
    np.testing.assert_allclose(got[:, :3], want, rtol=1e-2, atol=1e-2)
    assert (np.abs(got[:, :3] - want) <= 1e-5).mean() >= 0.9


# -- K4 (csrc/fused_mlp.cu) on the same header: its weight block placed
# in shared memory as load_weights places it, both designs' walks ----------

_MI, _R8 = np.arange(32) >> 3, np.arange(32) & 7
_G, _TQ = np.arange(32) >> 2, np.arange(32) & 3


def _place(mem, at, rows_u16, k):
    """load_weights / load_features: (rows, k) bf16 values into mem at
    byte ``at`` in mlp_mma's layout."""
    for r in range(rows_u16.shape[0]):
        for c in range(k // 8):
            o = (at + _offset(r, c, k)) // 2
            mem[o:o + 8] = rows_u16[r, 8 * c:8 * c + 8]


def _features(feats, k_in):
    x = np.zeros((feats.shape[0], k_in), np.float32)
    x[:, :feats.shape[1]] = feats
    return _bf16(x)


def _a_step(mem, tile, row0, ks, k):
    """mlp_mma::load_a_step."""
    return _ldmatrix_x4(mem, lambda l: tile + _offset(
        row0 + ((_MI[l] & 1) << 3) + _R8[l], 2 * ks + (_MI[l] >> 1), k))


def _b_pair(mem, w, nt, ks, k):
    """The B fragments of n-tiles nt, nt + 1 at k-step ks (mma_step)."""
    return _ldmatrix_x4(mem, lambda l: w + _offset(
        8 * nt + ((_MI[l] >> 1) << 3) + _R8[l], 2 * ks + (_MI[l] & 1), k))


def _relu_to_a(acc):
    """mlp_mma::relu_to_a: acc (MT, N/8, 32, 4) -> [mt][j] A fragments."""
    h = _bf16(np.maximum(acc, 0.0))
    return [[np.stack([h[mt, 2 * j][:, 0:2], h[mt, 2 * j][:, 2:4],
                       h[mt, 2 * j + 1][:, 0:2], h[mt, 2 * j + 1][:, 2:4]],
                      axis=1) for j in range(h.shape[1] // 2)]
            for mt in range(h.shape[0])]


def _output(a_of_ks, mem, w, k):
    """mlp_mma::output_layer (one row tile): k-step pairs through
    ldmatrix.x4, an odd last k-step through .x2."""
    o = np.zeros((32, 4), np.float32)
    ks = 0
    while ks + 1 < k // 16:
        b = _ldmatrix_x4(mem, lambda l: w + _offset(_R8[l], 2 * ks + _MI[l],
                                                    k))
        _mma(o, a_of_ks(ks), b[:, 0], b[:, 1])
        _mma(o, a_of_ks(ks + 1), b[:, 2], b[:, 3])
        ks += 2
    if (k // 16) % 2:
        b = _ldmatrix_x4(mem, lambda l: w + _offset(
            _R8[l], 2 * ks + (_MI[l] & 1), k))
        _mma(o, a_of_ks(ks), b[:, 0], b[:, 1])
    return o


def _rows_of(o):
    """store_out: o[2 h + e] of lane l is row g + 8 h, column 2 tq + e."""
    out = np.zeros((16, 8), np.float32)
    for h in range(2):
        for e in range(2):
            out[_G + 8 * h, 2 * _TQ + e] = o[:, 2 * h + e]
    return out


def _k4_resident(feats, layers):
    """One warp tile of fused_mlp_resident_kernel<W>."""
    from nrc_hpm_tpu_torch.ops import fused_mlp as fm

    k_in, W, stream = fm.plan(layers, feats.shape[1], layers[-1].shape[1])
    assert not stream
    MT, depth = (2 if W <= 64 else 1), len(layers) - 1
    block = fm.kernel_weights(layers, k_in, W).view(torch.int16).numpy() \
        .view(np.uint16)
    w0, wh = W * fm.row_bytes(k_in), W * fm.row_bytes(W)
    out_at = w0 + (depth - 1) * wh
    tile = out_at + fm.OUT_PAD * fm.row_bytes(W)
    mem = np.zeros((tile + 16 * MT * fm.row_bytes(k_in)) // 2, np.uint16)
    _place(mem, 0, block[:W * k_in].reshape(W, k_in), k_in)
    at = W * k_in
    for m in range(1, depth):
        _place(mem, w0 + (m - 1) * wh, block[at:at + W * W].reshape(W, W), W)
        at += W * W
    _place(mem, out_at, block[at:].reshape(fm.OUT_PAD, W), W)
    _place(mem, tile, _features(feats, k_in), k_in)
    acc = np.zeros((MT, W // 8, 32, 4), np.float32)
    for ks in range(k_in // 16):
        a = [_a_step(mem, tile, 16 * mt, ks, k_in) for mt in range(MT)]
        for nt in range(0, W // 8, 2):
            b = _b_pair(mem, 0, nt, ks, k_in)
            for mt in range(MT):
                _mma(acc[mt, nt], a[mt], b[:, 0], b[:, 1])
                _mma(acc[mt, nt + 1], a[mt], b[:, 2], b[:, 3])
    h = _relu_to_a(acc)
    for m in range(1, depth):
        acc = np.zeros((MT, W // 8, 32, 4), np.float32)
        for ks in range(W // 16):
            for nt in range(0, W // 8, 2):
                b = _b_pair(mem, w0 + (m - 1) * wh, nt, ks, W)
                for mt in range(MT):
                    _mma(acc[mt, nt], h[mt][ks], b[:, 0], b[:, 1])
                    _mma(acc[mt, nt + 1], h[mt][ks], b[:, 2], b[:, 3])
        h = _relu_to_a(acc)
    return np.concatenate([_rows_of(_output(lambda ks: h[mt][ks], mem,
                                            out_at, W))
                           for mt in range(MT)])


def _k4_stream(feats, layers):
    """Warp 1 (rows 16-31 of the block tile) of fused_mlp_stream_kernel:
    the weight chunks placed in the ring's slots in turn, the activations
    through the two shared tiles."""
    from nrc_hpm_tpu_torch.ops import fused_mlp as fm

    k_in, W, stream = fm.plan(layers, feats.shape[1], layers[-1].shape[1])
    assert stream
    depth, row0, chunk = len(layers) - 1, 16, 64
    block = fm.kernel_weights(layers, k_in, W).view(torch.int16).numpy() \
        .view(np.uint16)
    k_max = max(k_in, W)
    tile, slot = 128 * fm.row_bytes(k_max), chunk * fm.row_bytes(k_max)
    act, slots = (0, tile), (2 * tile, 2 * tile + slot)
    mem = np.zeros((2 * tile + 2 * slot) // 2, np.uint16)
    _place(mem, act[0] + row0 * fm.row_bytes(k_in), _features(feats, k_in),
           k_in)
    per = -(-W // chunk)
    for j in range(depth * per + 1):
        layer = min(j // per, depth)
        n0 = (j - layer * per) * chunk if layer < depth else 0
        rows = min(chunk, W - n0) if layer < depth else fm.OUT_PAD
        k = k_in if layer == 0 else W
        start = 0 if layer == 0 else W * k_in + (layer - 1) * W * W
        at = slots[j % 2]
        _place(mem, at, block[start + n0 * k:start + (n0 + rows) * k]
               .reshape(rows, k), k)
        src = act[layer & 1]
        if layer == depth:
            return _rows_of(_output(lambda ks: _a_step(mem, src, row0, ks, k),
                                    mem, at, k))
        acc = np.zeros((chunk // 8, 32, 4), np.float32)
        for ks in range(k // 16):
            a = _a_step(mem, src, row0, ks, k)
            for nt in range(0, rows // 8, 2):
                b = _b_pair(mem, at, nt, ks, k)
                _mma(acc[nt], a, b[:, 0], b[:, 1])
                _mma(acc[nt + 1], a, b[:, 2], b[:, 3])
        h = _bf16(np.maximum(acc, 0.0))
        dst = act[(layer + 1) & 1]
        for nt in range(rows // 8):
            for hh in range(2):
                for lane in range(32):
                    o = (dst + _offset(row0 + _G[lane] + 8 * hh,
                                       n0 // 8 + nt, W) + 4 * _TQ[lane]) // 2
                    mem[o:o + 2] = h[nt, lane, 2 * hh:2 * hh + 2]


@pytest.mark.parametrize("design,width,in_dim,depth", [
    ("resident", 16, 20, 2), ("resident", 24, 20, 1),
    ("resident", 32, 80, 2), ("resident", 48, 48, 1),
    ("resident", 64, 80, 2), ("resident", 80, 24, 1),
    ("resident", 96, 256, 1), ("resident", 112, 40, 2),
    ("resident", 128, 80, 2), ("stream", 144, 80, 2),
    ("stream", 200, 256, 1), ("stream", 256, 24, 1),
    ("stream", 128, 128, 8)])
def test_k4_fragment_walk_computes_the_mlp(design, width, in_dim, depth):
    """K4's walk at each templated width (and the STREAM design's chunks),
    padding included: layer 0 from the feature tile one k-step at a time,
    the weight rows where load_weights or the ring puts them, the output
    layer's odd last k-step through ldmatrix.x2; the plain bf16 MLP within
    1e-2 (a bf16 activation can flip by one ulp), most outputs within
    1e-5."""
    rs = np.random.RandomState(width + in_dim + depth)
    dims = [in_dim] + [width] * depth + [3]
    layers = [torch.from_numpy((rs.normal(size=(a, b)) / np.sqrt(a))
                               .astype(np.float32))
              for a, b in zip(dims[:-1], dims[1:])]
    rows = 32 if design == "resident" and width <= 64 else 16
    feats = rs.uniform(-1, 1, (rows, in_dim)).astype(np.float32)
    walk = _k4_resident if design == "resident" else _k4_stream
    got = walk(feats, layers)
    want = mlp_apply({"layers": layers}, torch.from_numpy(feats)).numpy()
    assert not got[:, 3:].any()
    np.testing.assert_allclose(got[:, :3], want, rtol=1e-2, atol=1e-2)
    assert (np.abs(got[:, :3] - want) <= 1e-5).mean() >= 0.9


@pytest.mark.parametrize("case,what", [
    ("x5-f64", "x5 must be"), ("x5-4", "x5 must be"),
    ("table-shape", "packed_table must be"),
    ("levels", "<= 16 levels"), ("bins", "<= 8 bins"),
    ("in-dim", "in_dim <= 64"), ("hidden", "64 wide"),
    ("out-dim", "out_dim <= 8"), ("too-few-inputs", "64 wide"),
    ("layer-device", "layer 1 is on cpu")])
def test_check_refuses_what_the_kernel_does_not_take(case, what):
    """K3's limits (width 64, in_dim <= 64, out_dim <= 8, <= 16 levels,
    <= 8 bins) are refused before any launch (meta tensors stand in for
    the card's)."""
    meta = dict(device="meta")
    spec = tenc.HashGridSpec(n_levels=2, log2_table_size=8)
    n_bins, out_dim = 4, 3
    dims = [16, 64, 64, 3]
    x5 = torch.zeros((8, 5), **meta)
    table = torch.zeros(spec.total_params, dtype=torch.int32, **meta)
    if case == "x5-f64":
        x5 = x5.double()
    elif case == "x5-4":
        x5 = torch.zeros((8, 4), **meta)
    elif case == "table-shape":
        table = torch.zeros(spec.total_params + 1, dtype=torch.int32, **meta)
    elif case == "levels":
        spec = tenc.HashGridSpec(n_levels=17, log2_table_size=8)
        table = torch.zeros(spec.total_params, dtype=torch.int32, **meta)
    elif case == "bins":
        n_bins = 9
    elif case == "in-dim":
        dims[0] = 80
    elif case == "hidden":
        dims[1:3] = [32, 32]
    elif case == "out-dim":
        dims[-1] = out_dim = 9
    elif case == "too-few-inputs":
        dims[0] = spec.out_dim + 2 * n_bins - 1
    layers = [torch.zeros((a, b), **meta) for a, b in zip(dims, dims[1:])]
    if case == "layer-device":
        layers[1] = torch.zeros((64, 64))
    with pytest.raises(ValueError, match=what):
        fem._check(table, layers, x5, spec, n_bins, out_dim)
    # the cache's route test agrees: a shape K3 refuses goes to K4
    shape_case = case in ("levels", "bins", "in-dim", "hidden", "out-dim",
                          "too-few-inputs")
    assert fem.takes(spec, n_bins, layers, out_dim) == (not shape_case)
