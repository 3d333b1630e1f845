"""The plain versions of kernels K1 (pw_events) and K2 (pw_profile)
against the Pallas kernels in interpret mode and against the XLA
profile/inversion machinery.

Tolerances: the plain versions keep the kernels' operation order, so the
integer outputs and the per-interval fields agree exactly; XLA on the CPU
contracts some multiply-adds into FMAs, so depths and event distances
carry ulp-level differences (the bounds of tests/test_pw_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_hpm_tpu import transmittance as jtr
from nrc_hpm_tpu.ops.pw_kernels import pw_events, pw_profile
from nrc_hpm_tpu.volume import Volume as JVolume
from nrc_hpm_tpu_torch.ops import pw_kernels as pk
from nrc_hpm_tpu_torch.volume import Volume as TVolume


def _volumes():
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    return (JVolume.from_dense(data, 0.6, 0.8),
            TVolume.from_dense(data, 0.6, 0.8, device="cpu"))


def _lanes(n, seed):
    r = np.random.RandomState(seed)
    start = r.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = r.uniform(0.5, 60.0, n).astype(np.float32)
    seed_u = r.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    e_last = r.uniform(0.0, 2.0, n).astype(np.float32)
    return start, d, tmax, seed_u, e_last


def _torch(start, d, tmax, seed_u):
    return (torch.from_numpy(start), torch.from_numpy(d),
            torch.from_numpy(tmax), torch.from_numpy(seed_u.view(np.int32)))


@pytest.mark.parametrize("salt", [pk.SALT_RATIO, pk.SALT_DELTA])
def test_events_plain_matches_pallas_interpret(salt):
    jv, tv = _volumes()
    start, d, tmax, seed_u, e_last = _lanes(256, 3)
    want = pw_events(jv, jnp.asarray(start), jnp.asarray(d),
                     jnp.asarray(tmax), jnp.asarray(seed_u),
                     jnp.asarray(e_last), 5, S=8, salt=salt, interpret=True)
    got = pk.pw_events(tv, *_torch(start, d, tmax, seed_u),
                       torch.from_numpy(e_last), 5, S=8, salt=salt)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert got["lin"].shape == (8, 256) and got["lin"].dtype == np.int32
    for k in ("lin", "c_at", "sres", "ctot"):
        assert np.array_equal(got[k], want[k]), f"{k} must agree exactly"
    np.testing.assert_allclose(got["t"], want["t"], rtol=1e-4, atol=1e-5,
                               err_msg="t within rtol 1e-4, atol 1e-5")
    for k in ("e_new", "rtot"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6,
                                   err_msg=f"{k} within rtol 2e-5")


@pytest.mark.parametrize("want_ctrl", [False, True])
def test_profile_plain_matches_pallas_interpret(want_ctrl):
    jv, tv = _volumes()
    start, d, tmax, seed_u, _ = _lanes(256, 5)
    want = pw_profile(jv, jnp.asarray(start), jnp.asarray(d),
                      jnp.asarray(tmax), jnp.asarray(seed_u),
                      want_ctrl=want_ctrl, interpret=True)
    got = pk.pw_profile(tv, *_torch(start, d, tmax, seed_u),
                        want_ctrl=want_ctrl)
    assert np.array_equal(got["ctot"].numpy(), np.asarray(want["ctot"]))
    assert np.array_equal(got["t_ctrl"].numpy() < 1e37,
                          np.asarray(want["t_ctrl"]) < 1e37), \
        "control collisions must agree"
    np.testing.assert_allclose(got["t_ctrl"].numpy(),
                               np.asarray(want["t_ctrl"]), rtol=1e-4,
                               atol=1e-5, err_msg="t_ctrl within rtol 1e-4")
    np.testing.assert_allclose(got["rtot"].numpy(), np.asarray(want["rtot"]),
                               rtol=2e-5, atol=1e-6,
                               err_msg="rtot within rtol 2e-5")


def test_plain_matches_xla_profile_and_inversion():
    jv, tv = _volumes()
    start, d, tmax, seed_u, _ = _lanes(512, 7)
    n = 512
    got = pk.pw_events(tv, *_torch(start, d, tmax, seed_u),
                       torch.zeros(n), 0, S=8)
    sigma, c, ccum, rcum, h = jtr._coarse_profile(
        jv, jnp.asarray(start), jnp.asarray(d), jnp.asarray(tmax), 32)
    np.testing.assert_allclose(got["rtot"].numpy(), np.asarray(rcum[-1]),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got["ctot"].numpy(), np.asarray(ccum[-1]),
                               rtol=2e-5, atol=1e-6)
    u = jtr._indexed_draws_lead(jnp.asarray(seed_u), jnp.uint32(0), 8,
                                salt=pk.SALT_RATIO)
    E = jnp.cumsum(-jnp.log1p(-u), axis=0)
    t_ref, beyond_ref, (c_ref, s_ref) = jtr._map_events(E, rcum, h,
                                                        (c, sigma))
    t_k = got["t"].numpy()
    assert np.array_equal(t_k < 0, np.asarray(beyond_ref)), \
        "beyond-segment events must agree"
    live = t_k >= 0
    np.testing.assert_allclose(t_k[live], np.asarray(t_ref)[live],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["c_at"].numpy()[live],
                               np.asarray(c_ref)[live], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        got["sres"].numpy()[live],
        np.maximum(np.asarray(s_ref - c_ref), 1e-12)[live], rtol=1e-5,
        atol=1e-7)


def test_events_e_base_continues_stream():
    _, tv = _volumes()
    start, d, tmax, seed_u, _ = _lanes(256, 9)
    lanes = _torch(start, d, tmax, seed_u)
    one = pk.pw_events(tv, *lanes, torch.zeros(256), 0, S=16)
    half = pk.pw_events(tv, *lanes, torch.zeros(256), 0, S=8)
    rest = pk.pw_events(tv, *lanes, half["e_new"], 8, S=8)
    assert torch.equal(rest["e_new"], one["e_new"]), \
        "the event depth is a sequential sum: halves equal the whole"
    assert torch.equal(torch.cat([half["t"], rest["t"]]), one["t"])


def _walk_mirror(vol, start, d, tmax, seed_u, e_last, e_base, S, salt):
    """K1's interval walk in sequential float32 numpy, in the kernel's
    order (lanes side by side): the S event depths drawn in order; one
    sweep of the intervals in which event s is finished, its interval count
    and running sums recorded, at the first interval with E_s < rcum[c],
    before that interval's terms are added; then every event's outputs,
    from its record or, for an event the sweep did not finish (beyond the
    segment), from the sums over all intervals."""
    f32 = np.float32
    lanes = _torch(start, d, tmax, seed_u)
    sig, ctl, rcum, ccum, h = (
        x.numpy() for x in pk._profile_plain(vol, *lanes[:3]))
    seed64 = lanes[3].to(torch.int64) & 0xFFFFFFFF
    C, n = pk.C, h.shape[0]
    idx = np.arange(n)
    Es, E = [], e_last.copy()
    for s in range(S):
        E = E - torch.log1p(-pk._uniform(seed64, e_base + s, salt)).numpy()
        Es.append(E)
    Es = np.stack(Es)
    kacc, e_left, r_prev = (np.zeros(n, f32) for _ in range(3))
    c_at, sig_at = ctl[0].copy(), sig[0].copy()
    rec = np.zeros((4, S, n), f32)
    done = np.zeros(n, np.int64)          # events finished so far
    for c in range(C):
        while True:
            go = done < S
            go[go] = Es[done[go], idx[go]] < rcum[c, idx[go]]
            if not go.any():
                break
            i = idx[go]
            rec[:, done[i], i] = kacc[i], e_left[i], c_at[i], sig_at[i]
            done[i] += 1
        kacc = kacc + f32(1.0)
        e_left = e_left + (rcum[c] - r_prev)
        c_at = c_at + (ctl[c + 1] - ctl[c])
        sig_at = sig_at + (sig[c + 1] - sig[c])
        r_prev = rcum[c]
    inv, _, (X, Y, Z) = pk._scene(vol)
    out = {k: [] for k in ("lin", "t", "c_at", "sres")}
    for e in range(S):
        beyond = e >= done
        k, el, ca, sa = (np.where(beyond, fin, r[e]) for fin, r in
                         zip((kacc, e_left, c_at, sig_at), rec))
        sres = np.maximum(sa - ca, f32(1e-12))
        rate_h = sres * h
        t = k * h + (Es[e] - el) * h / np.maximum(rate_h, f32(1e-20))
        t = np.where(beyond, f32(-1.0), t)
        u = [(start[:, a] + t * d[:, a]) * f32(inv[a]) + f32(0.5)
             for a in range(3)]
        inside = np.all([(x >= 0) & (x < 1) for x in u], axis=0)
        g = [np.clip(np.floor(x * f32(m)), f32(0), f32(m - 1))
             for x, m in zip(u, (X, Y, Z))]
        lin = (g[0] * f32(Y * Z) + g[1] * f32(Z) + g[2]).astype(np.int32)
        out["lin"].append(np.where(inside & ~beyond, lin, -1))
        out["t"].append(t)
        out["c_at"].append(ca)
        out["sres"].append(sres)
    out = {k: np.stack(v) for k, v in out.items()}
    out.update(e_new=E, rtot=rcum[-1], ctot=ccum[-1])
    return out


def _walk_case(case):
    """(volume, lanes, e_last, e_base) of one walk case."""
    start, d, tmax, seed_u, e_last = _lanes(256, 11)
    data = np.random.RandomState(42).rand(8, 8, 8).astype(np.float32)
    density, e_base = 0.6, 0
    if case == "tmax0":
        tmax[::2] = 0.0
    elif case == "flat":
        # empty macrocells (majorant = control = 0) beside dense ones
        data = np.random.RandomState(42).rand(32, 32, 32).astype(np.float32)
        data[:, :, :20] = 0.0
    elif case == "beyond":
        density = 1e-8
    elif case == "e_last":
        e_last, e_base = e_last * 4.0, 5
    if case != "e_last":
        e_last = np.zeros_like(e_last)
    vol = TVolume.from_dense(data, density, 0.8, device="cpu")
    return vol, (start, d, tmax, seed_u), e_last, e_base


@pytest.mark.parametrize("salt", [pk.SALT_RATIO, pk.SALT_DELTA])
@pytest.mark.parametrize("case", ["random", "tmax0", "flat", "beyond",
                                  "e_last"])
def test_interval_walk_is_bitwise_the_telescoping_sums(case, salt):
    """The kernel's O(S + C) walk carries its sums from event to event; the
    plain version's S x C telescoping loop adds +-0 beyond each event's
    interval prefix.  The two agree bitwise on every output."""
    vol, lanes, e_last, e_base = _walk_case(case)
    S = 16
    want = pk.pw_events_plain(vol, *_torch(*lanes), torch.from_numpy(e_last),
                              e_base, S=S, salt=salt)
    got = _walk_mirror(vol, *lanes, e_last, e_base, S, salt)
    for k, w in want.items():
        assert got[k].dtype == w.numpy().dtype, k
        assert np.array_equal(got[k].view(np.int32),
                              w.numpy().view(np.int32)), f"{k} bitwise"
    t, rtot = want["t"].numpy(), want["rtot"].numpy()
    # each case reaches what it is named for
    if case == "tmax0":
        assert (rtot[::2] == 0).all() and (t[:, ::2] == -1).all()
    elif case == "flat":
        _, _, rcum, _, _ = pk._profile_plain(vol, *_torch(*lanes)[:3])
        steps = np.diff(rcum.numpy(), axis=0)
        assert (steps == 0).mean() > 0.05 and (steps > 0).any()
    elif case == "beyond":
        assert (t == -1).all() and (want["lin"].numpy() == -1).all()
    if case != "beyond":
        assert (t >= 0).mean() > 0.1 and (t == -1).any()


def _cells_lookup_mirror(vol, px, py, pz):
    """K2's macro_lookup_cells in numpy: the cell's integer coordinates
    (a floor saturated to int32, as __float2int_rd), the bounds tested as
    unsigned integers, the index in integers."""
    f32 = np.float32
    inv, dims, _ = pk._scene(vol)
    tbl = vol.macro_packed.numpy().view(np.uint32)
    ints = []
    for p, i, m in zip((px, py, pz), inv, dims):
        c = (p * f32(i) + f32(0.5)) * f32(m)
        ints.append(np.clip(np.floor(c).astype(np.float64), -2.0 ** 31,
                            2.0 ** 31 - 1).astype(np.int64))
    strict = np.all([(i & 0xFFFFFFFF) < m for i, m in zip(ints, dims)], 0)
    ext = np.all([((i & 0xFFFFFFFF) + 1) & 0xFFFFFFFF < m + 2
                  for i, m in zip(ints, dims)], 0)
    (ix, iy, iz), (mx, my, mz) = ints, dims
    lin = (np.clip(ix, 0, mx - 1) * (my * mz) + np.clip(iy, 0, my - 1) * mz
           + np.clip(iz, 0, mz - 1))
    w = tbl[lin]
    s = (w & np.uint32(0xFFFF0000)).view(f32)
    c = np.fmin((w << np.uint32(16)).view(f32), s)
    d = f32(vol.density_factor)
    return (np.where(ext, s, f32(0.0)) * d,
            np.where(strict, c, f32(0.0)) * d)


def test_cell_lookup_is_bitwise_the_float_lookup():
    """K2 looks the macro table up on integer cell coordinates; the plain
    version (K1's lookup) on float ones.  The same bits for points inside,
    on cell faces, in the one-cell border and far outside the box."""
    rs = np.random.RandomState(13)
    data = (0.3 + rs.rand(64, 48, 80)).astype(np.float32)
    vol = TVolume.from_dense(data, 0.6, 0.8, device="cpu")
    inv, dims, _ = pk._scene(vol)
    sky = [1.0 / v for v in inv]
    pts = [rs.uniform(-0.7 * s, 0.7 * s, 4096) for s in sky]
    # exactly on cell faces and box faces, and beyond int32 cell indices
    faces = [((rs.randint(-2, m + 3, 512) / m) - 0.5) * s
             for s, m in zip(sky, dims)]
    far = [rs.choice([-1e12, -3e9, 3e9, 1e12], 64) for _ in sky]
    px, py, pz = (np.concatenate(v).astype(np.float32)
                  for v in zip(pts, faces, far))
    tbl64 = vol.macro_packed.to(torch.int64) & 0xFFFFFFFF
    want = pk._macro_lookup(vol, tbl64, *(torch.from_numpy(v)
                                          for v in (px, py, pz)))
    got = _cells_lookup_mirror(vol, px, py, pz)
    for g, w in zip(got, want):
        assert np.array_equal(g.view(np.int32), w.numpy().view(np.int32))
    sig, ctl = got
    # outside, the one-cell border (majorant only) and inside all reached
    assert (sig == 0).any() and ((sig > 0) & (ctl == 0)).any()
    assert (ctl > 0).any()


def _profile_walk_mirror(vol, start, d, tmax, seed_u, want_ctrl):
    """K2 in sequential float32 numpy, in the kernel's order (lanes side by
    side): the control draw first; the whole sweep of the C intervals on
    integer-cell lookups; then the walk, which adds each interval's terms
    while E >= ccum[c] and stops at the first interval with E < ccum[c]."""
    f32 = np.float32
    C, n = pk.C, tmax.shape[0]
    h = tmax * f32(1.0 / C)
    if want_ctrl:
        seed64 = torch.from_numpy(seed_u.astype(np.int64))
        E = -torch.log1p(-pk._uniform(seed64, 0, pk.SALT_CTRL)).numpy()
    p_sig, p_ctl = _cells_lookup_mirror(vol, *start.T)
    rc = cc = np.zeros(n, f32)
    ctl, ccum = [], []
    for i in range(C):
        t_i = f32(i + 1) * h
        n_sig, n_ctl = _cells_lookup_mirror(
            vol, *(start[:, a] + t_i * d[:, a] for a in range(3)))
        s = np.maximum(p_sig, n_sig)
        c = np.minimum(np.minimum(p_ctl, n_ctl), s)
        cc = cc + c * h
        rc = rc + (s - c) * h
        ctl.append(c)
        ccum.append(cc)
        p_sig, p_ctl = n_sig, n_ctl
    ctl.append(np.zeros(n, f32))
    out = dict(rtot=rc, ctot=cc, t_ctrl=np.full(n, f32(pk.T_BEYOND)))
    if want_ctrl:
        kacc, e_left, c_at = np.zeros(n, f32), np.zeros(n, f32), ctl[0]
        live, cc_prev = np.ones(n, bool), np.zeros(n, f32)
        for c in range(C):
            live &= E >= ccum[c]
            kacc = np.where(live, kacc + f32(1.0), kacc)
            e_left = np.where(live, e_left + (ccum[c] - cc_prev), e_left)
            c_at = np.where(live, c_at + (ctl[c + 1] - ctl[c]), c_at)
            cc_prev = ccum[c]
        rate_h = np.maximum(c_at * h, f32(1e-20))
        t = kacc * h + (E - e_left) * h / rate_h
        out["t_ctrl"] = np.where(E >= cc, f32(pk.T_BEYOND), t)
    return out


def _profile_case(case):
    """(volume, lanes) of one K2 walk case: _walk_case's lanes over a
    volume large enough for its eroded control to be non-zero inside (the
    8^3 and 32^3 volumes of the K1 cases have none)."""
    lanes = _walk_case(case)[1]
    data = 0.3 + np.random.RandomState(42).rand(64, 64, 64)
    if case == "flat":
        data[:, :, :24] = 0.0
    density = 1e-8 if case == "beyond" else 0.6
    return TVolume.from_dense(data.astype(np.float32), density, 0.8,
                              device="cpu"), lanes


@pytest.mark.parametrize("want_ctrl", [True, False])
@pytest.mark.parametrize("case", ["random", "tmax0", "flat", "beyond"])
def test_profile_walk_is_bitwise_the_telescoping_sums(case, want_ctrl):
    """K2's single-event walk stops adding at the first interval past its
    control depth; the plain version's telescoping loop adds +-0 there.
    The two agree bitwise on rtot, ctot and t_ctrl."""
    vol, lanes = _profile_case(case)
    want = pk.pw_profile_plain(vol, *_torch(*lanes), want_ctrl=want_ctrl)
    got = _profile_walk_mirror(vol, *lanes, want_ctrl)
    for k, w in want.items():
        assert got[k].dtype == np.float32, k
        assert np.array_equal(got[k].view(np.int32),
                              w.numpy().view(np.int32)), f"{k} bitwise"
    t, rtot = want["t_ctrl"].numpy(), want["rtot"].numpy()
    beyond = t >= 1e37
    if not want_ctrl or case == "beyond":
        assert beyond.all()
    else:
        assert 0.05 < beyond.mean() < 0.95, "draws inside and beyond"
    if case == "tmax0":
        assert (rtot[::2] == 0).all() and beyond[::2].all()
    elif case == "flat":
        _, _, _, ccum, _ = pk._profile_plain(vol, *_torch(*lanes)[:3])
        steps = np.diff(ccum.numpy(), axis=0)
        assert (steps == 0).mean() > 0.05 and (steps > 0).any()
