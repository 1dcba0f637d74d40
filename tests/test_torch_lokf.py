"""Port parity of the single-plane M (TDR_M_HILO=0, the JAX package's
pallas_score.m_hilo() off: its "lokf" scheme) on the CPU.

The JAX crop kernel contracts its map against M quantized to int8 per
(variant, column); by default a hi and a lo plane, with TDR_M_HILO=0 one
plane and the kf column's residual beside it.  That changes the scores by
about half a per cent, more than JAX's own crop bounds see
(test_pallas_interpret's _check: median rel < 5e-3).  So every bound here
calibrates itself: g, the median relative change between JAX's lokf and
hi/lo scorers on the same inputs, is computed in the same test, and the
port's lokf scores must lie within g / 4 of JAX's lokf ones and at least
g / 2 from the port's hi/lo ones, its kf within 1e-6 of JAX's.

The port is given the map JAX scores (its int8 map dequantized, pq qinv,
or the codes of the nibble-packed map), so that only M separates the two
packages.  The JAX references run in interpret mode, compiled (jax.jit:
an eager search_shifts rounds two of the 40 search shifts otherwise),
under a monkeypatched TDR_M_HILO; each fixture asserts that its lokf
reference differs from hi/lo.  Covered: the quantizer's integers and
scales against JAX's tables, the twelve plain versions against the JAX
lokf scorers (uniform and K-bucket, float and code map), the kernels'
arithmetic emulated against the plains, whole crop, K-bucket and mesh
updates against JAX, the flag read once.  The kernels themselves are held
to the plains on the card (tests/test_torch_cuda.py -k lokf).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from top_down_renderer_tpu.filter import filter as fj
from top_down_renderer_tpu.filter import multiscale as ms_j
from top_down_renderer_tpu.filter import pallas_score as ps
from top_down_renderer_torch.filter import crop_score as cs
from top_down_renderer_torch.filter import filter as ft
from top_down_renderer_torch.filter import multiscale as ms
from top_down_renderer_torch.filter.scoring import rotation_shift
from top_down_renderer_torch.utils.convert import filter_state_from_numpy

import test_multiscale as tms
from test_pallas_interpret import _centers
from test_torch_crop_score import (
    C, CW, F, N, R, STENCIL, TH, _ratio, _rows_of, _t, _world,
)
from torch_parity import assert_rel, np_

torch.set_num_threads(2)

MULTI_N = 96
MULTI_SLOTS = np.array([0.5, 1.0], np.float32)  # mips 1 and 2 at res 1


def _nibbles(byte):
    return np.stack([byte & 15, byte >> 4], -1).reshape(byte.shape[:-1]
                                                         + (-1,))


def _jax_map(packed, int4):
    """JAX's quantization of the map: (the field its kernels score, pq
    qinv or code qinv, float32; qinv (8,))."""
    if int4:
        pq, qinv = ps.quantize_channels_int4(jnp.asarray(packed))
        vals = _nibbles(np.asarray(pq).view(np.uint8))
    else:
        pq, qinv = ps.quantize_channels(jnp.asarray(packed))
        vals = np.asarray(pq)
    qinv = np.asarray(qinv)
    return (vals.astype(np.float32) * qinv).astype(np.float32), qinv


def _med_rel(ref, got, ok):
    ref, got = np.asarray(ref)[ok], np.asarray(got)[ok]
    return float(np.median(np.abs(got - ref)
                           / np.maximum(np.abs(ref), 1e-9)))


def _clear(kf):
    """Rows whose kf lies clear of the 0.5 gate and off the map's far
    edge: the single plane's kf is the count to ~1e-7."""
    kf = np.asarray(kf)
    return (kf >= 0.5) & (np.abs(kf - 0.5) > 1e-6)


def _hold(label, ref_hilo, ref, got, got_hilo, ok):
    """The self-calibrated bound: g = median rel(JAX lokf, JAX hi/lo) on
    the rows ok; the reference must differ from hi/lo (g > 1e-3), the
    port's lokf lie within g / 4 of JAX's and at least g / 2 from the
    port's hi/lo.  Returns g."""
    g = _med_rel(ref_hilo, ref, ok)
    assert g > 1e-3, f"{label}: the lokf reference is hi/lo's (g {g})"
    p = _med_rel(ref, got, ok)
    assert p <= g / 4, f"{label}: port vs JAX lokf {p} > g/4 ({g})"
    d = _med_rel(got_hilo, got, ok)
    assert d >= g / 2, f"{label}: port lokf vs hi/lo {d} < g/2 ({g})"
    return g


def _near_argmin(k, k_ref, costs_ref):
    """The argmin equal but at near ties: where the port's k differs from
    JAX's, JAX's cost at the port's k lies within rel 1e-4 of its best
    (chip_smoke's REL_TOL); and on >= 99 % of the rows equal."""
    k, k_ref = np.asarray(k), np.asarray(k_ref)
    assert np.mean(k == k_ref) >= 0.99
    for i in np.flatnonzero(k != k_ref):
        best = costs_ref[i, k_ref[i]]
        assert abs(costs_ref[i, k[i]] - best) <= 1e-4 * abs(best), i


# -- the JAX references ---------------------------------------------------
@pytest.fixture(scope="module")
def uniform():
    """test_torch_crop_score's float_world (float, edge and far-out
    centres) scored by the JAX uniform tracked, raw-row and argmin
    kernels, compiled, in interpret mode, under TDR_M_HILO=0 and =1, on
    the float map and the code map (TDR_MAP_INT4=1)."""
    packed, scan, rng = _world(5)
    centers = _centers(rng)
    centers[:128] += rng.uniform(-0.5, 0.5, (128, 2)).astype(np.float32)
    centers[135:] += rng.uniform(-0.5, 0.5, (N - 135, 2)).astype(np.float32)
    thetas = (rng.random(N) * 2 * np.pi).astype(np.float32)
    mo = ps.pick_crop_size(F, R)
    ref = {}
    for int4 in (False, True):
        for hilo in (False, True):
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("TDR_M_HILO", "1" if hilo else "0")
                mp.setenv("TDR_MAP_INT4", "1" if int4 else "0")
                mp.setattr(ps, "tracked_p_tile", lambda mo, **kw: 16)
                mp.setattr(ps, "init_p_tile", lambda mo, **kw: 16)
                maps = ps.build_padded_maps(jnp.asarray(packed))
                assert maps.i4 == int4 and ps.m_hilo() == hilo
                args = (maps, jnp.asarray(STENCIL), jnp.asarray(scan),
                        jnp.asarray(CW), jnp.asarray(centers))
                tracked = jax.jit(lambda *a: ps.make_score_tracked(
                    mo, 1.0, True)(*a, F))(*args, jnp.asarray(thetas))
                raw = jax.jit(lambda *a: ps.make_score_init(
                    mo, 40, 1.0, True)(*a, F))(*args)
                sel = jax.jit(lambda *a: ps.make_score_init(
                    mo, 40, 1.0, True, sel=True)(*a, F))(*args)
            ref[int4, hilo] = {k: tuple(np.asarray(x) for x in v) for k, v in
                               (("tracked", tracked), ("raw", raw),
                                ("sel", sel))}
    return packed, scan, centers, thetas, ref


@pytest.fixture(scope="module")
def multi():
    """The JAX K-bucket scorers (test_code_pyramid_plains_hold_the_jax_
    int4_multi_bounds' world: two buckets, scales 0.5 and 1.0 at mips 1
    and 2), compiled, in interpret mode, under TDR_M_HILO=0 and =1, on the
    float and the code pyramid."""
    packed, stencil, scan, cw, rng = tms._world(seed=9)
    centers = rng.integers(48, 200, (MULTI_N, 2)).astype(np.float32)
    scale = np.where(rng.random(MULTI_N) < 0.5, 0.5, 1.0).astype(np.float32)
    thetas = (rng.random(MULTI_N) * 2 * np.pi).astype(np.float32)
    tail = (jnp.asarray(scale), jnp.asarray(MULTI_SLOTS),
            jnp.asarray(1.0, jnp.float32))
    ref = {}
    for int4 in (False, True):
        for hilo in (False, True):
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("TDR_M_HILO", "1" if hilo else "0")
                mp.setenv("TDR_MAP_INT4", "1" if int4 else "0")
                mp.setattr(ps, "init_p_tile", lambda mo, **kw: 16)
                mp.setattr(ps, "tracked_p_tile", lambda mo, **kw: 16)
                pyr = ms_j.build_pyramid_maps(jnp.asarray(packed), (1, 2))
                args = (pyr, jnp.asarray(stencil), jnp.asarray(scan), cw,
                        jnp.asarray(centers))
                raw = jax.jit(lambda *a: ms_j.make_score_init_multi(
                    2, (0, 1), interpret=True, mo=tms.MO)(*a))(*args, *tail)
                sel = jax.jit(lambda *a: ms_j.make_score_init_multi(
                    2, (0, 1), interpret=True, mo=tms.MO, sel=True)(*a))(
                        *args, *tail)
                tracked = jax.jit(lambda *a: ms_j.make_score_tracked_multi(
                    2, (0, 1), interpret=True, mo=tms.MO)(*a))(
                        *args, jnp.asarray(thetas), *tail)
            ref[int4, hilo] = {k: tuple(np.asarray(x) for x in v) for k, v in
                               (("tracked", tracked), ("raw", raw),
                                ("sel", sel))}
    return packed, stencil, scan, np.asarray(cw), centers, scale, thetas, ref


def _uniform_maps(packed, int4):
    """The port's maps of JAX's field: (lokf CropMap, hi/lo CropMap)."""
    if int4:
        t = torch.as_tensor(packed)
        return (cs.CropMap(t, int4=True, m_hilo=False),
                cs.CropMap(t, int4=True))
    field, qinv = _jax_map(packed, False)
    t = torch.as_tensor(field)
    return (cs.CropMap(t, m_hilo=False, m_qinv=torch.as_tensor(qinv)),
            cs.CropMap(t))


# -- the quantizer against JAX's tables -----------------------------------
def _jax_lokf(m_var, amax, kf_col):
    """_run_kernel's lokf arithmetic on a JAX table: (integers, scales)."""
    m32 = np.asarray(m_var.astype(jnp.float32))
    a = np.asarray(amax) * np.float32(1.0 + 2.0**-8)
    s = np.maximum(a, np.float32(1e-30)) / np.float32(127.0)
    q = np.clip(np.round(m32 / s[..., None]), -127, 127)
    res = m32[:, kf_col] - q[:, kf_col] * s[:, kf_col, None]
    s_lo = s[:, kf_col] / np.float32(254.0)
    q[:, kf_col + 1] = np.clip(np.round(res / s_lo[:, None]), -127, 127)
    s = s.copy()
    s[:, kf_col + 1] = s_lo
    return q, s


def _table_rows(pix, mo, int4, cp):
    """The JAX table's K index of each (pixel, channel) of the port's fold
    (float map), or of each (pixel, byte) plane entry (code map, plus the
    plane's width)."""
    dr, dc = ps.crop_dims(mo)
    py = pix[:, 0] + dr // 2
    if int4:
        t4 = ps.trim_bytes_i4(mo)
        base = py * t4 + (pix[:, 1] + mo + 1) * 4
        return base[:, None] + np.arange(cp // 2)[None]
    base = py * ps.trim_lanes(mo) + (pix[:, 1] + (dc - 16) // 2) * 8
    return base[:, None] + np.arange(cp)[None]


def _jax_weights(q, rows, int4):
    """JAX's integers at the port's (pixel, channel) rows: (cols, P, CP);
    on the code map its weights q_e + q_b and 16 q_b."""
    if not int4:
        return q[:, rows]
    half = q.shape[1] // 2
    qe, qb = q[:, rows], q[:, half + rows]
    return np.stack([qe + qb, 16 * qb], -1).reshape(q.shape[0],
                                                    rows.shape[0], -1)


@pytest.mark.parametrize("int4", [False, True], ids=["float", "code"])
def test_init_quantizer_equals_jax_tables(int4):
    """init_m_lokf's integers and column scales against _run_kernel's
    lokf arithmetic on JAX's own build_m_init table (compiled, the map
    quantization's qinv folded in): every scale equal, the integers equal
    on >= 99.9 % of the entries (the port sums each pixel's cells exactly,
    JAX in float32 on its matrix unit)."""
    packed, scan, _ = _world(5)
    _, qinv = _jax_map(packed, int4)
    mo = ps.pick_crop_size(F, R)
    m_var, amax = jax.jit(lambda a, b, c, q: ps.build_m_init(
        a, b, c, F, mo, 40, q, with_amax=True, i4=int4))(
            jnp.asarray(scan), jnp.asarray(CW), jnp.asarray(STENCIL),
            jnp.asarray(qinv))
    q, s = (x[0] for x in _jax_lokf(m_var, amax, 80))
    pix, npix, order, seg = cs.fold_offsets(cs.crop_offsets(
        torch.as_tensor(STENCIL), F)[None])
    w, sc = cs.init_m_lokf(torch.as_tensor(scan), torch.as_tensor(CW), order,
                           seg, 40, torch.as_tensor(qinv), int4)
    cp = cs.channel_pad(C)
    n = int(npix[0])
    # JAX's columns: cost k, norm 40 + k, kf 80, its residual 81
    cols = np.r_[np.stack([np.arange(40), 40 + np.arange(40)], 1).ravel(),
                 80, 81]
    np.testing.assert_array_equal(np_(sc[0])[:82], s[cols])
    assert (np_(sc[0])[82:] > 0).all()
    want = _jax_weights(q[cols], _table_rows(np_(pix[0, :n]), mo, int4, cp),
                        int4)
    got = np_(w[0]).reshape(-1, cp, cs.M_COLS)[:n].transpose(2, 0, 1)[:82]
    assert np.mean(got == want) >= 0.999
    assert (got != 0).sum() > 10_000 and not np_(w[0, n * cp:]).any()


@pytest.mark.parametrize("int4", [False, True], ids=["float", "code"])
def test_tracked_quantizer_equals_jax_tables(int4):
    """tracked_lokf's integers and (bucket, shift) scales against
    _run_kernel's lokf arithmetic on JAX's build_m_tracked tables: shift s
    is column s % 16 of group s // 16 (its norm 16 further on, kf 32, the
    residual 33); the scales equal, the integers on >= 99.9 %."""
    packed, scan, _ = _world(5)
    _, qinv = _jax_map(packed, int4)
    mo = ps.pick_crop_size(F, R)
    m_var, amax = jax.jit(lambda a, b, c, q: ps.build_m_tracked(
        a, b, c, F, mo, q, with_amax=True, i4=int4))(
            jnp.asarray(scan), jnp.asarray(CW), jnp.asarray(STENCIL),
            jnp.asarray(qinv))
    q, s = _jax_lokf(m_var, amax, 2 * ps.GW)
    pix, npix, order, seg = cs.fold_offsets(cs.crop_offsets(
        torch.as_tensor(STENCIL), F)[None])
    w, sc = cs.tracked_lokf(cs.tracked_weights(
        torch.as_tensor(scan), torch.as_tensor(CW), order, seg,
        torch.as_tensor(qinv)), int4, C)
    n, cp = int(npix[0]), cs.channel_pad(C)
    rows = _table_rows(np_(pix[0, :n]), mo, int4, cp)
    same = total = 0
    for sh in range(TH):
        g, j = divmod(sh, ps.GW)
        cols = [j, ps.GW + j, 2 * ps.GW, 2 * ps.GW + 1]
        np.testing.assert_array_equal(np_(sc[0, sh]), s[g, cols])
        jw = _jax_weights(q[g][cols], rows, int4)  # (4, n, CP)
        want = np.concatenate([jw[0, :, :C], jw[1:, :, C].T], 1)
        got = np_(w[0, sh, :n])
        same += (got == want).sum()
        total += got.size
    assert same / total >= 0.999


# -- the plain versions against the JAX lokf scorers ----------------------
@pytest.mark.parametrize("int4", [False, True], ids=["float", "code"])
def test_uniform_plains_hold_jax_lokf(uniform, int4):
    """The port's uniform scorers on a CropMap with m_hilo=False (on the
    CPU: the plain versions, the dequantized single-plane M) against the
    JAX lokf kernels: tracked cost and norm, the raw rows' costs at all 40
    search shifts, the argmin's best cost, each within g / 4 of JAX's lokf
    and at least g / 2 from the port's hi/lo; kf within 1e-6 of JAX's; the
    argmin JAX's but at near ties."""
    packed, scan, centers, thetas, ref = uniform
    lokf, hilo = _uniform_maps(packed, int4)
    args = _t(STENCIL, scan, CW, centers)
    th = torch.as_tensor(thetas)
    jl, jh = ref[int4, False], ref[int4, True]

    got = cs.score_tracked(lokf, C, *args, th, F)
    got_h = cs.score_tracked(hilo, C, *args, th, F)
    assert np.abs(np_(got[2]) - jl["tracked"][2]).max() <= 1e-6
    ok = _clear(jl["tracked"][2])
    for i, what in ((0, "cost"), (1, "norm")):
        _hold(f"tracked {what}", jh["tracked"][i], jl["tracked"][i],
              np_(got[i]), np_(got_h[i]), ok)

    nums, dens, kf = cs.score_init_raw(lokf, C, *args, F)
    nums_h, dens_h, _ = cs.score_init_raw(hilo, C, *args, F)
    assert np.abs(np_(kf) - jl["raw"][2]).max() <= 1e-6
    ok = np.broadcast_to(_clear(jl["raw"][2])[:, None], nums.shape)
    _hold("raw cost", _ratio(*jh["raw"][:2]), _ratio(*jl["raw"][:2]),
          _ratio(nums, dens), _ratio(nums_h, dens_h), ok)

    best, k, kf2 = cs.score_init_sel(lokf, C, *args, F)
    best_h = cs.score_init_sel(hilo, C, *args, F)[0]
    rbest, rtheta, rkf = jl["sel"]
    assert np.abs(np_(kf2) - rkf).max() <= 1e-6
    fin = (rbest < cs.FLT_MAX) & _clear(rkf)
    np.testing.assert_array_equal((np_(best) < cs.FLT_MAX)[fin], True)
    _hold("best cost", jh["sel"][0], rbest, np_(best), np_(best_h), fin)
    k_ref = np.round(rtheta / np.float32(2 * math.pi / 40)).astype(int)
    _near_argmin(np_(k)[fin], k_ref[fin], _ratio(*jl["raw"][:2])[fin])


@pytest.mark.parametrize("int4", [False, True], ids=["float", "code"])
def test_multi_plains_hold_jax_lokf(multi, int4):
    """The K-bucket scorers on a pyramid built with m_hilo=False (the
    plain versions: one dequantized single-plane M a bucket) against the
    JAX K-bucket lokf scorers, at the same self-calibrated bounds."""
    packed, stencil, scan, cw, centers, scale, thetas, ref = multi
    if int4:
        t = torch.as_tensor(packed)
        pyrs = [ms.build_pyramid_maps(t, (1, 2), True, m_hilo=h)
                for h in (False, True)]
    else:
        field, qinv = _jax_map(packed, False)
        t = torch.as_tensor(field)
        pyrs = [ms.build_pyramid_maps(t, (1, 2), m_hilo=h)
                for h in (False, True)]
        pyrs[0]._m_qinv = torch.as_tensor(qinv)  # JAX's full-map qinv
    assert not pyrs[0].m_hilo and pyrs[1].m_hilo
    tail = (torch.as_tensor(scale), torch.as_tensor(MULTI_SLOTS), (0, 1),
            1.0)
    args = [(p, tms.C, *_t(stencil, scan, cw, centers)) for p in pyrs]
    jl, jh = ref[int4, False], ref[int4, True]
    th = torch.as_tensor(thetas)

    got, got_h = (ms.score_tracked_multi(*a, th, *tail) for a in args)
    assert np.abs(np_(got[2]) - jl["tracked"][2]).max() <= 1e-6
    ok = _clear(jl["tracked"][2])
    for i, what in ((0, "cost"), (1, "norm")):
        _hold(f"multi tracked {what}", jh["tracked"][i], jl["tracked"][i],
              np_(got[i]), np_(got_h[i]), ok)

    (nums, dens, kf), (nh, dh, _) = (ms.score_init_multi_raw(*a, *tail)
                                     for a in args)
    assert np.abs(np_(kf) - jl["raw"][2]).max() <= 1e-6
    ok = np.broadcast_to(_clear(jl["raw"][2])[:, None], nums.shape)
    _hold("multi raw cost", _ratio(*jh["raw"][:2]), _ratio(*jl["raw"][:2]),
          _ratio(nums, dens), _ratio(nh, dh), ok)

    best, k, kf2 = ms.score_init_multi_sel(*args[0], *tail)
    best_h = ms.score_init_multi_sel(*args[1], *tail)[0]
    rbest, rtheta, rkf = jl["sel"]
    assert np.abs(np_(kf2) - rkf).max() <= 1e-6
    fin = (rbest < cs.FLT_MAX) & _clear(rkf)
    _hold("multi best cost", jh["sel"][0], rbest, np_(best), np_(best_h),
          fin)
    k_ref = np.round(rtheta / np.float32(2 * math.pi / 40)).astype(int)
    _near_argmin(np_(k)[fin], k_ref[fin], _ratio(*jl["raw"][:2])[fin])


# -- the kernels' arithmetic, on the CPU ----------------------------------
def _classes_world(c, seed, h=64, w=80):
    rng = np.random.default_rng(seed)
    packed = np.zeros((h, w, 8), np.float32)
    packed[..., :c] = rng.random((h, w, c)) * 50
    packed[..., c] = (rng.random((h, w)) < 0.9).astype(np.float32)
    scan = (rng.random((c, TH, R)) * 3).astype(np.float32)
    centers = rng.uniform(-20, 100, (160, 2)).astype(np.float32)
    centers[:3] = [[0.0, 0.0], [79.0, 63.0], [-500.0, 30.0]]
    cw = (0.5 + rng.random(c)).astype(np.float32)
    return packed, scan, centers, cw


def _code_values(maps, c):
    """The codes of a code CropMap as the kernels read them, (H*W, CP)
    float32."""
    cp = cs.channel_pad(c)
    b = np_(maps.codes(c)).astype(np.uint32)
    word = sum(b[..., j] << (8 * j) for j in range(cp // 2))
    nib = np.stack([(word >> (4 * ch)) & 15 for ch in range(cp)], -1)
    return torch.as_tensor(nib.reshape(-1, cp).astype(np.float32))


def _kernel_weights(y, s, rq, c, int4):
    """lokf_weights of csrc/crop_tracked.cuh in numpy float32, one line of
    the kernel at a time, from tracked_weights' sums y (K, Th, P, C + 2)
    and the scales s (K, Th, 4): the weights the tracked kernel folds."""
    y, s = np_(y), np_(s)[:, :, None, :]
    f32 = np.float32

    def bf(x):
        return np_(torch.as_tensor(x).to(torch.bfloat16).float())

    def q(x, sc):
        return np.clip(np.rint(x / sc), -127, 127).astype(f32)

    sx, sy, sz, sw = (s[..., i] for i in range(4))
    w = np.zeros(y.shape, f32)
    yn, yk = y[..., c], y[..., c + 1]
    if int4:
        for ch in range(c):
            if ch % 2 == 0:
                b = (y[..., ch + 1] if ch + 1 < c else 0 * yn) * f32(0.0625)
                w[..., ch] = (q(bf(y[..., ch] - b), sx) + q(bf(b), sx)) * sx
            else:
                w[..., ch] = (f32(16) * q(bf(y[..., ch] * f32(0.0625)), sx)
                              * sx)
        div, mul = (f32(0.0625), f32(16)) if c % 2 else (f32(1), f32(1))
        w[..., c] = mul * q(bf(yn * div), sy) * sy
        tk = bf(yk * div)
        qk = q(tk, sz)
        w[..., c + 1] = (mul * qk) * sz + (mul * q(tk - qk * sz, sw)) * sw
        return torch.as_tensor(w)
    rq = np_(rq)
    for ch in range(c):
        w[..., ch] = (q(bf(y[..., ch]), sx) * sx) * rq[ch]
    w[..., c] = (q(bf(yn), sy) * sy) * rq[c]
    tk = bf(yk)
    qk = q(tk, sz)
    w[..., c + 1] = (qk * sz + q(tk - qk * sz, sw) * sw) * rq[c]
    return torch.as_tensor(w)


def _table_weights(table, s, rq, c, int4):
    """lokf_dequant of csrc/crop_tracked.cuh in numpy float32, one line of
    the kernel at a time, from the weights pass's table (K, Th, C + 3, P)
    int16 and scales (K, Th, 4): the weights (K, Th, P, C + 2) the tracked
    kernel dequantizes into shared memory, (q s) rq on the float map, q s
    on the code map, the kf weight q_kf s_kf + q_lo s_lo."""
    q = np_(table).astype(np.float32).transpose(0, 1, 3, 2)
    s = np_(s)[:, :, None, :]
    sx, sy, sz, sw = (s[..., i] for i in range(4))
    w = np.zeros(q.shape[:-1] + (c + 2,), np.float32)
    rq = np_(rq)
    for ch in range(c):
        w[..., ch] = q[..., ch] * sx if int4 else (q[..., ch] * sx) * rq[ch]
    w[..., c] = q[..., c] * sy if int4 else (q[..., c] * sy) * rq[c]
    k = q[..., c + 1] * sz + q[..., c + 2] * sw
    w[..., c + 1] = k if int4 else k * rq[c]
    return torch.as_tensor(w)


_FOLD_CASES = [(1, 1.0, False), (3, 0.5, False), (6, 0.37, False),
               (2, 1.0, True), (3, 0.5, True), (7, 0.37, True)]


@pytest.mark.parametrize("c,f,int4,src", [
    pytest.param(*k, src, id="-".join(map(str, k)) + tag)
    for src, tag in (("sums", ""), ("table", "-table"))
    for k in _FOLD_CASES])
def test_lokf_tracked_fold_equals_plain(c, f, int4, src):
    """The tracked kernel's single-plane weights on the CPU, src "sums":
    lokf_weights, emulated line by line in numpy from the exact per-pixel
    sums and tracked_scales' scales; src "table": the weights pass's plain
    version (tracked_table: tracked_lokf's integers, as int16 in the
    kernel's (K, Th, C + 3, P) layout, and its scales) and the kernel's
    dequantization of them (lokf_dequant, emulated in numpy).  Either
    equals tracked_lokf_weights' bit for bit on the float map, and weighs
    the window as the kernel does (the float map's values, or the codes
    themselves on the code map) to the plain version's scores (rel 1e-5,
    kf within 1e-6); every shift, windows across the edges and far out."""
    packed, scan, centers, cw = _classes_world(c, int(f * 100) + c)
    m, sten, sc, cwt, ctr = _t(packed, STENCIL, scan, cw, centers)
    th = torch.as_tensor((np.arange(160) * np.float32(2 * math.pi / TH)
                          - 2 * math.pi).astype(np.float32))
    maps = cs.CropMap(m, int4=int4, m_hilo=False)
    qinv = maps.m_qinv
    cost, norm, kf = cs.score_tracked(maps, c, sten, sc, cwt, ctr, th, f)
    fold = cs.fold_offsets(cs.crop_offsets(sten, f)[None])
    y = cs.tracked_weights(sc, cwt, fold[2], fold[3], qinv)
    s = cs.tracked_scales(sc, cwt, qinv, fold, c, int4)
    rq = 1.0 / qinv
    if src == "sums":
        w = _kernel_weights(y, s, rq, c, int4)
    else:
        table, ts = cs.tracked_table(sc, cwt, qinv, fold, c, int4)
        wl, sl = cs.tracked_lokf(y, int4, c)
        assert table.dtype == torch.int16
        assert table.shape == (1, TH, c + 3, fold[0].shape[1])
        assert torch.equal(table.float().transpose(-1, -2), wl)
        assert torch.equal(ts, sl) and torch.equal(ts, s)
        assert np.abs(np_(table)).max() <= (2032 if int4 else 127)
        w = _table_weights(table, ts, rq, c, int4)
    if int4:
        a = _code_values(maps, c)
    else:
        assert torch.equal(w, cs.tracked_lokf_weights(
            *cs.tracked_lokf(y, False, c), rq, c))
        a = cs.compact_map(m, c).reshape(-1, cs.channel_pad(c))
    inv = float(np.float32(1.0) / np.float32(TH * R))
    got = cs.folded_scores(a, torch.tensor([[0, 64, 80, 0]]),
                           cs.crop_centers(ctr, 1.0), fold[0], w,
                           torch.zeros(160, dtype=torch.int32),
                           rotation_shift(th, TH), c, inv)
    assert np.abs(np_(got[2]) - np_(kf)).max() <= 1e-6
    ok = _clear(np_(kf))
    assert_rel(np_(cost)[ok], np_(got[0])[ok], 1e-5, "cost")
    assert_rel(np_(norm)[ok], np_(got[1])[ok], 1e-5, "norm")
    assert (np_(kf) == 0).any() and ok.any()


def _window_rows(values, ctr, pix, npix):
    """(N, npix CP): each particle's window of the fold's pixels on the
    (H, W, CP) map values, zero outside it."""
    h, w, cp = values.shape
    q = int(npix)
    iy = ctr[:, None, 0] + pix[None, :q, 0]
    ix = ctr[:, None, 1] + pix[None, :q, 1]
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    lin = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    a = torch.where(valid[..., None], values.reshape(-1, cp)[lin.long()],
                    0.0)
    return a.reshape(len(ctr), -1)


@pytest.mark.parametrize("c,int4", [(1, False), (3, False), (6, False),
                                    (2, True), (3, True), (6, True)])
def test_lokf_init_product_equals_plain(c, int4):
    """The single-plane theta search's arithmetic on the CPU: the window
    times 1 / qinv split into bf16 hi and lo (the codes as they are on the
    code map) times the plane of integers (exact in bf16), A_hi B + A_lo B
    (A B), each column then times its scale, kf columns 80 and 81 added:
    the plain version's raw rows (rel 1e-5, kf within 1e-6), and it
    selects as the plain version does (rel 1e-4, the argmin on 99.9 %).
    The records hold that one plane, then the pixels."""
    packed, scan, centers, cw = _classes_world(c, 20 + c)
    m, sten, sc, cwt, ctr = _t(packed, STENCIL, scan, cw, centers[:96])
    maps = cs.CropMap(m, int4=int4, m_hilo=False)
    qinv = maps.m_qinv
    nums, dens, kf = cs.score_init_raw(maps, c, sten, sc, cwt, ctr, 1.0)
    pix, npix, order, seg = cs.fold_pixels(cs.crop_offsets(sten, 1.0)[None])
    w, s = cs.init_m_lokf(sc, cwt, order, seg, 40, qinv, int4)
    cp = cs.channel_pad(c)
    assert torch.equal(w.to(torch.bfloat16).float(), w)
    if int4:
        vals = _code_values(maps, c).reshape(64, 80, cp)
        parts = (_window_rows(vals, cs.crop_centers(ctr, 1.0), pix[0],
                              npix[0]),)
    else:
        vals = (cs.compact_map(m, c) * (1.0 / qinv[:cp])).reshape(64, 80, cp)
        a = _window_rows(vals, cs.crop_centers(ctr, 1.0), pix[0], npix[0])
        parts = cs.split_bf16(a)
    b = w[0, : int(npix[0]) * cp].double()
    acc = sum(p.double() @ b for p in parts).float() * s[0]
    acc[:, cs.KF_COL] += acc[:, cs.KF_COL + 1]
    got = _rows_of(acc, 40, TH * R)
    assert np.abs(np_(got[2]) - np_(kf)).max() <= 1e-6
    ok = _clear(np_(kf))
    assert_rel(np_(nums)[ok], np_(got[0])[ok], 1e-5, "num")
    assert_rel(np_(dens)[ok], np_(got[1])[ok], 1e-5, "den")
    best, k, _ = cs.score_init_sel(maps, c, sten, sc, cwt, ctr, 1.0)
    sb, sk = cs.select_best(*got)
    fin = (np_(best) < cs.FLT_MAX) & ok
    assert_rel(np_(best)[fin], np_(sb)[fin], 1e-4, "split best")
    assert np.mean(np_(sk) == np_(k)) >= 0.999

    rows = torch.tensor([0, 96])
    rec, sched, scales = cs.init_records(sc, cwt, (pix, npix, order, seg),
                                         rows, 40, **cs.record_args(maps))
    assert torch.equal(scales, s)
    plane = cs.K_CHUNK * cs.M_COLS
    kk, nn = np.meshgrid(np.arange(32), np.arange(cs.M_COLS), indexing="ij")
    at = ((kk // 8) * 11 + nn // 8) * 64 + (nn % 8) * 8 + kk % 8
    order_c = np_(cs.code_chunk_order()) if int4 else np.arange(32)
    wb = w.to(torch.bfloat16).view(torch.int16)
    assert rec.shape[2] == plane + (cs.K_CHUNK // cp) * 4
    for ch in (0, 3):
        np.testing.assert_array_equal(np_(rec[0, ch][at]),
                                      np_(wb[0, 32 * ch + order_c]))
        np.testing.assert_array_equal(
            np_(rec[0, ch, plane:].view(torch.int32)).reshape(-1, 2),
            np_(pix[0, ch * 32 // cp:(ch + 1) * 32 // cp]))


# -- whole steps under TDR_M_HILO=0 ---------------------------------------
def _integer_map(d):
    """d's map with its distances rounded to integers up to 126 and one
    126 a class: the int8 map's qinv is 1 and stores them exactly, so
    JAX's crop kernel and the port read one field."""
    packed = d["packed"]
    packed[..., :C] = np.round(packed[..., :C] * (126.0 / 50.0))
    packed[0, 0, :C] = 126.0
    return packed


@pytest.mark.parametrize("mode", ["tracked", "init", "mixed"])
def test_crop_step_under_the_flag_matches_jax(mode, monkeypatch):
    """One crop update with TDR_M_HILO=0 read as the filter reads it
    (crop_score.m_hilo on the port's CropMap) against the JAX fast crop
    step under the flag (its kernel in interpret mode) on integer centres
    of an integer map, with the reference's resample draw:
    test_crop_step_on_integer_centres_matches_jax_exact's tolerances."""
    from test_torch_filter import (N as SN, _compare_states,
                                   _resample_shift, _setups)

    monkeypatch.setenv("TDR_M_HILO", "0")
    for name in ("score_tracked_fast_mo", "score_init_sel_mo"):
        fn = getattr(ps, name)
        monkeypatch.setattr(ps, name, lambda *a, _fn=fn, **kw: _fn(
            *a, **kw, interpret=True))
    monkeypatch.setattr(ps, "tracked_p_tile", lambda mo, **kw: 32)
    monkeypatch.setattr(ps, "init_p_tile", lambda mo, **kw: 32)
    st_j, d, params = _setups(mode != "init", cluster=False, integer=True)
    if mode == "mixed":
        have = np.arange(SN) % 3 == 0
        d["state"]["particles"]["have_init"][:] = have
        st_j = st_j.replace(particles=st_j.particles.replace(
            have_init=jnp.asarray(have)))
    packed = _integer_map(d)
    res = 0.5
    step_j = fj.make_update_step_fast(params, 3, 1.0, 100, SN, mode,
                                      mo=ps.pick_crop_size(1.0, R),
                                      gmm_every=1)
    out_j = step_j(st_j, ps.build_padded_maps(jnp.asarray(packed)),
                   *(jnp.asarray(d[k]) for k in
                     ("map_size", "stencil", "scan")), jnp.float32(res))
    step_t = ft.make_update_step_fast(params, 3, 1.0, 100, SN, mode,
                                      gmm_every=1)
    maps = cs.CropMap(torch.as_tensor(packed), m_hilo=cs.m_hilo())
    assert not maps.m_hilo
    out_t = step_t(filter_state_from_numpy(d["state"]), maps,
                   *(torch.as_tensor(d[k]) for k in
                     ("map_size", "stencil", "scan")), res,
                   shift=_resample_shift(st_j))
    _compare_states(out_j, out_t)


@pytest.mark.parametrize("mode", ["init", "tracked"])
def test_multi_step_under_the_flag_matches_jax(mode, monkeypatch):
    """One K-bucket step with TDR_M_HILO=0 on both sides (the port's
    pyramid built with crop_score.m_hilo, its plain scorers; JAX's in
    interpret mode): test_multi_step_matches_jax's state, map and
    tolerances."""
    from test_torch_filter import _compare_states, _resample_shift
    from test_torch_multiscale import (BMI, MIPS, STEP_N, STEP_SLOTS,
                                       _theta_flips_are_near_ties)
    from top_down_renderer_torch.testing import synthetic_setup
    import __graft_entry__ as ge
    from top_down_renderer_tpu.config import FilterParams
    from top_down_renderer_tpu.filter import resample as res_j
    from top_down_renderer_torch.filter.resample import pack_fields

    monkeypatch.setenv("TDR_M_HILO", "0")
    monkeypatch.setattr(ps, "init_p_tile", lambda mo, **kw: 16)
    monkeypatch.setattr(ps, "tracked_p_tile", lambda mo, **kw: 16)
    st_j, *_, params = ge._synthetic_setup(STEP_N, seed=3)
    d = synthetic_setup(STEP_N, seed=3)
    rng = np.random.default_rng(4)
    packed = _integer_map(d)
    scale = STEP_SLOTS[rng.integers(0, 2, st_j.particles.n_max)]
    have = np.full(len(scale), mode != "init")
    d["state"]["particles"]["scale"][:] = scale
    d["state"]["particles"]["have_init"][:] = have
    st_j = st_j.replace(particles=st_j.particles.replace(
        scale=jnp.asarray(scale), have_init=jnp.asarray(have)))
    params = FilterParams(**{**params.__dict__, "fixed_scale": -1.0})
    n = st_j.particles.n_max
    res = 0.5
    step_j = fj.make_update_step_multiscale(
        params, C, 1.0, 100, n, mode, 2, BMI, mo=tms.MO, gmm_every=1,
        interpret=True)
    out_j = step_j(st_j, ms_j.build_pyramid_maps(jnp.asarray(packed), MIPS),
                   jnp.asarray(d["map_size"]), jnp.asarray(d["stencil"]),
                   jnp.asarray(d["scan"]), jnp.float32(res),
                   jnp.asarray(STEP_SLOTS))
    step_t = ft.make_update_step_multiscale(params, C, 1.0, 100, n, mode,
                                            BMI, gmm_every=1)
    t = {k: torch.as_tensor(d[k]) for k in ("map_size", "stencil", "scan")}
    st_t = filter_state_from_numpy(d["state"])
    pyr = ms.build_pyramid_maps(torch.as_tensor(packed), MIPS,
                                m_hilo=cs.m_hilo())
    assert not pyr.m_hilo
    out_t = step_t(st_t, pyr, t["map_size"], t["stencil"], t["scan"], res,
                   torch.as_tensor(STEP_SLOTS), shift=_resample_shift(st_j))
    _compare_states(out_j, out_t, rows_frac=0.0)
    p = st_t.particles
    flip = _theta_flips_are_near_ties(out_j, out_t, st_t, (
        pyr, C, t["stencil"], t["scan"], ft._pad_class_weights(params, C),
        p.pose_px(), p.scale, torch.as_tensor(STEP_SLOTS), BMI, res))
    if mode == "tracked":
        assert not flip.any()
    rows_j = np.asarray(res_j.pack_fields(out_j.particles))
    rows_t = np_(pack_fields(out_t.particles))
    same = np.all(rows_j == rows_t, axis=1) | flip
    assert same.mean() >= 0.99, f"{same.mean():.3f} rows identical"


def test_mesh_init_step_under_the_flag_matches_jax(tmp_path_factory,
                                                   monkeypatch):
    """The mesh's K-bucket steps (the theta search through the raw rows,
    then tracked) with TDR_M_HILO=0 in the environment of both packages:
    the port's filter on two gloo ranks reads it once (m_hilo None), its
    pyramid takes the single plane, and its max_likelihood after each
    update is the reference mesh's (test_mesh_multi_path_matches_jax's
    bounds and dispatch keys)."""
    from test_sharding import _mini_world_pf_unknown_scale
    from test_torch_sharding import ATOL, RTOL, _jax_mesh, _keys, _ranks

    monkeypatch.setenv("TDR_M_HILO", "0")
    mesh = _jax_mesh()
    monkeypatch.setattr(ps, "init_p_tile", lambda mo, **kw: 16)
    monkeypatch.setattr(ps, "tracked_p_tile", lambda mo, **kw: 16)
    pf_j = _mini_world_pf_unknown_scale(mesh=mesh, seed=11)
    key, shifts = pf_j.state.key, []
    for _ in range(2):
        key, k_rs, _ = jax.random.split(key, 3)
        shifts.append(float(jax.random.uniform(k_rs)))
    ranks = _ranks(tmp_path_factory, "unknown_scale_rank", 11, shifts)
    rng = np.random.default_rng(5)
    mls = []
    for _ in shifts:
        pf_j.update(jnp.asarray(rng.random((3, 100, 25)).astype(
            np.float32)), 1.0)
        mls.append(pf_j.max_likelihood())
    keys = _keys(pf_j._sharded_fns)
    assert [k[:2] for k in keys] == [("multi", "init"), ("multi", "tracked")]
    for got in ranks.result():
        assert got["m_hilo"] is False
        assert got["keys"] == keys
        np.testing.assert_allclose(got["ml"], np.stack(mls), rtol=RTOL,
                                   atol=ATOL)
        assert got["n_active"] == int(pf_j.state.n_active)


# -- the switch ------------------------------------------------------------
def test_the_filter_reads_the_flag_once(monkeypatch):
    """Only the filter reads TDR_M_HILO, once, when it is made with
    m_hilo=None: its maps and pyramids carry the choice; a filter made
    before the flag changes, or with m_hilo given, keeps its own; a
    CropMap or pyramid made without m_hilo is hi/lo whatever the flag; the
    entry names carry "_lokf" last; the ablations refuse the single plane
    (they time the hi/lo bodies)."""
    from drive_consumer_torch import make_filter
    from util_synthetic import make_world

    world = make_world(128, 128)
    monkeypatch.delenv("TDR_M_HILO", raising=False)
    default, _ = make_filter("cpu", 512, seed=0, world=world)
    monkeypatch.setenv("TDR_M_HILO", "0")
    flagged, _ = make_filter("cpu", 512, seed=0, world=world)
    assert default.m_hilo is True and flagged.m_hilo is False
    monkeypatch.setenv("TDR_M_HILO", "1")
    assert flagged._get_map(1).m_hilo is False
    assert not flagged._get_pyramid_maps((1, 2)).m_hilo
    assert default._get_map(2).m_hilo and default._get_pyramid_maps(
        (1, 2)).m_hilo
    monkeypatch.setenv("TDR_M_HILO", "0")
    assert default._get_map(1).m_hilo
    pinned = ft.ParticleFilter(512, flagged.map, flagged.params,
                               device="cpu", m_hilo=True)
    assert pinned.m_hilo and pinned._get_map(1).m_hilo
    packed = torch.zeros((8, 8, 8))
    assert cs.CropMap(packed).m_hilo
    assert ms.build_pyramid_maps(packed, (1, 2)).m_hilo
    lokf = cs.CropMap(packed, m_hilo=False)
    from top_down_renderer_torch.probes import crop_ablate as ca

    t = (torch.zeros((TH, R, 2)), torch.zeros((C, TH, R)), torch.ones(C),
         torch.zeros((4, 2)))
    with pytest.raises(ValueError, match="hi/lo M"):
        ca.crop_ablate("full", lokf, C, *t, torch.zeros(4), 0.5)
    with pytest.raises(ValueError, match="hi/lo M"):
        ca.crop_ablate_init("full", lokf, C, *t, 0.5)
    for base, raw, want in (("crop_score_tracked", False,
                             "crop_score_tracked_lokf"),
                            ("crop_score_multi_init", True,
                             "crop_score_multi_init_raw_lokf")):
        assert cs.entry_name(base, lokf, raw) == want
        assert cs.entry_name(base, cs.CropMap(packed, int4=True,
                                              m_hilo=False), raw) == (
            want[:-5] + "_i4_lokf")
        assert cs.entry_name(base, cs.CropMap(packed), raw) == want[:-5]


def test_hilo_default_leaves_every_result_bit_equal():
    """m_hilo=True (the default) scores as before: a CropMap and a
    pyramid made with it explicitly give the bits of ones made without
    it and of the plain versions called without the switch, float and
    code map."""
    packed, scan, rng = _world(7, 64, 64)
    centers = rng.uniform(-5, 70, (64, 2)).astype(np.float32)
    thetas = torch.as_tensor((rng.random(64) * 2 * np.pi).astype(np.float32))
    args = _t(STENCIL, scan, CW, centers)
    t = torch.as_tensor(packed)
    for int4 in (False, True):
        a, b = cs.CropMap(t, int4=int4), cs.CropMap(t, int4=int4,
                                                     m_hilo=True)
        assert a.plain_m() == {} == b.plain_m()
        plain = a.plain(C).packed
        for x, y, z in (
                (cs.score_tracked(a, C, *args, thetas, F),
                 cs.score_tracked(b, C, *args, thetas, F),
                 cs.score_tracked_plain(plain, C, *args, thetas, F)),
                (cs.score_init_raw(a, C, *args, F),
                 cs.score_init_raw(b, C, *args, F),
                 cs.score_init_raw_plain(plain, C, *args, F))):
            for u, v, w in zip(x, y, z):
                assert torch.equal(u, v) and torch.equal(u, w)
        pa, pb = (ms.build_pyramid_maps(t, (1, 2), int4, m_hilo=h)
                  for h in (True, True))
        tail = (torch.ones(64), torch.tensor([1.0]), (0,), 1.0)
        for u, v in zip(ms.score_tracked_multi(pa, C, *args, thetas, *tail),
                        ms.score_tracked_multi_plain(pb.plain(C), C, *args,
                                                     thetas, *tail)):
            assert torch.equal(u, v)
