"""Port parity of the nibble-packed map (TDR_MAP_INT4=1, the JAX
package's pallas_score.map_int4) on the CPU.

The port's quantizer (crop_score.quantize_channels_int4, compact_codes)
gives JAX's bytes; the uniform mip map quantizes its own subsample and
the pyramid the full-resolution map once, each as the JAX package does.
The code plains (the float plain versions on dequantize_int4 of the
codes) hold the JAX int4 crop kernels' bounds (tests/
test_pallas_interpret.py's _check; the JAX kernels in interpret mode,
under the flag), equal JAX's exact scorer on the dequantized map at
integer centres, and hold the JAX K-bucket int4 scorers' bounds; the
code kernels' arithmetic (the unpack, the tracked fold, window @ M and
its bf16 split) is emulated against the plains; whole crop and K-bucket
steps under the flag match the JAX steps; the conv path reads the float32
map with or without the flag; and without the flag a CropMap is today's
float map.  The code kernels themselves are held to these plain versions
on the card (tests/test_torch_cuda.py, marked cuda).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from top_down_renderer_tpu.filter import filter as fj
from top_down_renderer_tpu.filter import multiscale as ms_j
from top_down_renderer_tpu.filter import pallas_score as ps
from top_down_renderer_tpu.filter import resample as res_j
from top_down_renderer_torch.filter import conv_score
from top_down_renderer_torch.filter import crop_score as cs
from top_down_renderer_torch.filter import filter as ft
from top_down_renderer_torch.filter import multiscale as ms
from top_down_renderer_torch.filter.resample import pack_fields
from top_down_renderer_torch.filter.scoring import rotation_shift, shift_mask
from top_down_renderer_torch.testing import synthetic_setup
from top_down_renderer_torch.utils.convert import filter_state_from_numpy

import test_multiscale as tms
from test_pallas_interpret import _centers, _check
from test_torch_crop_score import (
    C, CW, F, N, R, SSH, STENCIL, TH, _exact_j, _init_costs, _ratio,
    _rows_of, _shifts_j, _split_product, _t, _tracked_cost, _window_rows,
    _world,
)
from test_torch_filter import _compare_states, _resample_shift, _setups
from torch_parity import assert_rel, np_, tracked_pairs

torch.set_num_threads(2)


def _nibbles(byte: np.ndarray) -> np.ndarray:
    """(..., B) bytes -> (..., 2B) codes: channel 2j the low nibble of
    byte j, 2j + 1 its high one."""
    return np.stack([byte & 15, byte >> 4], -1).reshape(byte.shape[:-1]
                                                         + (-1,))


def _jax_codes(packed):
    """JAX's quantize_channels_int4: (bytes (..., 4) uint8, qinv (8,))."""
    pq, qinv = ps.quantize_channels_int4(jnp.asarray(packed))
    return np.asarray(pq).view(np.uint8), np.asarray(qinv)


def _jax_dequantized(packed):
    """The field the JAX int4 kernels score: code * qinv, float32."""
    byte, qinv = _jax_codes(packed)
    return (_nibbles(byte).astype(np.float32) * qinv).astype(np.float32)


def _classes_world(c, seed, h=48, w=64):
    rng = np.random.default_rng(seed)
    packed = np.zeros((h, w, 8), np.float32)
    packed[..., :c] = rng.random((h, w, c)) * 50
    packed[..., c] = (rng.random((h, w)) < 0.9).astype(np.float32)
    return packed, rng


# -- the quantizer and the code map --------------------------------------
@pytest.mark.parametrize("c", [1, 3, 6])
def test_codes_are_jax_quantize_channels_int4_bytes(c):
    """compact_codes of the port's quantizer: JAX's bytes for the C + 1
    channels the score reads (their nibbles, and whole bytes where both
    nibbles are read), the channels above zeroed; qinv within rtol 1e-6;
    ties (v * qmax / amax = k + 0.5) rounded half to even as JAX does;
    the known channel dequantizes to exactly {0, 1}."""
    packed, _ = _classes_world(c, c)
    packed[1, 1, :c] = 60.0  # amax 60: qmax / amax = 1/4 and 7/60
    packed[0, :15, 0] = (np.arange(15) + 0.5) * 4.0  # ties on channel 0
    byte, qinv = _jax_codes(packed)
    maps = cs.CropMap(torch.as_tensor(packed), int4=True)
    codes = np_(maps.codes(c))
    cp = cs.channel_pad(c)
    assert codes.shape == (48, 64, cp // 2) and codes.dtype == np.uint8
    np.testing.assert_array_equal(_nibbles(codes)[..., : c + 1],
                                  _nibbles(byte)[..., : c + 1])
    assert not _nibbles(codes)[..., c + 1 :].any()
    np.testing.assert_array_equal(codes[..., : (c + 1) // 2],
                                  byte[..., : (c + 1) // 2])
    np.testing.assert_array_equal(
        _nibbles(codes)[0, :15, 0], np.round(np.arange(15) + 0.5))
    np.testing.assert_allclose(np_(maps.qinv), qinv, rtol=1e-6)
    plain = np_(maps.plain(c).packed)
    np.testing.assert_array_equal(plain[..., c], packed[..., c])
    np.testing.assert_array_equal(plain[..., : c + 1],
                                  _jax_dequantized(packed)[..., : c + 1])
    assert not plain[..., c + 1 :].any()
    assert maps.compact(c).dtype == torch.float32


def test_mip_map_and_pyramid_quantize_where_jax_does(monkeypatch):
    """Under the flag the uniform mip map quantizes its own subsample (its
    qinv is JAX's build_padded_maps(dist[::4, ::4]).qinv), the pyramid the
    full-resolution map once (build_pyramid_maps' qinv), each level of it
    subsampling those codes (pq[::m, ::m]); the two differ."""
    monkeypatch.setenv("TDR_MAP_INT4", "1")
    packed, _, _ = _world()
    mip_j = ps.build_padded_maps(jnp.asarray(packed[::4, ::4]))
    pyr_j = ms_j.build_pyramid_maps(jnp.asarray(packed), (1, 2, 4))
    assert mip_j.i4 and pyr_j.i4
    mip = cs.CropMap(cs.mip_map(torch.as_tensor(packed), 4), cs.map_int4())
    pyr = ms.build_pyramid_maps(torch.as_tensor(packed), (1, 2, 4),
                                cs.map_int4())
    assert mip.int4 and pyr.int4
    np.testing.assert_allclose(np_(mip.qinv), np.asarray(mip_j.qinv),
                               rtol=1e-6)
    np.testing.assert_allclose(np_(pyr.qinv), np.asarray(pyr_j.qinv),
                               rtol=1e-6)
    assert not np.allclose(np_(mip.qinv)[:C], np_(pyr.qinv)[:C], rtol=1e-6)
    byte, _ = _jax_codes(packed)
    for lv, m in enumerate((1, 2, 4)):
        off, h, w = pyr.levels[lv]
        want = byte[::m, ::m, :2]
        np.testing.assert_array_equal(
            np_(pyr.codes(C))[off : off + h * w].reshape(h, w, 2), want)
        level = pyr.level_crop_map(lv)
        assert level.int4
        np.testing.assert_array_equal(np_(level.codes(C)), want)
        assert torch.equal(level.qinv, pyr.qinv)


# -- the code plains against the JAX int4 kernels --------------------------
@pytest.fixture(scope="module")
def float_world_i4():
    """test_torch_crop_score's float_world under the flag: the JAX int4
    tracked, raw-row and argmin theta-search kernels in interpret mode."""
    packed, scan, rng = _world(5)
    centers = _centers(rng)
    centers[:128] += rng.uniform(-0.5, 0.5, (128, 2)).astype(np.float32)
    centers[135:] += rng.uniform(-0.5, 0.5, (N - 135, 2)).astype(np.float32)
    thetas = (rng.random(N) * 2 * np.pi).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TDR_MAP_INT4", "1")
        mp.setattr(ps, "tracked_p_tile", lambda mo, **kw: 16)
        mp.setattr(ps, "init_p_tile", lambda mo, **kw: 16)
        maps = ps.build_padded_maps(jnp.asarray(packed))
        assert maps.i4
        jargs = (maps, jnp.asarray(STENCIL), jnp.asarray(scan),
                 jnp.asarray(CW), jnp.asarray(centers))
        mo = ps.pick_crop_size(F, R)
        tracked = ps.score_tracked_fast_mo(
            *jargs, jnp.asarray(thetas), F, mo, interpret=True)
        raw = ps.score_init_fast_mo(*jargs, F, mo, interpret=True)
        sel = ps.score_init_sel_mo(*jargs, F, mo, interpret=True)
    ref = {k: tuple(np.asarray(a) for a in v)
           for k, v in (("tracked", tracked), ("raw", raw), ("sel", sel))}
    return packed, scan, centers, thetas, ref


@pytest.mark.parametrize("flavour", ["tracked", "raw", "sel"])
def test_code_plains_hold_the_jax_int4_kernel_bounds(float_world_i4,
                                                     flavour):
    """The port's scorers on a code CropMap (on the CPU: the plain
    versions on the dequantized map) against the JAX int4 kernels on float,
    edge and far-out centres, within _check's bounds; the argmin's theta
    equal on 90 % (near ties under the int8 M table)."""
    packed, scan, centers, thetas, ref = float_world_i4
    args = _t(packed, STENCIL, scan, CW, centers)
    maps = cs.CropMap(args[0], int4=True)
    if flavour == "tracked":
        num, den, kf = cs.score_tracked(maps, C, *args[1:],
                                        torch.as_tensor(thetas), F)
        rn, rd, rkf = ref["tracked"]
        _check(_ratio(rn, rd), _ratio(num, den), rkf, np_(kf), "i4 tracked")
    elif flavour == "raw":
        nums, dens, kf = cs.score_init_raw(maps, C, *args[1:], F)
        rn, rd, rkf = ref["raw"]
        for j in range(0, 40, 3):
            _check(_ratio(rn[:, j], rd[:, j]), _ratio(nums[:, j], dens[:, j]),
                   rkf, np_(kf), f"i4 init shift {j}")
    else:
        best, k, kf = cs.score_init_sel(maps, C, *args[1:], F)
        rbest, rtheta, rkf = ref["sel"]
        finite = rbest < cs.FLT_MAX
        np.testing.assert_array_equal(np_(best) < cs.FLT_MAX, finite)
        _check(rbest[finite], np_(best)[finite], rkf[finite],
               np_(kf)[finite], "i4 sel_init best")
        theta = np_(k).astype(np.float32) * np.float32(2 * math.pi / 40)
        assert np.mean(np.isclose(theta, rtheta)[finite]) > 0.9


@pytest.mark.parametrize("mode", ["tracked", "init"])
def test_code_plains_on_integer_centres_equal_exact_on_dequantized(mode):
    """On integer centres the code plains pick the exact path's pixels of
    the dequantized map: JAX's exact scorer on JAX's dequantized field
    (code * qinv) within rel 1e-4, kf equal (test_integer_centres_equal_
    exact on the code map)."""
    packed, scan, rng = _world()
    centers = _centers(rng)
    thetas = (rng.random(N) * 2 * np.pi).astype(np.float32)
    costs_e, kf_e = _exact_j(_jax_dequantized(packed), scan, centers, F)
    args = _t(packed, STENCIL, scan, CW, centers)
    maps = cs.CropMap(args[0], int4=True)
    if mode == "tracked":
        num, den, kf = cs.score_tracked(maps, C, *args[1:],
                                        torch.as_tensor(thetas), F)
        ref = costs_e[np.arange(N), _shifts_j(thetas)]
        got = _tracked_cost(num, den, kf)
    else:
        nums, dens, kf = cs.score_init_raw(maps, C, *args[1:], F)
        ref = costs_e[:, SSH]
        got = _init_costs(nums, dens, kf)
    np.testing.assert_array_equal(np_(kf), kf_e)
    ok = kf_e >= 0.5
    assert ok.sum() > 200 and (~ok).sum() >= 2
    assert_rel(ref[ok], got[ok], 1e-4, f"i4 {mode}")
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(got))


def test_code_pyramid_plains_hold_the_jax_int4_multi_bounds(monkeypatch):
    """The K-bucket scorers on a code pyramid (the plain versions on its
    dequantized levels) against the JAX K-bucket int4 scorers (interpret
    mode, test_multi_int4_bucket_parity's world and buckets) within
    _check's bounds: raw rows, the argmin's best cost, tracked."""
    monkeypatch.setenv("TDR_MAP_INT4", "1")
    monkeypatch.setattr(ps, "init_p_tile", lambda mo, **kw: 16)
    monkeypatch.setattr(ps, "tracked_p_tile", lambda mo, **kw: 16)
    packed, stencil, scan, cw, rng = tms._world(seed=9)
    slots = np.array([0.5, 1.0], np.float32)
    n = 96
    centers = rng.integers(48, 200, (n, 2)).astype(np.float32)
    scale = np.where(rng.random(n) < 0.5, 0.5, 1.0).astype(np.float32)
    thetas = (rng.random(n) * 2 * np.pi).astype(np.float32)
    pyr_j = ms_j.build_pyramid_maps(jnp.asarray(packed), (1, 2))
    jargs = (pyr_j, jnp.asarray(stencil), jnp.asarray(scan), cw,
             jnp.asarray(centers))
    tail_j = (jnp.asarray(scale), jnp.asarray(slots),
              jnp.asarray(1.0, jnp.float32))
    rn, rd, rkf = map(np.asarray, ms_j.make_score_init_multi(
        2, (0, 1), interpret=True, mo=tms.MO)(*jargs, *tail_j))
    rbest, _, rkf2 = map(np.asarray, ms_j.make_score_init_multi(
        2, (0, 1), interpret=True, mo=tms.MO, sel=True)(*jargs, *tail_j))
    tn, td, tkf = map(np.asarray, ms_j.make_score_tracked_multi(
        2, (0, 1), interpret=True, mo=tms.MO)(
            *jargs, jnp.asarray(thetas), *tail_j))

    pyr = ms.build_pyramid_maps(torch.as_tensor(packed), (1, 2),
                                cs.map_int4())
    assert pyr.int4
    args = (pyr, tms.C, *_t(stencil, scan, np.asarray(cw), centers))
    tail = (torch.as_tensor(scale), torch.as_tensor(slots), (0, 1), 1.0)
    nums, dens, kf = ms.score_init_multi_raw(*args, *tail)
    for j in range(0, 40, 3):
        _check(_ratio(rn[:, j], rd[:, j]), _ratio(nums[:, j], dens[:, j]),
               rkf, np_(kf), f"i4 multi init shift {j}")
    best, _, kf2 = ms.score_init_multi_sel(*args, *tail)
    finite = rbest < cs.FLT_MAX
    np.testing.assert_array_equal(np_(best) < cs.FLT_MAX, finite)
    _check(rbest[finite], np_(best)[finite], rkf2[finite], np_(kf2)[finite],
           "i4 multi sel best")
    num, den, kf3 = ms.score_tracked_multi(*args, torch.as_tensor(thetas),
                                           *tail)
    _check(_ratio(tn, td), _ratio(num, den), tkf, np_(kf3), "i4 multi tracked")


# -- the code kernels' arithmetic, on the CPU --------------------------------
def _code_values(codes: torch.Tensor, cp: int):
    """The codes as the kernels read them, in numpy: each pixel's CP/2
    bytes as one little-endian word, channel ch = (word >> 4 ch) & 15.
    Returns (..., CP) float32 codes."""
    b = np_(codes).astype(np.uint32)
    word = sum(b[..., j] << (8 * j) for j in range(cp // 2))
    nib = np.stack([(word >> (4 * ch)) & 15 for ch in range(cp)], -1)
    return torch.as_tensor(nib.astype(np.float32))


@pytest.mark.parametrize("c,f", [(1, 1.0), (3, 0.5), (6, 0.37)])
def test_code_tracked_fold_equals_code_plain(c, f):
    """The tracked code kernel's arithmetic on the CPU: each pixel's word
    unpacked into code * qinv in float32 (the kernel's byte permute and
    fma(2^23 + code, q, -2^23 q), one rounding) is the dequantized
    compact map bit for bit, and the fold's weights times that window
    (folded_scores) equal the code plain version (rel 1e-5, kf
    bit-equal); every shift, windows across the edges and far out."""
    packed, rng = _classes_world(c, int(f * 100) + c, 64, 80)
    scan = (rng.random((c, TH, R)) * 3).astype(np.float32)
    centers = rng.uniform(-20, 100, (160, 2)).astype(np.float32)
    centers[:3] = [[0.0, 0.0], [79.0, 63.0], [-500.0, 30.0]]
    thetas = np.arange(160) * np.float32(2 * math.pi / TH) - 2 * math.pi
    cw = (0.5 + rng.random(c)).astype(np.float32)
    m, sten, sc, cwt, ctr = _t(packed, STENCIL, scan, cw, centers)
    th = torch.as_tensor(thetas.astype(np.float32))
    maps = cs.CropMap(m, int4=True)
    cp, qinv = cs.channel_pad(c), np_(maps.qinv)[: cs.channel_pad(c)]
    x = _code_values(maps.codes(c), cp).double() + 2.0**23  # exact
    a = torch.as_tensor((x * qinv - 2.0**23 * qinv).numpy().astype(
        np.float32))  # the fma: the exact product, rounded once
    np.testing.assert_array_equal(
        np_(a)[..., : c + 1],
        np_(cs.compact_map(maps.plain(c).packed, c))[..., : c + 1])
    cost, norm, kf = cs.score_tracked(maps, c, sten, sc, cwt, ctr, th, f)
    pix, _, order, seg = cs.fold_offsets(cs.crop_offsets(sten, f)[None])
    w = cs.tracked_weights(sc, cwt, order, seg)
    got = cs.folded_scores(
        a.reshape(-1, cp), torch.tensor([[0, 64, 80, 0]]),
        cs.crop_centers(ctr, 1.0), pix, w,
        torch.zeros(160, dtype=torch.int32), rotation_shift(th, TH), c)
    np.testing.assert_array_equal(np_(got[2]), np_(kf))
    assert_rel(np_(cost), np_(got[0]), 1e-5, "cost")
    assert_rel(np_(norm), np_(got[1]), 1e-5, "norm")


@pytest.mark.parametrize("c", [1, 2, 3, 6])
def test_code_init_product_equals_code_plain(c):
    """The theta-search code kernel's arithmetic on the CPU: the window of
    the codes as they are times fold_qinv(M) is the code plain version's
    raw rows (rel 1e-5), the kf column's sum divided by known_code its kf
    bit for bit; with M's bf16 hi/lo split (the codes exact in bf16: A
    B_hi + A B_lo, no third product) it selects as the code plain version
    does (rel 1e-4, the argmin on 99.9 %)."""
    packed, rng = _classes_world(c, 20 + c, 64, 80)
    scan = (rng.random((c, TH, R)) * 3).astype(np.float32)
    centers = rng.uniform(-20, 100, (96, 2)).astype(np.float32)
    centers[:3] = [[0.0, 0.0], [79.0, 63.0], [-500.0, 30.0]]
    cw = (0.5 + rng.random(c)).astype(np.float32)
    m, sten, sc, cwt, ctr = _t(packed, STENCIL, scan, cw, centers)
    maps = cs.CropMap(m, int4=True)
    nums, dens, kf = cs.score_init_raw(maps, c, sten, sc, cwt, ctr, 1.0)
    pix, npix, order, seg = cs.fold_pixels(cs.crop_offsets(sten, 1.0)[None])
    mq = cs.fold_qinv(cs.init_m(sc, cwt, order, seg, 40), maps.qinv, c)
    a, mm = _window_rows(_code_values(maps.codes(c), cs.channel_pad(c)),
                         cs.crop_centers(ctr, 1.0), pix[0], npix[0], mq[0])
    acc = (a.double() @ mm.double()).float()
    acc[:, cs.KF_COL] /= cs.known_code(c)
    got = _rows_of(acc, 40, TH * R)
    assert_rel(np_(nums), np_(got[0]), 1e-5, "num")
    assert_rel(np_(dens), np_(got[1]), 1e-5, "den")
    np.testing.assert_array_equal(np_(got[2]), np_(kf))
    assert (np_(kf) == 0).any() and (np_(kf) > 0.5).any()
    bh, bl = (x.double() for x in cs.split_bf16(mm))
    assert torch.equal(a.to(torch.bfloat16).double(), a.double())
    split = (a.double() @ bh + a.double() @ bl).float()
    split[:, cs.KF_COL] /= cs.known_code(c)
    best, k, _ = cs.score_init_sel(maps, c, sten, sc, cwt, ctr, 1.0)
    sb, sk = cs.select_best(*_rows_of(split, 40, TH * R))
    fin = np_(best) < cs.FLT_MAX
    np.testing.assert_array_equal(np_(sb) < cs.FLT_MAX, fin)
    assert_rel(np_(best)[fin], np_(sb)[fin], 1e-4, "split best")
    assert np.mean(np_(sk) == np_(k)) >= 0.999


def test_code_records_give_each_thread_whole_pixels():
    """The code map's M records, decoded as the code kernel reads them:
    fragment column c of a chunk is row code_chunk_order()[c] of fold_qinv's
    M, thread t's four pairs are rows 8t .. 8t + 7 (whole pixels at CP 2,
    4 and 8), the pixel offsets stay in order; the float records are
    unchanged by the option."""
    order = np_(cs.code_chunk_order())
    np.testing.assert_array_equal(np.sort(order), np.arange(cs.K_CHUNK))
    for t in range(4):
        cols = [16 * ks + 8 * hf + 2 * t + e for ks in (0, 1)
                for hf in (0, 1) for e in (0, 1)]
        np.testing.assert_array_equal(np.sort(order[cols]),
                                      8 * t + np.arange(8))
    rng = np.random.default_rng(2)
    c = 6
    scan = torch.as_tensor((rng.random((c, TH, R)) * 3).astype(np.float32))
    off = cs.crop_offsets(torch.as_tensor(STENCIL), torch.tensor(
        [[[0.5]], [[1.0]]]))
    fold = cs.fold_pixels(off)
    qinv = torch.as_tensor(rng.random(8).astype(np.float32) + 0.5)
    rows = torch.tensor([0, 5, 9])
    rec4, sched4 = cs.init_records(scan, torch.ones(c), fold, rows, 40, qinv)
    rec, sched = cs.init_records(scan, torch.ones(c), fold, rows, 40)
    assert torch.equal(sched4, sched) and rec4.shape == rec.shape
    mq = cs.fold_qinv(cs.init_m(scan, torch.ones(c), fold[2], fold[3], 40),
                      qinv, c)
    plane = cs.K_CHUNK * cs.M_COLS
    k, n = np.meshgrid(np.arange(32), np.arange(cs.M_COLS), indexing="ij")
    at = ((k // 8) * 11 + n // 8) * 64 + (n % 8) * 8 + k % 8
    hi, lo = (x.view(torch.int16) for x in cs.split_bf16(mq))
    for b in range(2):
        for ch in (0, 5):
            r = rec4[b, ch]
            src = 32 * ch + order
            np.testing.assert_array_equal(np_(r[at]), np_(hi[b, src]))
            np.testing.assert_array_equal(np_(r[plane + at]),
                                          np_(lo[b, src]))
            np.testing.assert_array_equal(np_(r[2 * plane:]),
                                          np_(rec[b, ch, 2 * plane:]))
    assert not np.array_equal(np_(rec4), np_(rec))


# -- whole steps under the flag ----------------------------------------------
@pytest.mark.parametrize("mode", ["tracked", "init", "mixed"])
def test_crop_step_under_the_flag_matches_jax_exact_on_dequantized(
        mode, monkeypatch):
    """One crop update with TDR_MAP_INT4=1 (read as the filter reads it)
    on integer, noise-free centres against the JAX exact step on the
    field JAX's int4 quantizer gives, with the reference's resample draw:
    test_crop_step_on_integer_centres_matches_jax_exact's tolerances."""
    monkeypatch.setenv("TDR_MAP_INT4", "1")
    st_j, d, params = _setups(mode != "init", cluster=False, integer=True)
    n = st_j.particles.n_max
    if mode == "mixed":
        have = np.arange(n) % 3 == 0
        d["state"]["particles"]["have_init"][:] = have
        st_j = st_j.replace(particles=st_j.particles.replace(
            have_init=jnp.asarray(have)))
    res = 0.5
    step_j = fj.make_update_step(params, 3, 1.0, 100, n, gmm_every=1,
                                 chunk_size=n)
    out_j = step_j(st_j, jnp.asarray(_jax_dequantized(d["packed"])),
                   *(jnp.asarray(d[k]) for k in
                     ("map_size", "stencil", "scan")), jnp.float32(res))
    step_t = ft.make_update_step_fast(params, 3, 1.0, 100, n, mode,
                                      gmm_every=1)
    packed, *rest = (torch.as_tensor(d[k]) for k in
                     ("packed", "map_size", "stencil", "scan"))
    maps = cs.CropMap(packed, cs.map_int4())
    assert maps.int4
    out_t = step_t(filter_state_from_numpy(d["state"]), maps, *rest, res,
                   shift=_resample_shift(st_j))
    _compare_states(out_j, out_t)


@pytest.mark.parametrize("mode", ["init", "tracked", "mixed"])
def test_multi_step_under_the_flag_matches_jax(mode, monkeypatch):
    """One K-bucket step with TDR_MAP_INT4=1 on both sides: the port's
    code pyramid (plain scorers) against the JAX step on its int4 pyramid
    (interpret mode), test_multi_step_matches_jax's state, map and
    tolerances (the map's distances integers up to 126, so the codes
    are the same in both)."""
    from test_torch_multiscale import (BMI, MIPS, STEP_N, STEP_SLOTS,
                                       _theta_flips_are_near_ties)
    from top_down_renderer_torch.testing import synthetic_setup
    import __graft_entry__ as ge
    from top_down_renderer_tpu.config import FilterParams

    monkeypatch.setenv("TDR_MAP_INT4", "1")
    monkeypatch.setattr(ps, "init_p_tile", lambda mo, **kw: 16)
    monkeypatch.setattr(ps, "tracked_p_tile", lambda mo, **kw: 16)
    st_j, *_, params = ge._synthetic_setup(STEP_N, seed=3)
    d = synthetic_setup(STEP_N, seed=3)
    rng = np.random.default_rng(4)
    packed = d["packed"]
    packed[..., :C] = np.round(packed[..., :C] * (126.0 / 50.0))
    packed[0, 0, :C] = 126.0
    scale = STEP_SLOTS[rng.integers(0, 2, st_j.particles.n_max)]
    have = np.full(len(scale), mode != "init")
    if mode == "mixed":
        have = np.arange(len(scale)) % 3 == 0
    d["state"]["particles"]["scale"][:] = scale
    d["state"]["particles"]["have_init"][:] = have
    st_j = st_j.replace(particles=st_j.particles.replace(
        scale=jnp.asarray(scale), have_init=jnp.asarray(have)))
    params = FilterParams(**{**params.__dict__, "fixed_scale": -1.0})
    n = st_j.particles.n_max
    res = 0.5
    pyr_j = ms_j.build_pyramid_maps(jnp.asarray(packed), MIPS)
    assert pyr_j.i4
    step_j = fj.make_update_step_multiscale(
        params, C, 1.0, 100, n, mode, 2, BMI, mo=tms.MO, gmm_every=1,
        interpret=True)
    out_j = step_j(st_j, pyr_j, jnp.asarray(d["map_size"]),
                   jnp.asarray(d["stencil"]), jnp.asarray(d["scan"]),
                   jnp.float32(res), jnp.asarray(STEP_SLOTS))
    step_t = ft.make_update_step_multiscale(params, C, 1.0, 100, n, mode,
                                            BMI, gmm_every=1)
    t = {k: torch.as_tensor(d[k]) for k in ("map_size", "stencil", "scan")}
    st_t = filter_state_from_numpy(d["state"])
    pyr = ms.build_pyramid_maps(torch.as_tensor(packed), MIPS, cs.map_int4())
    assert pyr.int4
    out_t = step_t(st_t, pyr, t["map_size"], t["stencil"], t["scan"], res,
                   torch.as_tensor(STEP_SLOTS), shift=_resample_shift(st_j))
    _compare_states(out_j, out_t, rows_frac=0.0)
    p = st_t.particles
    flip = _theta_flips_are_near_ties(out_j, out_t, st_t, (
        pyr.plain(C), C, t["stencil"], t["scan"],
        ft._pad_class_weights(params, C), p.pose_px(), p.scale,
        torch.as_tensor(STEP_SLOTS), BMI, res))
    if mode == "tracked":
        assert not flip.any()
    rows_j = np.asarray(res_j.pack_fields(out_j.particles))
    rows_t = np_(pack_fields(out_t.particles))
    same = np.all(rows_j == rows_t, axis=1) | flip
    assert same.mean() >= 0.99, f"{same.mean():.3f} rows identical"


def _world_filter(map_int4, world):
    from drive_consumer_torch import make_filter

    pf, _ = make_filter("cpu", 512, seed=0, world=world, map_int4=map_int4)
    return pf


def test_conv_field_is_the_same_with_and_without_the_flag(monkeypatch):
    """The conv path reads the float32 map under the flag too, as the JAX
    conv field reads the unquantized map: a filter on the code map and one
    on the float map build the same conv map bit for bit (the crop maps
    differ), and one conv update of a clustered cloud from the same state
    and draws gives both the same state bit for bit."""
    from util_synthetic import make_world

    world = make_world(128, 128)
    pfs, states = [], []
    for flag in ("1", "0"):
        monkeypatch.setenv("TDR_MAP_INT4", flag)
        pf = _world_filter(None, world)
        assert pf._get_map(1).int4 == (flag == "1")
        pfs.append(pf)
    a, b = (pf._get_conv_map().padded for pf in pfs)
    assert a.dtype == torch.float32
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not torch.equal(pfs[0]._get_map(1).plain(3).packed,
                           pfs[1]._get_map(1).packed)
    scan = torch.as_tensor(np.random.default_rng(2).random(
        (3, 100, 25)).astype(np.float32))
    d = synthetic_setup(512, h=128, w=128, c=3, cluster=(56, 56, 12),
                        theta_spread=(0.7, 0.05))
    start = filter_state_from_numpy(d["state"]).replace(step=1)
    p = start.particles
    start = start.replace(smask=shift_mask(rotation_shift(p.theta, 100),
                                           p.alive, 100))
    for pf in pfs:
        pf.state, pf._all_have_init, pf._snap = start, True, None
        pf.generator.manual_seed(7)
        before = conv_score.CALLS["cost_field"]
        plan = pf._fast_mode(0.5)
        assert plan.path == "conv", plan
        pf.update(scan, 0.5)
        assert conv_score.CALLS["cost_field"] == before + 1
        states.append(pf.state)
    for x, y in zip(*(pack_fields(s.particles) for s in states)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert torch.equal(states[0].particles.weight, states[1].particles.weight)


def test_without_the_flag_a_crop_map_is_the_float_map(monkeypatch):
    """With TDR_MAP_INT4 unset a CropMap, a pyramid and a filter's maps
    are float32: no codes, and their scores today's bits (the explicit
    int4=False ones, equal to the plain version on the packed map).  Only
    the filter reads the flag, once, when it is made: under the flag a
    CropMap or pyramid made without int4 stays float32, a filter made
    before it and one made with map_int4=False keep the float map at every
    mip, and one made under it with None holds the code map."""
    monkeypatch.delenv("TDR_MAP_INT4", raising=False)
    packed, scan, rng = _world(7, 64, 64)
    centers = rng.uniform(-5, 70, (64, 2)).astype(np.float32)
    thetas = (rng.random(64) * 2 * np.pi).astype(np.float32)
    args = _t(packed, STENCIL, scan, CW, centers)
    th = torch.as_tensor(thetas)
    default = cs.CropMap(args[0])
    assert not default.int4 and default.plain(C) is default
    with pytest.raises(ValueError, match="no codes"):
        default.codes(C)
    pyr = ms.build_pyramid_maps(args[0], (1, 2))
    assert not pyr.int4 and pyr.plain(C) is pyr
    want = cs.score_tracked_plain(args[0], C, *args[1:], th, F)
    for maps in (default, cs.CropMap(args[0], int4=False)):
        got = cs.score_tracked(maps, C, *args[1:], th, F)
        for x, y in zip(got, want):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
        best = cs.score_init_sel(maps, C, *args[1:], F)
        for x, y in zip(best, cs.score_init_sel_plain(args[0], C, *args[1:],
                                                      F)):
            assert torch.equal(x, y)
    from util_synthetic import make_world

    world = make_world(128, 128)
    pf = _world_filter(None, world)
    assert pf.map_int4 is False and not pf._get_map(1).int4
    monkeypatch.setenv("TDR_MAP_INT4", "1")
    assert not cs.CropMap(args[0]).int4
    assert not ms.build_pyramid_maps(args[0], (1, 2)).int4
    assert not pf._get_map(2).int4 and not pf._get_pyramid_maps((1, 2)).int4
    assert not _world_filter(False, world)._get_map(1).int4
    flagged = _world_filter(None, world)
    assert flagged.map_int4 is True and flagged._get_map(1).int4
    assert flagged._get_pyramid_maps((1, 2)).int4


def test_operand_checks_refuse_the_other_map():
    """check_map_operand: a code entry ("..._i4") takes the code map with
    qinv, a float entry the compact map without; either given the other's
    map, or a wrong qinv, raises before any launch.  The ablations refuse
    a code map."""
    from top_down_renderer_torch.probes import crop_ablate as ca

    packed, scan, rng = _world(4, 32, 32)
    maps = cs.CropMap(torch.as_tensor(packed), int4=True)
    codes, compact, qinv = maps.codes(C), maps.compact(C), maps.qinv
    cs.check_map_operand(True, codes, qinv, C)
    cs.check_map_operand(False, compact, None, C)
    for int4, op, q in ((True, compact, qinv),
                        (True, codes, None),
                        (True, codes, qinv[:4]),
                        (True, codes, qinv.double()),
                        (False, codes, None),
                        (False, compact, qinv),
                        (False, compact[..., :2], None)):
        with pytest.raises((TypeError, ValueError)):
            cs.check_map_operand(int4, op, q, C)
    with pytest.raises(ValueError):
        cs.check_map_operand(True, codes.transpose(0, 1), qinv, C)
    assert cs.map_operand(maps, C)[0] is codes
    float_map = cs.CropMap(torch.as_tensor(packed))
    op, q = cs.map_operand(float_map, C)
    assert op is float_map.compact(C) and q is None
    for base, raw, want in (("crop_score_tracked", False,
                             "crop_score_tracked_i4"),
                            ("crop_score_multi_init", True,
                             "crop_score_multi_init_raw_i4")):
        assert cs.entry_name(base, maps, raw) == want
        assert cs.entry_name(base, float_map, raw) == want[:-3]
    t = _t(STENCIL, scan, CW, rng.uniform(0, 32, (8, 2)).astype(np.float32))
    with pytest.raises(ValueError, match="float32 map"):
        ca.crop_ablate("full", maps, C, *t, torch.zeros(8), 0.5)
    with pytest.raises(ValueError, match="float32 map"):
        ca.crop_ablate_init("full", maps, C, *t, 0.5)
    maps._codes[C] = compact  # a map whose operand is not its format's
    with pytest.raises(TypeError):
        cs.map_operand(maps, C)


# -- the hi/lo tracked kernels' row order and the code windows, on the CPU ---
def _window_case(kind, c, seed=21, h=45, w=67, int4=True):
    """Inputs of the code tracked kernel (int4 False: of the float one, the
    same inputs on the float map) on an odd-sized map (so that rows start
    at every byte of a 16-byte word), particles clustered in a corner
    (their own shifts, so that whole blocks hold them), spread, at the
    edges and far out: (maps, ctr (N, 2), key (N,), fold, levels (K, 4),
    groups, extent)."""
    packed, rng = _classes_world(c, seed, h, w)
    n = 300
    centers = np.concatenate([
        rng.uniform(0, 12, (150, 2)),
        rng.uniform(-10, max(h, w) + 10, (146, 2)),
        [[0.0, 0.0], [h - 1.0, w - 1.0], [-400.0, 20.0], [30.0, 900.0]],
    ]).astype(np.float32)[:, ::-1].copy()  # (x, y) -> the pose's (x, y)
    # the clustered rows on shifts 0-1, the others on 2-5: blocks of each
    shifts = np.concatenate([rng.integers(0, 2, 150),
                             rng.integers(2, 6, n - 150)])
    thetas = (shifts * (2 * np.pi / TH)).astype(np.float32)
    scan = (rng.random((c, TH, R)) * 3).astype(np.float32)
    cw = (0.5 + rng.random(c)).astype(np.float32)
    sten, sc, cwt, ctr_px, th = _t(STENCIL, scan, cw, centers, thetas)
    if kind == "uniform":
        maps = cs.CropMap(torch.as_tensor(packed), int4=int4)
        _, fold, ctr, key = cs._tracked_inputs(maps, c, sten, sc, cwt, ctr_px,
                                               th, 0.5, 1.0)
        levels = torch.tensor([[0, h, w, 0]], dtype=torch.int32)
        return maps, ctr, key, fold, levels, TH, max(h, w)
    maps = ms.build_pyramid_maps(torch.as_tensor(packed), (1, 2, 4), int4)
    slots = torch.tensor([0.5, 1.0, 2.0])
    scale = torch.as_tensor(np.resize(np.float32([0.5, 1.0, 2.0]), n))
    _, table, fold, ctr, key = ms._tracked_inputs(
        maps, c, sten, sc, cwt, ctr_px, th, scale, slots, (0, 1, 2), 1.0, 1.0)
    extent = max(max(lv[1:]) for lv in maps.levels)
    return maps, ctr, key, fold, table, 3 * TH, extent


@pytest.mark.parametrize("int4", [True, False])
@pytest.mark.parametrize("kind", ["uniform", "buckets"])
def test_code_tracked_order_is_group_major_by_position(kind, int4):
    """tracked_order (the rows of the hi/lo tracked kernels, on the code
    map and on the float map) equals its plain twin tracked_order_plain
    bit for bit; each group's rows are contiguous and the groups come in
    tracked_rows' order; within a group the centres' Morton codes rise;
    the group is the key's bits from kshift up."""
    maps, ctr, key, fold, levels, groups, extent = _window_case(
        kind, 3, int4=int4)
    skey, perm, kshift = cs.tracked_order(key, ctr, groups, extent)
    pkey, pperm, pshift = cs.tracked_order_plain(np_(key), np_(ctr), groups,
                                                 extent)
    assert skey.dtype == torch.int32 and perm.dtype == torch.int64
    np.testing.assert_array_equal(np_(skey), pkey)
    np.testing.assert_array_equal(np_(perm), pperm)
    assert kshift == pshift and (np_(skey) >= 0).all()
    rkey, rperm = (np_(x) for x in cs.tracked_rows(key))
    group = np_(skey) >> kshift
    np.testing.assert_array_equal(group, rkey)  # today's groups, in order
    np.testing.assert_array_equal(np.sort(np_(perm)), np.arange(len(key)))
    np.testing.assert_array_equal(np_(key)[np_(perm)], group)
    low = np_(skey) & ((1 << kshift) - 1)
    same = np.diff(group) == 0
    assert (np.diff(low)[same] >= 0).all()
    for g in np.unique(group):  # each group's rows are that group's rows
        np.testing.assert_array_equal(np.sort(np_(perm)[group == g]),
                                      np.flatnonzero(np_(key) == g))


@pytest.mark.parametrize("kind", ["uniform", "buckets"])
def test_tracked_pairs_walks_the_kernels_row_loop(kind):
    """torch_parity.tracked_pairs (the hi/lo tracked kernels' loop rule,
    whose shares of rows the card tests read) against the loop walked row
    by row as crop_tracked.cuh walks it: each block's runs of one group,
    warp w taking rows run0 + w + 32 i and 16 rows later together where
    both rows' stencils lie inside their level; the rest one at a time."""
    maps, ctr, key, fold, levels, groups, extent = _window_case(
        kind, 3, int4=False)
    if kind == "uniform":  # the corner's cloud moved inside: rows that pair
        ctr = ctr.clone()
        ctr[:150] = torch.as_tensor(np.random.default_rng(3).integers(
            [20, 31], [25, 36], (150, 2)), dtype=torch.int32)
    skey, perm, kshift = cs.tracked_order(key, ctr, groups, extent)
    inside, paired, run = tracked_pairs(skey, perm, ctr, kshift, TH,
                                        levels, fold)
    pix, npix = fold[0].long(), fold[1].long()
    group = np_(skey).astype(np.int64) >> kshift
    c = np_(ctr).astype(np.int64)[np_(perm)]
    n = len(group)
    want_in = np.zeros(n, bool)
    for j in range(n):
        b = group[j] // TH
        off = np_(pix[b, : npix[b]])
        lv = np_(levels[b]).astype(np.int64)
        want_in[j] = ((c[j, 0] + off[:, 0] >= 0).all()
                      and (c[j, 0] + off[:, 0] < lv[1]).all()
                      and (c[j, 1] + off[:, 1] >= 0).all()
                      and (c[j, 1] + off[:, 1] < lv[2]).all())
    want_pair = np.zeros(n, bool)
    runs = []
    for b0 in range(0, n, cs.TRACKED_TILE):
        r0 = b0
        end = min(b0 + cs.TRACKED_TILE, n)
        while r0 < end:
            r1 = r0 + 1
            while r1 < end and group[r1] == group[r0]:
                r1 += 1
            runs.append((r0, r1))
            for w in range(16):
                for r in range(r0 + w, r1, 32):
                    r2 = r + 16
                    if r2 < r1 and want_in[r] and want_in[r2]:
                        want_pair[r] = want_pair[r2] = True
            r0 = r1
    np.testing.assert_array_equal(np_(inside), want_in)
    np.testing.assert_array_equal(np_(paired), want_pair)
    np.testing.assert_array_equal(
        np_(run), np.repeat(np.arange(len(runs)), [b - a for a, b in runs]))
    assert want_in.any() and (~want_in).any()
    if kind == "uniform":
        assert want_pair.any()


def _windows(kind, c, cap=None):
    """The plain window rule on _window_case's inputs, at cap bytes (None:
    as many as any window needs)."""
    maps, ctr, key, fold, levels, groups, extent = _window_case(kind, c)
    skey, perm, kshift = cs.tracked_order(key, ctr, groups, extent)
    codes = maps.codes(c)
    flat = codes.reshape(-1, codes.shape[-1])
    win = cs.tracked_windows(skey, perm, ctr, kshift, TH, levels, fold,
                             flat.shape[0], flat.shape[1],
                             1 << 30 if cap is None else cap)
    return win, flat, skey, perm, kshift, ctr, fold, levels


def _block_rows(win, i, skey, kshift):
    """The sorted rows of window i: its block's rows of its bucket."""
    b0 = int(win["block"][i]) * cs.TRACKED_TILE
    rows = torch.arange(b0, min(b0 + cs.TRACKED_TILE, skey.shape[0]))
    return rows[(skey[rows].long() >> kshift) // TH == win["bucket"][i]]


@pytest.mark.parametrize("kind", ["uniform", "buckets"])
def test_code_window_box_covers_every_pixel_its_rows_read(kind):
    """For every block and bucket, the plain rule's box holds every
    in-level pixel its rows read (centre + each of the bucket's distinct
    pixels), and its windows hold the block's rows once each;
    launch_windows (the rule on a launch's arguments) takes the same boxes
    and stages those within the block's bytes."""
    win, _, skey, perm, kshift, ctr, fold, levels = _windows(kind, 3)
    maps, _, key, *_ = _window_case(kind, 3)
    pix, npix = fold[0].long(), fold[1].long()
    assert int(win["rows"].sum()) == skey.shape[0]
    got = cs.launch_windows(maps, None if kind == "uniform" else levels,
                            45, 67, 3, torch.zeros(3, TH, R), fold, ctr, key)
    cap = cs.tracked_window_cap(3, TH * R, int(npix.max()), cs.WINDOW_BUDGET)
    for k in ("block", "bucket", "rows", "y0", "y1", "x0", "x1", "bytes"):
        assert torch.equal(got[k], win[k]), k
    assert torch.equal(got["staged"], win["staged"] & (win["bytes"] <= cap))
    for i in range(win["block"].shape[0]):
        rows = _block_rows(win, i, skey, kshift)
        assert len(rows) == int(win["rows"][i])
        b = int(win["bucket"][i])
        off = pix[b, : npix[b]]
        c = ctr.long()[perm[rows]]
        y = (c[:, None, 0] + off[:, 0]).reshape(-1)
        x = (c[:, None, 1] + off[:, 1]).reshape(-1)
        h, w = int(levels[b, 1]), int(levels[b, 2])
        read = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        if not bool(read.any()):
            continue
        assert int(win["y0"][i]) <= int(y[read].min())
        assert int(win["y1"][i]) >= int(y[read].max())
        assert int(win["x0"][i]) <= int(x[read].min())
        assert int(win["x1"][i]) >= int(x[read].max())


def _staged_bytes(win, i, flat, levels, elem):
    """Window i staged as the kernel stages it: box row r's segment, from
    the 16-byte word at or below its first byte to the one at or above its
    last, at byte (c0 + r pitch) rounded down to 16 of the window, c0 the
    first byte's place in its word; no two rows' segments meet, and no
    byte comes from past the buffer.  Returns (the window's bytes, c0)."""
    buf = np_(flat).reshape(-1)
    y0, y1, x0, x1, pitch = (int(win[k][i])
                             for k in ("y0", "y1", "x0", "x1", "pitch"))
    lv = levels[int(win["bucket"][i])].long()
    c0 = (int(lv[0]) + y0 * int(lv[2]) + x0) * elem % 16
    out = np.zeros((y1 - y0 + 1) * pitch + 16, np.uint8)
    end = 0
    for r, y in enumerate(range(y0, y1 + 1)):
        s = (int(lv[0]) + y * int(lv[2]) + x0) * elem
        a0, a1 = s // 16 * 16, -(-(s + (x1 - x0 + 1) * elem) // 16) * 16
        at = (c0 + r * pitch) // 16 * 16
        assert at % 16 == 0 and at >= end and a1 <= buf.size
        assert (c0 + r * pitch) % 16 == s % 16  # the row's skew kept
        out[at : at + a1 - a0] = buf[a0:a1]
        end = at + a1 - a0
    assert end <= out.size
    return out, c0


@pytest.mark.parametrize("kind,c", [("uniform", 3), ("uniform", 1),
                                    ("buckets", 3), ("buckets", 6)])
def test_code_window_gather_equals_pixel_windows(kind, c):
    """Each row's codes read from its staged window at the kernel's
    offset, c0 + (y - y0) pitch + (x - x0) bytes a pixel, equal
    pixel_windows' gather of the code map bit for bit, on every byte
    alignment of a row, at the edges and far out; a window that fits no
    cap is not staged, and one whose last word would pass the buffer's
    end is not either."""
    win, flat, skey, perm, kshift, ctr, fold, levels = _windows(kind, c)
    elem = flat.shape[1]
    pix, npix = fold[0], fold[1].long()
    staged = win["staged"]
    assert bool(staged.any())
    skews = set()
    for i in np.flatnonzero(np_(staged)):
        rows = _block_rows(win, i, skey, kshift)
        b = int(win["bucket"][i])
        data, c0 = _staged_bytes(win, i, flat, levels, elem)
        p = perm[rows]
        want = cs.pixel_windows(flat, levels, torch.full((len(p),), b),
                                ctr[p], pix)[:, : npix[b]]
        off = pix.long()[b, : npix[b]]
        y = ctr.long()[p][:, None, 0] + off[:, 0]
        x = ctr.long()[p][:, None, 1] + off[:, 1]
        inside = ((y >= 0) & (y < levels[b, 1]) & (x >= 0)
                  & (x < levels[b, 2]))
        at = (c0 + (y - win["y0"][i]) * win["pitch"][i]
              + (x - win["x0"][i]) * elem)
        skews |= set(np_((c0 + (y[inside] - win["y0"][i])
                          * win["pitch"][i]) % 16).tolist())
        idx = np_(torch.where(inside, at, 0))[..., None] + np.arange(elem)
        got = np.where(np_(inside)[..., None], data[idx], 0)
        np.testing.assert_array_equal(got, np_(want).astype(np.uint8))
    assert len(skews) > 2  # rows at several byte offsets of their word
    none = cs.tracked_windows(skey, perm, ctr, kshift, TH, levels, fold,
                              flat.shape[0], elem, 0)
    assert not bool(none["staged"].any())
    # the same windows over a buffer cut just past each level's last pixel
    # read: a window whose last word would pass the end stays on L2
    end = int(((win["y1"] * levels[win["bucket"], 2] + win["x1"] + 1
                + levels[win["bucket"], 0]).long() * elem).max())
    cut = cs.tracked_windows(skey, perm, ctr, kshift, TH, levels, fold,
                             end // elem, elem, 1 << 30)
    past = (win["y1"] * levels[win["bucket"], 2] + win["x1"] + 1
            + levels[win["bucket"], 0]).long() * elem
    np.testing.assert_array_equal(
        np_(cut["staged"]),
        np_(win["staged"] & ((past + 15) // 16 * 16 <= end // elem * elem)))


@pytest.mark.parametrize("int4", [True, False])
def test_code_tracked_scores_are_the_same_in_both_row_orders(int4):
    """The hi/lo tracked kernels' arithmetic (folded_scores on the
    dequantized codes, or on the float map) over tracked_order's rows and
    over tracked_rows', each row's result put back on its particle: the
    same bits."""
    maps, ctr, key, fold, levels, groups, extent = _window_case(
        "uniform", 3, int4=int4)
    pix, npix, order, seg = fold
    rng = np.random.default_rng(5)
    scan = torch.as_tensor((rng.random((3, TH, R)) * 3).astype(np.float32))
    cw = torch.as_tensor(CW)
    w = cs.tracked_weights(scan, cw, order, seg)
    compact = cs.compact_map(maps.plain(3).packed, 3).reshape(-1, 4)
    outs = []
    for skey, perm in (cs.tracked_order(key, ctr, groups, extent)[:2],
                       cs.tracked_rows(key)):
        got = cs.folded_scores(compact, levels, ctr[perm], pix, w,
                               torch.zeros(len(perm), dtype=torch.int32),
                               key[perm], 3)
        back = torch.empty(3, len(perm))
        back[:, perm] = torch.stack(got)
        outs.append(back)
    np.testing.assert_array_equal(np_(outs[0]).view(np.int32),
                                  np_(outs[1]).view(np.int32))


def test_tracked_smem_states_the_tight_stride_and_the_window():
    """tracked_smem at stride P and at the tight stride, the launch's
    shared memory and the window's bytes (tracked_window_cap) at the
    slice's shapes: C = 3 and 6, Th*R = 2,500, the largest npix 1,577
    (f = 1) and 489 (K = 12 buckets); a launch that stages windows keeps
    two blocks an SM where its layout at stride P allows, and budget 0
    is the layout at stride P with no window."""
    assert cs.tracked_smem(3, 2500) == 110_336
    assert cs.tracked_smem(3, 2500, npix=1577) == 84_352
    assert cs.tracked_smem(3, 2500, npix=489) == 53_888
    assert cs.tracked_smem(3, 2500) - cs.tracked_smem(3, 2500,
                                                      npix=1577) == 25_984
    budget = cs.WINDOW_BUDGET
    assert cs.tracked_launch_smem(3, 2500, budget) == cs.TRACKED_SMEM_TWO
    assert cs.tracked_launch_smem(3, 2500, 0) == 110_336
    assert cs.tracked_launch_smem(6, 2500, budget) == cs.TRACKED_SMEM_ONE
    # two blocks an SM: 228 KB an SM, 1 KB reserved a block, ~1 KB static
    assert 2 * (cs.TRACKED_SMEM_TWO + 2048) <= 228 * 1024
    assert cs.TRACKED_SMEM_ONE + 2048 <= cs.SMEM_LIMIT
    assert cs.tracked_window_cap(3, 2500, 1577, budget) == 29_312
    assert cs.tracked_window_cap(3, 2500, 489, budget) == 59_776
    assert cs.tracked_window_cap(6, 2500, 1577, budget) == 97_040
    assert cs.tracked_window_cap(3, 2500, 1577, 4096) == 4096
    assert cs.tracked_window_cap(3, 2500, 1577, 0) == 0
