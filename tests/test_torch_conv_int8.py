"""Port parity of the conv path's int8 cost field (TDR_CONV_INT8=1: the JAX
package's cost_field_s2d_split_i8, the port's conv_score.cost_field_i8).

The same numpy inputs from a seed go to the JAX functions, compiled
(jax.jit: XLA turns the divisions by 127 and 254 into products by constant
reciprocals and contracts two products into FMAs, which eager JAX does
not), and to the port on the CPU, where cost_field_i8 runs its plain
version:

- (a) the map's codes and qinv equal JAX's quantize_channels and its
  padded int8 map bit for bit, whatever TDR_MAP_INT4 says;
- (b) the hi/lo integers equal the ones JAX's cost_field_s2d_split_i8
  folds (captured from inside its compiled call), and each field value
  JAX's out4 / out_kf at the centre's s2d cell: rel <= 1e-6, the count of
  values that differ at all reported (0 when written);
- (c) the tracked scorer's (num, den, kf) against JAX's make_conv_scorer
  under TDR_CONV_INT8=1, rel <= 1e-6, the kf < 0.5 gate identical;
- (d) the port's int8 scorer against its float one, within JAX's own
  bounds (tests/test_conv_score.py::test_conv_int8_matches_bf16);
- (e) ParticleFilter(conv_int8=True) against the JAX filter under
  TDR_CONV_INT8=1, over clustered updates, and the fused conv step three
  times from JAX's states (_compare_states);
- (f) the plan keeps the float field for init, mixed (the full window)
  and past the s2d gate, and the mesh keeps it;
- (g) map_int4=True leaves the int8 field unchanged.

The card kernels' layout (i8_layout, the plain version of what the
quantizer kernel writes) is held to a numpy build, and the field kernel's
indexing (its TMA window box, its chunk list and cluster splits, wgmma's
m64 A and accumulator fragments of the PTX ISA, its epilogue) is emulated
in numpy against the plain version; the kernels themselves are held to
their plain versions on the card (tests/test_torch_cuda.py -k "int8 or
conv_field_i8 or conv_quant_i8", chip_smoke B5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from top_down_renderer_tpu.filter import conv_score as cs_j
from top_down_renderer_tpu.filter import filter as fj
from top_down_renderer_tpu.filter import pallas_score as ps
from top_down_renderer_torch import kernels
from top_down_renderer_torch.filter import conv_score as cs
from top_down_renderer_torch.filter import crop_score
from top_down_renderer_torch.filter import filter as ft
from top_down_renderer_torch.parallel import sharding
from top_down_renderer_torch.utils.convert import filter_state_from_numpy

from test_torch_conv_score import TH, C, _filters, _inputs, _set_smask
from test_torch_filter import _compare_states, _setups
from torch_mesh_ranks import conv as mesh_conv_case
from torch_parity import assert_rel, np_, to_numpy_tree
from util_synthetic import make_world

torch.set_num_threads(2)

F_HALF = 0.5  # scale * res: conv bucket mo 12, a 26 x 26 kernel


def _t(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _conv_map(packed, c=C, **kw):
    return cs.ConvMap(crop_score.compact_map(torch.as_tensor(packed), c),
                      **kw)


def _unfold_s2d(map4, hp, wp):
    """JAX's fold_map_s2d undone: (Y4, X4, 16 K) -> (hp, wp, K)."""
    y4, x4, kk = map4.shape
    k = kk // 16
    return (np.asarray(map4).reshape(y4, x4, 4, 4, k).transpose(0, 2, 1, 3, 4)
            .reshape(4 * y4, 4 * x4, k)[:hp, :wp])


# -- (a) the map -----------------------------------------------------------
@pytest.mark.parametrize("int4", [False, True])
def test_codes_and_qinv_equal_jax(int4, monkeypatch):
    """quantize_channels equals JAX's on the packed map, and the ConvMap's
    codes JAX's padded int8 map (its s2d fold undone) on the C + 1 channels
    the score reads, zero above; under TDR_MAP_INT4=1 JAX quantizes the
    int8 map afresh, to the same codes."""
    monkeypatch.setenv("TDR_MAP_INT4", "1" if int4 else "0")
    d = _inputs(seed=5)
    codes_j, qinv_j = ps.quantize_channels(jnp.asarray(d["packed"]))
    codes, qinv = cs.quantize_channels(torch.as_tensor(d["packed"]))
    np.testing.assert_array_equal(np_(codes), np.asarray(codes_j))
    np.testing.assert_array_equal(np_(qinv).view(np.int32),
                                  np.asarray(qinv_j).view(np.int32))
    maps = ps.build_padded_maps(jnp.asarray(d["packed"]))
    assert maps.i4 == int4
    cmap = _conv_map(d["packed"], int8=True)
    assert cmap.codes.shape == (cmap.hp, cmap.wp, 4)
    assert cmap.codes.dtype == torch.int8
    p8 = _unfold_s2d(maps.padded4d_i8, cmap.hp, cmap.wp)
    np.testing.assert_array_equal(np_(cmap.codes)[..., : C + 1],
                                  p8[..., : C + 1])
    assert not np_(cmap.codes)[..., C + 1 :].any()
    np.testing.assert_array_equal(np_(cmap.qinv)[: C + 1],
                                  np.asarray(maps.qinv4d)[: C + 1])
    assert _conv_map(d["packed"]).codes is None


# -- (b) the integers and the field ---------------------------------------
def _jax_kernel(d, mo, ww, s0, f):
    return jax.jit(lambda sc, cw, st: cs_j.build_conv_kernel(
        sc, cw, st, f, mo, "tracked", 40, ww, s0))(
            d["scan"], d["cw"], d["stencil"])


def _jax_field_i8(maps, kern, origin, mo, region, monkeypatch):
    """JAX's int8 field at every centre of the block, (S_out, region,
    region), and the integers its compiled call folds: (k_i8 (dr, dc, 8,
    2 sm) [hi | lo], kf2 (dr, dc, 8, 2))."""
    captured = []
    fold = cs_j.fold_kernel_s2d

    def capture(k):
        jax.debug.callback(lambda x: captured.append(np.asarray(x)), k)
        return fold(k)

    monkeypatch.setattr(cs_j, "fold_kernel_s2d", capture)
    # traced afresh, so that the capture runs whatever an earlier case of
    # the same shapes compiled
    cs_j.cost_field_s2d_split_i8.clear_cache()
    s_out = kern.shape[-1]
    out4, out_kf, roy, rox = jax.block_until_ready(
        cs_j.cost_field_s2d_split_i8(maps.padded4d_i8, kern, maps.qinv4d,
                                     jnp.asarray(origin, jnp.int32), mo,
                                     region, s_out))
    monkeypatch.setattr(cs_j, "fold_kernel_s2d", fold)
    iy, ix = np.meshgrid(np.arange(region), np.arange(region), indexing="ij")
    jy, jx = iy + int(roy), ix + int(rox)
    nxb = region // 4 + 1
    cell = ((jy // 4) * nxb + jx // 4) * 16 + (jy % 4) * 4 + jx % 4
    rows = np.asarray(out4).reshape(-1, s_out - 1)[cell]
    kf = np.asarray(out_kf).reshape(-1)[cell]
    field = np.concatenate([rows, kf[..., None]], -1).transpose(2, 0, 1)
    kf2, k_i8 = sorted(captured, key=lambda a: a.shape[-1])
    return field, k_i8, kf2


def _classes(d, c, seed):
    """d with its map, scan and class weights redrawn for c classes (the
    known channel at c)."""
    rng = np.random.default_rng(seed)
    h, w = d["packed"].shape[:2]
    packed = np.zeros((h, w, 8), np.float32)
    packed[..., :c] = rng.random((h, w, c)) * 50
    packed[..., c] = (rng.random((h, w)) < 0.9).astype(np.float32)
    return dict(d, packed=packed,
                scan=(rng.random((c, TH, d["scan"].shape[2])) * 3).astype(
                    np.float32),
                cw=(0.5 + rng.random(c)).astype(np.float32))


@pytest.mark.parametrize("mo,ww,s0,edge,c", [
    # a window across shift 0
    pytest.param(12, 16, 95, None, C, id="12-16-95-None"),
    # S_out 65; the block at the map's corner
    pytest.param(12, 32, 7, "low", C, id="12-32-7-low"),
    pytest.param(24, 16, 3, "high", C, id="24-16-3-high"),  # the far corner
    # CP 8 (six classes), the quantizer's other channel layout
    pytest.param(12, 16, 95, None, 6, id="12-16-95-None-cp8"),
    # S_out 129: two column groups of the card's layout
    pytest.param(12, 64, 40, None, C, id="12-64-40-None"),
])
def test_field_and_integers_equal_jax(mo, ww, s0, edge, c, monkeypatch):
    d = _inputs(seed=6, band=0.3)
    if c != C:
        d = _classes(d, c, seed=16)
    cp = 4 if c < 4 else 8
    f = {12: F_HALF, 24: 1.0}[mo]
    region = 64
    kern_j = _jax_kernel(d, mo, ww, s0, f)
    t = _t(d)
    kern = cs.build_conv_kernel(t["scan"], t["cw"], t["stencil"], f, mo,
                                "tracked", window_w=ww, s0=s0)
    assert kern.shape[:2] == (2 * ww + 1, cp)
    np.testing.assert_array_equal(
        np_(kern),
        np.asarray(kern_j.astype(jnp.float32))[:, :, :cp].transpose(
            3, 2, 0, 1))
    cmap = _conv_map(d["packed"], c, int8=True)
    dr, dc = cs.conv_dims(mo)
    origin = {None: (160, 150), "low": (dr // 2, dc // 2),
              "high": (cmap.hp - (region + dr - 1) + dr // 2,
                       cmap.wp - (region + dc - 1) + dc // 2)}[edge]
    maps = ps.build_padded_maps(jnp.asarray(d["packed"]))
    ref, k_i8, kf2 = _jax_field_i8(maps, kern_j, origin, mo, region,
                                   monkeypatch)
    ints, scales = cs.quantize_conv_kernel(kern, cmap.qinv)
    sm = 2 * ww
    got_ints = np_(ints).astype(np.int8)  # (S_out, 2, CP, dr, dc)
    want = np.concatenate([
        k_i8[..., :sm, None], k_i8[..., sm:, None]], -1)  # (dr, dc, 8, sm, 2)
    np.testing.assert_array_equal(got_ints[:sm].transpose(3, 4, 2, 0, 1),
                                  want[:, :, :cp])
    np.testing.assert_array_equal(got_ints[sm].transpose(2, 3, 1, 0),
                                  kf2[:, :, :cp])
    assert not k_i8[:, :, cp:].any() and not kf2[:, :, cp:].any()
    before = cs.CALLS["cost_field_i8"]
    field = np_(cs.cost_field_i8(cmap.codes, ints, scales,
                                 torch.tensor(origin), mo, region))
    assert cs.CALLS["cost_field_i8"] == before + 1
    differ = int((field != ref).sum())
    print(f"int8 field, mo {mo} W {ww}: {differ} of {field.size} values "
          "differ from JAX's")
    assert_rel(ref, field, 1e-6, f"field ({differ} values differ)")


# -- the card kernels' layout and indexing, emulated --------------------------
@pytest.mark.parametrize("cp", [4, 8])
@pytest.mark.parametrize("ww", [16, 32, 64])
def test_i8_layout_equals_numpy(cp, ww):
    """i8_layout (the plain version of what the quantizer kernel writes and
    the field kernel's TMA reads) against a numpy build of B[group, chunk,
    n, b] = ints[s, p, c, dy, dx] at n = 2 s + p (its group's row), k = 32
    chunk + (b XOR 16 where (n >> 2) is odd: the 32-byte swizzle) = (dy
    dcp + dx) CP + c, zeros past dc and past 2 S_out, and the chunk flags; quantize_i8 on the CPU is quantize_conv_kernel laid
    out so.  The groups: the least wgmma int8 widths."""
    rng = np.random.default_rng(cp + ww)
    mo = 12
    dr, dc = cs.conv_dims(mo)
    s_out = 2 * ww + 1
    kern = rng.standard_normal((s_out, cp, dr, dc)).astype(np.float32) * (
        rng.random((s_out, cp, dr, dc)) < 0.5)
    kern[:, :, 3:7] = 0.0  # whole zero chunks
    kern = torch.as_tensor(kern).bfloat16().float()
    qinv = torch.as_tensor(rng.random(cp).astype(np.float32) + 0.1)
    ints, scales = cs.quantize_conv_kernel(kern, qinv)
    b, nonzero = cs.i8_layout(ints)
    groups, width = cs.i8_columns(s_out)
    assert (groups, width) == {16: (1, 80), 32: (1, 144), 64: (2, 144)}[ww]
    # an N that wgmma's m64nNk32 .s8 takes: 8, 16, 24, multiples of 16
    assert width in (8, 16, 24, *range(32, 257, 16))
    assert groups * width >= 2 * s_out > (groups * width
                                          - 16 * groups if width > 32
                                          else 0)
    dcp = cs.i8_dcp(dc, cp)
    chunks = dr * dcp * cp // 32
    want = np.zeros((groups, chunks, width, 32), np.int8)
    s, p, c, dy, dx = np.meshgrid(*map(np.arange, ints.shape),
                                  indexing="ij")
    n = 2 * s + p
    k = (dy * dcp + dx) * cp + c
    row = n % width  # its 16-byte halves swapped where (row >> 2) is odd
    want[n // width, k // 32, row, (k % 32) ^ (16 * ((row >> 2) & 1))] = (
        np_(ints))
    assert b.dtype == torch.int8 and b.is_contiguous()
    np.testing.assert_array_equal(np_(b), want)
    np.testing.assert_array_equal(np_(nonzero),
                                  want.reshape(groups, chunks, -1).any(-1))
    assert 0 < int(nonzero.sum()) < nonzero.numel()
    qb, qnz, qs = cs.quantize_i8(kern, qinv)
    assert torch.equal(qb, b) and torch.equal(qnz, nonzero)
    assert torch.equal(qs, scales)


@pytest.mark.parametrize("ww", [8, 24, 48])
def test_i8_layout_refuses_widths_without_a_kernel(ww):
    """The layout's groups are a table of W 16, 32 and 64 (the card
    kernel's instances): any other W raises, in i8_columns and so in
    i8_layout and quantize_i8 on the CPU too."""
    s_out = 2 * ww + 1
    with pytest.raises(ValueError):
        cs.i8_columns(s_out)
    ints = torch.zeros((s_out, 2, 4, 10, 10), dtype=torch.int8)
    with pytest.raises(ValueError):
        cs.i8_layout(ints)
    with pytest.raises(ValueError):
        cs.quantize_i8(torch.zeros((s_out, 4, 10, 10)), torch.ones(4))


@pytest.mark.parametrize("mo", [12, 24, 36, 48])
@pytest.mark.parametrize("cp", [4, 8])
def test_i8_window_box_covers_the_reads(mo, cp):
    """The field kernel's window box (i8_window): within TMA's 256 a
    dimension, and wide enough for every A word a thread reads, from any
    start of the block's first pixel in its 16-byte group (0 to 16 - CP
    bytes in)."""
    dr, dc = cs.conv_dims(mo)
    dcp = cs.i8_dcp(dc, cp)
    rows, groups16 = cs.i8_window(dr, dcp, cp)
    assert rows <= 256 and groups16 <= 256
    ty, tx = cs.I8_TILE
    assert rows == ty + dr - 1
    # the last byte read: row's start xs, chunk kk, centre g + 8, word a3
    last = (16 - cp) + (dcp * cp - 32) + (tx - 1) * cp + 16 + 3 * 4 + 3
    assert last < groups16 * 16
    assert (tx - 1 + dcp - 1) * cp + 15 < groups16 * 16  # the last pixel


def test_conv_map_codes_rows_are_whole_16_byte_groups():
    """ConvMap's codes: a (hp, wp, CP) view of rows padded with zeros to
    whole 16-byte groups (the card kernel's TMA strides), equal to the
    padded map, at a width whose rows are not whole groups."""
    rng = np.random.default_rng(2)
    for c, width in ((3, 97), (6, 97), (3, 96)):
        packed = np.zeros((40, width, 8), np.float32)
        packed[..., : c + 1] = rng.random((40, width, c + 1)) * 30
        cmap = _conv_map(packed, c, int8=True)
        cp = crop_score.channel_pad(c)
        assert cmap.codes.shape == (cmap.hp, cmap.wp, cp)
        assert cmap.codes.stride(0) % 16 == 0
        assert cmap.codes.stride()[1:] == (cp, 1)
        assert cmap.codes.stride(0) - cmap.wp * cp < 16
        codes, _ = cs.quantize_channels(crop_score.compact_map(
            torch.as_tensor(packed), c))
        pad = cmap.pad
        want = torch.nn.functional.pad(codes, (0, 0, pad, pad, pad, pad))
        assert torch.equal(cmap.codes, want)
        rows = torch.as_strided(cmap.codes, (cmap.hp, cmap.codes.stride(0)),
                                (cmap.codes.stride(0), 1))
        assert not rows[:, cmap.wp * cp :].any()


def _tma_box(rows_flat, xg, y0, groups16, nrows):
    """A box of the 3-D tensor map (16, pitch / 16, hp) over the codes'
    rows (hp, pitch) at coordinates (0, xg, y0): nrows x groups16 16-byte
    groups, zeros out of bounds (TMA's fill)."""
    hp, pitch = rows_flat.shape
    ys = y0 + np.arange(nrows)
    xs = 16 * xg + np.arange(16 * groups16)
    ok = ((ys >= 0) & (ys < hp))[:, None] & ((xs >= 0) & (xs < pitch))
    return np.where(ok, rows_flat[np.clip(ys, 0, hp - 1)][
        :, np.clip(xs, 0, pitch - 1)], 0)


def _emulate_kernel(codes, b, nonzero, origin, dr, dc, region, s_out,
                    splits):
    """csrc/conv_field_i8.cu's field kernel in numpy: each group's list of
    the chunks flagged nonzero, cut into `splits` ranges (a cluster's
    blocks); each block's window as the TMA box from the 16-byte group at
    or below its first pixel (zeros off the rows); each consumer thread's A
    words (warp w of warpgroup wg: centre row 4 wg + w; a0 row g, bytes 4 t
    .., a1 row g + 8, a2 and a3 16 bytes on) placed where wgmma's m64 A
    fragment puts them (rows 16 w + ...), times the chunk's K-major B rows
    (read through the 32-byte swizzle);
    the products' m64 x N tile read back as wgmma's accumulator fragment
    (register r: row 16 w + g + 8 ((r >> 1) & 1), column 8 (r >> 2) + 2 t +
    (r & 1)); the cluster's sums added and each pair (hi, lo) written by
    the split whose share it is, once.  Returns the sums (2 S_out, region,
    region)."""
    hp, wp, cp = codes.shape
    pitch = codes.stride(0)
    rows_flat = np_(torch.as_strided(codes, (hp, pitch), (pitch, 1))).astype(
        np.int64)
    dcp = cs.i8_dcp(dc, cp)
    cpr = dcp * cp // 32
    nrows, groups16 = cs.i8_window(dr, dcp, cp)
    ty, tx = cs.I8_TILE
    groups, chunks, width, _ = b.shape
    # B's rows as wgmma reads them through the 32-byte swizzle
    rows = np.arange(width)[:, None]
    bb = np_(b).astype(np.int64)[..., rows, np.arange(32) ^ (
        16 * ((rows >> 2) & 1))]
    nz = np_(nonzero)
    lane = np.arange(32)
    g, t, i4 = lane // 4, lane % 4, np.arange(4)
    r = np.arange(width // 2)
    acc_row = g[:, None] + 8 * ((r >> 1) & 1)  # (lane, register), in a warp
    acc_col = 8 * (r >> 2) + 2 * t[:, None] + (r & 1)
    sums = np.zeros((groups * width, region, region), np.int64)
    written = np.zeros(sums.shape, np.int64)
    for grp in range(groups):
        listed = np.nonzero(nz[grp])[0]
        for by in range(region // ty):
            for bx in range(region // tx):
                y0 = origin[0] - dr // 2 + by * ty
                x0 = origin[1] - dc // 2 + bx * tx
                xg = x0 * cp // 16
                xs = x0 * cp - 16 * xg
                win = _tma_box(rows_flat, xg, y0, groups16, nrows)
                total = np.zeros((2, 4, 32, width // 2), np.int64)
                for split in range(splits):
                    lo = len(listed) * split // splits
                    hi = len(listed) * (split + 1) // splits
                    for kc in listed[lo:hi]:
                        dy, kk = kc // cpr, (kc % cpr) * 32
                        for wg in range(2):
                            a = np.zeros((64, 32), np.int64)
                            for w in range(4):
                                row = win[wg * 4 + w + dy]
                                base = xs + kk + 4 * t[:, None] + i4
                                for dm, dk in ((0, 0), (8, 0), (0, 16),
                                               (8, 16)):
                                    a[16 * w + g[:, None] + dm,
                                      dk + 4 * t[:, None] + i4] = row[
                                        base + (g[:, None] + dm) * cp + dk]
                            prod = a @ bb[grp, kc].T  # (64, width)
                            for w in range(4):
                                total[wg, w] += prod[16 * w + acc_row,
                                                     acc_col]
                npair = width // 4
                for split in range(splits):
                    for p in range(npair * split // splits,
                                   npair * (split + 1) // splits):
                        col = grp * width + 8 * (p >> 1) + 2 * t
                        x = bx * tx + g + 8 * (p & 1)
                        for wg in range(2):
                            for w in range(4):
                                y = by * ty + wg * 4 + w
                                for e in range(2):
                                    sums[col + e, y, x] = total[wg, w, :,
                                                                2 * p + e]
                                    written[col + e, y, x] += 1
    assert (written == 1).all()
    return sums[: 2 * s_out]


@pytest.mark.parametrize("c,ww,edge,splits", [(3, 16, False, 1),
                                              (3, 32, True, 3),
                                              (6, 16, True, 2),
                                              (6, 64, False, 3)])
def test_kernel_indexing_emulated_equals_plain(c, ww, edge, splits):
    """The field kernel's chunk list and cluster splits, TMA window box,
    A fragments, m64 tile, N padding and epilogue (emulated on the
    quantizer's layout) against the plain version's sums, CP 4 and 8, one
    and two column groups, a block at the map's far corner (the padded tap
    columns past the map read TMA's zeros), rows that are not whole
    16-byte groups, a kernel with zero chunks."""
    rng = np.random.default_rng(c + ww)
    packed = np.zeros((80, 97, 8), np.float32)
    packed[..., : c + 1] = rng.random((80, 97, c + 1)) * 40
    cmap = _conv_map(packed, c, int8=True)
    mo, region = 12, 32
    dr, dc = cs.conv_dims(mo)
    s_out = 2 * ww + 1
    cp = crop_score.channel_pad(c)
    kern = rng.standard_normal((s_out, cp, dr, dc)).astype(np.float32) * (
        rng.random((s_out, cp, dr, dc)) < 0.7)
    kern[:, :, 5:9] = 0.0  # whole zero chunks (a tap row at most 32 bytes)
    kern[:, :, :, :8] = 0.0
    kern = torch.as_tensor(kern).bfloat16().float()
    ints, scales = cs.quantize_conv_kernel(kern, cmap.qinv)
    origin = ((cmap.hp - (region + dr - 1) + dr // 2,
               cmap.wp - (region + dc - 1) + dc // 2) if edge else (50, 40))
    field, sums = cs.cost_field_i8(cmap.codes, ints, scales,
                                   torch.tensor(origin), mo, region, sums=True)
    assert sums.dtype == torch.int32 and sums.shape == (2 * s_out, 32, 32)
    b, nonzero, qscales = cs.quantize_i8(kern, cmap.qinv)
    assert torch.equal(qscales, scales)
    assert 0 < int(nonzero.sum()) < nonzero.numel()
    got = _emulate_kernel(cmap.codes, b, nonzero, origin, dr, dc, region,
                          s_out, splits)
    np.testing.assert_array_equal(got, np_(sums))
    hi, lo = got.reshape(s_out, 2, region, region).transpose(1, 0, 2, 3)
    s = np_(scales)[..., None, None]
    deq = cs.fma_f32(torch.as_tensor(hi.astype(np.float32)),
                     torch.as_tensor(s[:, 0]),
                     torch.as_tensor(lo.astype(np.float32) * s[:, 1]))
    assert torch.equal(deq, field)
    f2, s2 = cs.conv_field_i8(cmap.codes, cmap.qinv, kern,
                              torch.tensor(origin), mo, region, sums=True)
    assert torch.equal(f2, field) and torch.equal(s2, sums)


def test_fma_f32_rounds_once():
    """fma_f32 against an exact rational reference on values where two
    roundings (float64, then float32) and a product rounded first differ
    from one rounding."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = rng.standard_normal(4000).astype(np.float32)
    b = rng.standard_normal(4000).astype(np.float32)
    c = (-(a.astype(np.float64) * b)).astype(np.float32)  # cancellation
    c[::2] = rng.standard_normal(2000).astype(np.float32)
    got = np_(cs.fma_f32(*(torch.as_tensor(x) for x in (a, b, c))))
    want = []
    for x, y, z in zip(a.tolist(), b.tolist(), c.tolist()):
        e = Fraction(x) * Fraction(y) + Fraction(z)
        lo = np.float32(float(e))  # within an ulp: pick the nearest, ties even
        cands = {lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))}
        best = min(cands, key=lambda v: (
            abs(Fraction(float(v)) - e),
            int(np.float32(v).view(np.int32)) & 1))
        want.append(best)
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    naive = (a * b + c).astype(np.float32)
    assert (naive != got).any()


# -- (c), (d) the scorer ------------------------------------------------------
def _jax_scores_i8(d, mo, region, ww, s0, f, monkeypatch):
    monkeypatch.setenv("TDR_CONV_INT8", "1")
    maps = ps.build_padded_maps(jnp.asarray(d["packed"]))
    scorer = cs_j.make_conv_scorer(mo, region, "tracked", window_w=ww)

    @jax.jit
    def run(p3, p4, p8, q, sten, scan, cw, ctr, theta, alive):
        return scorer(p3, p4, maps.pad, sten, scan, cw, ctr, theta, f, alive,
                      s0, padded4d_i8=p8, qinv=q)

    out = run(maps.padded3d, maps.padded4d, maps.padded4d_i8, maps.qinv4d,
              *(jnp.asarray(d[k]) for k in ("stencil", "scan", "cw",
                                            "centers", "thetas", "alive")))
    return [np.asarray(x) for x in out]


def _port_scores(d, mo, region, ww, s0, f, conv_int8):
    t = _t(d)
    scorer = cs.make_conv_scorer(mo, region, "tracked", window_w=ww,
                                 conv_int8=conv_int8)
    before = dict(cs.CALLS)
    out = scorer(_conv_map(d["packed"], int8=conv_int8), t["stencil"],
                 t["scan"], t["cw"], t["centers"], t["thetas"], f,
                 t["alive"], s0)
    name = "cost_field_i8" if conv_int8 else "cost_field"
    assert {k: cs.CALLS[k] - before[k] for k in before} == {
        k: int(k == name) for k in before}
    return [np_(x) for x in out]


@pytest.mark.parametrize("mo,ww,s0", [(12, 16, 95), (12, 32, 7),
                                      (24, 16, 3)])
def test_int8_scorer_matches_jax(mo, ww, s0, monkeypatch):
    d = _inputs(seed=1, band=0.3)
    f = {12: F_HALF, 24: 1.0}[mo]
    ref = _jax_scores_i8(d, mo, 64, ww, s0, f, monkeypatch)
    got = _port_scores(d, mo, 64, ww, s0, f, True)
    alive = d["alive"]
    for i, name in enumerate(("num", "den", "kf")):
        assert got[i].shape == ref[i].shape
        assert_rel(ref[i][alive], got[i][alive], 1e-6, name)
    np.testing.assert_array_equal(got[2] < 0.5, ref[2] < 0.5)
    assert 0 < (ref[2][alive] < 0.5).sum() < alive.sum()


@pytest.mark.parametrize("mo,ww,s0", [(12, 16, 95), (24, 32, 7)])
def test_int8_scorer_within_jax_bounds_of_the_float_one(mo, ww, s0):
    """tests/test_conv_score.py::test_conv_int8_matches_bf16's bounds:
    cost median rel 1e-3, max 1e-2; kf within 2e-3; the gate equal off
    its knife edge."""
    d = _inputs(seed=7, band=0.3)
    f = {12: F_HALF, 24: 1.0}[mo]
    n0, d0, k0 = _port_scores(d, mo, 64, ww, s0, f, False)
    n1, d1, k1 = _port_scores(d, mo, 64, ww, s0, f, True)
    alive = d["alive"]
    with np.errstate(divide="ignore", invalid="ignore"):
        c0, c1 = n0 / d0, n1 / d1
    m = alive & (k0 >= 0.5)
    assert m.any()
    err = np.abs(c1[m] - c0[m]) / np.maximum(np.abs(c0[m]), 1e-6)
    assert np.median(err) < 1e-3, np.median(err)
    assert err.max() < 1e-2, err.max()
    assert (err > 0).any()  # a different function
    np.testing.assert_allclose(k1, k0, rtol=2e-3, atol=2e-3)
    off_edge = np.abs(k0 - 0.5) > 2e-3
    np.testing.assert_array_equal((k1 < 0.5)[off_edge], (k0 < 0.5)[off_edge])


# -- (e) whole updates --------------------------------------------------------
@pytest.mark.parametrize("ww,s0", [(16, 90), (32, 80)])
def test_int8_conv_steps_match_jax(ww, s0, monkeypatch):
    """Three fused conv updates (tracked, region 64) of a clustered cloud
    in both packages, each from the reference's state, with its resample
    draw handed to the port."""
    monkeypatch.setenv("TDR_CONV_INT8", "1")
    st_j, d, params = _setups(True, cluster=True)
    n = st_j.particles.n_max
    res = 0.5  # f = 1: conv bucket 24
    step_j = fj.make_update_step_fast(
        params, 3, 1.0, TH, n, "tracked", mo=24, gmm_every=1, path="conv",
        region=64, window_w=ww)
    step_t = ft.make_update_step_fast(
        params, 3, 1.0, TH, n, "tracked", gmm_every=1, path="conv", mo=24,
        region=64, window_w=ww, conv_int8=True)
    packed, mss, sten, scan = (d[k] for k in ("packed", "map_size",
                                              "stencil", "scan"))
    maps_j = ps.build_padded_maps(jnp.asarray(packed))
    cmap = _conv_map(packed, 3, int8=True)
    for _ in range(3):
        shift_key = jax.random.split(st_j.key)[0]
        _, k_rs, _ = jax.random.split(shift_key, 3)
        shift = float(jax.random.uniform(k_rs))
        state_t = filter_state_from_numpy(to_numpy_tree(st_j))  # st_j is
        # donated to the reference's step
        out_j = step_j(st_j, maps_j, jnp.asarray(mss), jnp.asarray(sten),
                       jnp.asarray(scan), jnp.float32(res), s0=s0)
        before = dict(cs.CALLS)
        out_t = step_t(state_t, cmap,
                       *(torch.as_tensor(a) for a in (mss, sten, scan)), res,
                       params.fixed_scale, s0, shift=shift)
        assert cs.CALLS["cost_field_i8"] == before["cost_field_i8"] + 1
        assert cs.CALLS["cost_field"] == before["cost_field"]
        _compare_states(out_j, out_t)
        st_j = out_j


def test_filter_with_conv_int8_matches_jax_filter(monkeypatch):
    """ParticleFilter(conv_int8=True) and the JAX filter under
    TDR_CONV_INT8=1 on a tight cloud with a theta prior: three updates,
    each planned conv tracked (mo 48, window 32, then 16) by both and
    scored on the int8 field, the reference's resample draw handed to the
    port."""
    monkeypatch.setenv("TDR_CONV_INT8", "1")
    pf_j, pf_t = _filters(make_world(), init_pos_px_x=128.0,
                          init_pos_px_y=105.0, init_pos_px_cov=5.0,
                          init_pos_deg_theta=40.0)
    assert pf_t.conv_int8 is True  # read from the environment
    _set_smask(pf_j, pf_t, [10, 11, 12])
    draws = []

    def handed(fast, generator, noise_generator):
        return dict(shift=draws[-1])

    monkeypatch.setattr(pf_t, "_draws", handed)
    rng = np.random.default_rng(8)
    for _ in range(3):
        plan = pf_t._fast_mode(1.0)
        assert tuple(plan) == tuple(pf_j._fast_mode(1.0))
        assert plan.path == "conv" and plan.mode == "tracked"
        assert plan.mo == 48 and plan.ww in (16, 32)
        shift_key = jax.random.split(pf_j.state.key)[0]
        draws.append(float(jax.random.uniform(jax.random.split(
            shift_key, 3)[1])))
        scan = rng.random((3, 100, 25)).astype(np.float32)
        before = dict(cs.CALLS)
        pf_j.update(scan, 1.0)
        pf_t.update(scan, 1.0)
        assert cs.CALLS["cost_field_i8"] == before["cost_field_i8"] + 1
        assert cs.CALLS["cost_field"] == before["cost_field"]
        _compare_states(pf_j.state, pf_t.state)
        pf_t.state = filter_state_from_numpy(to_numpy_tree(pf_j.state))
        pf_t._snap = None


def test_filter_reads_the_flag_once(monkeypatch):
    monkeypatch.delenv("TDR_CONV_INT8", raising=False)
    _, pf = _filters(make_world(), init_pos_px_x=128.0, init_pos_px_y=105.0,
                     init_pos_px_cov=5.0, init_pos_deg_theta=40.0)
    assert pf.conv_int8 is False and pf._get_conv_map().codes is None
    monkeypatch.setenv("TDR_CONV_INT8", "1")
    assert pf.conv_int8 is False
    pf2 = ft.ParticleFilter(512, pf.map, pf.params, seed=3)
    assert pf2.conv_int8 is True
    assert pf2._get_conv_map().codes is not None
    assert ft.ParticleFilter(512, pf.map, pf.params, seed=3,
                             conv_int8=False).conv_int8 is False


# -- (f) where the float field stays ---------------------------------------
def test_s2d_gate_is_jax_gate():
    """The gate the int8 field needs: the reference's s2d kernel bytes
    against its K4_MAX_BYTES, for every conv bucket and tracked window
    (mo 48 at W = 64 is past it)."""
    for mo in (12, 24, 36, 48):
        dr, dc = cs.conv_dims(mo)
        for ww in (16, 32, 64, 100):
            s_out = 2 * ww + 1
            k4 = (16 * s_out * cs_j.s2d_extent(dr) * cs_j.s2d_extent(dc)
                  * 128 * 2)
            assert cs.s2d_gate(mo, s_out) == (k4 <= cs_j.K4_MAX_BYTES)
    assert not cs.s2d_gate(48, 129) and cs.s2d_gate(48, 65)


@pytest.mark.parametrize("mode,ww,gate", [
    ("init", 100, True),      # the theta search
    ("tracked", 100, True),   # mixed updates' full window: (2 W) % 32 != 0
    ("tracked", 16, False),   # past the s2d gate (closed here)
])
def test_float_field_where_jax_keeps_it(mode, ww, gate, monkeypatch):
    if not gate:
        monkeypatch.setattr(cs, "K4_MAX_BYTES", 0)
    d = _inputs(seed=2, n=64, band=0.3)
    t = _t(d)
    scorer = cs.make_conv_scorer(12, 64, mode, window_w=ww, conv_int8=True)
    before = dict(cs.CALLS)
    scorer(_conv_map(d["packed"], int8=True), t["stencil"], t["scan"],
           t["cw"], t["centers"], t["thetas"], F_HALF, t["alive"])
    assert cs.CALLS["cost_field"] == before["cost_field"] + 1
    assert cs.CALLS["cost_field_i8"] == before["cost_field_i8"]


def test_mixed_step_keeps_the_float_field():
    st_j, d, params = _setups(True, cluster=True)
    n = st_j.particles.n_max
    have = np.arange(n) % 3 == 0
    d["state"]["particles"]["have_init"][:] = have
    step = ft.make_update_step_fast(
        params, 3, 1.0, TH, n, "mixed", gmm_every=1, path="conv", mo=24,
        region=64, window_w=100, conv_int8=True)
    before = dict(cs.CALLS)
    step(filter_state_from_numpy(d["state"]),
         _conv_map(d["packed"], 3, int8=True),
         *(torch.as_tensor(d[k]) for k in ("map_size", "stencil", "scan")),
         0.5, params.fixed_scale, 0, shift=0.25)
    assert cs.CALLS["cost_field"] == before["cost_field"] + 2
    assert cs.CALLS["cost_field_i8"] == before["cost_field_i8"]


def test_mesh_keeps_the_float_field(tmp_path, monkeypatch):
    """A world-1 gloo mesh in this process under TDR_CONV_INT8=1: the
    row-sharded conv step computes the float field (the reference's mesh
    never reads its int8 map), equal to the mesh's run without the flag;
    the one-device filter under the flag computes the int8 one."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh(1, "cpu")
        runs = {}
        for flag in ("0", "1"):
            monkeypatch.setenv("TDR_CONV_INT8", flag)
            before = dict(cs.CALLS)
            runs[flag] = mesh_conv_case(mesh)
            assert cs.CALLS["cost_field"] == before["cost_field"] + 1
            assert cs.CALLS["cost_field_i8"] == before["cost_field_i8"]
    finally:
        dist.destroy_process_group()
    assert runs["1"]["plans"][0][3] == "conv"
    assert runs["1"]["plans"][0][6] in (16, 32)  # a window int8 could take
    np.testing.assert_array_equal(runs["0"]["ml"], runs["1"]["ml"])
    np.testing.assert_array_equal(runs["0"]["weight"], runs["1"]["weight"])
    before = dict(cs.CALLS)
    one = mesh_conv_case(None)
    assert cs.CALLS["cost_field_i8"] == before["cost_field_i8"] + 1
    assert one["plans"] == runs["1"]["plans"]


# -- (g) the nibble-packed crop map -------------------------------------------
def test_map_int4_leaves_the_int8_field_unchanged():
    """map_int4=True changes the crop maps, not the conv map's codes: the
    same codes and the same scores."""
    pf_j, pf_t = _filters(make_world(), init_pos_px_x=128.0,
                          init_pos_px_y=105.0, init_pos_px_cov=5.0,
                          init_pos_deg_theta=40.0)
    cmaps, outs = [], []
    for int4 in (False, True):
        pf = ft.ParticleFilter(512, pf_t.map, pf_t.params, seed=3,
                               conv_int8=True, map_int4=int4)
        cmaps.append(pf._get_conv_map())
        d = _inputs(seed=3)
        t = _t(d)
        scorer = cs.make_conv_scorer(12, 64, "tracked", window_w=16,
                                     conv_int8=True)
        outs.append(scorer(cmaps[-1], t["stencil"], t["scan"], t["cw"],
                           t["centers"] * 0.3, t["thetas"], F_HALF,
                           t["alive"], 0))
    assert torch.equal(cmaps[0].codes, cmaps[1].codes)
    assert torch.equal(cmaps[0].qinv, cmaps[1].qinv)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_int8_field_on_the_cpu_launches_no_kernel():
    """On CPU tensors cost_field_i8 runs its plain version: the call is
    counted in CALLS, no launch in kernels.LAUNCHES."""
    assert "conv_field_i8" in kernels.LAUNCHES
    before = kernels.LAUNCHES["conv_field_i8"]
    cmap = _conv_map(_inputs(seed=4)["packed"], int8=True)
    ints = torch.zeros((33, 2, 4, 26, 26), dtype=torch.int8)
    calls = cs.CALLS["cost_field_i8"]
    field = cs.cost_field_i8(cmap.codes, ints, torch.ones(33, 2),
                             torch.tensor([60, 60]), 12, 64)
    assert not field.any() and field.shape == (33, 64, 64)
    assert cs.CALLS["cost_field_i8"] == calls + 1
    assert kernels.LAUNCHES["conv_field_i8"] == before
