"""The probes (top_down_renderer_torch/probes) against the TPU probe
kernels they replace, on the CPU, from the same numpy inputs.

The JAX probe kernels that import cleanly (probe_dma_unaligned._kernel,
probe_dma_fold._kernel_a / _kernel_fold / _kernel_db,
probe_int8_mm._kernel) run through pl.pallas_call(interpret=True), their
HBM operands in pl.ANY, as the probes' own calls pass them; the port's
plain versions must equal them bit for bit.  probe_dma_align.py and
probe_dma2.py run at import, and probe_int8.py nests its kernels, so their
counterparts are held to the numpy slicing, sums and rolls those probes
assert.  The crop ablation's variants (K3, tracked) are held to their
definitions on a 4,096-particle cloud, the theta search's (K4) on 512
particles, and its `full` also to JAX's theta search in interpret mode.
The kernels themselves are held to these plain
versions on the card by tests/test_torch_cuda.py (which imports no JAX)
and chip_smoke.py phase P.
"""

import functools
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import probe_dma_fold
import probe_dma_unaligned
import probe_int8_mm
import test_torch_crop_score as tcs
from test_pallas_interpret import _check
from test_torch_crop_score import float_world  # noqa: F401 (a fixture)
from top_down_renderer_torch.filter import crop_score as cs
from top_down_renderer_torch.filter import multiscale as ms
from top_down_renderer_torch.probes import __main__ as probes
from top_down_renderer_torch.probes import crop_ablate as ca
from top_down_renderer_torch.probes import mm
from top_down_renderer_torch.probes import window as wg
from top_down_renderer_torch.testing import synthetic_setup

CPU = torch.device("cpu")
N_WIN = 256  # windows of the DMA-probe comparisons: 4 tiles of 64
N_ABL = 4096  # particles of the ablation cloud


def _gather(src_np, origins_np, rows, cols, geometry, out="copy"):
    got = wg.window_gather(torch.as_tensor(src_np), torch.as_tensor(
        origins_np, dtype=torch.int32), rows, cols, geometry=geometry,
        out=out)
    return got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()


# -- K1 against the JAX DMA kernels ------------------------------------------
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_unaligned_row_copies_equal_probe_dma_unaligned(dtype):
    """8-row copies at row starts {0,1,3,7,9,17,30,101} of a (256, 1024)
    map, int8 and bf16 (probe_dma_unaligned.run)."""
    rng = np.random.default_rng(0)
    h, w, dr = probe_dma_unaligned.H, probe_dma_unaligned.W, \
        probe_dma_unaligned.DR
    if dtype == "int8":
        src = rng.integers(-127, 128, (h, w), dtype=np.int8)
        jdt, tdt = jnp.int8, torch.int8
    else:
        src = rng.standard_normal((h, w)).astype(np.float32)
        jdt, tdt = jnp.bfloat16, torch.bfloat16
    starts = np.array([0, 1, 3, 7, 9, 17, 30, 101], np.int32)
    n = len(starts)
    gs = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(n,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((1, dr, w), lambda i, s: (i, 0, 0)),
        scratch_shapes=[pltpu.VMEM((dr, w), jdt), pltpu.SemaphoreType.DMA(())],
    )
    ref = pl.pallas_call(
        functools.partial(probe_dma_unaligned._kernel, n=n), grid_spec=gs,
        out_shape=jax.ShapeDtypeStruct((n, dr, w), jdt), interpret=True,
    )(jnp.asarray(starts), jnp.asarray(src, jdt))
    ref = np.asarray(ref.astype(jnp.float32))
    src_t = torch.as_tensor(np.array(jnp.asarray(src, jdt).astype(
        jnp.float32))).to(tdt)[None]
    origins = torch.as_tensor(np.stack([0 * starts, starts, 0 * starts], 1))
    for geometry in ("strided", "async"):
        got = wg.window_gather(src_t, origins, dr, w, geometry=geometry)
        np.testing.assert_array_equal(got.float().numpy(), ref)


def _fold_inputs(seed, h=128, wb=2048):
    """A small int8 map for probe_dma_fold's kernels and N_WIN origins:
    (src, strided origins (y/8, x/128), folded origins)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(-100, 100, (h, wb), dtype=np.int8)
    ys = rng.integers(0, (h - probe_dma_fold.DR) // 8, N_WIN)
    xs = rng.integers(0, (wb - probe_dma_fold.DCB) // 128, N_WIN)
    ys_f = rng.integers(0, h // 64 - 1, N_WIN)
    xs_f = rng.integers(0, (8 * wb - probe_dma_fold.DCF) // 128, N_WIN)
    return (src, np.stack([ys, xs], 1).astype(np.int32),
            np.stack([ys_f, xs_f], 1).astype(np.int32))


def _fold_call(kernel, buf_shape, src, origins, *, db=False):
    """probe_dma_fold's grid (P_TILE windows a step) in interpret mode:
    (N_WIN, 128) float32, the first 128 bytes of each window's first
    row."""
    p = probe_dma_fold.P_TILE
    tiles = N_WIN // p
    smem = [pl.BlockSpec((p, 2), lambda i, d: (i, 0),
                         memory_space=pltpu.SMEM)]
    if db:
        smem.append(pl.BlockSpec(
            (p, 2), lambda i, d: (jnp.minimum(i + 1, tiles - 1), 0),
            memory_space=pltpu.SMEM))
    gs = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(tiles,),
        in_specs=smem + [pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((p, 128), lambda i, d: (i, 0)),
        scratch_shapes=[pltpu.VMEM(buf_shape, jnp.int8),
                        pltpu.SemaphoreType.DMA((2,) if db else ())],
    )
    ops = [jnp.zeros(1, jnp.int32)] + [jnp.asarray(origins)] * len(smem)
    out = pl.pallas_call(kernel, grid_spec=gs, interpret=True,
                         out_shape=jax.ShapeDtypeStruct((N_WIN, 128),
                                                        jnp.float32),
                         )(*ops, jnp.asarray(src))
    return np.asarray(out)


def _origins3(o2, ymul, xmul):
    return np.stack([0 * o2[:, 0], o2[:, 0] * ymul, o2[:, 1] * xmul],
                    1).astype(np.int32)


@pytest.mark.parametrize("geometry", ["strided", "async"])
def test_strided_crops_equal_probe_dma_fold_kernel_a_and_db(geometry):
    """256 crops of 56 rows x 640 B at (8 y, 128 x): one strided fetch
    each (_kernel_a), and double-buffered across tiles (_kernel_db)."""
    src, o2, _ = _fold_inputs(1)
    dr, dc, p = probe_dma_fold.DR, probe_dma_fold.DCB, probe_dma_fold.P_TILE
    if geometry == "strided":
        ref = _fold_call(probe_dma_fold._kernel_a, (p, dr, dc), src, o2)
    else:
        ref = _fold_call(probe_dma_fold._kernel_db, (2, p, dr, dc), src, o2,
                         db=True)
    got = _gather(src[None], _origins3(o2, 8, 128), dr, dc, geometry)
    np.testing.assert_array_equal(got[:, 0, :128].astype(np.float32), ref)
    sums = _gather(src[None], _origins3(o2, 8, 128), dr, dc, geometry, "sum")
    np.testing.assert_array_equal(sums, got.astype(np.int64).sum((1, 2)))


@pytest.mark.parametrize("nsl", [1, 2])
def test_folded_slices_equal_probe_dma_fold_kernel_fold(nsl):
    """256 fetches of nsl (8, 5,120 B) slices of the 8-row-folded map
    (_kernel_fold)."""
    src, _, of = _fold_inputs(2)
    p, dcf = probe_dma_fold.P_TILE, probe_dma_fold.DCF
    src8 = src.reshape(src.shape[0] // 8, -1)
    ref = _fold_call(functools.partial(probe_dma_fold._kernel_fold, nsl=nsl),
                     (p, 8 * nsl, dcf), src8, of)
    folded = wg.fold_rows(torch.as_tensor(src)[None]).numpy()
    np.testing.assert_array_equal(folded[0], src8)
    got = _gather(folded, _origins3(of, 8, 128), 8 * nsl, dcf,
                  f"folded{nsl}")
    np.testing.assert_array_equal(got[:, 0, :128].astype(np.float32), ref)


# -- K1 against the probes' own numpy references ---------------------------
def test_align_sweep_sums_equal_numpy():
    """probe_dma_align: 64 x 512 bf16 slices at y0 = 3 ymul, x0 = xmul over
    its alignment sweep, summed (float64, rounded once)."""
    src = jnp.asarray(np.random.default_rng(3).random((256, 1024)),
                      jnp.bfloat16)
    src_np = np.array(src.astype(jnp.float32))
    src_t = torch.as_tensor(src_np).to(torch.bfloat16)[None]
    for ymul, xmul in ((8, 128), (1, 128), (8, 1), (16, 256), (1, 1)):
        o = np.array([[0, 3 * ymul, xmul]], np.int32)
        got = _gather(src_t, o, 64, 512, "strided", "sum")
        want = np.float32(src_np[3 * ymul:3 * ymul + 64,
                                 xmul:xmul + 512].astype(np.float64).sum())
        assert got[0] == want, (ymul, xmul)


def test_stacked_slice_sum_equals_probe_dma2():
    """probe_dma2 probe 1: the (64, 512) slice of stack 3 at y 16, x 128
    of arange % 1000 in bf16, summed; the probe's own bound is rel 1e-2."""
    src = jnp.asarray(np.arange(8 * 128 * 1024).reshape(8, 128, 1024) % 1000,
                      jnp.bfloat16)
    src_np = np.array(src.astype(jnp.float32))
    got = _gather(torch.as_tensor(src_np).to(torch.bfloat16),
                  np.array([[3, 16, 128]], np.int32), 64, 512, "strided",
                  "sum")
    ref = src_np[3, 16:16 + 64, 128:128 + 512].sum(dtype=np.float64)
    assert got[0] == np.float32(ref)
    assert abs(float(got[0]) - ref) < ref * 1e-2


@pytest.mark.parametrize("ymul", [8, 32])
def test_int8_slice_equals_probe_int8_dma(ymul):
    """probe_int8.probe_dma: the (56, 640) int8 slice at y0 = 3 ymul, x0 =
    128 of a (256, 2048) map."""
    src = np.random.default_rng(0).integers(-128, 128, (256, 2048)).astype(
        np.int8)
    got = _gather(src[None], np.array([[0, 3 * ymul, 128]], np.int32), 56,
                  640, "strided")
    np.testing.assert_array_equal(got[0], src[3 * ymul:3 * ymul + 56,
                                              128:128 + 640])


@pytest.mark.parametrize("rx", [0, 3, 11])
def test_rotation_is_a_window_of_the_row_laid_out_twice(rx):
    """probe_int8.probe_rotate: a (56, 640) int8 block rotated by rx * 8
    bytes equals np.roll(block, -rx * 8, 1); here the window at byte rx * 8
    of the block laid out twice."""
    blk = np.random.default_rng(1).integers(-128, 128, (56, 640)).astype(
        np.int8)
    twice = np.concatenate([blk, blk], 1)[None]
    got = _gather(twice, np.array([[0, 0, rx * 8]], np.int32), 56, 640,
                  "strided")
    np.testing.assert_array_equal(got[0], np.roll(blk, -rx * 8, axis=1))


def test_covered_bytes_counts_each_covered_byte_once():
    rng = np.random.default_rng(4)
    shape, rows, cols = (2, 40, 300), 7, 50
    o = np.stack([rng.integers(0, 2, 30), rng.integers(0, 34, 30),
                  rng.integers(0, 251, 30)], 1).astype(np.int32)
    mask = np.zeros(shape, bool)
    for k, y, x in o:
        mask[k, y:y + rows, x:x + cols] = True
    assert wg.covered_bytes(shape, torch.as_tensor(o), rows, cols, 2) == \
        2 * mask.sum()


def test_window_gather_refuses_what_the_kernel_cannot_take():
    src = torch.zeros((1, 64, 256), dtype=torch.int8)
    ok = torch.tensor([[0, 0, 0]], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        wg.window_gather(src, torch.tensor([[0, 60, 0]], dtype=torch.int32),
                         8, 16)
    with pytest.raises(ValueError, match="folded rows"):
        wg.window_gather(src, ok, 12, 16, geometry="folded1")
    # async takes any start, but TMA's row pitch is a multiple of 16 bytes
    wg.window_gather(src, torch.tensor([[0, 0, 3]], dtype=torch.int32), 8,
                     16, geometry="async")
    with pytest.raises(ValueError, match="async"):
        wg.window_gather(torch.zeros((1, 64, 250), dtype=torch.int8), ok, 8,
                         16, geometry="async")
    with pytest.raises(ValueError, match="async"):
        wg.window_gather(torch.zeros((1, 300, 256), dtype=torch.int8), ok,
                         257, 16, geometry="async")
    with pytest.raises(TypeError):
        wg.window_gather(src.float(), ok, 8, 16)
    with pytest.raises(ValueError, match="geometry"):
        wg.window_gather(src, ok, 8, 16, geometry="tiled")


@pytest.mark.parametrize("cols", [1, 15, 16, 17, 255, 256, 257, 300, 512,
                                  640, 1024, 5120])
@pytest.mark.parametrize("elem", [1, 2])
def test_tma_boxes_cover_a_row(cols, elem):
    """Each box at most BOX_MAX (256) bytes and a multiple
    of 16 bytes; the boxes lie end to end from 0 and cover the lead and
    cols, the last by less than 16 bytes more; the stage holds the larger
    layout's boxes, each on 128 bytes."""
    rows = 56
    stages = []
    for lead in range(wg.STAGE_ALIGN // elem):
        boxes = wg.tma_boxes(cols, elem, lead)
        assert all(0 < w * elem <= wg.BOX_MAX
                   and w * elem % 16 == 0 for _, w in boxes)
        assert [x for x, _ in boxes] == list(np.cumsum(
            [0] + [w for _, w in boxes[:-1]]))
        end = boxes[-1][0] + boxes[-1][1]
        assert lead + cols <= end and (end - lead - cols) * elem < 16
        assert all(w * elem == wg.BOX_MAX for _, w in boxes[:-1])
        stages.append(sum(-(-rows * w * elem // 128) * 128
                          for _, w in boxes))
    assert wg.async_stage_bytes(rows, cols, elem) == max(stages)


def test_a_crop_stages_in_three_boxes():
    """A crop of 56 x 640 B: boxes of 256 + 256 + 128 B, or 256 + 256 + 160
    B from the 32-byte boundary below any other start; 37,632 B a stage,
    six stages in 227 KB."""
    assert wg.tma_boxes(640, 1) == [(0, 256), (256, 256), (512, 128)]
    assert wg.tma_boxes(640, 1, 31) == [(0, 256), (256, 256), (512, 160)]
    assert wg.tma_boxes(1024, 2, 15) == [(128 * b, 128) for b in range(8)] + [
        (1024, 16)]
    assert wg.async_stage_bytes(56, 640, 1) == 56 * 672
    assert wg.async_stages(56, 640, 1) == wg.MAX_STAGES == 6
    assert wg.async_stages(64, 512, 2) == 3  # 64 x 1,056 B a stage


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_async_gather_at_any_byte_equals_the_strided_plain_version(dtype):
    """The async geometry at any row and byte (and ragged widths) on the
    CPU: copies and sums equal the plain version, which is the strided
    geometry's too."""
    rng = np.random.default_rng(7)
    src = torch.as_tensor(rng.integers(-100, 100, (2, 96, 1024)),
                          dtype=torch.float32).to(dtype)
    for rows, cols in ((56, 640), (8, 300), (3, 17)):
        n = 64
        o = torch.as_tensor(np.stack([
            rng.integers(0, 2, n), rng.integers(0, 96 - rows + 1, n),
            rng.integers(0, 1024 - cols + 1, n)], 1), dtype=torch.int32)
        for out in ("copy", "sum"):
            got = wg.window_gather(src, o, rows, cols, geometry="async",
                                   out=out)
            want = wg.window_gather_plain(src, o, rows, cols, out)
            assert torch.equal(got, want)
            assert torch.equal(got, wg.window_gather(src, o, rows, cols,
                                                     geometry="strided",
                                                     out=out))
        ref = torch.stack([src[k, y:y + rows, x:x + cols]
                           for k, y, x in o.tolist()])
        assert torch.equal(wg.window_gather(src, o, rows, cols,
                                            geometry="async"), ref)


# -- K2 -------------------------------------------------------------------------
@pytest.mark.parametrize("a_type", list(mm.A_TYPES))
def test_plan_sends_dense_products_to_wgmma(a_type):
    """The theta search's shape is 800 tiles: six waves of 132 whole, and
    the last wave's 8 tiles split over K.  Row 13's shape (48 x 64 x
    35,840) and probe_int8_mm's (128 x 64 x 1,024) are one tile each: all
    of it split.  Splits are at least two stages, none empty, at most one
    item an SM for the split tiles; a shape of whole waves, or whose last
    wave fills more than half the card, is not split."""
    for m, n, k in ((102_400, 128, 4096), (48, 64, 35_840), (128, 64, 1024),
                    (4096, 128, 35_840)):
        route, split = mm.plan(m, n, k, a_type, False)
        stages = -(-k // mm.STAGE_K[a_type])
        per = -(-stages // split)
        tail = mm._tiles(m, n) - mm.whole_tiles(m, n, split)
        assert route == "wgmma" and 1 < split and tail * split <= 2 * mm.SMS
        assert per >= mm.MIN_SPLIT_STAGES and (split - 1) * per < stages
    assert mm.whole_tiles(102_400, 128, 16) == 792
    assert mm.whole_tiles(48, 64, 94) == 0
    assert mm.plan(48, 64, 35_840, a_type, False)[1] >= 64
    for m in (101_376, 100 * 128):  # six whole waves; 100 tiles
        assert mm.plan(m, 128, 4096, a_type, False) == ("wgmma", 1)
        assert mm.whole_tiles(m, 128, 1) == mm._tiles(m, 128)


def test_plan_keeps_the_select_route_on_mma_sync():
    for m, n, k in ((32, 128, 256), (102_400, 128, 4096), (48, 64, 35_840)):
        assert mm.plan(m, n, k, "bf16", True) == ("mma_sync", 1)


@pytest.mark.parametrize("m", [1, 7, 48, 200])
@pytest.mark.parametrize("n", [1, 9, 64, 88])
def test_products_take_every_shape_they_took_before(m, n):
    """_check's contract: any M and N, K a multiple of 64 (int8) or 32
    (bf16, converted); the CPU runs the plain version, and plan names a
    route with K splits that cover K."""
    rng = np.random.default_rng(m * 100 + n)
    for k in (64, 192):
        a = torch.as_tensor(rng.integers(-127, 128, (m, k)), dtype=torch.int8)
        b = torch.as_tensor(rng.integers(-127, 128, (n, k)), dtype=torch.int8)
        assert torch.equal(mm.mm_s8(a, b), mm.mm_s8_plain(a, b))
        assert mm.plan(m, n, k, "s8", False)[0] == "wgmma"
    for k in (32, 96):
        a8 = torch.as_tensor(rng.integers(-127, 128, (m, k)),
                             dtype=torch.int8)
        bb = torch.as_tensor(rng.random((n, k)) - 0.5).to(torch.bfloat16)
        ab = a8.to(torch.bfloat16)
        for a, a_type in ((a8, "s8_to_bf16"), (ab, "bf16")):
            assert torch.equal(mm.mm_bf16(a, bb), mm.mm_bf16_plain(a, bb))
            route, split = mm.plan(m, n, k, a_type, False)
            assert route == "wgmma" and split >= 1


def test_int8_product_equals_probe_int8_mm():
    """probe_int8_mm: int8 (128, 1024) x (64, 1024)^T -> int32, exactly."""
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 128, (128, 1024), dtype=np.int8)
    b = rng.integers(-127, 128, (64, 1024), dtype=np.int8)
    ref = pl.pallas_call(
        probe_int8_mm._kernel, interpret=True,
        out_shape=jax.ShapeDtypeStruct((128, 64), jnp.int32),
    )(jnp.asarray(a), jnp.asarray(b))
    got = mm.mm_s8(torch.as_tensor(a), torch.as_tensor(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _probe_rel(got, want):
    """probe_int8's measure: |got - want| / (|want| + 1e3)."""
    return np.max(np.abs(got - want) / (np.abs(want) + 1e3))


def test_selected_blocks_equal_numpy():
    """probe_dma2 probe 2 (ones times constant blocks, blocks [2, 0, 3,
    1]), and random bf16 blocks picked per 8-row block."""
    rng = np.random.default_rng(5)
    x = torch.ones((32, 256), dtype=torch.bfloat16)
    mvar = np.stack([np.full((256, 128), v, np.float32) for v in range(4)])
    blocks = torch.as_tensor(mvar.transpose(0, 2, 1).copy()).to(
        torch.bfloat16)
    sel = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    got = mm.mm_bf16(x, blocks, select=sel).numpy()
    np.testing.assert_array_equal(got[::8, 0] / 256, [2, 0, 3, 1])
    a = torch.as_tensor(rng.random((64, 96)) - 0.5).to(torch.bfloat16)
    b = torch.as_tensor(rng.random((3, 40, 96)) - 0.5).to(torch.bfloat16)
    sel = torch.as_tensor(rng.integers(0, 3, 8), dtype=torch.int32)
    got = mm.mm_bf16(a, b, select=sel).numpy()
    a64, b64 = a.double().numpy(), b.double().numpy()
    want = np.concatenate([a64[8 * i:8 * i + 8] @ b64[s].T
                           for i, s in enumerate(sel.numpy())])
    assert _probe_rel(got, want) < 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_int8_to_bf16_product_equals_numpy():
    """probe_int8.probe_convert_matmul: int8 crops (48, 35,840) converted
    to bf16 times M (64, 35,840) bf16, float32 sums."""
    rng = np.random.default_rng(2)
    crop = rng.integers(0, 127, (48, 56 * 640)).astype(np.int8)
    m_np = (rng.random((64, 56 * 640)) - 0.5).astype(np.float32)
    m_bf = torch.as_tensor(m_np).to(torch.bfloat16)
    got = mm.mm_bf16(torch.as_tensor(crop), m_bf).numpy()
    want = crop.astype(np.float64) @ m_bf.double().numpy().T
    assert _probe_rel(got, want) < 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_products_refuse_what_the_kernel_cannot_take():
    a = torch.zeros((16, 48), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 64"):
        mm.mm_s8(a, torch.zeros((8, 48), dtype=torch.int8))
    with pytest.raises(TypeError):
        mm.mm_s8(a.float(), a)
    b = torch.zeros((2, 8, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="select"):
        mm.mm_bf16(torch.zeros((16, 64), dtype=torch.bfloat16), b,
                   select=torch.tensor([0, 2], dtype=torch.int32))


# -- K3 -------------------------------------------------------------------------
def _ablation_args(seed=0, c=3, constant=False, theta=None, n=N_ABL,
                   cluster=(80, 80, 60)):
    d = synthetic_setup(n, h=256, w=256, c=c, seed=seed, cluster=cluster)
    packed = d["packed"]
    if constant:
        packed[..., :c] = np.arange(1, c + 1, dtype=np.float32) * 3.5
    p = d["state"]["particles"]
    th = p["theta"] if theta is None else np.full(n, theta, np.float32)
    t = [torch.as_tensor(v) for v in (packed, d["stencil"], d["scan"],
                                      np.linspace(0.5, 2, c).astype(
                                          np.float32), p["init_px"], th)]
    return (cs.CropMap(t[0]), c, *t[1:5], t[5], 1.0)


def test_full_is_the_plain_tracked_score_bit_for_bit():
    args = _ablation_args()
    want = cs.score_tracked_plain(args[0].packed, *args[1:])
    for got in (ca.crop_ablate("full", *args),
                ca.crop_ablate_plain("full", *args)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_no_fold_equals_full_when_every_tile_has_one_group():
    one = _ablation_args(theta=0.3)
    full = ca.crop_ablate("full", *one)
    for g, w in zip(ca.crop_ablate("no_fold", *one), full):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
    spread = _ablation_args()
    assert not torch.allclose(ca.crop_ablate("no_fold", *spread)[0],
                              ca.crop_ablate("full", *spread)[0])


def test_no_gather_and_gather_only_on_a_constant_map():
    """On a map constant per class, every pixel known, and windows inside
    it: no_gather scores as full, and gather_only counts the distinct
    pixels (norm = npix, cost = npix sum_c value_c)."""
    args = _ablation_args(constant=True)
    npix = int(cs.fold_offsets(cs.crop_offsets(args[2], 1.0)[None])[1][0])
    for g, w in zip(ca.crop_ablate("no_gather", *args),
                    ca.crop_ablate("full", *args)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
    cost, norm, kf = ca.crop_ablate("gather_only", *args)
    assert torch.all(norm == npix)
    torch.testing.assert_close(cost, torch.full_like(cost, npix * 21.0),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(kf, norm * np.float32(1 / 2500), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("order", ca.ORDERS)
def test_fold_only_writes_its_groups_folded_weights(order):
    """fold_only: the particle at sorted row j (in either row order)
    writes slot j % U of its group's weights (tracked_weights)."""
    maps, c, sten, scan, cw, ctr, theta, f = _ablation_args()
    cost, norm, kf = ca.crop_ablate("fold_only", maps, c, sten, scan, cw,
                                    ctr, theta, f, order=order)
    pix, npix, order_, seg = cs.fold_offsets(cs.crop_offsets(sten, f)[None])
    w = cs.tracked_weights(scan, cw, order_, seg)[0]
    shift = cs.rotation_shift(theta, scan.shape[1])
    perm = ca.ablation_rows(order, shift, cs.crop_centers(ctr, 1.0),
                            scan.shape[1], 256)[1]
    if order == "key":
        assert torch.equal(perm, cs.tracked_rows(shift)[1])
    u_count = int(npix[0])
    for j in (0, 1, 63, 64, 1000, N_ABL - 1):
        p = int(perm[j])
        ws = w[int(shift[p]), j % u_count].double()
        assert abs(float(cost[p]) - float(ws[0])) <= 1e-6 * float(ws[0])
        assert abs(float(norm[p]) - float(ws[c])) <= 1e-6 * float(ws[c])
        assert kf[p] == np.float32(ws[c + 1] * np.float32(1 / 2500))


def test_checked_is_full_and_full_holds_in_both_row_orders():
    """K3's plain versions: `checked` is `full` bit for bit, and `full`
    gives the same bits with its rows in position order and in key
    order; the order-bound variants (no_fold, fold_only) differ between
    the orders only in which block a row lands in, and no_gather does
    not depend on the order."""
    args = _ablation_args()
    full = ca.crop_ablate_plain("full", *args)
    for order in ca.ORDERS:
        for variant in ("full", "checked"):
            got = ca.crop_ablate_plain(variant, *args, order=order)
            for g, w in zip(got, full):
                assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    for g, w in zip(ca.crop_ablate_plain("no_gather", *args),
                    ca.crop_ablate_plain("no_gather", *args, order="key")):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    pos, key = (ca.crop_ablate_plain("fold_only", *args, order=o)[0]
                for o in ca.ORDERS)
    assert not torch.equal(pos, key)
    assert torch.equal(pos.sort().values, key.sort().values)
    with pytest.raises(ValueError, match="order"):
        ca.crop_ablate_plain("full", *args, order="shift")


def _multi_args(n=N_ABL):
    maps, c, sten, scan, cw, ctr, theta, _ = _ablation_args(n=n,
                                                            cluster=None)
    hyp = (10.0 ** (np.arange(10) / 10.0)).astype(np.float32)
    _, slots, mips = ms.plan_buckets(hyp, 25, 0.5, 10.0)
    levels = tuple(sorted(set(mips)))
    return (ms.build_pyramid_maps(maps.packed, levels), c, sten, scan, cw,
            ctr, theta, torch.as_tensor(np.resize(hyp, n)),
            torch.as_tensor(slots), tuple(levels.index(m) for m in mips), 0.5)


def test_bucket_variants_on_the_multi_tracked_path():
    """The K-bucket case: full is score_tracked_multi_plain bit for bit,
    and every variant keeps its definition's relation to full."""
    args = _multi_args()
    want = ms.score_tracked_multi_plain(*args)
    full = ca.crop_ablate_multi("full", *args)
    for g, w in zip(full, want):
        assert torch.equal(g, w)
    for g, w in zip(ca.crop_ablate_multi_plain("full", *args), want):
        assert torch.equal(g, w)
    for variant in ca.VARIANTS[1:]:
        got = ca.crop_ablate_multi(variant, *args)
        assert all(torch.isfinite(g).all() and g.shape == (N_ABL,)
                   for g in got), variant
    # gather_only's norm counts each particle's known in-map pixels
    norm = ca.crop_ablate_multi("gather_only", *args)[1]
    assert torch.all(norm == norm.round()) and norm.max() > 0


def test_crop_ablate_refuses_an_unknown_variant():
    with pytest.raises(ValueError, match="variant"):
        ca.crop_ablate("no_roll", *_ablation_args(n=64))


# -- K4 -------------------------------------------------------------------------
N_INIT = 512  # particles of the theta-search ablation's clouds


def _init_args(c=3, constant=False, n=N_INIT, cluster=(80, 80, 60),
               seed=0):
    """score_init_sel's arguments on a 256^2 map: a cloud of n particles
    (cluster None: spread over the map, windows across its edges)."""
    maps, c, sten, scan, cw, ctr, _, f = _ablation_args(
        seed=seed, c=c, constant=constant, n=n, cluster=cluster)
    return (maps, c, sten, scan, cw, ctr, f)


def _init_multi_args(n=N_INIT):
    args = _multi_args(n)
    return args[:6] + args[7:]  # score_init_multi_sel's: no theta


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("multi", [False, True])
def test_init_full_is_the_plain_theta_search_bit_for_bit(multi, raw):
    """full is the production plain version, argmin and raw rows, uniform
    and K-bucket, through the wrapper and through its plain version."""
    if multi:
        args = _init_multi_args()
        want = (ms.score_init_multi_raw_plain if raw
                else ms.score_init_multi_sel_plain)(*args)
        fns = (ca.crop_ablate_multi_init, ca.crop_ablate_multi_init_plain)
    else:
        args = _init_args(cluster=None)
        maps, rest = args[0], args[1:]
        want = (cs.score_init_raw_plain if raw
                else cs.score_init_sel_plain)(maps.packed, *rest)
        fns = (ca.crop_ablate_init, ca.crop_ablate_init_plain)
    for fn in fns:
        _same(fn("full", *args, raw=raw), want)


def test_init_full_plain_holds_the_jax_theta_search(float_world):
    """On test_torch_crop_score's float-centre world, full's plain version
    selects against JAX's score_init_sel_mo (interpret mode) within the
    JAX crop kernel's bounds (tests/test_pallas_interpret.py's _check)."""
    packed, scan, centers, _, ref = float_world
    args = [torch.as_tensor(a) for a in (packed, tcs.STENCIL, scan, tcs.CW,
                                         centers)]
    best, k, kf = ca.crop_ablate_init_plain(
        "full", cs.CropMap(args[0]), tcs.C, *args[1:], tcs.F)
    rbest, rtheta, rkf = ref["sel"]
    finite = rbest < cs.FLT_MAX
    np.testing.assert_array_equal(best.numpy() < cs.FLT_MAX, finite)
    _check(rbest[finite], best.numpy()[finite], rkf[finite],
           kf.numpy()[finite], "full plain best")
    theta = k.numpy().astype(np.float32) * np.float32(2 * np.pi / 40)
    assert np.mean(np.isclose(theta, rtheta)[finite]) > 0.9


def _windows(args):
    """(each particle's window rows (n, P*CP) float32, M (P*CP, 88)) of a
    uniform case, gathered pixel by pixel in numpy."""
    maps, c, sten, scan, cw, ctr, f = args
    pix, npix, order, seg = cs.fold_offsets(cs.crop_offsets(sten, f)[None])
    m = cs.init_m(scan, cw, order, seg)[0]
    compact = cs.compact_map(maps.packed, c).numpy()
    h, w, cp = compact.shape
    cyx = cs.crop_centers(ctr, 1.0).numpy()
    a = np.zeros((len(cyx), pix.shape[1], cp), np.float32)
    for q, (dy, dx) in enumerate(pix[0, :int(npix[0])].tolist()):
        y, x = cyx[:, 0] + dy, cyx[:, 1] + dx
        ok = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        a[ok, q] = compact[y[ok], x[ok]]
    return torch.as_tensor(a.reshape(len(cyx), -1)), m


def _raw_rows(acc, tr=2500):
    return (acc[:, 0:80:2].float(), acc[:, 1:80:2].float(),
            acc[:, cs.KF_COL].float() * float(np.float32(1) / np.float32(tr)))


def test_init_one_plane_is_the_hi_plane_product():
    """one_plane's rows are bf16(window) @ bf16(M) with the production
    epilogue, and differ from full's on a random map."""
    args = _init_args(cluster=None)
    a, m = _windows(args)
    want = _raw_rows(a.to(torch.bfloat16).double()
                     @ m.to(torch.bfloat16).double())
    got = ca.crop_ablate_init("one_plane", *args, raw=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
    best, k, kf = ca.crop_ablate_init("one_plane", *args)
    wbest, wk = cs.select_best(*want)
    assert torch.equal(k, wk) and torch.equal(kf, want[2])
    torch.testing.assert_close(best, wbest, rtol=1e-6, atol=0)
    full = ca.crop_ablate_init("full", *args, raw=True)
    ok = full[2] >= 0.5
    rel = ((got[0] - full[0]).abs() / full[0].abs())[ok]
    assert rel.max() > 1e-4  # one bf16 plane keeps ~2^-9, not 2^-16


def test_init_no_gather_and_gather_only_on_a_constant_map():
    """On a map constant per class, every pixel known, and windows inside
    it: no_gather scores as full, and gather_only sums the bf16 values of
    the quarter of each window's rows a column's threads hold: column n
    gets rows r with (r % 8) // 2 == (n % 8) // 2, i.e. at CP = 4 the
    even (t = 0, 1) or odd (t = 2, 3) pixels' channels 2t % 4 and
    2t % 4 + 1."""
    args = _init_args(constant=True)
    for g, w in zip(ca.crop_ablate_init("no_gather", *args, raw=True),
                    ca.crop_ablate_init("full", *args, raw=True)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
    npix = int(cs.fold_offsets(cs.crop_offsets(args[2], 1.0)[None])[1][0])
    value = [3.5, 7.0, 10.5, 1.0]  # the classes' distances, known
    pixels = [(npix + 1) // 2, (npix + 1) // 2, npix // 2, npix // 2]
    quad = [pixels[t] * (value[2 * t % 4] + value[2 * t % 4 + 1])
            for t in range(4)]
    nums, dens, kf = ca.crop_ablate_init("gather_only", *args, raw=True)
    want = torch.tensor([quad[k % 4] for k in range(40)])
    assert torch.equal(nums, want.expand_as(nums))
    assert torch.equal(dens, want.expand_as(dens))  # exact in bf16: lo = 0
    assert torch.equal(kf, torch.full_like(kf, quad[0]) * float(
        np.float32(1) / np.float32(2500)))


def test_init_ring_only_sums_each_chunks_first_pixel():
    """ring_only: every row of a bucket holds the sum of |dy| (even
    columns) and |dx| (odd) over the first pixel of each of M's chunks of
    K_CHUNK / CP pixels; argmin rows tie at k = 0."""
    args = _init_args()
    pix, npix = cs.fold_offsets(cs.crop_offsets(args[2], 1.0)[None])[:2]
    firsts = np.asarray(pix[0, :int(npix[0])])[::cs.K_CHUNK // 4]
    dy, dx = np.abs(firsts).sum(0).astype(np.float32)
    nums, dens, kf = ca.crop_ablate_init("ring_only", *args, raw=True)
    assert torch.all(nums == dy) and torch.all(dens == dx)
    best, k, _ = ca.crop_ablate_init("ring_only", *args)
    assert torch.all(k == 0) and torch.all(best == np.float32(dy / dx))


@pytest.mark.parametrize("multi", [False, True])
def test_init_no_promote_plain_equals_full_within_summation_order(multi):
    """no_promote's plain version (window @ M in float64) against full's
    (the production plain version, float32 circulant products)."""
    if multi:
        args, fn = _init_multi_args(), ca.crop_ablate_multi_init_plain
    else:
        args, fn = _init_args(cluster=None), ca.crop_ablate_init_plain
    got, want = fn("no_promote", *args, raw=True), fn("full", *args, raw=True)
    assert torch.equal(got[2], want[2])
    ok = want[2] >= 0.5
    assert ok.sum() > N_INIT // 2
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g[ok], w[ok], rtol=1e-5, atol=0)


def _defined_acc(variant, a, m, centre, firsts):
    """acc (n, 88) float64 of a theta-search variant by its definition
    (crop_ablate's module docstring), in numpy: a (n, P*CP) float32 the
    windows, m (P*CP, 88) float32 M, centre (n, CP) the centre pixel's
    channels, firsts (chunks, 2) the first pixel of each of M's chunks."""
    def bf16(x):
        return torch.as_tensor(x).to(torch.bfloat16).double().numpy()

    cols = np.arange(cs.M_COLS)
    if variant == "ring_only":
        dy, dx = np.abs(firsts).sum(0)
        return np.tile(np.where(cols % 2 == 0, dy, dx), (len(a), 1)) * 1.0
    if variant == "one_plane":
        return bf16(a) @ bf16(m)
    if variant == "gather_only":
        hi = bf16(a)
        lo = bf16(a - hi.astype(np.float32))
        quad = (np.arange(a.shape[1]) % 8) // 2
        even, odd = (np.stack([x[:, quad == q].sum(1) for q in range(4)], 1)
                     for x in (hi, hi + lo))
        q = (cols % 8) // 2
        return np.where(cols % 2 == 0, even[:, q], odd[:, q])
    if variant == "no_gather":
        a = np.tile(centre, m.shape[0] // centre.shape[1])
    return a.astype(np.float64) @ m.astype(np.float64)


def test_bucket_init_variants_follow_their_definitions():
    """The K-bucket case: each variant's raw rows are its definition
    (_defined_acc) on each bucket's windows, gathered pixel by pixel from
    the bucket's level in numpy (full's within float32 summation order
    where kf >= 0.5), and its argmin rows the production epilogue's
    (select_best) on them."""
    args = _init_multi_args()
    pyr, c, sten, scan, cw, ctr_px, scale, slots, bmi, res = args
    bucket, off, ctr, table = ms._prepare(pyr, sten, ctr_px, scale, slots,
                                          bmi, res, 1.0)
    pix, npix, order, seg = cs.fold_offsets(off)
    m = cs.init_m(scan, cw, order, seg).numpy()
    compact = cs.compact_map(pyr.flat, c).numpy()
    cp = compact.shape[1]
    bucket, ctr, table = bucket.numpy(), ctr.numpy(), table.numpy()
    inv_tr = np.float32(1) / np.float32(scan.shape[1] * scan.shape[2])
    assert len(set(bucket.tolist())) > 1
    for variant in ca.INIT_VARIANTS:
        got = ca.crop_ablate_multi_init(variant, *args, raw=True)
        for b, (base, h, w, _) in enumerate(table.tolist()):
            rows = np.flatnonzero(bucket == b)
            if not len(rows):
                continue
            cy, cx = ctr[rows, 0], ctr[rows, 1]
            p = pix[b, :int(npix[b])].numpy()
            a = np.zeros((len(rows), pix.shape[1], cp), np.float32)
            for q, (dy, dx) in enumerate(p.tolist()):
                y, x = cy + dy, cx + dx
                ok = (y >= 0) & (y < h) & (x >= 0) & (x < w)
                a[ok, q] = compact[base + y[ok] * w + x[ok]]
            centre = compact[base + np.clip(cy, 0, h - 1) * w
                             + np.clip(cx, 0, w - 1)]
            per = cs.K_CHUNK // cp
            firsts = p[:-(-len(p) * cp // cs.K_CHUNK) * per:per]
            acc = _defined_acc(variant, a.reshape(len(rows), -1), m[b],
                               centre, firsts)
            want = (acc[:, 0:80:2].astype(np.float32),
                    acc[:, 1:80:2].astype(np.float32),
                    acc[:, cs.KF_COL].astype(np.float32) * inv_tr)
            sel = torch.as_tensor(rows)
            np.testing.assert_array_equal(got[2][sel].numpy(), want[2])
            exact = variant in ("full", "checked")  # the production's
            ok = want[2] >= 0.5 if exact else np.ones(len(rows), bool)
            for g, w_ in zip(got[:2], want[:2]):
                np.testing.assert_allclose(
                    g[sel].numpy()[ok], w_[ok],
                    rtol=1e-5 if exact else 1e-6, atol=0,
                    err_msg=f"{variant}, bucket {b}")
        if variant not in ("full", "checked"):
            _same(ca.crop_ablate_multi_init(variant, *args),
                  (*cs.select_best(*got), got[2]))


@pytest.mark.parametrize("multi", [False, True])
def test_init_checked_is_full_in_both_row_orders(multi):
    """K4's CPU cases in both row orders: `checked` and `full` are the
    production plain version bit for bit, argmin and raw rows, in
    position order and in the particles' order, and every other variant's
    rows do not depend on the order."""
    if multi:
        args = _init_multi_args(n=256)
        fn = ca.crop_ablate_multi_init
        prod = (ms.score_init_multi_sel_plain, ms.score_init_multi_raw_plain)
        want = tuple(p(*args) for p in prod)
    else:
        args = _init_args(n=256, cluster=None)
        fn = ca.crop_ablate_init
        want = (cs.score_init_sel_plain(args[0].packed, *args[1:]),
                cs.score_init_raw_plain(args[0].packed, *args[1:]))
    for order in ca.INIT_ORDERS:
        for variant in ("full", "checked"):
            _same(fn(variant, *args, order=order), want[0])
            _same(fn(variant, *args, raw=True, order=order), want[1])
    for variant in ca.INIT_VARIANTS:
        _same(fn(variant, *args, raw=True, order="particles"),
              fn(variant, *args, raw=True))
    with pytest.raises(ValueError, match="order"):
        fn("full", *args, order="key")


@pytest.mark.parametrize("multi", [False, True])
def test_init_ablation_rows_in_the_particles_order(multi):
    """init_ablation_rows: position order leaves init_inputs' rows as
    they are; the particles' order is the identity at a uniform scale and
    multiscale.bucket_rows over K buckets, each bucket keeping its rows
    (row_start) and every row its particle."""
    if multi:
        pyr, c, sten, scan, cw, ctr, scale, slots, bmi, res = \
            _init_multi_args(n=256)
        inputs = ms.init_inputs(pyr, c, sten, scan, cw, ctr, scale, slots,
                                bmi, res)
        bucket = ms._prepare(pyr, sten, ctr, scale, slots, bmi, res, 1.0)[0]
        want = ms.bucket_rows(bucket, len(bmi))[0]
    else:
        inputs = cs.init_inputs(*_init_args(n=256, cluster=None))
        want = torch.arange(256, dtype=torch.int32)
    assert ca.init_ablation_rows("position", inputs) is inputs
    other = ca.init_ablation_rows("particles", inputs)
    assert other[:9] == inputs[:9] and other[11:] == inputs[11:]
    assert torch.equal(other[9], want) and other[9].dtype == torch.int32
    assert not torch.equal(other[9], inputs[9])
    assert torch.equal(other[10], inputs[10])


def test_init_ablation_refuses_unknown_variants_and_classes():
    args = _init_args(n=64)
    with pytest.raises(ValueError, match="variant"):
        ca.crop_ablate_init("no_roll", *args)
    for c in (1, 7):
        a = _init_args(c=c, n=64)
        with pytest.raises(ValueError, match="built for C"):
            ca.crop_ablate_init("full", *a)
    with pytest.raises(ValueError, match="built for C"):
        ca.crop_ablate_multi_init_plain("one_plane",
                                        *_init_args(c=1, n=64)[:6],
                                        None, None, (0,), 0.5)


def test_kernel_ms_reports_a_second_profile(monkeypatch, capsys):
    """A profile whose device trace comes back empty is taken again, and
    kernel_ms says it took two."""
    from torch.autograd import DeviceType

    class Event:
        device_type, key, count = DeviceType.CUDA, "probe_mm_s8", 4
        self_device_time_total = 8.0  # us over the 4 launches

    class Profile:
        runs = 0

        def __init__(self, **kw):
            pass

        def __enter__(self):
            Profile.runs += 1
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [] if Profile.runs == 1 else [Event()]

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    ms_, tries = probes.kernel_ms(lambda: calls.append(1), "probe_mm",
                                  runs=4)
    assert (ms_, tries) == (2.0 / 1e3, 2)
    assert len(calls) == 3 + 4 + 4
    assert "profile 1 saw no launch" in capsys.readouterr().err


# -- the probe path on the CPU -------------------------------------------------
def test_probe_path_checks_on_the_cpu():
    """probes.__main__'s functions at small sizes on the CPU: every check
    holds and no time is measured."""
    recs = (probes.window_parity(CPU, 0)
            + probes.window_rates(CPU, 0, N_WIN, 256, "small")
            + probes.run_mm(CPU, 0, 256)
            + probes.run_ablate(CPU, 0, 512))
    # K3: three cases, each variant with its rows in each order
    assert len(recs) == 6 + 6 + 7 + 3 * len(ca.VARIANTS) * len(ca.ORDERS)
    assert len(ca.VARIANTS) * len(ca.ORDERS) == 12
    assert all(r.get("kernel_ms") is None for r in recs)
    assert {r["replaces"].split(":")[0] for r in recs} == {
        f"tests/{f}.py" for f in (
            "probe_dma_unaligned", "probe_dma_align", "probe_dma2",
            "probe_dma_fold", "probe_int8", "probe_int8_mm",
            "exp_crop_ablate")}


def test_theta_search_ablation_checks_on_the_cpu():
    """probes.run_ablate_init's cases at 256 particles on the CPU: 3 cases
    times 7 variants times 2 row orders, every check holds, no time is
    measured."""
    recs = probes.run_ablate_init(CPU, 0, 256)
    nv = len(ca.INIT_VARIANTS)
    assert [r["probe"] for r in recs[:2 * nv]] == [
        f"ablate_init/spread C=3/{v}" for v in ca.INIT_VARIANTS] + [
        f"ablate_init/spread C=3/{v} particles" for v in ca.INIT_VARIANTS]
    assert [r["order"] for r in recs[:2 * nv]] == list(np.repeat(
        ca.INIT_ORDERS, nv))
    assert len(recs) == 42 and {r["buckets"] for r in recs} == {1, 12}
    assert all(r["kernel_ms"] is None and r["profile_tries"] is None
               and r["replaces"] == "tests/exp_crop_ablate.py:39"
               and r["bound_ms"] > 0 for r in recs)
    by = {r["probe"].split("/")[-1]: r for r in recs[:nv]}
    assert by["one_plane"]["ops"] * 3 == pytest.approx(by["full"]["ops"])
    assert by["checked"]["ops"] == by["full"]["ops"]
    assert by["gather_only"]["bound_by"] == "bytes"
    assert by["ring_only"]["ops"] == 0.0
    # the bound is the function's bytes for every variant; what gather_only
    # and ring_only re-read from L2 stands beside it
    assert {r["bytes"] for r in by.values()} == {by["full"]["bytes"]}
    assert (by["full"]["l2_bytes"] == by["gather_only"]["l2_bytes"]
            > by["no_gather"]["l2_bytes"] == by["ring_only"]["l2_bytes"] > 0)


def test_probe_command_prints_one_json_line_a_probe():
    out = io.StringIO()
    with redirect_stdout(out):
        assert probes.main(["mm", "--device", "cpu", "--n", "64"]) == 0
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert [r["probe"] for r in lines] == [
        "int8_mm", "dma2_select", "int8_convert_mm", "int8_convert_mm/bf16",
        "theta_shape/s8", "theta_shape/s8_to_bf16", "theta_shape/bf16"]
    assert all(r["card"] == "cpu" for r in lines)
    assert [(r["route"], r["split_k"] > 1) for r in lines] == [
        ("wgmma", True), ("mma_sync", False), ("wgmma", True),
        ("wgmma", True)] + [("wgmma", True)] * 3  # --n 64: one tile
