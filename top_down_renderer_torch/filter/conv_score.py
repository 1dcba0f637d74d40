"""Convolutional grid scoring: the clustered-particle fast path
(counterpart of filter/conv_score.py).

After convergence the cloud occupies a small region of the map.  There,
evaluating the cost at every integer centre of the region is cheaper than
per-particle work: the stencil folded through the circulant columns of the
scan is a convolution kernel K, and

    field[s, y, x] = sum_{c, dy, dx} K[s, c, dy, dx] * map[c, y + dy, x + dx]

is one convolution over the region (output channels: the costs at the
shifts, their norms, the known count).  Each particle then reads its row
of the field at its rounded centre.  The samples are those of the crop
path: nearest neighbour at round(centre / map_resolution) +
round(offset * f).

The reference runs this on XLA (conv_general_dilated, or an im2col
matmul), not in a Pallas kernel, so the port runs it on cuDNN through
torch.nn.functional.conv2d.  Its arithmetic follows the reference's:
both operands rounded to bf16, products and sums in float32.  The map is
the compact one (the C + 1 channels the score reads, crop_score.
compact_map) with a MAP_PAD border of zeros, rounded to bf16 and kept
in float32; the kernel's taps are bf16 values kept in float32.  The
convolution runs in float32 with TF32 off, so each product of two bf16
values is exact and only the order of the float32 sums differs from the
reference's.  A bf16 convolution would round every output to 8 bits.

The int8 field (TDR_CONV_INT8=1, the filter's conv_int8; the reference's
cost_field_s2d_split_i8): a different function, within about 1e-3 of the
float field.  The map is quantized per channel to int8 codes
(quantize_channels, 126 / amax) and each column of the kernel, times the
map's qinv per channel, to a hi/lo pair of int8 integers with scales of
its own (quantize_conv_kernel); the field is the exact int32 product,
dequantized in float32.  On the card the scorer's conv_field_i8 makes two
launches of csrc/conv_field_i8.cu: the quantizer kernel (quantize_i8: the
integers in the layout the field kernel reads, i8_layout's) and the field
kernel (an implicit GEMM on wgmma fed by TMA); on the CPU their plain
versions.  cost_field_i8 takes integers quantized before, on the CPU (the
JAX-parity tests' way in); launch_field_i8 is the field kernel alone, on
operands already laid out.  The scorer takes the int8 field where the
reference does: the tracked flavour with (2 W) % 32 == 0 and the kernel
under the reference's s2d gate; the init flavour, the full window of
mixed updates and large kernels keep the float field.

CALLS counts the cost fields computed ("cost_field" on cuDNN,
"cost_field_i8" the int8 ones); kernels.LAUNCHES["conv_quant_i8"] and
["conv_field_i8"] count the int8 kernels' launches.

The reference's space-to-depth fold and its kf split are layouts for the
TPU's 128-lane tiling (ROADMAP, "Not to port"): the port runs the direct
formulation of both fields, whose sums they only reorder (the int8 one's
exactly).
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from top_down_renderer_torch import kernels
from top_down_renderer_torch.filter.crop_score import (
    channel_pad,
    crop_offsets,
    int8_qinv,
)
from top_down_renderer_torch.kernels import ptr
from top_down_renderer_torch.filter.scoring import (
    circulants_at_shifts,
    rotation_shift,
    search_shifts,
)

# output-region buckets (cost-field height and width in px)
REGION_BUCKETS = (64, 128, 192, 256)
MAP_PAD = 64  # the reference's zero border around the map (MAP_PAD)

CALLS = {"cost_field": 0, "cost_field_i8": 0}

# The reference's gate between its space-to-depth conv and its direct one
# (top_down_renderer_tpu/filter/conv_score.py F_S2D, K4_MAX_BYTES,
# s2d_extent).  The port runs the direct conv only; the multi-device
# dispatch reads the gate to plan what the reference plans there.
F_S2D = 4
K4_MAX_BYTES = 256 * 2**20


def conv_dims(mo: int):
    """Kernel extent (rows, cols) for max stencil offset mo: the conv
    slides at 1 px, so it needs no alignment margin."""
    d = 2 * mo + 2
    return d, d


def s2d_gate(mo: int, s_out: int) -> bool:
    """True where the reference would run its folded (s2d) conv: its
    folded kernel of s_out columns at bucket mo fits K4_MAX_BYTES."""
    dr, dc = conv_dims(mo)
    ext = lambda d: (d + 2) // F_S2D + 1  # noqa: E731 - the folded extent
    return 16 * s_out * ext(dr) * ext(dc) * 128 * 2 <= K4_MAX_BYTES


def pick_region(extent: int) -> int | None:
    """The smallest region bucket covering `extent` px, or None."""
    for b in REGION_BUCKETS:
        if extent <= b:
            return b
    return None


def _windowed_cost_norm(scan, class_weights, s0, ww):
    """Cost and norm circulant columns (Th*R*C, ww), (Th*R, ww) of the
    consecutive circular shift window [s0, s0 + ww)."""
    th = scan.shape[1]
    shifts = (s0 + torch.arange(ww, device=scan.device)) % th
    return circulants_at_shifts(scan, class_weights, shifts)


def _searched_cost_norm(scan, class_weights, num_rot):
    """Cost and norm circulant columns at the num_rot search shifts
    (scoring.search_shifts: the compiled reference step's tie rounding)."""
    th = scan.shape[1]
    return circulants_at_shifts(
        scan, class_weights, search_shifts(th, num_rot, scan.device)
    )


def build_conv_kernel(
    scan: torch.Tensor,
    class_weights: torch.Tensor,
    stencil: torch.Tensor,
    f,
    mo: int,
    mode: str,
    num_rot: int = 40,
    window_w: int = 100,
    s0=0,
) -> torch.Tensor:
    """(S_out, CP, dr, dc) float32 conv kernel (OIHW) of bf16 values.

    tracked: the circular shift window [s0, s0 + window_w), S_out =
      2 window_w + 1: [0, W) costs | [W, 2W) norms | [2W] kf count.
    init: the num_rot search shifts, S_out = 2 num_rot + 1, alike.
    Channels < C carry the cost columns, channel C (the known indicator)
    the norms and the count.  Each stencil cell's coefficients are rounded
    to bf16 and added onto its tap (round(offset * f) + the kernel's
    centre) in float64, an order-free and exact sum, then rounded to bf16:
    the reference's one-hot product, whose float32 sums of a few bf16
    values are exact too."""
    c, th, r = scan.shape
    tr = th * r
    cp = channel_pad(c)
    dr, dc = conv_dims(mo)
    off = crop_offsets(stencil, f).long()
    tap = (off[:, 0] + dr // 2) * dc + (off[:, 1] + dc // 2)
    if mode == "tracked":
        cost, norm = _windowed_cost_norm(scan, class_weights, s0, window_w)
    else:
        cost, norm = _searched_cost_norm(scan, class_weights, num_rot)
    n = cost.shape[1]
    s_out = 2 * n + 1
    feat = torch.cat([cost.reshape(tr, c * n), norm,
                      torch.ones((tr, 1), device=scan.device)], 1)
    acc = torch.zeros((dr * dc, feat.shape[1]), dtype=torch.float64,
                      device=scan.device)
    acc.index_add_(0, tap, feat.to(torch.bfloat16).double())
    k = torch.zeros((dr * dc, cp, s_out), dtype=torch.float32,
                    device=scan.device)
    k[:, :c, :n] = acc[:, : c * n].view(-1, c, n)
    k[:, c, n : 2 * n] = acc[:, c * n : c * n + n]
    k[:, c, 2 * n] = acc[:, -1]
    k = k.to(torch.bfloat16).to(torch.float32)
    return k.permute(2, 1, 0).reshape(s_out, cp, dr, dc).contiguous()


class ConvMap:
    """The conv path's map operand: the compact map (H, W, CP)
    (crop_score.compact_map) with a border of `pad` zeros, rounded to bf16
    and kept in float32, laid out (1, CP, hp, wp).  hp = H + 2 pad and
    wp = W + 2 pad, as the reference's padded map.

    int8: also the int8 field's operand, `codes` (hp, wp, CP) int8 (a
    pixel's channels contiguous) with the same border, quantized from the
    float32 map by quantize_channels, and their `qinv` (CP,); else both
    are None.  codes is a view of rows padded with zeros to whole 16-byte
    groups (the card kernel's TMA strides)."""

    def __init__(self, compact: torch.Tensor, pad: int = MAP_PAD,
                 int8: bool = False):
        h, w = compact.shape[:2]
        self.padded = F.pad(
            compact.permute(2, 0, 1), (pad, pad, pad, pad)
        ).to(torch.bfloat16).to(torch.float32)[None].contiguous()
        self.hp, self.wp, self.pad = h + 2 * pad, w + 2 * pad, pad
        self.codes = self.qinv = None
        if int8:
            codes, self.qinv = quantize_channels(compact)
            cp = codes.shape[-1]
            # the card kernel stages windows by TMA, whose row strides are
            # whole 16-byte groups: the rows are stored that wide, zeros
            # past wp, and codes is the (hp, wp, CP) view
            wide = -(-self.wp * cp // 16) * 16 // cp
            store = torch.zeros((self.hp, wide, cp), dtype=torch.int8,
                                device=codes.device)
            store[pad : pad + h, pad : pad + w] = codes
            self.codes = store[:, : self.wp]


def cost_field(
    padded: torch.Tensor,
    kernel: torch.Tensor,
    origin_yx: torch.Tensor,
    mo: int,
    region: int,
    rows=None,
) -> torch.Tensor:
    """The cost field over a (region, region) block of centres whose
    top-left centre is origin_yx (padded coordinates, a (2,) integer
    tensor: the block is cut on the device, with no host read).  Returns
    (S_out, region, region) float32: field[:, y, x] belongs to the centre
    at padded (origin_y + y, origin_x + x).  rows = (r0, nr) computes only
    the field's rows [r0, r0 + nr), (S_out, nr, region): one rank's share
    of a row-sharded field (parallel/sharding.py); rows past the padded
    map read its last row, for the caller to drop.  cuDNN runs it in
    float32, TF32 off, with a deterministic algorithm."""
    dr, dc = conv_dims(mo)
    dev = padded.device
    r0, nr = (0, region) if rows is None else rows
    ys = origin_yx[0] - dr // 2 + torch.arange(r0, r0 + nr + dr - 1,
                                               device=dev)
    if rows is not None:
        ys = ys.clamp(max=padded.shape[2] - 1)
    xs = origin_yx[1] - dc // 2 + torch.arange(region + dc - 1, device=dev)
    block = padded.index_select(2, ys).index_select(3, xs)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        out = F.conv2d(block, kernel)
    CALLS["cost_field"] += 1
    return out[0]


# -- the int8 field (TDR_CONV_INT8=1) -------------------------------------
# XLA folds the reference's divisions by the constants 127 and 127 * 254
# into products by their float32 reciprocals
_HI_RECIP = float(np.float32(1.0) / np.float32(127.0))
_LO_RECIP = float(np.float32(1.0) / np.float32(127.0 * 254.0))
# S_out -> (groups, width): the 2 S_out integer columns of W 16, 32 and 64
# in as few groups as wgmma's widest int8 product (N 256) allows, each
# padded to the least N it takes for .s8 (8, 16, 24, then multiples of
# 16): 66 columns one group of 80, 130 one of 144, 258 two of 144.  The
# card kernel has instances of these widths only.
I8_COLUMNS = {33: (1, 80), 65: (1, 144), 129: (2, 144)}
I8_TILE = (8, 16)  # centre rows and columns a block of the card kernel


def conv_int8() -> bool:
    """TDR_CONV_INT8=1: the tracked conv field in int8 (cost_field_i8)
    where the reference takes its int8 field; default 0, the float32 field.
    Only the filter reads it, once, where its conv_int8 is None."""
    return os.environ.get("TDR_CONV_INT8", "0") == "1"


def quantize_channels(packed: torch.Tensor):
    """(..., K) float32 -> (codes (..., K) int8, qinv (K,) float32): the
    JAX package's quantize_channels (pallas_score.py) in the same float32
    operations: per channel amax = max(max |v|, 1e-6), codes clip(round(v
    (126 / amax)), -127, 127) (half to even; 126 / amax an IEEE
    division), qinv = amax / 126 (crop_score.int8_qinv)."""
    p32 = packed.to(torch.float32)
    amax = torch.clamp(p32.reshape(-1, p32.shape[-1]).abs().amax(0),
                       min=1e-6)
    q = torch.full((), 126.0, device=p32.device) / amax
    codes = torch.clamp(torch.round(p32 * q), -127.0, 127.0).to(torch.int8)
    return codes, int8_qinv(p32)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a b + c of float32 tensors (broadcast) rounded once to float32, as a
    fused multiply-add: the product is exact in float64, the sum's
    rounding error is recovered (two-sum) and, where it is not zero, kept
    as the last bit of the float64 sum (round to odd), so that rounding
    that sum to float32 rounds the exact value."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    v = s - p
    e = (p - (s - v)) + (c - v)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, float("inf")), e)
    return torch.where((e != 0) & even, torch.nextafter(s, toward), s).float()


def quantize_conv_kernel(kernel: torch.Tensor, qinv: torch.Tensor):
    """The int8 field's integers and scales of an (S_out, CP, dr, dc)
    kernel (build_conv_kernel's), as the compiled reference's
    cost_field_s2d_split_i8 computes them, each output column s (the W
    costs, the W norms, the kf column) on its own: kq = kernel qinv[c];
    amax = max(max |kq|, 1e-30); s_hi = amax f32(1/127); hi = clip(round(kq
    / s_hi), -127, 127) (an IEEE division, half to even); s_lo = amax
    f32(1/32258); lo = clip(round(fma(kernel, qinv, -hi s_hi) / s_lo),
    -127, 127).  XLA turns the reference's divisions by 127 and (then) 254
    into products by these constant reciprocals, and contracts kq - hi s_hi
    into an FMA of the unrounded kq (tests/test_torch_conv_int8.py).
    Returns (ints (S_out, 2, CP, dr, dc) int8: hi, lo; scales (S_out, 2)
    float32: s_hi, s_lo)."""
    qv = qinv[: kernel.shape[1]].view(1, -1, 1, 1)
    kq = kernel * qv
    amax = torch.clamp(kq.abs().amax((1, 2, 3)), min=1e-30)
    s_hi, s_lo = amax * _HI_RECIP, amax * _LO_RECIP
    hi = torch.clamp(torch.round(kq / s_hi.view(-1, 1, 1, 1)), -127.0, 127.0)
    res = fma_f32(kernel, qv, -(hi * s_hi.view(-1, 1, 1, 1)))
    lo = torch.clamp(torch.round(res / s_lo.view(-1, 1, 1, 1)), -127.0, 127.0)
    return (torch.stack([hi, lo], 1).to(torch.int8),
            torch.stack([s_hi, s_lo], 1))


def i8_dcp(dc: int, cp: int) -> int:
    """The int8 kernel's tap columns: dc rounded up to 32 / CP, so that a
    k32 slice of a tap row is whole pixels."""
    step = 32 // cp
    return -(-dc // step) * step


def i8_columns(s_out: int):
    """(groups, width) of I8_COLUMNS; S_out other than W 16, 32 or 64's
    raises."""
    if s_out not in I8_COLUMNS:
        raise ValueError(f"{2 * s_out} columns: the int8 layout takes W 16, "
                         "32 or 64 (S_out 33, 65, 129)")
    return I8_COLUMNS[s_out]


def i8_window(dr: int, dcp: int, cp: int):
    """The card kernel's window box: (rows, 16-byte groups a row).  A block
    of I8_TILE centres reads I8_TILE[0] + dr - 1 rows of I8_TILE[1] + dcp -
    1 pixels, staged from the 16-byte group at or below its first pixel, so
    up to 15 bytes more: one group to spare."""
    return (I8_TILE[0] + dr - 1,
            ((I8_TILE[1] + dcp - 1) * cp + 15) // 16 + 1)


def i8_layout(ints: torch.Tensor):
    """The plain version of the layout the card kernel's TMA reads (the
    quantizer kernel writes it): the integers (S_out, 2, CP, dr, dc) as B
    (groups, chunks, width, 32) int8, i8_columns' groups of columns n = 2 s
    + p (zeros past 2 S_out), each k32 chunk of K = (dy, dx, c) over dx <
    i8_dcp (zeros past dc) a run of `width` rows of 32 bytes (K-major:
    B[group, chunk, n, b] the integer of column n at k = 32 chunk + b); and
    nonzero (groups, chunks) bool, a chunk's flag: one of its integers is
    not zero.  Each row is stored in the 32-byte swizzle that the field
    kernel's wgmma reads (its 16-byte halves swapped where (n >> 2) is
    odd), so that its TMA copies a chunk as it is."""
    s_out, _, cp, dr, dc = ints.shape
    dcp = i8_dcp(dc, cp)
    groups, width = i8_columns(s_out)
    b = torch.zeros((dr, dcp, cp, groups * width), dtype=torch.int8,
                    device=ints.device)
    b[:, :dc, :, : 2 * s_out] = ints.permute(3, 4, 2, 0, 1).reshape(
        dr, dc, cp, 2 * s_out)
    b = b.view(dr * dcp * cp // 32, 32, groups, width).permute(2, 0, 3, 1)
    nonzero = b.ne(0).flatten(2).any(-1)
    odd = (torch.arange(width, device=ints.device) >> 2) & 1 == 1
    b = b.contiguous()
    b[:, :, odd] = b[:, :, odd].roll(16, -1)
    return b, nonzero


def quantize_i8(kernel: torch.Tensor, qinv: torch.Tensor):
    """The int8 field's operands of an (S_out, CP, dr, dc) float32 kernel:
    (B, nonzero, scales) as i8_layout lays out quantize_conv_kernel's
    integers, and its scales.  On CPU tensors those two plain versions; on
    CUDA one allocation, carved into the three and the kernel's scratch
    (a block's column maxima), and one launch of the quantizer kernel of
    csrc/conv_field_i8.cu (counted LAUNCHES["conv_quant_i8"]), with no
    host synchronisation; any other device raises."""
    if not kernels.on_card(kernel.device, "int8 conv quantizer"):
        ints, scales = quantize_conv_kernel(kernel, qinv)
        return (*i8_layout(ints), scales)
    if (kernel.dim() != 4 or kernel.dtype != torch.float32
            or kernel.shape[1] not in (4, 8) or not kernel.is_contiguous()):
        raise ValueError("kernel must be a contiguous (S_out, 4 or 8, dr, "
                         "dc) float32")
    s_out, cp, dr, dc = kernel.shape
    if (qinv.dtype != torch.float32 or qinv.dim() != 1
            or qinv.shape[0] < cp or not qinv.is_contiguous()
            or qinv.device != kernel.device):
        raise ValueError(f"qinv must be a contiguous float32 of >= {cp} "
                         "beside the kernel")
    dcp = i8_dcp(dc, cp)
    groups, width = i8_columns(s_out)
    chunks = dr * dcp * cp // 32
    # one buffer: B (its base, 16-byte aligned, for the field's TMA), the
    # scales, the scratch (width / 2 maxima a block, a block at most a
    # chunk) and the flags
    sizes = (groups * chunks * width * 32, s_out * 8,
             groups * chunks * width * 2, groups * chunks)
    b, scales, partial, nonzero = torch.empty(
        sum(sizes), dtype=torch.uint8, device=kernel.device).split(sizes)
    b = b.view(torch.int8).view(groups, chunks, width, 32)
    scales = scales.view(torch.float32).view(s_out, 2)
    partial = partial.view(torch.float32)
    nonzero = nonzero.view(torch.bool).view(groups, chunks)
    kernels.launch("conv_field_i8", "tdr_conv_quant_i8", ptr(kernel),
                   ptr(qinv), s_out, cp, dr, dc, dcp, groups, width,
                   _HI_RECIP, _LO_RECIP, ptr(partial), partial.numel(),
                   ptr(b), ptr(nonzero), ptr(scales))
    kernels.LAUNCHES["conv_quant_i8"] += 1
    return b, nonzero, scales


@functools.cache
def i8_splits(cp: int, width: int, dr: int, dcp: int, region: int,
              groups: int, device: int) -> int:
    """The blocks (a cluster) a tile of centres of the int8 kernel splits
    its chunks over, on card `device` (tdr_conv_field_i8_splits: as many as
    one wave of the card holds, at most 8), so that a small region still
    keeps every SM busy with several blocks; asked once a shape."""
    splits = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = kernels.load("conv_field_i8").tdr_conv_field_i8_splits(
            cp, width, dr, dcp, region, groups, ctypes.byref(splits))
    if err != 0:
        raise RuntimeError(f"tdr_conv_field_i8_splits: CUDA error {err}")
    return splits.value


def cost_field_i8_plain(codes, ints, scales, origin_yx, mo: int,
                        region: int):
    """The plain version of cost_field_i8: (field (S_out, region, region)
    float32, sums (2 S_out, region, region) int32, row 2 s + p).  The
    block's codes times the integers, one tap row dy at a time as a float64
    product, exact (every partial sum an integer below 2^31), then
    dequantized as the compiled reference does: fma(f32(hi), s_hi, f32(lo)
    s_lo) (fma_f32)."""
    dr, dc = conv_dims(mo)
    dev = codes.device
    s_out, _, cp = ints.shape[:3]
    ys = origin_yx[0] - dr // 2 + torch.arange(region + dr - 1, device=dev)
    xs = origin_yx[1] - dc // 2 + torch.arange(region + dc - 1, device=dev)
    block = codes.index_select(0, ys).index_select(1, xs).double()
    w = ints.double().permute(3, 4, 2, 0, 1).reshape(dr, dc * cp, 2 * s_out)
    acc = torch.zeros((region * region, 2 * s_out), dtype=torch.float64,
                      device=dev)
    for dy in range(dr):
        win = block[dy : dy + region].unfold(1, dc, 1)  # (R, R, CP, dc)
        acc += win.transpose(2, 3).reshape(region * region, dc * cp) @ w[dy]
    sums = acc.to(torch.int32).T.reshape(2 * s_out, region, region)
    hi, lo = sums.view(s_out, 2, region, region).unbind(1)
    field = fma_f32(hi.float(), scales[:, 0, None, None],
                    lo.float() * scales[:, 1, None, None])
    return field, sums.contiguous()


def cost_field_i8(codes, ints, scales, origin_yx, mo: int, region: int,
                  sums: bool = False):
    """The int8 cost field, cost_field's (S_out, region, region) float32
    rows (costs, norms, kf), from the map's codes (ConvMap.codes) and
    integers and scales already quantized (quantize_conv_kernel), over the
    block of centres whose top-left centre is origin_yx ((2,) integer
    tensor): on CPU tensors, the plain version.  On the card the field
    quantizes its kernel itself (conv_field_i8), so CUDA tensors raise, as
    any other device does.  sums=True also returns the int32 sums
    (cost_field_i8_plain's)."""
    if kernels.on_card(codes.device, "int8 conv cost field"):
        raise ValueError("on the card the int8 field quantizes its float "
                         "kernel: conv_field_i8")
    field, acc = cost_field_i8_plain(codes, ints, scales, origin_yx, mo,
                                     region)
    CALLS["cost_field_i8"] += 1
    return (field, acc) if sums else field


def conv_field_i8(codes, qinv, kernel, origin_yx, mo: int, region: int,
                  sums: bool = False, splits=None):
    """cost_field_i8 of the float (S_out, CP, dr, dc) kernel
    (build_conv_kernel's), quantized against the map's qinv: on CPU tensors
    quantize_conv_kernel and the plain field; on CUDA two launches, the
    quantizer kernel (quantize_i8) and the field kernel, with no eager
    quantization or layout and no host synchronisation; any other device
    raises.  sums as cost_field_i8's; splits as launch_field_i8's."""
    if not kernels.on_card(codes.device, "int8 conv cost field"):
        field, acc = cost_field_i8_plain(
            codes, *quantize_conv_kernel(kernel, qinv), origin_yx, mo, region)
    else:
        field, acc = launch_field_i8(codes, *quantize_i8(kernel, qinv),
                                     origin_yx, mo, region, kernel.shape[0],
                                     sums, splits)
    CALLS["cost_field_i8"] += 1
    return (field, acc) if sums else field


def launch_field_i8(codes, b, nonzero, scales, origin_yx, mo: int,
                    region: int, s_out: int, sums: bool = False,
                    splits=None):
    """The field kernel of csrc/conv_field_i8.cu alone, on CUDA tensors, on
    operands laid out as quantize_i8 (or i8_layout) lays them out: (field,
    int32 sums or None); LAUNCHES["conv_field_i8"] counts it.  splits sets
    its split of a tile's chunks over a cluster's blocks (i8_splits where
    None)."""
    dev = codes.device
    if not kernels.on_card(dev, "int8 conv field kernel"):
        raise ValueError("launch_field_i8 takes CUDA tensors")
    dr, dc = conv_dims(mo)
    if (codes.dim() != 3 or codes.dtype != torch.int8
            or codes.shape[2] not in (4, 8) or codes.stride()[1:] != (
                codes.shape[2], 1) or codes.stride(0) % 16
            or codes.data_ptr() % 16):
        raise ValueError("codes must be an (hp, wp, 4 or 8) int8 with "
                         "contiguous pixels and rows of whole 16-byte groups "
                         "on a 16-byte aligned base (ConvMap's)")
    hp, wp, cp = codes.shape
    dcp = i8_dcp(dc, cp)
    groups, width = i8_columns(s_out)
    chunks = dr * dcp * cp // 32
    if (b.dtype != torch.int8 or tuple(b.shape) != (groups, chunks, width, 32)
            or not b.is_contiguous() or b.device != dev):
        raise ValueError(f"B must be a contiguous ({groups}, {chunks}, "
                         f"{width}, 32) int8 beside the codes")
    if (nonzero.dtype != torch.bool or tuple(nonzero.shape) != (groups,
                                                                chunks)
            or not nonzero.is_contiguous() or nonzero.device != dev):
        raise ValueError(f"nonzero must be a contiguous ({groups}, {chunks}) "
                         "bool beside the codes")
    if (scales.dtype != torch.float32 or tuple(scales.shape) != (s_out, 2)
            or not scales.is_contiguous() or scales.device != dev):
        raise ValueError(f"scales must be a contiguous ({s_out}, 2) float32")
    origin = origin_yx.to(torch.int64).contiguous()
    if tuple(origin.shape) != (2,) or origin.device != dev:
        raise ValueError("origin_yx must be a (2,) tensor beside the codes")
    if region % I8_TILE[1] or region < I8_TILE[1]:
        raise ValueError(f"region {region} is not a multiple of 16")
    if splits is None:
        splits = i8_splits(cp, width, dr, dcp, region, groups,
                           dev.index if dev.index is not None
                           else torch.cuda.current_device())
    out = torch.empty((s_out, region, region), dtype=torch.float32,
                      device=dev)
    acc = (torch.empty((2 * s_out, region, region), dtype=torch.int32,
                       device=dev) if sums else None)
    kernels.launch("conv_field_i8", "tdr_conv_field_i8", ptr(codes), hp, wp,
                   codes.stride(0), cp, ptr(b), ptr(nonzero), ptr(scales),
                   ptr(origin), dr, dc, dcp, region, s_out, groups, width,
                   splits, i8_window(dr, dcp, cp)[1], ptr(out),
                   None if acc is None else ptr(acc))
    kernels.LAUNCHES["conv_field_i8"] += 1
    return out, acc


def conv_centres(center_px: torch.Tensor, map_resolution: float, pad: int):
    """(cy, cx) (N,) int64: each centre's rounded padded pixel."""
    mres = torch.tensor(map_resolution, dtype=torch.float32,
                        device=center_px.device)
    cy = torch.round(center_px[:, 1] / mres).to(torch.int64) + pad
    cx = torch.round(center_px[:, 0] / mres).to(torch.int64) + pad
    return cy, cx


def alive_min(cy, cx, alive):
    """(least cy, least cx) () int64 over the alive particles (2^30 where
    none is alive)."""
    big = 1 << 30
    return torch.where(alive, cy, big).min(), torch.where(alive, cx, big).min()


def clamp_origin(ly, lx, cmap: "ConvMap", mo: int, region: int):
    """(oy, ox) () int64 region origin: the least alive centre (alive_min),
    clamped so that the conv block fits the padded map."""
    dr, dc = conv_dims(mo)
    return (ly.clamp(dr // 2, cmap.hp - (region + dr - 1) + dr // 2),
            lx.clamp(dc // 2, cmap.wp - (region + dc - 1) + dc // 2))


def read_scores(field, cell, theta, mode: str, num_rot: int, window_w: int,
                s0, th: int, r: int):
    """A flavour's scores from its (S_out, cells) field at each particle's
    cell: tracked (cost, norm, kf) (N,) at its own shift in the window [s0,
    s0 + window_w) (a shift outside it clamped to its edge), init (costs,
    norms (N, num_rot), kf (N,)).  kf: the count times f32(1 / (Th R)), as
    the reference's compiled division by a constant."""
    inv_tr = float(np.float32(1.0) / np.float32(th * r))
    if mode == "tracked":
        s = rotation_shift(theta, th)
        local = ((s - s0) % th).clamp(0, window_w - 1)
        return (field[local, cell], field[window_w + local, cell],
                field[2 * window_w, cell] * inv_tr)
    rows = field[:, cell]
    return (rows[:num_rot].T, rows[num_rot : 2 * num_rot].T,
            rows[2 * num_rot] * inv_tr)


def make_conv_scorer(
    mo: int,
    region: int,
    mode: str,
    num_rot: int = 40,
    map_resolution: float = 1.0,
    window_w: int = 100,
    conv_int8: bool = False,
):
    """Returns score(cmap: ConvMap, stencil, scan, class_weights,
    center_px, theta, f, alive, s0=0) for the clustered regime:

      tracked -> (cost, norm, kf) (N,) at each particle's own shift,
                 read from the window [s0, s0 + window_w)
      init    -> (costs, norms (N, num_rot), kf (N,)) at the search shifts

    The region's origin is the least rounded centre over the ALIVE
    particles (dead slots are stale resample leftovers anywhere on the
    map), clamped so that the block fits the padded map.  The caller plans
    the region so that every alive centre falls inside it; a straggler is
    clamped to the region's edge and scored there.  A shift outside the
    window is clamped to its edge the same way.

    conv_int8: the int8 field (cost_field_i8, on the map's codes) where the
    reference's scorer takes it under TDR_CONV_INT8=1: the tracked flavour
    with (2 window_w) % 32 == 0 (its kf split) and the kernel under its s2d
    gate; elsewhere the float32 field."""
    if mode not in ("tracked", "init"):
        raise ValueError(f"unknown conv mode {mode!r}")
    use_i8 = (conv_int8 and mode == "tracked" and (2 * window_w) % 32 == 0
              and s2d_gate(mo, 2 * window_w + 1))

    def score(cmap: ConvMap, stencil, scan, class_weights, center_px,
              theta, f, alive, s0=0):
        th, r = stencil.shape[:2]
        cy, cx = conv_centres(center_px, map_resolution, cmap.pad)
        oy, ox = clamp_origin(*alive_min(cy, cx, alive), cmap, mo, region)
        iy = (cy - oy).clamp(0, region - 1)
        ix = (cx - ox).clamp(0, region - 1)
        kernel = build_conv_kernel(scan, class_weights, stencil, f, mo,
                                   mode, num_rot, window_w, s0)
        origin = torch.stack([oy, ox])
        if use_i8:
            if cmap.codes is None:
                raise ValueError("the int8 conv field needs a ConvMap made "
                                 "with int8=True")
            field = conv_field_i8(cmap.codes, cmap.qinv, kernel, origin,
                                  mo, region)
        else:
            field = cost_field(cmap.padded, kernel, origin, mo, region)
        return read_scores(field.reshape(kernel.shape[0], -1),
                           iy * region + ix, theta, mode, num_rot, window_w,
                           s0, th, r)

    return score
