"""Matrix products on the tensor cores (the counterpart of the TPU's int8
and matrix-unit probes; kernel csrc/probe_mm.cu).

  mm_s8(a, b)                  int8 (M, K) x int8 (N, K)^T -> int32 (M, N)
  mm_bf16(a, b, select=None)   bf16 or int8 (M, K) x bf16 (N, K)^T ->
                               float32 (M, N); an int8 A is converted to
                               bf16 (exactly) on the way in.  With select
                               (M / 8,) int32, b is (G, N, K) and the
                               8-row block i of a takes b[select[i]].

K fills whole 64-byte slabs: a multiple of 64 for mm_s8, of 32 for
mm_bf16; M and N are free.  On CPU tensors each runs its plain version; on
CUDA tensors it launches the kernel on the route that plan() names for the
shape, counted in kernels.LAUNCHES["probe_mm"] (one a call, the split-K
sum included).  The plain
versions take the products in float64, exactly (int8 sums up to 2^53 / 2^14
terms; bf16 products exact, sums rounded once to float32); the kernel's
float32 sums differ from them by their rounding (MM_TOL).
"""

from __future__ import annotations

import torch

from top_down_renderer_torch import kernels
from top_down_renderer_torch.kernels import ptr

A_TYPES = {"s8": 0, "bf16": 1, "s8_to_bf16": 2}
SLAB = 64  # bytes of a row that K must fill
TILE = 128  # rows of A and of B a tile of the dense routes covers
# K elements a stage of the dense routes (128 bytes of A a row)
STAGE_K = {"s8": 128, "bf16": 64, "s8_to_bf16": 128}
SMS = 132  # streaming multiprocessors of an H100 SXM
MIN_SPLIT_STAGES = 2  # K stages a split of K takes at least
# the kernel's float32 sums against the exact product: |err| <= MM_TOL *
# sum_k |a_ik b_jk| (a float32 sum of K terms in some order errs by at most
# about K 2^-24 of it; the tensor cores' sum in blocks of 16 by far less)
MM_TOL = 1e-4


def mm_s8_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 x b (N, K) int8 transposed -> int32, in float64."""
    return _product64(a, b).to(torch.int32)


def _product64(a, b, select=None) -> torch.Tensor:
    """a (M, K) times b^T in float64: b (N, K), or (G, N, K) with b[select[i]]
    for the 8-row block i of a."""
    a, b = a.double(), b.double()
    if select is None:
        return a @ b.T
    m, k = a.shape
    return (a.view(m // 8, 8, k) @ b[select.long()].transpose(1, 2)).reshape(
        m, -1)


def mm_bf16_plain(a: torch.Tensor, b: torch.Tensor,
                  select=None) -> torch.Tensor:
    """a (M, K) bf16 or int8 x b^T (b (N, K) bf16, or (G, N, K) picked per
    8-row block of a by select) -> float32, summed in float64."""
    return _product64(a, b, select).float()


def abs_products(a, b, select=None) -> torch.Tensor:
    """sum_k |a_ik b_jk| (float64): the scale of MM_TOL."""
    return _product64(a.double().abs(), b.double().abs(), select)


def _tiles(m: int, n: int) -> int:
    return -(-m // TILE) * -(-n // TILE)


def _tail(m: int, n: int) -> int:
    """Tiles past the last whole wave of SMS (all of them below one)."""
    tiles = _tiles(m, n)
    return tiles % SMS if tiles >= SMS else tiles


def plan(m: int, n: int, k: int, a_type: str, select: bool):
    """(route, split_k) of the kernel for C (m, n) = A (m, k) B^T with A of
    a_type: "mma_sync" for the select route (a B block per 8 rows of A does
    not fit wgmma's 64-row tiles), else "wgmma".  The dense route computes
    the 128 x 128 tiles of whole waves of SMS whole; when the tiles past
    them (all tiles, below one wave) fill at most half the card, each of
    those is split over K into split_k items, each at least
    MIN_SPLIT_STAGES stages of STAGE_K and none empty, so that they come
    near one item an SM; split_k is 1 otherwise."""
    if select:
        return "mma_sync", 1
    tail = _tail(m, n)
    stages = -(-k // STAGE_K[a_type])
    if tail == 0 or 2 * tail > SMS:
        return "wgmma", 1
    splits = max(1, min(-(-SMS // tail), stages // MIN_SPLIT_STAGES))
    per = -(-stages // splits)
    return "wgmma", -(-stages // per)


def whole_tiles(m: int, n: int, split_k: int) -> int:
    """Tiles the dense route computes whole (row-major tile order): all of
    them without a split, else those before the split tail."""
    return _tiles(m, n) - (_tail(m, n) if split_k > 1 else 0)


def _check(a, b, select, a_types, b_type):
    if a.dtype not in a_types or b.dtype != b_type:
        raise TypeError(f"a must be {a_types} and b {b_type}; got {a.dtype}, "
                        f"{b.dtype}")
    if a.dim() != 2 or a.device != b.device:
        raise ValueError("a must be (M, K), on b's device")
    k = a.shape[1]
    if b.dim() != (2 if select is None else 3) or b.shape[-1] != k:
        want = "(N, K)" if select is None else "(G, N, K)"
        raise ValueError(f"b must be {want} with K = {k}, got "
                         f"{tuple(b.shape)}")
    slab = SLAB // (1 if a_types == (torch.int8,) else 2)
    if k < slab or k % slab:
        raise ValueError(f"K must be a multiple of {slab}, got {k}")
    if select is not None:
        if (select.dtype != torch.int32 or select.shape != (a.shape[0] // 8,)
                or a.shape[0] % 8 or select.device != a.device):
            raise ValueError("select must be (M / 8,) int32 on a's device")
        if not bool(((select >= 0) & (select < b.shape[0])).all()):
            raise ValueError("select names a block b does not have")
    for t, name in ((a, "a"), (b, "b")):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch(a, b, select, a_type: str, dtype) -> torch.Tensor:
    m, k = a.shape
    n = b.shape[-2]
    out = torch.empty((m, n), dtype=dtype, device=a.device)
    if select is not None:
        select = select.contiguous()
    _, split_k = plan(m, n, k, a_type, select is not None)
    whole = whole_tiles(m, n, split_k)
    blocks = split_k * (_tiles(m, n) - whole)
    scratch = (torch.empty((blocks, TILE, TILE), dtype=dtype,
                           device=a.device) if blocks else None)
    kernels.launch("probe_mm", "tdr_probe_mm", ptr(a), ptr(b),
                   None if select is None else ptr(select), m, n, k,
                   A_TYPES[a_type], whole, split_k,
                   None if scratch is None else ptr(scratch), ptr(out))
    kernels.LAUNCHES["probe_mm"] += 1
    return out


def mm_s8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 a (M, K) times b (N, K) transposed: int32 (M, N), exact."""
    _check(a, b, None, (torch.int8,), torch.int8)
    if not kernels.on_card(a.device, "int8 product"):
        return mm_s8_plain(a, b)
    return _launch(a, b, None, "s8", torch.int32)


def mm_bf16(a: torch.Tensor, b: torch.Tensor, *, select=None) -> torch.Tensor:
    """bf16 or int8 a (M, K) times bf16 b transposed: float32 (M, N)
    (module docstring)."""
    _check(a, b, select, (torch.bfloat16, torch.int8), torch.bfloat16)
    if not kernels.on_card(a.device, "bf16 product"):
        return mm_bf16_plain(a, b, select)
    a_type = "bf16" if a.dtype == torch.bfloat16 else "s8_to_bf16"
    return _launch(a, b, select, a_type, torch.float32)

