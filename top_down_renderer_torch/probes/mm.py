"""Matrix products on the tensor cores (the counterpart of the TPU's int8
and matrix-unit probes; kernel csrc/probe_mm.cu).

  mm_s8(a, b)                  int8 (M, K) x int8 (N, K)^T -> int32 (M, N)
  mm_bf16(a, b, select=None)   bf16 or int8 (M, K) x bf16 (N, K)^T ->
                               float32 (M, N); an int8 A is converted to
                               bf16 (exactly) on the way in.  With select
                               (M / 8,) int32, b is (G, N, K) and the
                               8-row block i of a takes b[select[i]].

K fills whole 64-byte slabs: a multiple of 64 for mm_s8, of 32 for
mm_bf16.  On CPU tensors each runs its plain version; on CUDA tensors it
launches the kernel, counted in kernels.LAUNCHES["probe_mm"].  The plain
versions take the products in float64, exactly (int8 sums up to 2^53 / 2^14
terms; bf16 products exact, sums rounded once to float32); the kernel's
float32 sums differ from them by their rounding (MM_TOL).
"""

from __future__ import annotations

import torch

from top_down_renderer_torch import kernels
from top_down_renderer_torch.kernels import ptr

A_TYPES = {"s8": 0, "bf16": 1, "s8_to_bf16": 2}
SLAB = 64  # bytes of a row a stage of the kernel reads
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
    kernels.launch("probe_mm", "tdr_probe_mm", ptr(a), ptr(b),
                   None if select is None else ptr(select), m, n, k,
                   A_TYPES[a_type], ptr(out))
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

