"""Window gather: copy or sum n rectangular windows of a stacked map (the
counterpart of the TPU's DMA probes; kernel csrc/probe_window.cu).

window_gather(src, origins, rows, cols, geometry=, out=) takes src (S, H,
W) int8 or bfloat16 and origins (n, 3) int32 (stack index, row, column in
elements: bytes for int8); window i is src[k, y:y + rows, x:x + cols], and
every window must lie inside the map.  out="copy" returns the windows (n,
rows, cols); out="sum" one exact sum a window, int32 for int8 and float32
for bfloat16 (summed in float64, then rounded once).  The geometry says
how the kernel fetches them: "strided" (a warp a window, 16-byte loads;
a window at any byte in the aligned 16-byte words that cover it),
"folded1" / "folded2" (src is fold_rows(map, 8), the map with 8 rows
folded into one, read in 1 or 2 slices of 8 folded rows: rows = 8 or 16),
"async" (each window staged in shared memory by TMA, in the boxes
tma_boxes(cols, elem, lead) names, through a ring of up to MAX_STAGES
window stages: any start, a row pitch of a multiple of 16 bytes, rows <=
256).  On CPU tensors it runs window_gather_plain, indexing a strided view
of src; on CUDA tensors it launches the kernel, counted in
kernels.LAUNCHES["probe_window_gather"].
"""

from __future__ import annotations

import torch

from top_down_renderer_torch import kernels
from top_down_renderer_torch.filter.crop_score import SMEM_LIMIT
from top_down_renderer_torch.kernels import ptr

GEOMETRIES = {"strided": 0, "folded1": 1, "folded2": 2, "async": 3}
OUTS = {"copy": 0, "sum": 1}
FOLD = 8  # map rows folded into one row (probe_dma_fold.py's layout)
_CHUNK = 2**26  # elements a chunk of the plain version gathers
# a TMA box holds at most 256 elements a dimension: here bytes of the map
# across, rows down
BOX_MAX = 256
STAGE_ALIGN = 32  # bytes a staged row starts on
# window stages of the async ring: six groups of 5 consumer warps and the
# producer warp are 992 of a block's 1,024 threads
MAX_STAGES = 6


def tma_boxes(cols: int, elem: int, lead: int = 0):
    """[(x offset, width)] in elements of `elem` bytes: the boxes that
    stage a row of `cols` elements by TMA, `lead` elements before it (a
    window at any byte is staged from the STAGE_ALIGN-byte boundary below
    it: lead = (x elem % STAGE_ALIGN) / elem).  Each box is at most BOX_MAX
    bytes wide and a multiple of 16 bytes; all but the last are that
    wide, and the last ends on the first 16 bytes at or past lead + cols
    (bytes the kernel ignores)."""
    staged = -(-(lead + cols) * elem // 16) * 16
    nfull = (staged - 1) // BOX_MAX
    return ([(BOX_MAX * b // elem, BOX_MAX // elem) for b in range(nfull)]
            + [(BOX_MAX * nfull // elem, (staged - BOX_MAX * nfull)
                // elem)])


def async_stage_bytes(rows: int, cols: int, elem: int) -> int:
    """Shared-memory bytes of one window stage of the async geometry: the
    larger of its two layouts (an aligned window, and one with the largest
    lead), each box starting on 128 bytes (csrc/probe_window.cu)."""
    return max(sum(-(-rows * w * elem // 128) * 128
                   for _, w in tma_boxes(cols, elem, lead))
               for lead in (0, STAGE_ALIGN // elem - 1))


def async_stages(rows: int, cols: int, elem: int) -> int:
    """Window stages of the async ring: as many as fit 227 KB, at most
    MAX_STAGES (the kernel's count)."""
    return min(MAX_STAGES, (SMEM_LIMIT - 512)
               // async_stage_bytes(rows, cols, elem))


def fold_rows(src: torch.Tensor, fold: int = FOLD) -> torch.Tensor:
    """(S, H, W) -> (S, H / fold, fold W): each `fold` consecutive rows
    laid end to end as one row (a view of the same bytes)."""
    s, h, w = src.shape
    if h % fold:
        raise ValueError(f"{h} rows do not fold by {fold}")
    return src.reshape(s, h // fold, fold * w)


def _windows(src, origins, rows: int, cols: int):
    """The (n, rows, cols) windows of src at origins, by indexing a view
    of every window position."""
    s, h, w = src.shape
    view = src.as_strided((s, h - rows + 1, w - cols + 1, rows, cols),
                          (h * w, w, 1, w, 1))
    o = origins.long()
    return view[o[:, 0], o[:, 1], o[:, 2]]


def window_gather_plain(src, origins, rows: int, cols: int,
                        out: str = "copy") -> torch.Tensor:
    """Plain version of window_gather (any device): the windows, or their
    sums (int64 for int8, float64 for bfloat16, cast to int32 and
    float32), `_CHUNK` elements at a time."""
    if out == "copy":
        return _windows(src, origins, rows, cols)
    acc, res = ((torch.int64, torch.int32) if src.dtype == torch.int8
                else (torch.float64, torch.float32))
    step = max(1, _CHUNK // (rows * cols))
    parts = [_windows(src, origins[i : i + step], rows, cols).to(acc)
             .sum((1, 2)) for i in range(0, origins.shape[0], step)]
    return torch.cat(parts).to(res)


def _check(src, origins, rows, cols, geometry, out) -> None:
    if geometry not in GEOMETRIES:
        raise ValueError(f"geometry must be one of {list(GEOMETRIES)}")
    if out not in OUTS:
        raise ValueError(f"out must be one of {list(OUTS)}")
    if src.dtype not in (torch.int8, torch.bfloat16) or src.dim() != 3:
        raise TypeError(f"src must be (S, H, W) int8 or bfloat16, got "
                        f"{tuple(src.shape)} {src.dtype}")
    if not src.is_contiguous() or src.data_ptr() % 16:
        raise ValueError("src must be contiguous and 16-byte aligned")
    if (origins.dtype != torch.int32 or origins.dim() != 2
            or origins.shape[1] != 3 or origins.device != src.device):
        raise ValueError(f"origins must be (n, 3) int32 on {src.device}")
    nsl = {"folded1": 1, "folded2": 2}.get(geometry)
    if nsl is not None and rows != FOLD * nsl:
        raise ValueError(f"{geometry} reads {FOLD * nsl} folded rows, not "
                         f"{rows}")
    s, h, w = src.shape
    if rows < 1 or cols < 1 or rows > h or cols > w:
        raise ValueError(f"a {rows} x {cols} window does not fit the map")
    if origins.shape[0]:
        k, y, x = origins.long().unbind(1)
        inside = ((k >= 0) & (k < s) & (y >= 0) & (y <= h - rows)
                  & (x >= 0) & (x <= w - cols))
        if not bool(inside.all()):
            raise ValueError("a window lies outside the map")
        if geometry == "async":
            es = src.element_size()
            if (w * es % 16 or rows > BOX_MAX
                    or async_stages(rows, cols, es) < 2):
                raise ValueError("async windows need a row pitch of a "
                                 f"multiple of 16 bytes, at most {BOX_MAX} "
                                 "rows and two of them in shared memory")


def window_gather(src, origins, rows: int, cols: int, *,
                  geometry: str = "strided", out: str = "copy"):
    """The windows of src at origins (module docstring): (n, rows, cols)
    for out="copy", (n,) sums for out="sum"."""
    _check(src, origins, rows, cols, geometry, out)
    if not kernels.on_card(src.device, "window gather"):
        return window_gather_plain(src, origins, rows, cols, out)
    n = origins.shape[0]
    if out == "copy":
        res = torch.empty((n, rows, cols), dtype=src.dtype, device=src.device)
    else:
        dtype = torch.int32 if src.dtype == torch.int8 else torch.float32
        res = torch.empty(n, dtype=dtype, device=src.device)
    if n:
        origins = origins.contiguous()
        kernels.launch("probe_window", "tdr_probe_window_gather", ptr(src),
                       *src.shape, src.element_size(), ptr(origins), n, rows,
                       cols, GEOMETRIES[geometry], OUTS[out], ptr(res))
        kernels.LAUNCHES["probe_window_gather"] += 1
    return res


def covered_bytes(shape, origins, rows: int, cols: int,
                  elem: int = 1) -> int:
    """Bytes of an (S, H, W) map that at least one window covers: what
    the gather must read at least once (a difference array per map row)."""
    s, h, w = shape
    o = origins.long()
    line = (o[:, 0] * h + o[:, 1])[:, None] + torch.arange(
        rows, device=o.device)
    x0 = o[:, 2:3].expand(-1, rows)
    d = torch.zeros((s * h, w + 1), dtype=torch.int32, device=o.device)
    one = torch.ones(line.numel(), dtype=torch.int32, device=o.device)
    d.index_put_((line.reshape(-1), x0.reshape(-1)), one, accumulate=True)
    d.index_put_((line.reshape(-1), (x0 + cols).reshape(-1)), -one,
                 accumulate=True)
    return int((d.cumsum(1, dtype=torch.int32)[:, :w] > 0).sum()) * elem
