"""Device time of the resample fill (csrc/fill_rows.cu), on the card.

Times the fill of the checkout at ROOT on two inputs: the resample's
segment starts of 102,400 rows (random (N, 8) rows, exponential weights
with half of them zero, n_new = N, shift 0.37: chip_smoke.py phase B2's
inputs), and 2^22 random rows with about 30 % of the slots valid.  For
each: the kernel alone (20 launches under torch.profiler after 3 warm-up
calls), its wrapper and its plain version (medians of 20 synchronised
host-clock calls), torch.cummax then index_select (the one PyTorch
formulation of the same function) and the bytes bound (each row read and
written once, each flag read once, at 3.35 TB/s).  Each result is held to
the plain version bit for bit first.

The tree to time is ROOT (default: this checkout); running it from two
checkouts on one machine, one after the other, compares them:

    python tests/time_torch_fill.py [ROOT]
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.abspath(
    sys.argv[1] if len(sys.argv) > 1
    else os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from top_down_renderer_torch.filter import resample as rs  # noqa: E402


def time_fill(label, rows0, valid0, card) -> None:
    got, ref = rs.fill_rows(rows0, valid0), rs.fill_rows_plain(rows0, valid0)
    torch.cuda.synchronize()
    smoke.check(torch.equal(got, ref), f"{label}: the fill differs")
    idx = torch.where(valid0, torch.arange(rows0.shape[0],
                                           device=rows0.device), 0)
    t = smoke.timed("fill_rows", lambda: rs.fill_rows(rows0, valid0),
                    lambda: rs.fill_rows_plain(rows0, valid0),
                    lambda: rows0.index_select(0,
                                               torch.cummax(idx, 0).values))
    b = smoke.bound(0.0, smoke.nbytes(rows0, valid0) + rows0.numel() * 4)
    print(f"{ROOT}: fill at {label}: kernel {t['ms']:.4f} ms (with its "
          f"wrapper {t['wrapper_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms,"
          f" cummax + index_select {t['library_ms']:.4f} ms, bound "
          f"{b[0]:.4f} ms ({b[1]}), {int(valid0.sum())} valid slots, on "
          f"{card}")


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_fill: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = smoke.card_name_and_limit()
    n = smoke.N
    rng = np.random.default_rng(2)
    rows = torch.as_tensor(rng.random((n, 8)).astype(np.float32), device=dev)
    w = rng.exponential(1.0, n).astype(np.float32)
    w[rng.random(n) < 0.5] = 0.0
    w = torch.as_tensor(w / w.sum(), device=dev)
    nn = torch.tensor(n, device=dev)
    time_fill(f"{n} rows", *rs._segment_starts(
        rows, w, nn, nn, torch.tensor(0.37, device=dev)), card)
    big = 2**22
    gen = torch.Generator(device=dev).manual_seed(3)
    valid = torch.rand(big, device=dev, generator=gen) < 0.3
    valid[0] = True
    time_fill("2^22 rows", torch.rand((big, 8), device=dev, generator=gen),
              valid, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
