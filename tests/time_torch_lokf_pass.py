"""Device time of the single-plane M's weights pass (csrc/crop_score.cu,
crop_lokf_weights_kernel) against variants of it built with another
choice of its constants, on the card:

  kLight       the cells a pixel may have for one thread to sum it alone
               (a heavier pixel is summed by its warp): 16, 32, 64, 128;
  kPassThreads the threads of a block (one block a (shift, bucket)): 256,
               512, 1024 (one block an SM);

each on the two folds the tracked cells score: the stencil's at f = 1 (K
= 1, 1,577 distinct pixels) and the 10 scale hypotheses' K = 12 buckets at
res 0.5 (197-489 pixels, the centre pixel 200-220 cells), C = 3, the float
map's table.  A variant is csrc/crop_score.cu with one constant replaced,
built by nvcc into a temporary directory and called through its C entry;
its table and scales must equal the production build's bit for bit.
Times: 50 launches under torch.profiler after 3 warm-up calls
(probes.kernel_ms).

    python tests/time_torch_lokf_pass.py
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from top_down_renderer_torch import kernels  # noqa: E402
from top_down_renderer_torch.filter import crop_score as cs  # noqa: E402
from top_down_renderer_torch.filter import multiscale as ms  # noqa: E402
from top_down_renderer_torch.maps.polar import polar_stencil  # noqa: E402
from top_down_renderer_torch.probes.__main__ import kernel_ms  # noqa: E402

SRC = kernels.CSRC / "crop_score.cu"
HEADERS = ("crop_tracked.cuh", "tma.cuh")
LIGHT = "constexpr int kLight = 64;"
THREADS = "constexpr int kPassThreads = 512;"
BOUNDS = "__launch_bounds__(kPassThreads, 2)\n    crop_lokf_weights_kernel"
# name -> the source's replacements (none: the production build)
VARIANTS = {
    "production (kLight 64, 512 threads)": [],
    "kLight 16": [(LIGHT, "constexpr int kLight = 16;")],
    "kLight 32": [(LIGHT, "constexpr int kLight = 32;")],
    "kLight 128": [(LIGHT, "constexpr int kLight = 128;")],
    "256 threads": [(THREADS, "constexpr int kPassThreads = 256;")],
    "1024 threads": [(THREADS, "constexpr int kPassThreads = 1024;"),
                     (BOUNDS, BOUNDS.replace(", 2)", ", 1)"))],
}
ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3


def build(name: str, tmp: str) -> str:
    """csrc/crop_score.cu with the variant's replacements, built into its
    own directory under tmp with the headers it includes."""
    src = SRC.read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"{name}: the source has no {old!r}")
        src = src.replace(old, new)
    d = os.path.join(tmp, str(list(VARIANTS).index(name)))
    os.makedirs(d)
    for h in HEADERS:
        with open(os.path.join(d, h), "w") as f:
            f.write((kernels.CSRC / h).read_text())
    with open(os.path.join(d, "crop_score.cu"), "w") as f:
        f.write(src)
    lib = os.path.join(d, "lib.so")
    proc = subprocess.run(
        [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", lib,
         os.path.join(d, "crop_score.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    return lib


def folds(dev):
    """{label: fold} of the stencil at f = 1 and of the D2 buckets."""
    sten = torch.as_tensor(polar_stencil(100, 25), device=dev)
    hyp = (10.0 ** (np.arange(10) / 10.0)).astype(np.float32)
    _, slots, mips = ms.plan_buckets(hyp, 25, 0.5, 10.0)
    multi = ms.bucket_offsets(
        sten, torch.as_tensor(slots, device=dev), 0.5,
        torch.as_tensor(mips, dtype=torch.float32, device=dev))
    return {"K=1": cs.fold_pixels(cs.crop_offsets(sten, 1.0)[None]),
            "K=12": cs.fold_pixels(multi.contiguous())}


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_lokf_pass: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    scan = torch.as_tensor((rng.random((3, 100, 25)) * 3).astype(np.float32),
                           device=dev)
    cw = torch.tensor([0.1, 1.5, 3.0], device=dev)
    qinv = torch.as_tensor(rng.random(8).astype(np.float32) + 0.01,
                           device=dev)
    cells = folds(dev)
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
            libs = dict(zip(VARIANTS, pool.map(lambda n: build(n, tmp),
                                               VARIANTS)))
        ref = {}
        out = {"card": torch.cuda.get_device_name(0)}
        for name, path in libs.items():
            fn = ctypes.CDLL(path).tdr_crop_lokf_weights
            fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
            out[name] = {}
            for label, (pix, npix, order, seg) in cells.items():
                k, cap = pix.shape[:2]
                table = torch.zeros((k, 100, 6, cap), dtype=torch.int16,
                                    device=dev)
                scales = torch.zeros((k, 100, 4), device=dev)

                def call():
                    err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (
                        scan, cw, qinv)), 3, 0, *(ctypes.c_void_p(
                            t.data_ptr()) for t in (npix, order, seg)),
                        k, 100, 25, cap, ctypes.c_void_p(table.data_ptr()),
                        ctypes.c_void_p(scales.data_ptr()), ctypes.c_void_p(
                            torch.cuda.current_stream().cuda_stream))
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                ms_, _ = kernel_ms(call, ("crop_lokf_weights_kernel",),
                                   runs=50)
                got = (table.cpu(), scales.cpu())
                want = ref.setdefault(label, got)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise RuntimeError(f"{name}: {label} differs from the "
                                       "production build")
                out[name][label] = ms_
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
