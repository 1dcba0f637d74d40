"""Build and load the package's CUDA kernels.

The sources live in top_down_renderer_torch/csrc/.  Each one is compiled
at first use with nvcc for sm_90a into a shared library with a plain C
interface, under top_down_renderer_torch/_build/, named by a hash of its
source and flags so a changed source rebuilds.  The library is loaded
with ctypes: pointers and the stream go as c_void_p, and every entry
point returns the CUDA error of its launch.

The wrappers around the kernels (filter/crop_score.py,
filter/multiscale.py, filter/resample.py) share on_card(), which sends
CPU tensors to their plain versions, and launch().  LAUNCHES counts the
launches of every kernel by name: each wrapper adds one where it
launches its kernel, and nowhere else, so that a run can show which
kernels its path went through.

Importing this module compiles nothing and needs no nvcc.
"""

from __future__ import annotations

import ctypes
import concurrent.futures
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# kernel launches by name (reset by callers that count a run)
LAUNCHES = {
    "crop_fold": 0,
    "crop_score_tracked": 0,
    "crop_score_init": 0,
    "crop_score_multi_tracked": 0,
    "crop_score_multi_init": 0,
    "crop_score_init_raw": 0,
    "crop_score_multi_init_raw": 0,
    "fill_rows": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "crop_score": {
        # offsets, K, TR, P, out, stream
        "tdr_crop_fold": (_P, _I, _I, _I, _P, _P),
        # compact map, H, W, C, scan, class weights, pix, npix, order, seg,
        # Th, R, P, sorted keys, perm, centers, N, inv_tr, out, stream
        "tdr_crop_score_tracked": (
            _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
            _I, _F, _P, _P,
        ),
        # compact pyramid, table, K, then as above from C on
        "tdr_crop_score_multi_tracked": (
            _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
            _I, _F, _P, _P,
        ),
    },
    "crop_score_init": {
        # compact map, H, W, CP, M records, sched, chunk_cap, centers, N,
        # S, inv_tr, out, stream
        "tdr_crop_score_init": (
            _P, _I, _I, _I, _P, _P, _I, _P, _I, _I, _F, _P, _P,
        ),
        # compact pyramid, table, K, CP, M records, sched, chunk_cap, perm,
        # centers, N, S, inv_tr, out, stream
        "tdr_crop_score_multi_init": (
            _P, _P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _F, _P, _P,
        ),
        # the raw-row epilogue of each: the same arguments, out (N, 2S + 1)
        "tdr_crop_score_init_raw": (
            _P, _I, _I, _I, _P, _P, _I, _P, _I, _I, _F, _P, _P,
        ),
        "tdr_crop_score_multi_init_raw": (
            _P, _P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _F, _P, _P,
        ),
    },
    "fill_rows": {
        # rows0, valid0, N, out, scratch, epoch, stream
        "tdr_fill_rows": (_P, _P, _I, _P, _P, ctypes.c_uint, _P),
    },
}


def default_device(device=None) -> torch.device:
    """`device`, or the card when none is given.  Without a card that is
    an error, never a silent fall back to the CPU: CPU callers say
    device="cpu"."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: top_down_renderer_torch runs on the card by "
            "default; pass device=\"cpu\" to run on the CPU"
        )
    return torch.device("cuda")


def on_card(device, what: str) -> bool:
    """True for a CUDA device (launch the kernel), False for the CPU
    (run the plain version); any other device has no `what` and raises."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {device}")
    return device.type == "cuda"


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address, as the entry points take it."""
    return ctypes.c_void_p(t.data_ptr())


def launch(name: str, fn_name: str, *args) -> None:
    """Call entry point fn_name of csrc/<name>.cu with args and the
    current CUDA stream; raise on the CUDA error it returns."""
    err = getattr(load(name), fn_name)(
        *args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    )
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err}")


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of top_down_renderer_torch build on a machine with "
        "the CUDA toolkit"
    )


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library for this exact source and
    these flags exists; returns the library's path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name}:\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build_all() -> dict:
    """Compile every source in parallel (one nvcc each, all started
    together); returns {name: seconds until its library was ready}."""
    t0 = time.perf_counter()

    def one(name):
        build(name)
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(_SIGNATURES)) as pool:
        return dict(zip(_SIGNATURES, pool.map(one, _SIGNATURES)))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu, with argtypes set."""
    lib = ctypes.CDLL(str(build(name)))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib
