"""Compare the SASS of the crop kernels of two checkouts, kernel by kernel.

Builds csrc/crop_score.cu, csrc/crop_score_init.cu, csrc/crop_ablate.cu
and csrc/crop_ablate_init.cu of the checkout at
OLD and of the one at NEW (default: this checkout) with the port's nvcc
flags (kernels.NVCC_FLAGS) into a temporary directory, disassembles each
library with the toolkit's cuobjdump and compares every kernel OLD's
library holds with NEW's of the same name, instruction by instruction
(addresses and encodings left out).  A kernel template's instantiation is
known by its name and template arguments: one whose parameters changed is
compared with its old self, and listed under "signature" too.  Prints one
line a kernel, with the SHA-256 of its instructions in OLD and in NEW,
and, last, one JSON line {"same": [...], "differ": [...], "new": [...],
"signature": [...], "sha256": {kernel: [old, new]}}; exits 1 if a kernel
of OLD is missing from NEW or its instructions differ.  So a change
that adds kernels beside the old ones shows that it left them as they
were:

    python tests/sass_diff_torch.py OLD_ROOT [NEW_ROOT]

Needs nvcc and cuobjdump (the CUDA toolkit); about 30 s a library.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from top_down_renderer_torch import kernels  # noqa: E402

SOURCES = ("crop_score", "crop_score_init", "crop_ablate",
           "crop_ablate_init")
_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")
_ENC = re.compile(r"/\* 0x[0-9a-f]+ \*/")
# the anonymous namespace's per-build hash in a mangled name
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_")
# a kernel template's mangled name up to the end of its template arguments
# (literals only: ILi4ELb0EE), before its return type and parameters
_TEMPLATE = re.compile(r"^(.*?I(?:L[a-z]+n?\d+E)+EE)v")


def kernel_key(name: str) -> str:
    """The name a kernel is compared under: a template instantiation's
    name and template arguments, without its parameters; any other
    kernel's whole mangled name."""
    hit = _TEMPLATE.match(name)
    return hit.group(1) if hit else name


def sass_by_kernel(lib: str) -> dict:
    """{mangled kernel name: [instruction, ...]} of a library's SASS."""
    tool = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    fns, cur = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = _ANON.sub("_GLOBAL__N__", line.split("Function :")[1])
            cur = fns.setdefault(name.strip(), [])
        elif cur is not None:
            text = _ANON.sub("_GLOBAL__N__",
                             _ENC.sub("", _ADDR.sub("", line))).strip()
            if text and not text.startswith((".", "-", "=")):
                cur.append(text)
    return fns


def sha256(body) -> str:
    """The SHA-256 of a kernel's instructions, one a line (None: none)."""
    if body is None:
        return None
    return hashlib.sha256("\n".join(body).encode()).hexdigest()


def build(root: str, name: str, out_dir: str) -> str:
    lib = os.path.join(out_dir, f"{os.path.basename(root)}_{name}.so")
    src = os.path.join(root, "top_down_renderer_torch", "csrc", f"{name}.cu")
    proc = subprocess.run(
        [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", lib, src],
        capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new", nargs="?", default=HERE)
    args = ap.parse_args()
    roots = (os.path.abspath(args.old), os.path.abspath(args.new))
    result = {"same": [], "differ": [], "new": [], "signature": [],
              "sha256": {}}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = [os.path.join(tmp, side) for side in ("old", "new")]
        for d in dirs:
            os.mkdir(d)
        jobs = [(r, n, d) for n in SOURCES for r, d in zip(roots, dirs)]
        with ThreadPoolExecutor(len(jobs)) as pool:
            libs = list(pool.map(lambda j: build(*j), jobs))
        for i, name in enumerate(SOURCES):
            old, new = (sass_by_kernel(x) for x in libs[2 * i:2 * i + 2])
            keys = {kernel_key(fn): fn for fn in new}
            result["signature"] += sorted(
                fn for fn in old
                if fn not in new and kernel_key(fn) in keys)
            new = {kernel_key(fn): body for fn, body in new.items()}
            old = {kernel_key(fn): body for fn, body in old.items()}
            for fn, body in sorted(old.items()):
                same = new.get(fn) == body
                result["same" if same else "differ"].append(fn)
                sha = [sha256(b) for b in (body, new.get(fn))]
                result["sha256"][fn] = sha
                print(f"{name}: {fn}: {len(body)} instructions, "
                      f"{'the same' if same else 'DIFFERENT or missing'}, "
                      f"SHA-256 {sha[0]} / {sha[1]}", flush=True)
            result["new"] += sorted(set(new) - set(old))
    print(json.dumps(result))
    return 1 if result["differ"] else 0


if __name__ == "__main__":
    sys.exit(main())
