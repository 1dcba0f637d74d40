"""SHA-256 of the window-route theta searches' outputs on the card.

Runs the sixteen entries of the theta searches, every one on the window
route (csrc/crop_score_init.cu: crop_init_kernel, the float map with the
hi/lo M; crop_init_i4_kernel, the code map with it; crop_init_lokf_kernel,
the single-plane M, on the float and on the code map), argmin and raw
rows, uniform and K-bucket, of the
checkout at ROOT on 102,400 particles over a 1024^2 map of 3 and of 6
classes: a spread cloud, one clustered to 100 px and one along the map's
edges (centres within 4 px of a side, inside and past it), uniform at f =
1 and 1.5 and over the 10 scale hypotheses' K buckets at res 0.5.
Prints one JSON line {"root", "card", "sha256": {case: SHA-256 of the
entry's output tensors}}, so that two checkouts' outputs can be compared
bit for bit (run each in a process of its own, on one card):

    python tests/sha_torch_init.py [ROOT]
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
    os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from top_down_renderer_torch.filter import crop_score as cs  # noqa: E402
from top_down_renderer_torch.filter import multiscale as ms  # noqa: E402
from top_down_renderer_torch.testing import synthetic_setup  # noqa: E402

N = 102_400
HW = 1024
KINDS = {"hilo": {"int4": False, "m_hilo": True},
         "i4": {"int4": True, "m_hilo": True},
         "lokf": {"int4": False, "m_hilo": False},
         "i4_lokf": {"int4": True, "m_hilo": False}}


def clouds(d, dev) -> dict:
    """The cases' centres (N, 2) float32 (x, y) on the card."""
    rng = np.random.default_rng(7)
    side = rng.integers(0, 4, N)
    along = rng.uniform(0, HW, N)
    depth = rng.uniform(-4, 4, N)
    edge = np.stack([
        np.where(side < 2, along, np.where(side == 2, depth, HW - 1 + depth)),
        np.where(side >= 2, along, np.where(side == 0, depth, HW - 1 + depth)),
    ], -1)
    return {name: torch.as_tensor(v.astype(np.float32), device=dev)
            for name, v in (
                ("spread", d["state"]["particles"]["init_px"]),
                ("clustered", rng.uniform(412, 512, (N, 2))),
                ("edge", edge))}


def digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.float().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    if not torch.cuda.is_available():
        print("sha_torch_init: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    hyp = (10.0 ** (np.arange(10) / 10.0)).astype(np.float32)
    _, slots, mips = ms.plan_buckets(hyp, 25, 0.5, 10.0)
    levels = tuple(sorted(set(mips)))
    bmi = tuple(levels.index(m) for m in mips)
    scale = torch.as_tensor(np.resize(hyp, N), device=dev)
    slots_t = torch.as_tensor(slots, device=dev)
    out = {}
    for c in (3, 6):
        d = synthetic_setup(N, h=HW, w=HW, c=c)
        packed = torch.as_tensor(d["packed"], device=dev)
        sten, scan = (torch.as_tensor(d[k], device=dev)
                      for k in ("stencil", "scan"))
        cw = torch.as_tensor(np.linspace(0.1, 3.0, c).astype(np.float32),
                             device=dev)
        for kind, kw in KINDS.items():
            maps = cs.CropMap(packed, **kw)
            pyr = ms.build_pyramid_maps(packed, levels, **kw)
            for cloud, ctr in clouds(d, dev).items():
                for f in (1.0, 1.5):
                    args = (maps, c, sten, scan, cw, ctr, f)
                    tag = f"{kind} C={c} {cloud} f={f}"
                    out[f"{tag} argmin"] = digest(cs.score_init_sel(*args))
                    out[f"{tag} raw"] = digest(cs.score_init_raw(*args))
                args = (pyr, c, sten, scan, cw, ctr, scale, slots_t, bmi, 0.5)
                tag = f"{kind} C={c} {cloud} K-bucket"
                out[f"{tag} argmin"] = digest(ms.score_init_multi_sel(*args))
                out[f"{tag} raw"] = digest(ms.score_init_multi_raw(*args))
    print(json.dumps({"root": ROOT, "card": smoke.card_name_and_limit(),
                      "sha256": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
