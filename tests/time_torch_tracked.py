"""Device time of the tracked crop kernel (csrc/crop_score.cu,
crop_tracked_kernel), on the card.

Times the tracked kernel of the checkout at ROOT on the clustered cell:
102,400 particles in a 100 px square of a 1024^2 3-class map, thetas in
a 0.15 rad band, f = 1 (1,577 distinct stencil pixels), class weights
(0.1, 1.5, 3.0): five rounds of 20 launches under torch.profiler after 3
warm-up calls (chip_smoke.kernel_ms of the checkout at ROOT).  Each
round's result must equal the first call's bit for bit, and its SHA-256
is printed, so that two checkouts' results can be compared too.

The tree to time is ROOT (default: this checkout); running it for two
checkouts on one machine, in turns (parent, change, change, parent),
compares them:

    python tests/time_torch_tracked.py [ROOT]
"""

from __future__ import annotations

import hashlib
import json
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
from top_down_renderer_torch.filter import crop_score as cs  # noqa: E402
from top_down_renderer_torch.testing import synthetic_setup  # noqa: E402

N = 102_400
ROUNDS = 5


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_tracked: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    d = synthetic_setup(N, h=1024, w=1024, c=3, cluster=(462, 462, 100),
                        theta_spread=(0.7, 0.075))
    p = d["state"]["particles"]
    args = (cs.CropMap(torch.as_tensor(d["packed"], device=dev)), 3,
            torch.as_tensor(d["stencil"], device=dev),
            torch.as_tensor(d["scan"], device=dev),
            torch.tensor([0.1, 1.5, 3.0], device=dev),
            torch.as_tensor(p["init_px"], device=dev),
            torch.as_tensor(p["theta"], device=dev), 1.0)

    def run():
        return cs.score_tracked(*args)

    first = torch.stack(run()).cpu()
    times = []
    for _ in range(ROUNDS):
        times.append(smoke.kernel_ms(run, ("crop_tracked_kernel<3>",)))
        if not torch.equal(torch.stack(run()).cpu().view(torch.int32),
                           first.view(torch.int32)):
            raise RuntimeError("the tracked kernel does not repeat")
    print(json.dumps({
        "root": ROOT, "card": smoke.card_name_and_limit(),
        "kernel_ms": times, "median_ms": float(np.median(times)),
        "sha256": hashlib.sha256(first.numpy().tobytes()).hexdigest(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
