"""The theta search's ablation (K4) in fresh processes, on the card.

Runs `python -m top_down_renderer_torch.probes ablate_init` RUNS times,
each in a process of its own (a reading carries what ran before it in
its process), and prints one JSON line per case and variant: the median
of the runs' kernel times, production times (for `full`) and wrapper
split, each run's readings and profile tries, the bound and the share of
it the median reaches, the bytes re-read from L2, the blocks an SM, and
the card's name and power limit.  Each run
checks every variant against its plain version and `full` against the
production kernel bit for bit (a failed check fails the run).

    python tests/time_torch_ablate_init.py [--runs 3] [--out FILE]

--out keeps every run's records as JSON lines.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
MEDIANS = ("kernel_ms", "wrapper_ms", "production_ms", "inputs_ms",
           "m_build_ms", "launch_ms")


def one_run() -> list:
    proc = subprocess.run(
        [sys.executable, "-m", "top_down_renderer_torch.probes",
         "ablate_init"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    sys.stderr.write(proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"the ablate_init probe failed ({proc.returncode})")
    return [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    runs = [one_run() for _ in range(args.runs)]
    if args.out:
        with open(args.out, "w") as f:
            for recs in runs:
                f.writelines(json.dumps(r) + "\n" for r in recs)
    for recs in zip(*runs):
        first = recs[0]
        assert all(r["probe"] == first["probe"] for r in recs)
        line = {k: first[k] for k in ("probe", "bound_ms", "bound_by",
                                      "particles", "buckets", "l2_bytes",
                                      "l2_window_rate_ms", "blocks_per_sm",
                                      "card")}
        for k in MEDIANS:
            if first.get(k) is not None:
                line[k] = float(np.median([r[k] for r in recs]))
                line[f"{k}_runs"] = [r[k] for r in recs]
        line["share_of_bound"] = line["bound_ms"] / line["kernel_ms"]
        line["profile_tries"] = [r["profile_tries"] for r in recs]
        if "production_tries" in first:
            line["production_tries"] = [r["production_tries"] for r in recs]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
