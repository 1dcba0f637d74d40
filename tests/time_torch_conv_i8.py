"""Device time of the int8 conv cost field on the card (csrc/conv_field_i8.cu,
TDR_CONV_INT8=1) of the checkout at ROOT, beside torch._int_mm on the
block's im2col and cuDNN's float32 field of the same kernel.

The cell is chip_smoke D's clustered conv cell in shape: a 1024^2 map of C
classes (random distances, seed 0), the tracked kernel of the polar
stencil (Th x R = 100 x 25) at the conv bucket's f, window W at 95, the
block of `region` centres at (500, 500): by default region 128, mo 24, C
3 (CP 4), W 16.  Five rounds of 20 calls of the field on quantized
integers (the field kernel alone, launch_field_i8, on the plain layout;
cost_field_i8 where the tree has no launch_field_i8) under torch.profiler
(after 3 warm-up calls) give the device time of its kernels (every event
whose name holds "conv_field_i8": where a tree splits K over a second
kernel, that one too) a call; where the tree has the quantizer kernel
(conv_quant_i8), its device time the same way in five rounds, its
wrapper's host time a call (median of 200 calls, no synchronisation) and
the SHA-256 of its B, flags and scales.  CUDA events around 20 calls give the field
with its wrapper, the field with its quantization as the int8 scorer
computes it (quantize_conv_kernel and cost_field_i8, or conv_field_i8's
two launches where the tree has them), torch._int_mm (im2col built
before) and the cuDNN field.
Each round's field must equal the plain version's bit for bit; the field's
SHA-256 is printed, so that two checkouts can be compared.  --splits N
sets the kernel's split of its chunks over N blocks a tile (default: its
own choice, one wave).  Run it for two checkouts on one machine in turns
(parent, change, change, parent):

    python tests/time_torch_conv_i8.py [--region R] [--mo MO] [--classes C] [--ww W] [--splits N] [ROOT]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--region", type=int, default=128)
ap.add_argument("--mo", type=int, default=24)
ap.add_argument("--classes", type=int, default=3)
ap.add_argument("--ww", type=int, default=16)
ap.add_argument("--splits", type=int, default=None,
                help="the kernel's split of its chunks (default: its own)")
ap.add_argument("root", nargs="?", default=os.path.join(
    os.path.dirname(os.path.abspath(__file__)), ".."))
ARGS = ap.parse_args()
ROOT = os.path.abspath(ARGS.root)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from top_down_renderer_torch.filter import conv_score  # noqa: E402
from top_down_renderer_torch.filter import crop_score as cs  # noqa: E402
from top_down_renderer_torch.maps.polar import polar_stencil  # noqa: E402
from top_down_renderer_torch.probes.__main__ import events_ms  # noqa: E402

ROUNDS, RUNS, HW = 5, 20, 1024


def device_ms(fn, name="conv_field_i8") -> dict:
    """The device time a call of fn of each kernel whose name holds
    `name`, under torch.profiler (runs calls after 3 warm-up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(RUNS):
            fn()
        torch.cuda.synchronize()
    ms = {e.key.split("(")[0]: e.device_time_total / RUNS / 1e3
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and name in e.key}
    if not ms:
        raise RuntimeError(f"the profile holds no {name} kernel")
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_conv_i8: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    c, mo, region, ww = ARGS.classes, ARGS.mo, ARGS.region, ARGS.ww
    rng = np.random.default_rng(0)
    packed = np.zeros((HW, HW, 8), np.float32)
    packed[..., :c] = rng.random((HW, HW, c)) * 50
    packed[..., c] = rng.random((HW, HW)) < 0.9
    cmap = conv_score.ConvMap(cs.compact_map(torch.as_tensor(
        packed, device=dev), c), int8=True)
    scan = torch.as_tensor((rng.random((c, 100, 25)) * 3).astype(
        np.float32), device=dev)
    cw = torch.as_tensor(rng.random(c).astype(np.float32) + 0.5, device=dev)
    sten = torch.as_tensor(polar_stencil(100, 25), device=dev)
    kernel = conv_score.build_conv_kernel(scan, cw, sten, mo / 24.0, mo,
                                          "tracked", window_w=ww, s0=95)
    ints, scales = conv_score.quantize_conv_kernel(kernel, cmap.qinv)
    origin = torch.tensor([500, 500], device=dev)
    args = (cmap.codes, ints, scales, origin, mo, region)
    kw = {} if ARGS.splits is None else {"splits": ARGS.splits}
    ref, _ = conv_score.cost_field_i8_plain(*args)
    if hasattr(conv_score, "launch_field_i8"):  # the field kernel alone
        laid = conv_score.i8_layout(ints)

        def field():
            return conv_score.launch_field_i8(
                cmap.codes, *laid, scales, origin, mo, region, ints.shape[0],
                **kw)[0]
    else:
        def field():
            return conv_score.cost_field_i8(*args, **kw)
    rounds, parts, digest = [], [], None
    for _ in range(ROUNDS):
        parts.append(device_ms(field))
        rounds.append(sum(parts[-1].values()))
        got = field()
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            raise RuntimeError("the field differs from the plain version's")
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
    dr, dc = conv_score.conv_dims(mo)
    oy, ox = 500 - dr // 2, 500 - dc // 2
    block = cmap.codes[oy : oy + region + dr - 1, ox : ox + region + dc - 1]
    s_out, _, cp = ints.shape[:3]
    a = block.unfold(0, dr, 1).unfold(1, dc, 1).permute(0, 1, 3, 4, 2)
    a = a.reshape(region * region, -1).contiguous()
    b = torch.zeros((-(-2 * s_out // 8) * 8, a.shape[1]), dtype=torch.int8,
                    device=dev)
    b[: 2 * s_out] = ints.permute(0, 1, 3, 4, 2).reshape(2 * s_out, -1)
    if hasattr(conv_score, "conv_field_i8"):  # the quantizer on the card
        def quantized():
            return conv_score.conv_field_i8(cmap.codes, cmap.qinv, kernel,
                                            origin, mo, region, **kw)
        def quantize():
            return conv_score.quantize_i8(kernel, cmap.qinv)

        quant = [sum(device_ms(quantize, "conv_quant_i8").values())
                 for _ in range(ROUNDS)]
        qout = quantize()
        torch.cuda.synchronize()
        quant_sha = hashlib.sha256(b"".join(
            t.cpu().numpy().tobytes() for t in qout)).hexdigest()
        host = []
        for i in range(200):
            t0 = time.perf_counter()
            quantize()
            host.append(time.perf_counter() - t0)
            if i % 50 == 49:
                torch.cuda.synchronize()
    else:
        def quantized():
            return conv_score.cost_field_i8(
                cmap.codes, *conv_score.quantize_conv_kernel(
                    kernel, cmap.qinv), origin, mo, region, **kw)
        quant, quant_sha, host = None, None, [float("nan")]
    got = quantized()
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        raise RuntimeError("the quantized field differs from the plain one")
    print(json.dumps({
        "root": ROOT, "region": region, "mo": mo, "classes": c, "ww": ww,
        "splits": ARGS.splits,
        "kernel_ms": sorted(rounds), "median_ms": float(np.median(rounds)),
        "by_kernel": {k: float(np.median([p[k] for p in parts]))
                      for k in parts[0]},
        "quant_kernel_ms": quant and sorted(quant),
        "quant_median_ms": quant and float(np.median(quant)),
        "quant_wrapper_host_us": float(np.median(host)) * 1e6,
        "quant_sha256": quant_sha,
        "field_ms": events_ms(field),
        "quantized_field_ms": events_ms(quantized),
        "int_mm_ms": events_ms(lambda: torch._int_mm(a, b.T)),
        "cudnn_f32_ms": events_ms(lambda: conv_score.cost_field(
            cmap.padded, kernel, origin, mo, region)),
        "sha256": digest,
        "card": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
