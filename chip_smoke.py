"""On-card smoke run of the PyTorch/CUDA port (top_down_renderer_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  A. build the CUDA sources in csrc/ (one nvcc each, all started
     together), time it, and count in the SASS of the libraries, with the
     toolkit's cuobjdump, the tensor-core (HGMMA) instructions of the
     theta search, of its ablation (K4) and of the probe product, and the
     TMA tensor loads (UTMALDG) of the probe product and the window gather
     (fails without the tool or without the instructions); and, per
     variant of K4, its HGMMA, global loads, bulk copies and mbarrier
     operations: the variants that keep a product hold HGMMA (one_plane a
     third of full's, checked as many), gather_only and ring_only none,
     gather_only every
     window load and ring_only none of them; and, per instantiation of the
     theta search, its HGMMA and global and shared-memory loads (LDG,
     LDS): each code-map twin (crop_init_i4_kernel) two thirds of its
     float twin's HGMMA, each single-plane twin (crop_init_lokf_kernel,
     TDR_M_HILO=0) two thirds of the hi/lo float kernel's on the float
     map and one third on the codes; per instantiation of the code
     tracked kernel (crop_tracked_i4_kernel<C>) its bulk copies (UBLKCP: the windows of
     codes it stages), shared and global loads (LDS, LDG), each with
     UBLKCP and LDS; and the int8 wgmma (IGMMA) and the TMA tensor loads
     (UTMALDG) of the int8 conv field;
  B. the uniform crop kernels against their plain PyTorch versions on
     the same card tensors at the slice's shapes: 102,400 particles, a
     1024^2 map with 6 classes (8 packed channels), Th x R = 100 x 25,
     f = 1.0 and 0.5, edge and far-out centres included; each tracked
     kernel also runs twice on the same inputs and must return the same
     bits (here and wherever a kernel is held against its plain version),
     and the tracked kernels' offset fold (one launch) must equal
     crop_score.fold_offsets (here, in B2, D and D2), and the row order
     of the crop wrappers (the order kernel, one launch: the sorted keys,
     the permutation and the buckets' first rows) must equal
     crop_score.order_rows_plain bit for bit (in B2 on both K-bucket
     wrappers' rows, in D on the spread and clustered cells' rows and on
     every tile coordinate, in N1 on the node's first orders); the theta
     search's
     raw rows (its raw-row epilogue) against score_init_raw_plain: kf bit
     for bit, nums and dens within rel 1e-4, and select_init_cost of the
     kernel's rows the argmin of the theta-search kernel on >= 99.9 %,
     also on a cloud clustered to 100 px; the theta search (rows by
     position, an unchecked gather for warps inside their level), at f =
     1.0 and 0.5 and on the clustered cloud, argmin and raw rows bit for
     bit in the particles' order;
  B2. the K-bucket crop kernels against their plain versions on the
     same map with the 10 init hypotheses 10^{k/10} at res 0.5 (the
     levels the dispatch picks), and per bucket against the uniform
     kernel on that bucket's mip level; the K-bucket raw rows as in B,
     and the K-bucket theta search bit for bit in the particles' order;
     the fill kernel against its plain version;
  B3. the crop kernels on the nibble-packed code map (TDR_MAP_INT4=1;
     CropMap(int4=True), build_pyramid_maps(int4=True)) at B's inputs
     (6 classes: 4 code bytes a pixel), f = 1.0 and 0.5, against their
     plain versions (the float plain versions on the dequantized codes)
     as in B, and the K-bucket ones on B2's 10 hypotheses (one
     quantization of the full map, every level its subsample) as in B2,
     per bucket against the uniform code kernel on the bucket's level of
     the code pyramid; then the code tracked kernels' two routes, each
     against its plain version and, at budget 0 (crop_score.WINDOW_BUDGET:
     every block's gather from L2), bit for bit its staged call: the
     K-bucket pyramid (the plain window rule, crop_score.launch_windows,
     stages some windows: the coarse levels'), the spread cloud on the
     full level (none) and a cloud clustered to 100 px (all); and the
     code theta search (crop_init_i4_kernel: rows by position, an
     unchecked gather for warps inside their level) on that clustered
     cloud, raw rows against their plain version; and that search, at f =
     1.0 and 0.5, K buckets and the clustered cloud, argmin and raw rows
     bit for bit in the particles' order;
  B4. the crop kernels with the single-plane M (TDR_M_HILO=0;
     CropMap(m_hilo=False), build_pyramid_maps(m_hilo=False)), on the
     float and the code map, at B's and B2's inputs as in B3, against
     their plain versions (the dequantized single-plane M): costs and raw
     rows within rel 1e-4, kf within 1e-6 (the single plane's kf is the
     cell count to ~1e-7, summed in two orders), the gate's patterns off
     the gate, the argmin on 99.9 %; the tracked kernels' scales pass
     bit for bit crop_score.tracked_lokf's scales; the theta search on
     either map (crop_init_lokf_kernel, rows by position) also on B3's
     clustered cloud, and bit for bit in the particles' order as B3's;
  B5. the int8 conv field's kernels (csrc/conv_field_i8.cu,
     TDR_CONV_INT8=1) against their plain versions on random 640^2 maps of
     3 and 6 classes (CP 4, 8), windows W 16, 32, 64, regions 64-256, conv
     buckets mo 12-48, origins inside the map and clamped to its edges:
     the quantizer's B, chunk flags and scales against quantize_conv_kernel
     laid out by i8_layout, the field's int32 sums and field on those
     integers and with its two launches (conv_field_i8), bit for bit, and
     twice on the same inputs;
  C. the known-scale main path through the public entry points: the
     consumer drive (2,048 particles, 30 scans, must converge) and 20
     updates of 102,400 particles on a 1024^2 map from a spread init;
     each update must run the scorer its plan names: a crop kernel
     launch on the crop path, a conv cost field (cuDNN, counted in
     conv_score.CALLS) and no crop launch on the conv path, which the
     dispatch takes once the alive box fits a conv region;
  C2. the unknown-scale main path at fixed_scale -1 on the same world:
     20 updates of 102,400 particles with the robot standing, each of
     which must launch a K-bucket kernel (theta search first) and none
     the exact step; 20 with the robot driving, where every update the
     dispatch plans on the K-bucket path must launch its kernel and the
     exact step may run only where the plan falls to it; then the
     unknown-scale consumer drive (2,048 particles, 30 scans), which
     must find the scale;
  C3. 10 updates of 102,400 particles with TDR_RESAMPLE=pallas: each
     must launch the fill kernel, whose rows must equal the gather
     path's bit for bit on the same weights and shift;
  C4. the conv path: 20 known-scale updates of 102,400 particles on the
     clustered cloud of D (100 px, a 0.15 rad theta band), driving; each
     must take the conv path (one cost field, no crop launch and no int8
     field launch), and a second run from the same state and generator
     seed must end in the same state bit for bit;
  C7. C4 with the int8 conv field, the filter's conv_int8=True: each
     conv-tracked update whose window the int8 field takes (2 W a
     multiple of 32, under the s2d gate) launches conv_quant_i8 and
     conv_field_i8 once each and
     makes no cuDNN field, no crop kernel runs, the two runs end bit for
     bit equal, and the mean likelihood is logged beside C4's;
  C5. the main path on the code map, the filter's map_int4=True: C's 20
     known-scale updates from a spread init, each planned crop update
     launching its code kernel (crop_score_tracked_i4 or
     crop_score_init_i4) and no float crop kernel, each conv update no
     crop kernel, on the float32 conv map; then C2's 20 unknown-scale
     updates standing, each launching a K-bucket code kernel and no
     float one; each code tracked launch logs the share of its windows
     the plain rule stages;
  C6. the main path with the single-plane M, the filter's m_hilo=False:
     C's 20 known-scale updates on the float map and on the code map
     (map_int4=True), each planned crop update launching its "_lokf"
     kernel (the scales pass before the tracked one) and no other crop
     kernel; C5's 20 unknown-scale updates standing on the code map, each
     launching a K-bucket "_i4_lokf" kernel and no other; then the
     unknown-scale consumer drive with m_hilo=False, held to C2's gates,
     launching no hi/lo crop kernel;
  D. each kernel's own device time (20 launches under torch.profiler,
     after 3 warm-up calls), and median host-clock times (3 warm-up, 20
     timed, synchronised) of its wrapper, its plain version, the PyTorch
     call that computes the same function where there is one, and one
     whole ParticleFilter.update, with the card's clocks before and after,
     at 102,400 particles on the 1024^2 map: theta search on a spread
     cloud, tracked on a cloud clustered to 100 px, the unknown-scale
     update from the 10 hypotheses (theta search, and tracked once each
     particle has a theta), the host part of its dispatch, the fill on
     C3's last state and on 2^22 random rows, and the offset fold on the
     clustered cell's offsets (beside its bound, its floor: the device
     time of a one-element fill under the same profiler, below which no
     one-block launch goes) and on D2's K = 12 bucket tables (checked
     there too); the row order on the clustered cell's rows beside
     torch.sort(stable=True) of the same keys (device time under the
     profiler, CUDA events, host clock) and its bound, and the profiles
     of the crop tracked and init updates, which must hold no library
     sort kernel; on the clustered cloud also the conv cost
     field alone (CUDA events) and the conv update beside the crop
     update; on those same 3-class inputs each crop kernel
     is held against its plain version as in B; the tracked kernel also
     runs on the spread cloud (tiles over all 100 shifts); the lines of
     the crop kernels give the distinct pixels of their stencil (per
     bucket on the K-bucket path), the pixels each particle reads;
     the raw-row kernels on the theta searches' inputs; and each code-map
     kernel (the filter map's or pyramid's codes, C = 3: 2 bytes a pixel)
     beside its float twin on the same cell, kernel, wrapper and plain
     times, its map operand's bytes and its bound with the map at those
     bytes, held against its plain version as in B (the code tracked ones
     also with the share of windows staged and their kernel time at
     budget 0); and each
     single-plane kernel (float and code) beside its hi/lo twin on the
     same cell (the theta searches' bound on two products a k16 step on
     the float map, one on the codes), with the scales pass on the
     clustered cell's fold, held against its plain version as in B4; and
     on the clustered conv cell the int8 field (its two kernels under the
     profiler, the quantizer and the field; the field with its two
     launches by host clock and by CUDA events beside cuDNN's float32
     field; plain versions; torch._int_mm on the block's im2col built
     outside the timed window), the field's bound on the taps with a
     nonzero integer (int8 tensor cores, or bytes) and on the dense taps,
     the quantizer's (bytes), and the conv update under conv_int8=True
     beside the float32 route's;
  M1. the multi-device filter (ParticleFilter(mesh=...)) on a world-1
     NCCL mesh on the card, 102,400 particles on the 1024^2 map: (a) ten
     unknown-scale updates standing (the K-bucket theta search through
     the raw-row kernel, then tracked), (b) five updates of C4's
     clustered cloud on the row-sharded conv step, (c) one known-scale
     update of a spread cloud, which plans crop and so runs the sharded
     exact step, as the reference's mesh does; each held against the
     single-device filter from the same state with the same draws
     (max_likelihood rtol 1e-4, atol 1e-5), each update's plan and
     launches checked, the dispatch keys equal to the plans; then the
     mesh update against the single-device one by host clock, (a)'s theta
     search and (b)'s conv update; and two K-bucket updates on the code
     pyramid (map_int4=True), the mesh's raw rows through
     crop_score_multi_init_raw_i4, then tracked, held to one device's;
     and two with the single-plane M (m_hilo=False), on the float and the
     code pyramid, through crop_score_multi_init_raw[_i4]_lokf, then
     tracked, no other crop kernel, held to one device's;
  M2. the same three on two ranks over gloo on the one card (two
     processes; collectives through host memory), held against M1 at the
     same tolerance (their times are not the card's mesh times);
  N. the node (TopDownRenderNode, the package's entry point) at 102,400
     particles on the 1536^2 six-class city world, loaded from
     benchmarks/data/city.png by the port's PNG reader, replaying the city
     drive's first scans (tests/city_drive_torch.py; 8,192 points each):
     N1 300 scans after warmup (the first scan's latency also without
     it), each update on the scorer its plan names (crop kernels, conv
     cost field, or the exact step where the plan falls to it), the node
     converged and the published poses within NODE_ERR_M of the true
     trajectory on average; per-scan render, filter and publish times
     (median, p90), and the blocking reads per scan (the synchronising
     calls torch.cuda's sync debug mode reports, by site, and the waits on
     the filter's snapshot copy); N2 the same with async_publish, whose
     nowait snapshot read must make no synchronising call (sync debug
     mode "error"); N3 the unknown-scale node over 150 scans, with a
     relocalisation kick (reinitialize_fraction) that makes a K-bucket
     update mixed (theta search and tracked);
  R. the operator's path, all at 102,400 particles on the 1536^2 city
     world, its inputs written from numpy into a temporary directory:
     the world as an SVG (tests/city_svg_torch.py: one rect per
     same-colour run, merged down repeating rows), the YAML configs, the
     drive's N_SCANS scans as a bz2 ROS bag (tests/rosbag_write_torch.py)
     converted by io/rosbag.py's main (equal to the bag written bit for
     bit); R1 run_node.main --config --bag --cache-dir in-process on the
     card: the native SVG parser ran (it and the Python one give the same
     polygons; both timed), the rasterisation on the card equals
     city.png's class maps bit for bit (timed with its crossings, and the
     EDT), the node converges, and its published poses equal N1's bit for
     bit (R1c: a node built from city.png in code replays the same bag
     right after, the control for R1's per-scan times); R1b the node again from the cache (no rasterisation, the grid
     equal) and the map from the raster directory (class maps equal); R2
     ActiveLocalizer on the node's GMM means after scans 5 and 10 and at
     the end, and on 8 particles of scan 5's cloud (K = 8), equal to the
     CPU's run; R3 accumulate_counts over the
     drive's points in the map frame, equal to the CPU's, and
     MapRefiner.refine with the majority vote off and on, map_viz.png
     reading back equal; R4 the filter state and generators saved after
     scan 150 and resumed in R1b's node: scans 151-170 give R1's state and
     poses bit for bit; R5 device_trace over R1's first 5 updates names
     the node's trace_span labels and the crop kernels launched, and the
     node's StepTimer report;
  P. the probe path (top_down_renderer_torch.probes, the counterparts of
     the TPU's probe kernels in tests/): the window gather (K1) on the
     TPU DMA probes' windows, bit for bit (strided and the TMA-staged
     async geometry, at any byte; copies beside advanced indexing of the
     strided view), then 102,400 windows of 56 x 640 B summed on a 13 MB
     and an 84 MB map in each fetch geometry, strided and async also at
     any row and byte; the tensor-core products (K2: wgmma fed by TMA,
     the select route on mma.sync) on the TPU matrix-unit probes' shapes,
     int8 bit for bit and bf16 within MM_TOL, row 13's 48 x 64 x 35,840
     with K split (converted and bf16; two launches bit for bit), then at
     the theta search's work shape (its last wave's tiles split over K)
     beside torch._int_mm and torch.matmul; a line a case with its route,
     kernel and wrapper ms, bound, share and library ms; the tracked crop
     kernel with stages knocked out (K3: no_fold, no_gather,
     gather_only, fold_only, and checked, every row through the
     bounds-checked loop) on D's clustered cloud and on the probe's own
     spread, clustered and K-bucket clouds, each variant with its rows in
     both orders (by position, as the production wrapper sorts them, and
     by key alone; a line each), `full` and `checked` bit for bit against
     the production kernel and the others against their plain versions
     at REL_TOL; the theta search with stages knocked out
     (K4: one_plane, no_gather, gather_only, ring_only, no_promote, and
     checked, every warp through the bounds-checked gather) on D's
     crop-init spread cell, the TPU clone's 6-class spread cloud and D2's
     multi-init cell, every variant with its rows by position (as the
     production wrappers order them), full and checked also in the
     particles' order, `full` and `checked` bit for bit against the
     production theta search (argmin and raw rows, uniform and K-bucket), every
     variant against its plain version (rel 1e-4, k a near-argmin), with
     the production kernel's time and `full`'s wrapper split into inputs,
     M build and launch; one JSON line a probe, a line whenever a kernel
     time took more than one profile;
  E. one JSON line of kernel results with each kernel's bound on the
     work its inputs need (the crop kernels per distinct stencil pixel:
     the theta searches on the nonzero entries of M on bf16 tensor cores,
     the tracked kernels on float32 outside them), each crop kernel's
     bound also on the per-cell basis of earlier runs (2 (C + 1) FLOPs
     per stencil cell, float32, the packed map read once), the largest
     relative error of each theta search against its plain version, the
     card's name and power limit, and the final {"ok": true, "device":
     ...} line.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import city_drive_torch as city_drive  # noqa: E402
import city_svg_torch as city_svg  # noqa: E402
import rosbag_write_torch as rosbag_write  # noqa: E402
from drive_consumer_torch import (  # noqa: E402
    SCALE_GT,
    drive,
    drive_unknown_scale,
    make_filter,
)
from spawn_ranks import run_ranks  # noqa: E402
from top_down_renderer_torch import kernels  # noqa: E402
from top_down_renderer_torch.filter import conv_score  # noqa: E402
from top_down_renderer_torch.filter import crop_score as cs  # noqa: E402
from top_down_renderer_torch.filter import filter as filter_mod  # noqa: E402
from top_down_renderer_torch.filter import gmm as gmm_mod  # noqa: E402
from top_down_renderer_torch.filter import multiscale as ms  # noqa: E402
from top_down_renderer_torch.filter import resample as rs  # noqa: E402
from top_down_renderer_torch.filter.scoring import (  # noqa: E402
    rotation_shift,
    shift_mask,
)
from top_down_renderer_torch.parallel import sharding  # noqa: E402
from top_down_renderer_torch.probes import __main__ as probes  # noqa: E402
from top_down_renderer_torch.probes.__main__ import (  # noqa: E402
    device_us,
    events_ms,
    kernel_ms,
)
from top_down_renderer_torch.probes import crop_ablate as ca  # noqa: E402
from top_down_renderer_torch.render.geometric import (  # noqa: E402
    render_geometric_polar,
)
from top_down_renderer_torch.render.semantic import (  # noqa: E402
    render_semantic_polar,
)
from top_down_renderer_torch.testing import synthetic_setup  # noqa: E402
from top_down_renderer_torch.utils.convert import (  # noqa: E402
    filter_state_from_numpy,
    filter_state_to_numpy,
)
from top_down_renderer_torch.active import (  # noqa: E402
    ActiveLocalizer,
    get_best_rel_pos,
)
from top_down_renderer_torch.io import rosbag  # noqa: E402
from top_down_renderer_torch.io.replay import Bag, replay  # noqa: E402
from top_down_renderer_torch.maps import native, png, rasterize, svg  # noqa: E402
from top_down_renderer_torch.maps.edt import compute_dists  # noqa: E402
from top_down_renderer_torch.maps.map import (  # noqa: E402
    TopDownMap,
    class_maps_from_index_image,
)
from top_down_renderer_torch.maps.png import read_png_rgb  # noqa: E402
from top_down_renderer_torch.maps.polar import polar_stencil  # noqa: E402
from top_down_renderer_torch.runtime import run_node  # noqa: E402
from top_down_renderer_torch.runtime.node import (  # noqa: E402
    TopDownRenderNode,
)
from top_down_renderer_torch.tools.refine import (  # noqa: E402
    MapRefiner,
    accumulate_counts,
)
from top_down_renderer_torch.utils.checkpoint import (  # noqa: E402
    filter_generators,
    load_filter_state,
    save_filter_state,
)
from top_down_renderer_torch.utils.tracing import device_trace  # noqa: E402
from util_synthetic import generate_scan_points, make_world  # noqa: E402

CROP_SRC = "top_down_renderer_torch/csrc/crop_score.cu"
INIT_SRC = "top_down_renderer_torch/csrc/crop_score_init.cu"
FILL_SRC = "top_down_renderer_torch/csrc/fill_rows.cu"
CONV_I8_SRC = "top_down_renderer_torch/csrc/conv_field_i8.cu"
# the kernels' names in a profile, at the drive map's 3 classes (the two
# theta searches are one kernel at CP = 4 channels, their raw-row epilogue
# another, the two tracked kernels one at C = 3); a bool template argument
# in either of the demangler's spellings
_ARGMIN = ("crop_init_kernel<4, false>", "crop_init_kernel<4, (bool)0>")
_RAW = ("crop_init_kernel<4, true>", "crop_init_kernel<4, (bool)1>")
# their twins on the nibble-packed code map (TDR_MAP_INT4=1)
_ARGMIN_I4 = ("crop_init_i4_kernel<4, false>",
              "crop_init_i4_kernel<4, (bool)0>")
_RAW_I4 = ("crop_init_i4_kernel<4, true>", "crop_init_i4_kernel<4, (bool)1>")


def _lokf_symbols(kernel, n, *flags):
    """A single-plane kernel's name, its int template argument n and its
    bool ones, in either of the demangler's spellings."""
    return tuple(f"{kernel}<{n}, " + ", ".join(spell[f] for f in flags) + ">"
                 for spell in ({True: "true", False: "false"},
                               {True: "(bool)1", False: "(bool)0"}))


SYMBOLS = {
    "crop_fold": ("crop_fold_kernel",),
    "crop_order": ("crop_order_kernel",),
    "crop_score_tracked": ("crop_tracked_kernel<3>",),
    "crop_score_init": _ARGMIN,
    "crop_score_multi_tracked": ("crop_tracked_kernel<3>",),
    "crop_score_multi_init": _ARGMIN,
    "crop_score_init_raw": _RAW,
    "crop_score_multi_init_raw": _RAW,
    "crop_score_tracked_i4": ("crop_tracked_i4_kernel<3>",),
    "crop_score_init_i4": _ARGMIN_I4,
    "crop_score_init_raw_i4": _RAW_I4,
    "crop_score_multi_tracked_i4": ("crop_tracked_i4_kernel<3>",),
    "crop_score_multi_init_i4": _ARGMIN_I4,
    "crop_score_multi_init_raw_i4": _RAW_I4,
    "fill_rows": ("fill_rows_kernel",),
}
# their twins with the single-plane M (TDR_M_HILO=0): crop_init_lokf_kernel
# <CP, RAW, I4>, crop_tracked_lokf_kernel<C, I4>, and the tracked kernels'
# weights pass (timed on the float map)
for _i4 in (False, True):
    _tag = "_i4" * _i4 + "_lokf"
    SYMBOLS.update({
        f"crop_score_tracked{_tag}": _lokf_symbols(
            "crop_tracked_lokf_kernel", 3, _i4),
        f"crop_score_multi_tracked{_tag}": _lokf_symbols(
            "crop_tracked_lokf_kernel", 3, _i4),
        f"crop_score_init{_tag}": _lokf_symbols(
            "crop_init_lokf_kernel", 4, False, _i4),
        f"crop_score_multi_init{_tag}": _lokf_symbols(
            "crop_init_lokf_kernel", 4, False, _i4),
        f"crop_score_init_raw{_tag}": _lokf_symbols(
            "crop_init_lokf_kernel", 4, True, _i4),
        f"crop_score_multi_init_raw{_tag}": _lokf_symbols(
            "crop_init_lokf_kernel", 4, True, _i4),
    })
SYMBOLS["crop_lokf_weights"] = _lokf_symbols("crop_lokf_weights_kernel", 3,
                                             False)
# the int8 conv field (a cluster adds a split tile's sums) and its
# quantizer
SYMBOLS["conv_field_i8"] = ("conv_field_i8_kernel",)
SYMBOLS["conv_quant_i8"] = ("conv_quant_i8_kernel",)
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    # the tracked kernels' offset fold, launched by both tracked wrappers
    "crop_fold": (CROP_SRC, "top_down_renderer_tpu/filter/pallas_score.py:693"),
    # the rows' order (the keys, their stable sort, the permutation and
    # the buckets' first rows, one launch), taken by every crop wrapper
    # (both tracked kernels, every theta search); the reference's wrapper
    # orders the rows with a counting sort in JAX, no kernel of its own
    "crop_order": (CROP_SRC,
                   "top_down_renderer_tpu/filter/pallas_score.py:693"),
    "crop_score_tracked": (
        CROP_SRC, "top_down_renderer_tpu/filter/pallas_score.py:693"),
    "crop_score_init": (
        INIT_SRC, "top_down_renderer_tpu/filter/pallas_score.py:693"),
    "crop_score_multi_tracked": (
        CROP_SRC, "top_down_renderer_tpu/filter/multiscale.py:444"),
    "crop_score_multi_init": (
        INIT_SRC, "top_down_renderer_tpu/filter/multiscale.py:363"),
    # the raw-row epilogue (sel_init = 0) of the same kernel: the uniform
    # one is on no path of the reference (its parity surface), the
    # K-bucket one is the multi-device init step's
    "crop_score_init_raw": (
        INIT_SRC, "top_down_renderer_tpu/filter/pallas_score.py:693"),
    "crop_score_multi_init_raw": (
        INIT_SRC, "top_down_renderer_tpu/filter/multiscale.py:363"),
    # the same TPU kernel's nibble-packed configuration (TDR_MAP_INT4=1,
    # its `i4` layout), on the same bodies reading the code map
    "crop_score_tracked_i4": (
        CROP_SRC, "top_down_renderer_tpu/filter/pallas_score.py:693"),
    "crop_score_init_i4": (
        INIT_SRC, "top_down_renderer_tpu/filter/pallas_score.py:693"),
    "crop_score_init_raw_i4": (
        INIT_SRC, "top_down_renderer_tpu/filter/pallas_score.py:693"),
    "crop_score_multi_tracked_i4": (
        CROP_SRC, "top_down_renderer_tpu/filter/multiscale.py:444"),
    "crop_score_multi_init_i4": (
        INIT_SRC, "top_down_renderer_tpu/filter/multiscale.py:363"),
    "crop_score_multi_init_raw_i4": (
        INIT_SRC, "top_down_renderer_tpu/filter/multiscale.py:363"),
    "fill_rows": (FILL_SRC, "top_down_renderer_tpu/filter/resample.py:116"),
    # the single-plane M's weights pass before the tracked kernel: every
    # (bucket, shift)'s integers and scales, the lokf quantization of
    # _run_kernel (XLA around the pallas_call)
    "crop_lokf_weights": (
        CROP_SRC, "top_down_renderer_tpu/filter/pallas_score.py:1053"),
    # the conv path's int8 cost field (TDR_CONV_INT8=1): an XLA contraction
    # of the reference, not a Pallas kernel
    "conv_field_i8": (
        CONV_I8_SRC, "top_down_renderer_tpu/filter/conv_score.py:562"),
    # its quantization of the kernel's columns to hi/lo int8 pairs and the
    # layout of the integers (XLA in the reference's function)
    "conv_quant_i8": (
        CONV_I8_SRC, "top_down_renderer_tpu/filter/conv_score.py:588"),
    # the probes (phase P): each replaces several TPU probe kernels, each
    # case of its line names its own
    "crop_ablate": ("top_down_renderer_torch/csrc/crop_ablate.cu",
                    "tests/exp_crop_ablate.py:39"),
    # the same TPU kernel in its theta-search configuration (ABL_S_COLS
    # 128), on the theta search's body
    "crop_ablate_init": ("top_down_renderer_torch/csrc/crop_ablate_init.cu",
                         "tests/exp_crop_ablate.py:39"),
    "probe_window_gather": ("top_down_renderer_torch/csrc/probe_window.cu",
                            "tests/probe_dma_fold.py:41"),
    "probe_mm": ("top_down_renderer_torch/csrc/probe_mm.cu",
                 "tests/probe_int8_mm.py:17"),
}
# the same TPU kernel with its single-plane M (TDR_M_HILO=0, the lokf
# scheme), on the same bodies with one B plane
for _name in [k for k in KERNELS if k.startswith("crop_score_")]:
    KERNELS[_name + "_lokf"] = KERNELS[_name]
# each probe kernel's case that stands for it in the kernels line
PROBE_HEADLINE = {"crop_ablate": "ablate/D clustered C=3/full",
                  "crop_ablate_init": "ablate_init/D spread C=3/full",
                  "probe_window_gather": "window/l2/strided",
                  "probe_mm": "theta_shape/s8"}
RAW = ("crop_score_init_raw", "crop_score_multi_init_raw")
RAW_I4 = tuple(k + "_i4" for k in RAW)
RAW_LOKF = tuple(k + "_lokf" for k in RAW)
RAW_I4_LOKF = tuple(k + "_lokf" for k in RAW_I4)
INIT = (("crop_score_init", "crop_score_multi_init") + RAW
        + ("crop_score_init_i4", "crop_score_multi_init_i4") + RAW_I4)
INIT += tuple(k + "_lokf" for k in INIT)
LOKF_KF_TOL = 1e-6  # the single plane's kf: the count to ~1e-7 (B4)
# published H100 SXM peaks (dense): float32 outside the tensor cores, bf16
# on them, HBM
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
N = 102_400
HW = 1024
C = 6
RES = 0.5  # range m/bin: f = scale 2 * 0.5 = 1.0, mip 1
REL_TOL = 1e-4  # float32 sums of ~15,000 positive terms in two orders
ML_RTOL, ML_ATOL = 1e-4, 1e-5  # max_likelihood, mesh against one device
M_MULTI = 10  # M's unknown-scale updates
M_CONV = 5  # M's conv updates


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def smi(query: str) -> str:
    """nvidia-smi's reading of `query` for card 0."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def card_name_and_limit() -> str:
    return smi("name,power.limit")


def log_clocks(label: str) -> None:
    log(f"[{label}] SM clock, its maximum, power draw, temperature: "
        + smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu"))


# the instructions each library's SASS must hold: wgmma (HGMMA; IGMMA
# for int8), the TMA tensor load (UTMALDG)
SASS_NEEDS = {"crop_score_init": ("HGMMA",),
              "conv_field_i8": ("IGMMA", "UTMALDG"),
              "crop_ablate_init": ("HGMMA", "UBLKCP"),
              "probe_mm": ("HGMMA", "UTMALDG"),
              "probe_window": ("UTMALDG",)}


def read_sass(name: str) -> str:
    """The SASS of csrc/<name>.cu's library, by the toolkit's cuobjdump
    (a toolkit without the tool fails)."""
    tool = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
    check(os.path.isfile(tool), f"no cuobjdump beside nvcc: {name}'s SASS "
          "cannot be read")
    return subprocess.run([tool, "-sass", str(kernels.build(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


def log_sass(name: str, opcodes) -> None:
    """Count each of `opcodes` in the SASS of csrc/<name>.cu's library; a
    build without one of them fails."""
    sass = read_sass(name)
    for op in opcodes:
        lines = [ln.strip() for ln in sass.splitlines() if op in ln]
        check(lines, f"no {op} instruction in {name}'s SASS")
        log(f"[A] {name}: {len(lines)} {op} instructions in its SASS, e.g. "
            f"{lines[0]}")


# K4's variants by index (csrc/crop_ablate_init.cu), in its mangled names
# crop_ablate_init_kernel<CP, RAW, V> (ILi4ELb0ELi<V>E: CP 4, argmin)
_ABLATE_INIT_FN = re.compile(
    r"Function : \S*crop_ablate_init_kernelILi4ELb0ELi(\d)E")
SASS_COUNTED = ("HGMMA", "LDG", "UBLKCP", "SYNCS")


def log_ablate_init_sass() -> dict:
    """Count, per variant of K4 (CP 4, argmin rows), its tensor-core
    products (HGMMA), global loads (LDG), bulk copies (UBLKCP) and
    mbarrier operations (SYNCS), so that no knocked-out stage took a kept
    one with it: full, one_plane, no_gather, no_promote and checked hold
    HGMMA (one_plane a third of full's, checked as many as full),
    gather_only and ring_only none; gather_only holds every global load
    full does, ring_only fewer (no window); each holds the ring's bulk
    copies."""
    sass = read_sass("crop_ablate_init")
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            hit = _ABLATE_INIT_FN.search(line)
            current = ca.INIT_VARIANTS[int(hit.group(1))] if hit else None
            if current:
                counts[current] = dict.fromkeys(SASS_COUNTED, 0)
        elif current:
            for op in SASS_COUNTED:
                counts[current][op] += f" {op}" in line
    check(set(counts) == set(ca.INIT_VARIANTS),
          f"crop_ablate_init's SASS names the variants {sorted(counts)}")
    for v, c in counts.items():
        log(f"[A] crop_ablate_init {v} (CP 4, argmin): {c}")
    hg = {v: c["HGMMA"] for v, c in counts.items()}
    check(all(hg[v] > 0 for v in ("full", "no_gather", "no_promote"))
          and 3 * hg["one_plane"] == hg["full"] == hg["checked"]
          and hg["gather_only"] == hg["ring_only"] == 0,
          f"K4's tensor-core products by variant: {hg}")
    ldg = {v: c["LDG"] for v, c in counts.items()}
    check(ldg["gather_only"] >= ldg["full"] > ldg["ring_only"],
          f"K4's global loads by variant: {ldg}")
    check(all(c["UBLKCP"] > 0 for c in counts.values()),
          "a K4 variant lost the ring's bulk copies")
    return counts


_INIT_FN = re.compile(
    r"Function : \S*(crop_init(?:_i4)?_kernel)ILi(\d)ELb(\d)E")
# crop_init_lokf_kernel<CP, RAW, I4>: the single-plane M's
_INIT_LOKF_FN = re.compile(
    r"Function : \S*(crop_init_lokf_kernel)ILi(\d)ELb(\d)ELb(\d)E")


INIT_COUNTED = ("HGMMA", "LDG", "LDS")


def log_init_sass() -> dict:
    """Count, per instantiation of the theta search (crop_init_kernel on
    the float map, crop_init_i4_kernel on the code map, and their
    single-plane twins crop_init_lokf_kernel; CP 2, 4, 8 x argmin, raw),
    its tensor-core products (HGMMA) and global and shared-memory loads
    (LDG, LDS): each code twin holds HGMMA, two thirds of its float twin's
    (its A, the codes, is exact in bf16: no A_lo product); each
    single-plane twin two thirds of the hi/lo float kernel's on the float
    map (no B_lo product) and one third on the codes (neither)."""
    counts, current = {}, None
    for line in read_sass("crop_score_init").splitlines():
        if "Function :" in line:
            hit = _INIT_FN.search(line) or _INIT_LOKF_FN.search(line)
            current = hit.groups() if hit else None
            if current:
                counts[current] = dict.fromkeys(INIT_COUNTED, 0)
        elif current:
            for op in INIT_COUNTED:
                counts[current][op] += f" {op}" in line
    twins = [(k, ("crop_init_kernel",) + k[1:]) for k in counts
             if k[0] == "crop_init_i4_kernel"]
    check(len(twins) == 6 and all(
        3 * counts[a]["HGMMA"] == 2 * counts.get(b, {}).get("HGMMA", -1) > 0
        for a, b in twins), f"crop_score_init's HGMMA by kernel: {counts}")
    lokf = [(k, ("crop_init_kernel",) + k[1:3]) for k in counts
            if k[0] == "crop_init_lokf_kernel"]
    check(len(lokf) == 12 and all(
        3 * counts[a]["HGMMA"] == (1 if a[3] == "1" else 2)
        * counts.get(b, {}).get("HGMMA", -1) > 0 for a, b in lokf),
        f"crop_score_init's single-plane HGMMA by kernel: {counts}")
    for key, c in sorted(counts.items()):
        fn, cp, raw = key[:3]
        what = "" if len(key) == 3 else (", code map" if key[3] == "1"
                                         else ", float map")
        log(f"[A] crop_score_init {fn} (CP {cp}, "
            f"{'raw' if raw == '1' else 'argmin'}{what}): {c}")
    return counts


# crop_tracked_lokf_kernel<C, I4> in its mangled names (ILi<C>ELb<I4>E)
_TRACKED_LOKF_FN = re.compile(
    r"Function : \S*crop_tracked_lokf_kernelILi(\d)ELb(\d)E")
TRACKED_LOKF_COUNTED = ("UBLKCP", "SYNCS", "DADD", "LDG")


def log_tracked_lokf_sass() -> dict:
    """Count, per instantiation of the single-plane tracked kernel
    (crop_tracked_lokf_kernel<C, I4>: C 1..7, float and code map), its
    bulk copies (UBLKCP), mbarrier operations (SYNCS), float64 adds (DADD)
    and global loads (LDG): each copies its group's weights (UBLKCP) and
    folds none in float64 (no DADD)."""
    counts, current = {}, None
    for line in read_sass("crop_score").splitlines():
        if "Function :" in line:
            hit = _TRACKED_LOKF_FN.search(line)
            current = hit.groups() if hit else None
            if current:
                counts[current] = dict.fromkeys(TRACKED_LOKF_COUNTED, 0)
        elif current:
            for op in TRACKED_LOKF_COUNTED:
                counts[current][op] += f" {op}" in line
    check(len(counts) == 14, "crop_score's SASS names the single-plane "
          f"tracked kernels {sorted(counts)}")
    for (c, i4), n in sorted(counts.items()):
        log(f"[A] crop_tracked_lokf_kernel<{c}, "
            f"{'code' if i4 == '1' else 'float'} map>: {n}")
    check(all(n["UBLKCP"] > 0 and n["DADD"] == 0 for n in counts.values()),
          f"crop_tracked_lokf_kernel's bulk copies and float64 adds: {counts}")
    return counts


# crop_tracked_i4_kernel<C> in its mangled names (ILi<C>E)
_TRACKED_I4_FN = re.compile(r"Function : \S*crop_tracked_i4_kernelILi(\d)E")
TRACKED_I4_COUNTED = ("UBLKCP", "LDS", "LDG")


def log_tracked_i4_sass() -> dict:
    """Count, per instantiation of the code tracked kernel
    (crop_tracked_i4_kernel<C>: C 1..7), its bulk copies (UBLKCP: the
    window's rows), shared-memory loads (LDS: the gather from the window,
    the weights and offsets) and global loads (LDG: the gather from L2,
    the fold's tables): each stages windows by bulk copies."""
    counts, current = {}, None
    for line in read_sass("crop_score").splitlines():
        if "Function :" in line:
            hit = _TRACKED_I4_FN.search(line)
            current = hit.group(1) if hit else None
            if current:
                counts[current] = dict.fromkeys(TRACKED_I4_COUNTED, 0)
        elif current:
            for op in TRACKED_I4_COUNTED:
                counts[current][op] += f" {op}" in line
    check(len(counts) == 7, "crop_score's SASS names the code tracked "
          f"kernels {sorted(counts)}")
    for c, n in sorted(counts.items()):
        log(f"[A] crop_tracked_i4_kernel<{c}>: {n}")
    check(all(n["UBLKCP"] > 0 and n["LDS"] > 0 for n in counts.values()),
          f"crop_tracked_i4_kernel's bulk copies and shared loads: {counts}")
    return counts


def max_rel(ref: torch.Tensor, got: torch.Tensor) -> float:
    return float(((got - ref).abs() / ref.abs().clamp(min=1e-9)).max())


def same_bits(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def same_kf(kf, rkf, kf_tol) -> bool:
    """kf bit for bit, or (the single-plane M) within kf_tol."""
    if kf_tol == 0.0:
        return torch.equal(kf, rkf)
    return float((kf - rkf).abs().max()) <= kf_tol


def off_gate(rkf, kf_tol):
    """The rows whose plain kf lies further than kf_tol from the 0.5 gate
    (all of them where kf is bit for bit): a single-plane kf, the count to
    ~1e-7 summed in two orders, may fall either side of it."""
    return (rkf - 0.5).abs() > kf_tol if kf_tol else torch.ones_like(
        rkf, dtype=torch.bool)


def compare_tracked(label, errs, name, tracked, need_gated=False,
                    kf_tol=0.0) -> int:
    """A tracked kernel against its plain version: tracked is (kernel
    call, plain call) without arguments, name its kernel's.  The kernel
    runs twice and must return the same bits; kf bit for bit, or within
    kf_tol (the single-plane M), the gate's patterns then compared off the
    gate (off_gate); cost and norm within REL_TOL.  Folds the largest
    |err| into errs["abs"]; returns the count of kf-gated particles."""
    num, den, kf = tracked[0]()
    again = tracked[0]()
    rnum, rden, rkf = tracked[1]()
    torch.cuda.synchronize()
    check(same_bits((num, den, kf), again),
          f"{label}: the tracked kernel does not repeat bit for bit")
    check(same_kf(kf, rkf, kf_tol), f"{label}: tracked kf differs")
    clear = off_gate(rkf, kf_tol)
    ok = (rkf >= 0.5) & clear
    if need_gated:
        check(0 < int(ok.sum()) < ok.numel(),
              f"{label}: no kf-gated particles")
    for a, b, what in ((num, rnum, "cost"), (den, rden, "norm")):
        rel = max_rel(b[ok], a[ok])
        check(rel <= REL_TOL, f"{label}: tracked {what} rel {rel}")
        errs["abs"][name] = max(errs["abs"][name],
                                float((a - b)[ok].abs().max()))
    cost = torch.where(kf < 0.5, torch.nan, num / den)
    rcost = torch.where(rkf < 0.5, torch.nan, rnum / rden)
    check(torch.equal(cost.isnan()[clear], rcost.isnan()[clear]),
          f"{label}: NaN pattern")
    return int((~ok).sum())


def compare(label, errs, names, tracked, init, need_gated=False,
            kf_tol=0.0) -> None:
    """A tracked and a theta-search kernel against their plain versions:
    tracked / init are (kernel call, plain call) without arguments, names
    their kernels'.  The tracked kernel as compare_tracked checks it; the
    theta search's kf bit for bit, or within kf_tol (the single-plane M),
    the gate's patterns then compared off the gate (off_gate).  Folds the
    largest |err| of each into errs["abs"], and the theta search's largest
    relative error into errs["rel"]."""
    gated = compare_tracked(label, errs, names[0], tracked, need_gated,
                            kf_tol)
    best, k, kf = init[0]()
    rbest, rk, rkf = init[1]()
    torch.cuda.synchronize()
    check(same_kf(kf, rkf, kf_tol), f"{label}: init kf differs")
    clear = off_gate(rkf, kf_tol)
    same_k = float((k == rk).float().mean())
    check(same_k >= 0.999, f"{label}: init argmin agrees on {same_k:.5f}")
    fin = (best < cs.FLT_MAX) & (rbest < cs.FLT_MAX)
    check(torch.equal((best < cs.FLT_MAX)[clear], (rbest < cs.FLT_MAX)[clear]),
          f"{label}: init FLT_MAX pattern")
    rel = max_rel(rbest[fin], best[fin])
    check(rel <= REL_TOL, f"{label}: init best rel {rel}")
    errs["rel"][names[1]] = max(errs["rel"][names[1]], rel)
    errs["abs"][names[1]] = max(errs["abs"][names[1]],
                                float((best - rbest)[fin].abs().max()))
    log(f"[{label}] tracked (repeats bit for bit) and init agree (init "
        f"argmin same on "
        f"{same_k:.5f}, init best rel {rel:.3e}, kf-gated "
        f"{gated})")


def compare_raw(label, errs, name, raw, plain, sel, kf_tol=0.0) -> None:
    """A raw-row kernel against its plain version (calls without
    arguments): kf bit for bit (or within kf_tol), nums and dens within
    REL_TOL where kf >= 0.5 (off the gate), and select_init_cost of the
    kernel's rows the theta-search kernel's argmin (`sel`) on >= 99.9 % of
    the rows.  Folds the largest |err| and relative error into errs."""
    nums, dens, kf = raw()
    rnums, rdens, rkf = plain()
    best, k, _ = sel()
    torch.cuda.synchronize()
    check(same_kf(kf, rkf, kf_tol), f"{label}: raw kf differs")
    ok = (rkf >= 0.5) & off_gate(rkf, kf_tol)
    rel = 0.0
    for a, b, what in ((nums, rnums, "num"), (dens, rdens, "den")):
        r = max_rel(b[ok], a[ok])
        check(r <= REL_TOL, f"{label}: raw {what} rel {r}")
        rel = max(rel, r)
        errs["abs"][name] = max(errs["abs"][name],
                                float((a - b)[ok].abs().max()))
    errs["rel"][name] = max(errs["rel"][name], rel)
    rbest, theta = filter_mod._raw_theta((nums, dens, kf), nums.shape[1])
    rk = torch.round(theta * (nums.shape[1] / (2 * math.pi))).long()
    same_k = float((rk == k).float().mean())
    check(same_k >= 0.999, f"{label}: select_init_cost of the raw rows "
          f"agrees with the argmin kernel on {same_k:.5f}")
    kf_err = float((kf - rkf).abs().max()) if kf.numel() else 0.0
    kf_how = ("bit for bit" if kf_err == 0.0
              else f"within {kf_tol:g} (largest |diff| {kf_err:.1e})")
    log(f"[{label}] raw rows agree (num/den rel {rel:.3e}, kf {kf_how}, "
        f"argmin same as the theta-search kernel on {same_k:.5f})")


def check_fold(label, off) -> None:
    """The fold kernel against fold_offsets on the same offsets: equal."""
    got = cs.fold_pixels(off)
    want = cs.fold_offsets(off)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{label}: the fold kernel differs from fold_offsets")
    log(f"[{label}] fold kernel equals fold_offsets: distinct pixels "
        f"{got[1].tolist()}")


def crop_pair(args, theta, f):
    """(tracked, init) kernel/plain call pairs of the uniform crop path;
    args[0] is the map's CropMap, as the filter passes it (the plain
    versions score maps.plain: the dequantized codes of a code map)."""
    maps, rest = args[0], args[1:]
    plain, pm = maps.plain(rest[0]).packed, maps.plain_m()
    return (
        (lambda: cs.score_tracked(maps, *rest, theta, f),
         lambda: cs.score_tracked_plain(plain, *rest, theta, f, **pm)),
        (lambda: cs.score_init_sel(maps, *rest, f),
         lambda: cs.score_init_sel_plain(plain, *rest, f, **pm)),
    )


def plain_args(args):
    """The K-bucket arguments with the pyramid the plain versions score."""
    return (args[0].plain(args[1]),) + tuple(args[1:])


def multi_pair(args, theta, scale, slots, bmi):
    """(tracked, init) kernel/plain call pairs of the K-bucket path."""
    plain, pm = plain_args(args), args[0].plain_m()
    return (
        (lambda: ms.score_tracked_multi(*args, theta, scale, slots, bmi, RES),
         lambda: ms.score_tracked_multi_plain(*plain, theta, scale, slots,
                                              bmi, RES, **pm)),
        (lambda: ms.score_init_multi_sel(*args, scale, slots, bmi, RES),
         lambda: ms.score_init_multi_sel_plain(*plain, scale, slots, bmi,
                                               RES, **pm)),
    )


CROP = ("crop_score_tracked", "crop_score_init")
CONV_I8 = ("conv_quant_i8", "conv_field_i8")  # the int8 field's launches
MULTI = ("crop_score_multi_tracked", "crop_score_multi_init")
CROP_I4 = tuple(k + "_i4" for k in CROP)  # on the code map
MULTI_I4 = tuple(k + "_i4" for k in MULTI)
FOLD = ("crop_fold",)  # launched by both tracked wrappers
ORDER = ("crop_order",)  # the rows' order, every crop update
# with the single-plane M (TDR_M_HILO=0), on the float and the code map
CROP_LOKF = tuple(k + "_lokf" for k in CROP)
MULTI_LOKF = tuple(k + "_lokf" for k in MULTI)
CROP_I4_LOKF = tuple(k + "_lokf" for k in CROP_I4)
MULTI_I4_LOKF = tuple(k + "_lokf" for k in MULTI_I4)
SCALES = ("crop_lokf_weights",)  # launched by both tracked wrappers
ALL_MULTI = MULTI + MULTI_I4 + MULTI_LOKF + MULTI_I4_LOKF
# every hi/lo crop kernel: none may launch on a single-plane path
HILO_CROP = CROP + MULTI + RAW + CROP_I4 + MULTI_I4 + RAW_I4


def phase_b(dev, errs):
    """Kernel vs plain at the slice's shapes on a 6-class map."""
    d = synthetic_setup(N, h=HW, w=HW, c=C, seed=1)
    d["packed"][:200, :300, C] = 0.0  # unknown block: kf < 0.5 there
    rng = np.random.default_rng(1)
    centers = (rng.random((N, 2)) * HW).astype(np.float32)
    centers[:6] = [[0, 0], [HW - 1, 5], [3, HW - 2], [100, 150],
                   [-400, 10], [HW + 900, HW + 900]]  # edges, far out
    t = {k: torch.as_tensor(d[k], device=dev)
         for k in ("packed", "stencil", "scan")}
    cw = torch.ones(C, device=dev)
    ctr = torch.as_tensor(centers, device=dev)
    theta = torch.as_tensor(d["state"]["particles"]["theta"], device=dev)
    args = (cs.CropMap(t["packed"]), C, t["stencil"], t["scan"], cw, ctr)
    for f in (1.0, 0.5):
        check_fold(f"B f={f}", cs.crop_offsets(t["stencil"], f)[None])
        compare(f"B C={C} f={f}", errs, CROP, *crop_pair(args, theta, f),
                need_gated=True)
        compare_raw(f"B raw C={C} f={f}", errs, RAW[0], *raw_triple(args, f))
        init_orders(f"B init order C={C} f={f}", "crop_score_init",
                    cs.init_inputs(*args, f))
    errs["abs"]["crop_fold"] = 0.0
    # a cloud clustered to 100 px (B3's): every warp's windows inside
    cargs = args[:5] + (torch.as_tensor(np.random.default_rng(3).uniform(
        462, 562, (N, 2)).astype(np.float32), device=dev),)
    compare_raw("B clustered raw", errs, RAW[0], *raw_triple(cargs, 1.0))
    init_orders("B clustered init order", "crop_score_init",
                cs.init_inputs(*cargs, 1.0))
    init_ms = median_ms(lambda: cs.score_init_sel(*args, 1.0))
    log(f"[B] theta-search kernel at C={C}, f=1.0: {init_ms:.4f} ms")
    torch.cuda.synchronize()
    return args, theta


def raw_triple(args, f):
    """(raw kernel, plain, argmin kernel) calls of the uniform theta
    search; args[0] is the map's CropMap."""
    maps, rest = args[0], args[1:]
    plain, pm = maps.plain(rest[0]).packed, maps.plain_m()
    return (lambda: cs.score_init_raw(maps, *rest, f),
            lambda: cs.score_init_raw_plain(plain, *rest, f, **pm),
            lambda: cs.score_init_sel(maps, *rest, f))


def multi_raw_triple(args, scale, slots, bmi):
    """(raw kernel, plain, argmin kernel) calls of the K-bucket theta
    search."""
    plain, pm = plain_args(args), args[0].plain_m()
    return (lambda: ms.score_init_multi_raw(*args, scale, slots, bmi, RES),
            lambda: ms.score_init_multi_raw_plain(*plain, scale, slots, bmi,
                                                  RES, **pm),
            lambda: ms.score_init_multi_sel(*args, scale, slots, bmi, RES))


def init_plan():
    """The dispatch's plan for the 10 init hypotheses at res RES:
    (hypotheses, slots, levels, bucket -> level)."""
    hyp = (10.0 ** (np.arange(10) / 10.0)).astype(np.float32)
    plan = ms.plan_buckets(hyp, 25, RES, 10.0)
    check(not isinstance(plan, str), plan)
    _, slots, mips = plan
    levels = tuple(sorted(set(mips)))
    return hyp, slots, levels, tuple(levels.index(m) for m in mips)


def phase_b2(dev, errs, b_args, theta):
    """The K-bucket kernels against their plain versions, and per bucket
    against the uniform kernel on the bucket's level; the fill kernel
    against its plain version."""
    maps, _, sten, scan, cw, ctr = b_args
    hyp, slots, levels, bmi = init_plan()
    pyr = ms.build_pyramid_maps(maps.packed, levels)
    log(f"[B2] slots {np.round(slots, 4).tolist()}, levels {levels}, "
        f"bucket -> level {bmi}, pyramid {pyr.flat.numel() * 4 / 2**20:.1f}"
        " MiB")
    scale = torch.as_tensor(np.tile(hyp, N // 10), device=dev)
    ctr = ctr.clone()
    # windows that cross a level's edge: particles 6-9 score on the
    # coarsest levels, at centres just beyond the map's sides
    ctr[6:10] = torch.tensor([[HW + 40.0, 500.0], [500.0, HW + 90.0],
                              [-60.0, 300.0], [300.0, -50.0]], device=dev)
    slots_t = torch.as_tensor(slots, device=dev)
    mips_t, _ = pyr.bucket_tables(bmi)
    check_fold("B2", ms.bucket_offsets(sten, slots_t, RES, mips_t))
    args = (pyr, C, sten, scan, cw, ctr)
    compare("B2 multi", errs, MULTI,
            *multi_pair(args, theta, scale, slots_t, bmi), need_gated=True)
    compare_raw("B2 multi raw", errs, RAW[1],
                *multi_raw_triple(args, scale, slots_t, bmi))
    init_orders("B2 multi init order", "crop_score_multi_init",
                ms.init_inputs(*args, scale, slots_t, bmi, RES))
    # the row order of both K-bucket wrappers (row_start of the buckets)
    check_orders("B2", captured_orders(lambda: [
        fn() for fn, _ in multi_pair(args, theta, scale, slots_t, bmi)]))

    check_buckets("B2", args, theta, scale, slots_t, bmi, levels)

    rng = np.random.default_rng(2)
    rows = torch.as_tensor(rng.random((N, 8)).astype(np.float32), device=dev)
    w = rng.exponential(1.0, N).astype(np.float32)
    w[rng.random(N) < 0.5] = 0.0
    w = torch.as_tensor(w / w.sum(), device=dev)
    starts = rs._segment_starts(rows, w, torch.tensor(N, device=dev),
                                torch.tensor(N, device=dev),
                                torch.tensor(0.37, device=dev))
    sparse = torch.zeros(N - 5, dtype=torch.bool, device=dev)
    sparse[[0, 5, N // 5, N * 9 // 10]] = True  # runs across many tiles
    for r0, v0 in (starts, (rows[: N - 5].contiguous(), sparse)):
        got, ref = rs.fill_rows(r0, v0), rs.fill_rows_plain(r0, v0)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), "fill kernel differs from plain")
    errs["abs"]["fill_rows"] = 0.0
    log("[B2] fill kernel equals its plain version bit for bit")


def check_buckets(label, args, theta, scale, slots_t, bmi, levels,
                  kf_tol=0.0) -> None:
    """Per bucket, the K-bucket kernels (args: their arguments before
    theta) against the uniform kernels on the bucket's level
    (PyramidMaps.level_crop_map: for a code pyramid, the pyramid's codes
    of that level): kf bit for bit, costs within REL_TOL, the argmin on
    99.9 %."""
    pyr, c, sten, scan, cw, ctr = args
    dev = ctr.device
    tr = ms.score_tracked_multi(*args, theta, scale, slots_t, bmi, RES)
    ini = ms.score_init_multi_sel(*args, scale, slots_t, bmi, RES)
    mips_t, _ = pyr.bucket_tables(bmi)
    bucket = ms.assign_buckets(scale, slots_t)
    f_eff = slots_t * torch.tensor(RES, device=dev) / mips_t
    for b in range(len(slots_t)):
        sel = bucket == b
        if not bool(sel.any()):
            continue
        level = pyr.level_crop_map(bmi[b])
        mres = float(levels[bmi[b]])
        u_args = (c, sten, scan, cw, ctr[sel])
        u_tr = cs.score_tracked(level, *u_args, theta[sel], f_eff[b], mres)
        u_in = cs.score_init_sel(level, *u_args, f_eff[b], 40, mres)
        torch.cuda.synchronize()
        lab = f"{label} bucket {b} (mip {levels[bmi[b]]})"
        check(same_kf(u_tr[2], tr[2][sel], kf_tol), f"{lab}: kf differs")
        ok = (u_tr[2] >= 0.5) & off_gate(u_tr[2], kf_tol)
        for i, name in ((0, "cost"), (1, "norm")):
            rel = max_rel(u_tr[i][ok], tr[i][sel][ok])
            check(rel <= REL_TOL, f"{lab}: tracked {name} rel {rel}")
        fin = u_in[0] < cs.FLT_MAX
        clear = off_gate(u_in[2], kf_tol)
        check(torch.equal(fin[clear], (ini[0][sel] < cs.FLT_MAX)[clear]),
              f"{lab}: FLT_MAX pattern")
        fin &= ini[0][sel] < cs.FLT_MAX
        rel = max_rel(u_in[0][fin], ini[0][sel][fin])
        check(rel <= REL_TOL, f"{lab}: init best rel {rel}")
        check(float((u_in[1] == ini[1][sel]).float().mean()) >= 0.999,
              f"{lab}: init argmin")
    log(f"[{label}] every bucket equals the uniform kernel on its level")


def phase_b3(dev, errs, b_args, theta):
    """The crop kernels on the nibble-packed code map (TDR_MAP_INT4=1) at
    phase B's inputs (6 classes, 4 code bytes a pixel): each against its
    plain version (the float plain version on the dequantized map) as in
    B, f = 1.0 and 0.5, and the K-bucket ones on B2's 10 hypotheses
    (one quantization of the full-resolution map, every level its
    subsample) against theirs and, per bucket, against the uniform code
    kernel on the bucket's level of the code pyramid."""
    maps, c, sten, scan, cw, ctr = b_args
    maps = cs.CropMap(maps.packed, int4=True)
    codes = maps.codes(c)
    check(codes.dtype == torch.uint8
          and codes.shape == (HW, HW, cs.channel_pad(c) // 2),
          f"B3: code map {codes.dtype} {tuple(codes.shape)}")
    log(f"[B3] code map {tuple(codes.shape)} uint8 ({nbytes(codes) / 2**20:.1f}"
        f" MiB; the float compact map {nbytes(maps.compact(c)) / 2**20:.1f} "
        f"MiB), qinv {[round(float(q), 6) for q in maps.qinv]}")
    args = (maps, c, sten, scan, cw, ctr)
    for f in (1.0, 0.5):
        compare(f"B3 C={c} f={f}", errs, CROP_I4, *crop_pair(args, theta, f),
                need_gated=True)
        compare_raw(f"B3 raw C={c} f={f}", errs, RAW_I4[0],
                    *raw_triple(args, f))
        init_orders(f"B3 init order C={c} f={f}", "crop_score_init",
                    cs.init_inputs(*args, f))

    hyp, slots, levels, bmi = init_plan()
    pyr = ms.build_pyramid_maps(maps.packed, levels, int4=True)
    check(torch.equal(pyr.qinv, maps.qinv),
          "B3: the code pyramid's qinv is not the full map's")
    scale = torch.as_tensor(np.tile(hyp, N // 10), device=dev)
    ctr = ctr.clone()
    ctr[6:10] = torch.tensor([[HW + 40.0, 500.0], [500.0, HW + 90.0],
                              [-60.0, 300.0], [300.0, -50.0]], device=dev)
    slots_t = torch.as_tensor(slots, device=dev)
    args = (pyr, c, sten, scan, cw, ctr)
    compare("B3 multi", errs, MULTI_I4,
            *multi_pair(args, theta, scale, slots_t, bmi), need_gated=True)
    compare_raw("B3 multi raw", errs, RAW_I4[1],
                *multi_raw_triple(args, scale, slots_t, bmi))
    init_orders("B3 multi init order", "crop_score_multi_init",
                ms.init_inputs(*args, scale, slots_t, bmi, RES))
    check_buckets("B3", args, theta, scale, slots_t, bmi, levels)

    # the code tracked kernels' two routes, each call also at budget 0 (every
    # gather from L2) bit for bit: the K-bucket pyramid (the coarse levels'
    # blocks stage their windows, the fine ones' not), the spread cloud on
    # the full level (no block: its windows span the map) and a cloud
    # clustered to 100 px, its thetas in a 0.15 rad band (every block)
    window_routes("B3 multi windows", errs, MULTI_I4[0],
                  multi_pair(args, theta, scale, slots_t, bmi)[0],
                  multi_windows(args, theta, scale, slots_t, bmi), "some")
    args = (maps, c, sten, scan, cw, b_args[5])
    window_routes("B3 spread windows", errs, CROP_I4[0],
                  crop_pair(args, theta, 1.0)[0],
                  uniform_windows(args, theta, 1.0), "none")
    rng = np.random.default_rng(3)
    args = (maps, c, sten, scan, cw, torch.as_tensor(
        rng.uniform(462, 562, (N, 2)).astype(np.float32), device=dev))
    band = torch.as_tensor((0.7 + 0.15 * rng.random(N)).astype(np.float32),
                           device=dev)
    window_routes("B3 clustered windows", errs, CROP_I4[0],
                  crop_pair(args, band, 1.0)[0],
                  uniform_windows(args, band, 1.0), "all")
    # the code theta search on the same cloud, against its plain version
    # and in the particles' order
    compare_raw("B3 clustered raw", errs, RAW_I4[0], *raw_triple(args, 1.0))
    init_orders("B3 clustered init order", "crop_score_init",
                cs.init_inputs(*args, 1.0))


def init_orders(label, base, inputs) -> None:
    """A theta search on the window route (crop_score.launch_init's
    `base`) on `inputs` (init_inputs': the rows in init_order), argmin and
    raw rows, bit for bit the same search with each bucket's rows in the
    particles' order (crop_ablate.init_ablation_rows: other warps, other
    votes on the unchecked gather, the same rows)."""
    other = ca.init_ablation_rows("particles", inputs)
    for raw in (False, True):
        got = cs.launch_init(base, inputs, raw)
        want = cs.launch_init(base, other, raw)
        torch.cuda.synchronize()
        check(same_bits(got, want), f"{label}: the rows in position order "
              f"differ from the particles' order (raw {raw})")
    log(f"[{label}] {cs.entry_name(base, inputs[0], False)}: argmin and raw "
        "rows in position order equal the particles' order bit for bit")


def uniform_windows(args, theta, f) -> dict:
    """The windows the uniform code tracked call on args (a code CropMap
    first, as crop_pair takes them) stages (crop_score.launch_windows, the
    plain rule)."""
    maps, c, sten, scan, cw, ctr = args
    _, fold, cc, key = cs._tracked_inputs(maps, c, sten, scan, cw, ctr,
                                          theta, f, 1.0)
    h, w = maps.packed.shape[:2]
    return cs.launch_windows(maps, None, h, w, c, scan, fold, cc, key)


def multi_windows(args, theta, scale, slots, bmi) -> dict:
    """... and the K-bucket one on args (a code pyramid first)."""
    pyr, c, sten, scan, cw, ctr = args
    _, table, fold, cc, key = ms._tracked_inputs(
        pyr, c, sten, scan, cw, ctr, theta, scale, slots, bmi, RES, 1.0)
    return cs.launch_windows(pyr, table, 0, 0, c, scan, fold, cc, key)


def window_routes(label, errs, name, tracked, windows, want) -> tuple:
    """A code tracked entry (tracked: kernel call, plain call) against its
    plain version (compare_tracked), and at budget 0 (every block's
    gather from L2) bit for bit its staged call; the share of windows the
    plain rule stages (windows) must be `want`: "all", "none" or "some".
    Returns (the windows' share staged, their rows' share)."""
    compare_tracked(label, errs, name, tracked)
    staged = tracked[0]()
    with mock.patch.object(cs, "WINDOW_BUDGET", 0):
        on_l2 = tracked[0]()
    torch.cuda.synchronize()
    check(same_bits(staged, on_l2),
          f"{label}: budget 0 (the gather from L2) differs from the staged "
          "call")
    share = cs.staged_share(windows)
    check({"all": share[0] == 1.0, "none": share[0] == 0.0,
           "some": 0.0 < share[0] < 1.0}[want],
          f"{label}: the plain rule stages {share}, not {want}")
    log(f"[{label}] {name} staged windows {share[0]:.4f} of "
        f"{windows['staged'].numel()} (rows {share[1]:.4f}); at budget 0 the "
        "same bits")
    return share


def phase_b4(dev, errs, b_args, theta):
    """The crop kernels with the single-plane M (TDR_M_HILO=0;
    CropMap(m_hilo=False), build_pyramid_maps(m_hilo=False)) at phase B's
    inputs, on the float and the code map: each against its plain version
    (the dequantized single-plane M) as in B, f = 1.0 and 0.5, but kf
    within LOKF_KF_TOL and the gate's patterns off it; the K-bucket ones
    on B2's 10 hypotheses, and per bucket against the uniform kernel on the
    bucket's level; the weights pass bit for bit crop_score.tracked_lokf's
    integers (on each bucket's npix[b] pixels rounded up to 8, the entries
    it writes) and scales on the uniform and the K-bucket folds; the theta
    searches on both maps (the window route) at f = 1.0 and 0.5, on B3's
    clustered cloud (its raw rows against their plain version too) and on
    K buckets, argmin and raw rows bit for bit in the particles' order."""
    maps, c, sten, scan, cw, ctr = b_args
    hyp, slots, levels, bmi = init_plan()
    scale = torch.as_tensor(np.tile(hyp, N // 10), device=dev)
    ctr2 = ctr.clone()
    ctr2[6:10] = torch.tensor([[HW + 40.0, 500.0], [500.0, HW + 90.0],
                               [-60.0, 300.0], [300.0, -50.0]], device=dev)
    slots_t = torch.as_tensor(slots, device=dev)
    for int4 in (False, True):
        tag = "code" if int4 else "float"
        lmap = cs.CropMap(maps.packed, int4=int4, m_hilo=False)
        args = (lmap, c, sten, scan, cw, ctr)
        names = CROP_I4_LOKF if int4 else CROP_LOKF
        raw = (RAW_I4_LOKF if int4 else RAW_LOKF)
        for f in (1.0, 0.5):
            compare(f"B4 {tag} C={c} f={f}", errs, names,
                    *crop_pair(args, theta, f), need_gated=True,
                    kf_tol=LOKF_KF_TOL)
            compare_raw(f"B4 {tag} raw C={c} f={f}", errs, raw[0],
                        *raw_triple(args, f), kf_tol=LOKF_KF_TOL)
            init_orders(f"B4 {tag} init order C={c} f={f}",
                        "crop_score_init", cs.init_inputs(*args, f))
        # B3's clustered cloud
        rng = np.random.default_rng(3)
        cargs = (lmap, c, sten, scan, cw, torch.as_tensor(
            rng.uniform(462, 562, (N, 2)).astype(np.float32), device=dev))
        compare_raw(f"B4 {tag} clustered raw", errs, raw[0],
                    *raw_triple(cargs, 1.0), kf_tol=LOKF_KF_TOL)
        init_orders(f"B4 {tag} clustered init order", "crop_score_init",
                    cs.init_inputs(*cargs, 1.0))
        pyr = ms.build_pyramid_maps(maps.packed, levels, int4, m_hilo=False)
        mips_t, _ = pyr.bucket_tables(bmi)
        for label, fold in (
                ("uniform", lmap.fold(sten, 1.0)),
                ("K-bucket", cs.fold_pixels(ms.bucket_offsets(
                    sten, slots_t, RES, mips_t)))):
            table, got = cs.tracked_table(scan, cw, lmap.m_qinv, fold, c,
                                          int4)
            w, want = cs.tracked_lokf(cs.tracked_weights(
                scan, cw, fold[2], fold[3], lmap.m_qinv), int4, c)
            want_q = w.transpose(-1, -2).to(torch.int16)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"B4 {tag}: the {label} scales "
                  "differ from tracked_lokf's")
            for b, u in enumerate(fold[1].tolist()):
                u8 = -(-u // 8) * 8
                check(torch.equal(table[b, ..., :u8], want_q[b, ..., :u8]),
                      f"B4 {tag}: the {label} integers of bucket {b} "
                      "differ from tracked_lokf's")
            log(f"[B4 {tag}] the {label} weights pass (table "
                f"{tuple(table.shape)} int16, scales {tuple(got.shape)}) "
                "equals tracked_lokf's bit for bit")
        errs["abs"]["crop_lokf_weights"] = 0.0
        args = (pyr, c, sten, scan, cw, ctr2)
        compare(f"B4 {tag} multi", errs,
                MULTI_I4_LOKF if int4 else MULTI_LOKF,
                *multi_pair(args, theta, scale, slots_t, bmi),
                need_gated=True, kf_tol=LOKF_KF_TOL)
        compare_raw(f"B4 {tag} multi raw", errs, raw[1],
                    *multi_raw_triple(args, scale, slots_t, bmi),
                    kf_tol=LOKF_KF_TOL)
        init_orders(f"B4 {tag} multi init order", "crop_score_multi_init",
                    ms.init_inputs(*args, scale, slots_t, bmi, RES))
        check_buckets(f"B4 {tag}", args, theta, scale, slots_t, bmi, levels,
                      kf_tol=LOKF_KF_TOL)


def big_filter(dev, **params):
    """102,400 particles on a 1024^2 class-map world, spread init."""
    world = make_world(HW, HW)
    pf, _ = make_filter(dev, N, seed=0, world=world, **params)
    check(pf.n_max == N, f"n_max {pf.n_max}")
    return pf, world


def scan_at(world, i, dev, move=True):
    """Scan i of a robot driving 1.5 m per scan (or standing still) at
    scale 2 along the drive world's road."""
    gt = np.array([60.0 + 3.0 * i * move, 105.0], np.float32)
    pts = generate_scan_points(world, gt, 0.0, SCALE_GT, 25.0, 8192, seed=i)
    return render_semantic_polar(
        torch.as_tensor(pts, device=dev), np.arange(256), RES,
        2 * math.pi / 100, 3, 100, 25,
    )


def conv_calls() -> int:
    return conv_score.CALLS["cost_field"]


class PlanLog:
    """Records the plan of every known-scale update of every
    ParticleFilter while it is open (a wrapper of _fast_mode)."""

    def __enter__(self):
        self.plans = []
        self._orig = orig = filter_mod.ParticleFilter._fast_mode

        def planned(pf, res):
            self.plans.append(orig(pf, res))
            return self.plans[-1]

        filter_mod.ParticleFilter._fast_mode = planned
        return self.plans

    def __exit__(self, *exc):
        filter_mod.ParticleFilter._fast_mode = self._orig


def check_paths(label, plans, crop, conv) -> None:
    """Each update ran the scorer its plan names: crop launches per
    update `crop`, conv cost fields per update `conv`."""
    check(len(plans) == len(crop) == len(conv),
          f"{label}: {len(plans)} plans for {len(crop)} updates")
    for i, (p, k, c) in enumerate(zip(plans, crop, conv)):
        want = (k == 0 and c >= 1) if p.path == "conv" else (k >= 1 and c == 0)
        check(want, f"{label}: update {i} planned {p.path} ({p.mode}) "
              f"launched {k} crop kernels and {c} cost fields")
    log(f"[{label}] paths per update: "
        + " ".join(f"{p.path}/{p.mode}/r{p.region}/w{p.ww}" for p in plans))


def run_updates(pf, world, dev, steps, names, move=True):
    """`steps` updates (with a propagate before each when the robot
    moves); returns the launches of `names` per update (and a last column
    of the conv cost fields) and the mean likelihood."""
    per = []
    for i in range(steps):
        before = [kernels.LAUNCHES[k] for k in names] + [conv_calls()]
        if move:
            pf.propagate([1.5, 0.0], 0.0)
        pf.update(scan_at(world, i, dev, move), RES)
        now = [kernels.LAUNCHES[k] for k in names] + [conv_calls()]
        per.append([a - b for a, b in zip(now, before)])
    torch.cuda.synchronize()
    ml, cov = pf.pose_stats()
    check(np.all(np.isfinite(ml)) and np.all(np.isfinite(cov)),
          "non-finite pose statistics")
    check(0 < pf.num_particles() <= N, "particle count out of range")
    return np.asarray(per), ml


def phase_c(dev):
    counts = [(0, conv_calls())]

    def on_step(i, pf):
        counts.append((sum(kernels.LAUNCHES[k] for k in CROP), conv_calls()))

    with PlanLog() as plans:
        err, cov_xx, _ = drive(dev, 2048, 30, res=1.0, on_step=on_step,
                               log=lambda *_: None)
    log(f"[C] consumer drive (2048 particles; crop at mip 2, then conv): "
        f"err {err:.3f} px, cov_xx {cov_xx:.3f}")
    check(err < 8.0 and cov_xx < 400.0, "consumer drive did not converge")
    crop, conv = np.diff(np.asarray(counts), axis=0).T
    check_paths("C drive", plans, crop, conv)

    pf, world = big_filter(dev)
    with PlanLog() as plans:
        per, ml = run_updates(pf, world, dev, 20, CROP)
    check_paths("C 102,400", plans, per[:, :-1].sum(1), per[:, -1])
    log(f"[C] 20 updates at {N} particles on {HW}^2: n_active "
        f"{pf.num_particles()}, ml {np.round(ml, 3).tolist()}")
    return pf, world


def multi_run(dev, world, move, map_int4=False, m_hilo=True):
    """20 unknown-scale updates at 102,400 particles from a spread init:
    (the dispatch's plan of each update, the updates that ran the exact
    step, the multi launches (tracked, init) of each update).  map_int4,
    m_hilo: the filter's; its own K-bucket kernels' launches are
    returned, and no other K-bucket kernel may launch."""
    pf, _ = make_filter(dev, N, seed=0, world=world, fixed_scale=-1.0,
                        map_int4=map_int4, m_hilo=m_hilo)
    own = tuple(k + "_i4" * map_int4 + "_lokf" * (not m_hilo) for k in MULTI)
    names = own + tuple(k for k in ALL_MULTI if k not in own)
    exact, plans = [], []
    step_fn, multi_mode = pf._update_fn, pf._multi_mode

    def exact_step(*a, **kw):
        exact.append(len(plans) - 1)
        return step_fn(*a, **kw)

    def planned(res):
        plans.append(multi_mode(res))
        return plans[-1]

    pf._update_fn, pf._multi_mode = exact_step, planned
    try:
        per, ml = run_updates(pf, world, dev, 20, names, move)
    finally:
        pf._update_fn, pf._multi_mode = step_fn, multi_mode
    label = (("C5" if map_int4 else "C2") if m_hilo else "C6") + (
        " moving" if move else " standing")
    check(not per[:, 2:].any(), f"{label}: other K-bucket launches or "
          f"conv cost fields {per.tolist()}")
    per = per[:, :2]  # the filter's own kernels; no conv cost field under
    # an unknown scale
    for i, (plan, (t, n)) in enumerate(zip(plans, per)):
        log(f"[{label}] update {i}: " + (
            "exact gather" if plan is None else
            f"{plan.mode}, K {plan.kp}, mo {plan.mo}, levels {plan.levels}")
            + f"; launches tracked {t}, init {n}")
    check(len(plans) == 20, f"{len(plans)} multi dispatches for 20 updates")
    check(pf.scale() < 0, "the scale froze without a caller")
    log(f"[{label}] 20 unknown-scale updates at {N} particles: n_active "
        f"{pf.num_particles()}, ml {np.round(ml, 3).tolist()}")
    return plans, exact, per


def phase_c2(dev, world):
    """The unknown-scale main path at 102,400 particles, then the
    unknown-scale consumer drive.

    Standing still, the scales stay on the 10 hypotheses: every update
    must launch a K-bucket kernel (theta search first, tracked after) and
    none the exact step.  Driving, the 2 %/scan scale diffusion can spread
    102,400 scales past 12 clusters even at rtol 0.08; the dispatch then
    falls to the exact step, as the reference's does on the same scales
    (tests/test_torch_multiscale.py holds the plans equal).  Every other
    update must launch a K-bucket kernel."""
    # (tracked, init) launches of each mode
    expect = {"init": [0, 1], "tracked": [1, 0], "mixed": [1, 1]}
    plans, exact, per = multi_run(dev, world, move=False)
    check(all(p is not None for p in plans) and not exact,
          f"standing: the exact step ran on updates {exact}")
    check(plans[0].mode == "init"
          and all(p.mode == "tracked" for p in plans[1:]),
          f"standing: modes {[p.mode for p in plans]}")
    check(all(per[i].tolist() == expect[p.mode] for i, p in enumerate(plans)),
          f"standing: launches per update {per.tolist()}")

    plans, exact, per = multi_run(dev, world, move=True)
    fell = [i for i, p in enumerate(plans) if p is None]
    check(exact == fell,
          f"moving: the exact step ran on {exact}, planned on {fell}")
    check(all(per[i].tolist() == expect[p.mode]
              for i, p in enumerate(plans) if p is not None),
          f"moving: launches per update {per.tolist()}")
    log(f"[C2 moving] the exact step ran on updates {fell} (scales past "
        f"the clustering ladder); a K-bucket kernel on the other "
        f"{20 - len(fell)}")

    ml, cov, drv = drive_unknown_scale(dev)
    log(f"[C2] unknown-scale drive (2048 particles, 30 scans): scale "
        f"{ml[3]:.4f}, cov[3,3] {cov[3, 3]:.5f}, frozen at "
        f"{drv.scale():.4f}")
    check(abs(ml[3] - SCALE_GT) / SCALE_GT < 0.1, f"scale {ml[3]}")
    check(cov[3, 3] < 0.1, f"cov[3,3] {cov[3, 3]}")
    if drv.scale() > 0:
        check(abs(drv.scale() - SCALE_GT) / SCALE_GT < 0.1,
              f"frozen scale {drv.scale()}")


@contextlib.contextmanager
def staged_log(label):
    """Log, for each code tracked launch (crop_score.launch_tracked on a
    code map with the hi/lo M) while the block runs, the share of its
    windows the plain rule stages (launch_windows; it reads the fold's
    npix to the host)."""
    launch = cs.launch_tracked
    seen = []

    def logged(base, maps, table, h, w, c, scan, cw, fold, ctr, key):
        if maps.int4 and maps.m_hilo:
            share = cs.staged_share(cs.launch_windows(
                maps, table, h, w, c, scan, fold, ctr, key))
            seen.append(share)
            log(f"[{label}] tracked launch {len(seen)} ({base}_i4, "
                f"{ctr.shape[0]} rows): staged windows {share[0]:.4f}, rows "
                f"{share[1]:.4f}")
        return launch(base, maps, table, h, w, c, scan, cw, fold, ctr, key)

    with mock.patch.object(cs, "launch_tracked", logged):
        yield seen


def phase_c5(dev, world):
    """The main path on the nibble-packed map, the filter's map_int4=True
    (TDR_MAP_INT4=1 through the argument): 20 known-scale updates of
    102,400 particles from a spread init, driving, as in C, each planned
    crop update launching its code kernel and no float crop kernel, each
    conv update no crop kernel, on the float32 conv map; then 20
    unknown-scale updates standing, as in C2, each launching a K-bucket
    code kernel and no float one."""
    pf, _ = make_filter(dev, N, seed=0, world=world, map_int4=True)
    with PlanLog() as plans, staged_log("C5 known scale"):
        per, ml = run_updates(pf, world, dev, 20, CROP_I4 + CROP)
    check(not per[:, 2:4].any(),
          f"C5: float crop launches per update {per.tolist()}")
    check_paths("C5 102,400", plans, per[:, :2].sum(1), per[:, -1])
    crop = [p for p in plans if p.path == "crop"]
    check(crop and all(pf._get_map(p.mip).int4 for p in crop),
          f"C5: crop plans {crop} on a float map")
    if any(p.path == "conv" for p in plans):
        got = pf._get_conv_map().padded
        want = conv_score.ConvMap(cs.compact_map(
            pf.map.grid.dist.to(dev), 3)).padded
        check(got.dtype == torch.float32 and torch.equal(got, want),
              "C5: the conv path's map is not the float32 one")
        log("[C5] the conv updates read the float32 conv map")
    log(f"[C5] 20 updates on the code map at {N} particles: n_active "
        f"{pf.num_particles()}, ml {np.round(ml, 3).tolist()}")
    expect = {"init": [0, 1], "tracked": [1, 0], "mixed": [1, 1]}
    with staged_log("C5 standing"):
        plans, exact, per = multi_run(dev, world, False, map_int4=True)
    check(all(p is not None for p in plans) and not exact
          and all(per[i].tolist() == expect[p.mode]
                  for i, p in enumerate(plans)),
          f"C5 standing: exact steps {exact}, launches {per.tolist()}")


# B5's cases: classes (CP 4, 8), window W, conv bucket mo, region, and
# the origin: inside the map, or clamped to its top-left ("low") or
# bottom-right ("high") edge, where the tap columns past dc read off it
B5_CASES = ((3, 16, 24, 128, None), (3, 32, 12, 64, "low"),
            (3, 16, 36, 256, "high"), (6, 64, 24, 256, "high"),
            (6, 32, 48, 192, None), (6, 16, 12, 64, "low"))
B5_HW = 640


def conv_i8_case(dev, c, ww, mo, region, edge, seed):
    """A B5 case on the card: the int8 ConvMap of a random B5_HW^2 map of
    c classes, the tracked conv kernel of a random scan at the bucket's f
    (window [95, 95 + W)); (the field's arguments: codes, the kernel
    quantized by its plain version, the block's origin, mo, region; the
    float kernel; qinv)."""
    rng = np.random.default_rng(seed)
    packed = np.zeros((B5_HW, B5_HW, 8), np.float32)
    packed[..., :c] = rng.random((B5_HW, B5_HW, c)) * 50
    packed[..., c] = rng.random((B5_HW, B5_HW)) < 0.9
    cmap = conv_score.ConvMap(cs.compact_map(torch.as_tensor(
        packed, device=dev), c), int8=True)
    scan = torch.as_tensor((rng.random((c, 100, 25)) * 3).astype(
        np.float32), device=dev)
    cw = torch.as_tensor(rng.random(c).astype(np.float32) + 0.5, device=dev)
    sten = torch.as_tensor(polar_stencil(100, 25), device=dev)
    kernel = conv_score.build_conv_kernel(scan, cw, sten, mo / 24.0, mo,
                                          "tracked", window_w=ww, s0=95)
    dr, dc = conv_score.conv_dims(mo)
    origin = {None: (300, 280), "low": (dr // 2, dc // 2),
              "high": (cmap.hp - (region + dr - 1) + dr // 2,
                       cmap.wp - (region + dc - 1) + dc // 2)}[edge]
    return ((cmap.codes, *conv_score.quantize_conv_kernel(kernel, cmap.qinv),
             torch.tensor(origin, device=dev), mo, region), kernel,
            cmap.qinv)


def phase_b5(dev, errs):
    """The int8 conv field's kernels against their plain versions on the
    card (B5_CASES): the quantizer's B, flags and scales equal
    quantize_conv_kernel's laid out by i8_layout, the field's int32 sums
    and field equal the plain version's bit for bit, on those integers and
    with the two launches, and a second launch on the same inputs gives
    the same bits."""
    for i, (c, ww, mo, region, edge) in enumerate(B5_CASES):
        args, kernel, qinv = conv_i8_case(dev, c, ww, mo, region, edge,
                                          20 + i)
        label = (f"B5 C={c} W={ww} mo {mo} region {region} origin "
                 f"{edge or 'inside'}")
        quant = [conv_score.quantize_i8(kernel, qinv) for _ in range(2)]
        ref_b, ref_nz = conv_score.i8_layout(args[1])
        torch.cuda.synchronize()
        for b, nz, sc in quant:
            check(torch.equal(b, ref_b) and torch.equal(nz, ref_nz)
                  and same_bits((sc,), (args[2],)),
                  f"{label}: the quantizer kernel's B, flags or scales "
                  "differ from the plain version's")
        quantized = (args[0], qinv, kernel, *args[3:])
        field, sums = conv_score.launch_field_i8(
            args[0], ref_b, ref_nz, args[2], *args[3:],
            args[1].shape[0], sums=True)
        again, sums2 = conv_score.conv_field_i8(*quantized, sums=True)
        twice, sums3 = conv_score.conv_field_i8(*quantized, sums=True)
        ref, ref_sums = conv_score.cost_field_i8_plain(*args)
        torch.cuda.synchronize()
        check(torch.isfinite(field).all() and field.shape == (
            2 * ww + 1, region, region), f"{label}: field {field.shape}")
        check(torch.equal(sums, ref_sums),
              f"{label}: int32 sums differ from the plain version's in "
              f"{int((sums != ref_sums).sum())} places")
        check(same_bits((field,), (ref,)),
              f"{label}: the field differs from the plain version's by up "
              f"to {float((field - ref).abs().max()):.3e}")
        check(same_bits((field, field), (again, twice))
              and torch.equal(sums, sums2) and torch.equal(sums, sums3),
              f"{label}: the field on the quantizer kernel's integers, or "
              "twice, differs")
        errs["abs"]["conv_field_i8"] = max(
            errs["abs"]["conv_field_i8"], float((field - ref).abs().max()))
        log(f"[B5] {label} (CP {args[0].shape[2]}): quantizer kernel "
            f"({int(ref_nz.sum())} of {ref_nz.numel()} chunks nonzero) and "
            f"int32 sums (largest |sum| {int(sums.abs().max())}) and field "
            "equal the plain versions' bit for bit, twice")


def phase_c6(dev, world):
    """The main path with the single-plane M, the filter's m_hilo=False
    (TDR_M_HILO=0 through the argument): C's 20 known-scale updates from a
    spread init, driving, each planned crop update launching its "_lokf"
    kernel and no other crop kernel, each conv update no crop kernel, on
    the float map and on the code map (map_int4=True); on the code map
    also C5's 20 unknown-scale updates standing, each launching a
    K-bucket "_i4_lokf" kernel and no other; then the unknown-scale
    consumer drive (2,048 particles, 30 scans) with m_hilo=False, which
    must find the scale within C2's gates and launch no hi/lo crop
    kernel."""
    for int4 in (False, True):
        tag = "code" if int4 else "float"
        own = CROP_I4_LOKF if int4 else CROP_LOKF
        pf, _ = make_filter(dev, N, seed=0, world=world, map_int4=int4,
                            m_hilo=False)
        others = tuple(k for k in CROP_LOKF + CROP_I4_LOKF + HILO_CROP
                       if k not in own)
        with PlanLog() as plans:
            per, ml = run_updates(pf, world, dev, 20, own + others)
        check(not per[:, 2:-1].any(),
              f"C6 {tag}: other crop launches per update {per.tolist()}")
        check_paths(f"C6 {tag} 102,400", plans, per[:, :2].sum(1),
                    per[:, -1])
        crop = [p for p in plans if p.path == "crop"]
        check(crop and not any(pf._get_map(p.mip).m_hilo for p in crop),
              f"C6 {tag}: crop plans {crop} on a hi/lo map")
        log(f"[C6 {tag}] 20 updates with the single-plane M at {N} "
            f"particles: n_active {pf.num_particles()}, ml "
            f"{np.round(ml, 3).tolist()}")
    expect = {"init": [0, 1], "tracked": [1, 0], "mixed": [1, 1]}
    plans, exact, per = multi_run(dev, world, False, map_int4=True,
                                  m_hilo=False)
    check(all(p is not None for p in plans) and not exact
          and all(per[i].tolist() == expect[p.mode]
                  for i, p in enumerate(plans)),
          f"C6 standing: exact steps {exact}, launches {per.tolist()}")
    before = {k: kernels.LAUNCHES[k] for k in HILO_CROP + MULTI_LOKF}
    ml, cov, drv = drive_unknown_scale(dev, m_hilo=False)
    ran = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    check(drv.m_hilo is False and not any(ran[k] for k in HILO_CROP)
          and all(ran[k] for k in MULTI_LOKF),
          f"C6 drive: launches {ran}")
    log(f"[C6] unknown-scale drive with the single-plane M (2048 "
        f"particles, 30 scans): scale {ml[3]:.4f}, cov[3,3] "
        f"{cov[3, 3]:.5f}, frozen at {drv.scale():.4f}; K-bucket launches "
        f"{ {k: ran[k] for k in MULTI_LOKF} }")
    check(abs(ml[3] - SCALE_GT) / SCALE_GT < 0.1, f"C6: scale {ml[3]}")
    check(cov[3, 3] < 0.1, f"C6: cov[3,3] {cov[3, 3]}")
    if drv.scale() > 0:
        check(abs(drv.scale() - SCALE_GT) / SCALE_GT < 0.1,
              f"C6: frozen scale {drv.scale()}")


def phase_c3(dev, world):
    """10 updates with TDR_RESAMPLE=pallas; every resample is checked
    against the gather on the same weights and shift."""
    pf, _ = make_filter(dev, N, seed=0, world=world)
    resample = filter_mod.systematic_resample

    def checked(p, w, n_new, n_act, shift=None, generator=None):
        if shift is None:
            shift = torch.rand((), generator=generator, device=w.device)
        out = resample(p, w, n_new, n_act, shift=shift)
        ref = resample(p, w, n_new, n_act, shift=shift, via="gather")
        check(torch.equal(rs.pack_fields(out), rs.pack_fields(ref))
              and torch.equal(out.alive, ref.alive),
              "fill rows differ from the gather's")
        return out

    os.environ["TDR_RESAMPLE"] = "pallas"
    filter_mod.systematic_resample = checked
    try:
        per, _ = run_updates(pf, world, dev, 10, ("fill_rows",))
    finally:
        filter_mod.systematic_resample = resample
        del os.environ["TDR_RESAMPLE"]
    check((per[:, 0] >= 1).all(), f"updates without a fill launch: {per}")
    log(f"[C3] 10 updates with the fill: rows equal the gather's")
    return pf


def clustered_state(dev):
    """bench.py's cloud: 102,400 particles in a 100 px square at the map's
    centre, thetas in a 0.15 rad band around 0.7, at step 1 (no GMM
    refit), with the shift mask of its thetas, as an update leaves it."""
    d = synthetic_setup(N, h=HW, w=HW, c=3, cluster=(HW // 2, HW // 2, 100),
                        theta_spread=(0.7, 0.15))
    st = filter_state_from_numpy(d["state"], dev).replace(step=1)
    p = st.particles
    return st.replace(smask=shift_mask(rotation_shift(p.theta, 100), p.alive,
                                       100))


def clustered_runs(pf, world, dev, label, names):
    """C4's runs: 20 driving updates from the clustered cloud, twice from
    the same state and generator seed, every update on the conv path; the
    two runs must end in the same state bit for bit.  Returns (the plans
    and per-update launches of `names` plus the cuDNN fields of each run,
    the last run's mean likelihood)."""
    start = clustered_state(dev)
    finals, runs = [], []
    for run in range(2):
        pf.state, pf._all_have_init = start, True
        pf.generator.manual_seed(7)
        with PlanLog() as plans:
            per, ml = run_updates(pf, world, dev, 20, names)
        check(all(p.path == "conv" for p in plans),
              f"{label}: updates off the conv path: {[p.path for p in plans]}")
        runs.append((list(plans), per))
        finals.append(pf.state)
    a, b = (rs.pack_fields(st.particles) for st in finals)
    check(torch.equal(a.view(torch.int32), b.view(torch.int32))
          and torch.equal(finals[0].particles.alive, finals[1].particles.alive)
          and torch.equal(finals[0].particles.weight.view(torch.int32),
                          finals[1].particles.weight.view(torch.int32)),
          f"{label}: two runs from the same state differ")
    return runs, ml


def phase_c4(dev, pf, world):
    """The conv path: 20 driving updates from the clustered cloud, twice
    from the same state and generator seed; returns the mean
    likelihood."""
    runs, ml = clustered_runs(pf, world, dev, "C4", CROP)
    for run, (plans, per) in enumerate(runs):
        check_paths(f"C4 run {run}", plans, per[:, :-1].sum(1), per[:, -1])
    log(f"[C4] 20 conv updates at {N} particles, twice: the same state bit "
        f"for bit; n_active {pf.num_particles()}, ml "
        f"{np.round(ml, 3).tolist()}")
    return ml


def int8_plan(plan) -> bool:
    """Whether a conv plan's update scores the int8 field under conv_int8
    (conv_score.make_conv_scorer's rule)."""
    return (plan.mode == "tracked" and (2 * plan.ww) % 32 == 0
            and conv_score.s2d_gate(plan.mo, 2 * plan.ww + 1))


def phase_c7(dev, world, c4_ml):
    """The conv path with the int8 field, the filter's conv_int8=True: C4's
    runs; every conv-tracked update the int8 field takes launches
    conv_quant_i8 and conv_field_i8 once each and makes no cuDNN field (any
    other makes one cuDNN field and no int8 launch), no crop kernel runs,
    and the two runs end
    bit for bit equal; the mean likelihood beside C4's."""
    pf, _ = make_filter(dev, N, seed=0, world=world, conv_int8=True)
    runs, ml = clustered_runs(pf, world, dev, "C7", CROP + CONV_I8)
    for run, (plans, per) in enumerate(runs):
        want = [[0, 0, 1, 1, 0] if int8_plan(p) else [0, 0, 0, 0, 1]
                for p in plans]
        check(per.tolist() == want, f"C7 run {run}: launches (crop, int8 "
              f"quantizer, int8 field, cuDNN field) per update "
              f"{per.tolist()} for plans {plans}")
        check(sum(map(int8_plan, plans)) >= 1, f"C7 run {run}: no update "
              "took the int8 field")
        log(f"[C7 run {run}] paths per update: " + " ".join(
            f"{p.mode}/r{p.region}/w{p.ww}/{'i8' if int8_plan(p) else 'f32'}"
            for p in plans))
    log(f"[C7] 20 conv updates with the int8 field at {N} particles, twice: "
        f"the same state bit for bit; n_active {pf.num_particles()}, ml "
        f"{np.round(ml, 3).tolist()} against C4's (float32 field) "
        f"{np.round(c4_ml, 3).tolist()}")


def median_ms(fn, warmup=3, runs=20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def as_updated(pf, state, have_init: bool) -> None:
    """Put `state` in the filter as the update that made it leaves it: its
    snapshot copy to the host started (made once per state and kept, so a
    timing loop that starts every update from one state reads it as the
    node's loop reads the previous update's)."""
    pf.state, pf._all_have_init = state, have_init
    kept = getattr(pf, "_kept_snaps", {})
    if id(state) not in kept:
        pf._prefetch_snapshot()
        kept[id(state)] = pf._snap  # holds the state: the id stays its own
        pf._kept_snaps = kept
    pf._snap = kept[id(state)]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: float, moved: float, peak: float = PEAK_F32_FLOPS):
    """(bound ms, what bounds it): the larger of the operations over
    `peak` (default: float32 outside the tensor cores) and the bytes over
    the HBM rate."""
    t_ops = ops / peak * 1e3
    t_bytes = moved / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def crop_bound(maps, c, tr, shifts, inputs):
    """The per-cell basis of earlier runs: each search shift costs C + 1
    FMAs per stencil cell (cost, norm); the packed map and the
    per-particle inputs are read once, (N, 3) written."""
    n = inputs[0].shape[0]
    return bound(2.0 * (c + 1) * tr * shifts * n,
                 nbytes(maps, *inputs) + n * 12)


def pixel_bound(compact, c, npix, counts, inputs, extra=0.0):
    """The tracked kernels on the work their inputs need: C + 1 FMAs
    (cost, norm) per distinct stencil pixel of the particle's bucket
    (npix (K,) distinct pixels, counts (K,) particles per bucket), float32
    outside the tensor cores; the compact map, the per-particle inputs and
    `extra` bytes (slab_bytes) read once, (N, 3) written."""
    n = int(counts.sum())
    ops = 2.0 * (c + 1) * float((counts.double().cpu()
                                 * npix.double().cpu()).sum())
    return bound(ops, nbytes(compact, *inputs) + n * 12 + extra)


def slab_bytes(c, npix, key, th) -> float:
    """The bytes of the weights table a single-plane tracked call reads:
    the slab of each group (key = bucket * Th + shift) its particles fall
    in, C + 3 int16 rows of its bucket's npix distinct pixels rounded up
    to 8, and its scales (16 bytes)."""
    groups = torch.unique(key.long())
    u8 = (npix.long()[groups // th] + 7) // 8 * 8
    return float(((c + 3) * 2 * u8 + 16).sum())


def tc_bound(compact, c, shifts, npix, counts, inputs, out_floats=3,
             products=3):
    """The theta search on bf16 tensor cores, counting the products the
    inputs need, not the dense ones the kernel runs: M has C S + S + 1
    nonzero entries per distinct pixel (S cost columns on each class
    channel; S norm columns and the kf column on the known channel), and
    each costs `products` split products of 2 FLOPs per particle of its
    bucket (npix (K,) distinct pixels, counts (K,) particles per bucket):
    three on the float map (A_hi B_hi, A_hi B_lo, A_lo B_hi), two on the
    code map, whose codes are exact in bf16 (no A_lo); the compact map,
    M's nonzero hi and lo entries and the per-particle inputs read once,
    (N, out_floats) float32 written: 3 for the argmin, 2 S + 1 for the
    raw rows."""
    nnz = (c * shifts + shifts + 1) * npix.double().cpu()
    n = int(counts.sum())
    ops = 2.0 * products * float((counts.double().cpu() * nnz).sum())
    moved = (nbytes(compact, *inputs) + float(nnz.sum()) * 4
             + n * 4 * out_floats)
    return bound(ops, moved, PEAK_BF16_FLOPS)


def weights_bound(scan, cw, qinv, fold):
    """The weights pass: for each of the K tables' Th shifts, each stencil
    cell's C + 1 coefficients added to its pixel's sums (float64 in the
    pass; counted at the float32 peak outside the tensor cores, the table's
    rate for CUDA cores); the scan, the class weights, qinv and the fold's
    CSR read once, and the integers it writes (C + 3 int16 a pixel of
    npix[b] rounded up to 8, at every shift) and the (K, Th, 4) scales
    written once."""
    _, npix, order, seg = fold
    c, th, r = scan.shape
    k = npix.shape[0]
    u8 = float(((npix.long().cpu() + 7) // 8 * 8).sum())
    return bound(1.0 * (c + 1) * th * r * th * k,
                 nbytes(scan, cw, qinv, npix, order, seg)
                 + th * (c + 3) * 2 * u8 + k * th * 16)


def both_ms(name, kernel) -> float:
    """The device time a call of a single-plane tracked wrapper takes in
    its two launches, the weights pass and the kernel (their sum under
    the profiler)."""
    pass_symbols = _lokf_symbols("crop_lokf_weights_kernel", 3, "_i4" in name)
    ms, tries = kernel_ms(kernel, SYMBOLS[name] + pass_symbols, per_call=2)
    if tries > 1:
        log(f"[D] {name} with its weights pass: the time took {tries} "
            "profiles (an empty device trace before)")
    return ms


def profiled_ms(label, kernel, symbols) -> float:
    """kernel_ms of `kernel`, with a line in the log where the reading took
    more than one profile."""
    ms, tries = kernel_ms(kernel, symbols)
    if tries > 1:
        log(f"[D] {label}: the kernel time took {tries} profiles (an empty "
            "device trace before)")
    return ms


def timed(name, kernel, plain, library=None):
    """The kernel's own device time (ms), its wrapper's, its plain
    version's and the library call's (host clock, synchronised)."""
    return dict(ms=profiled_ms(name, kernel, SYMBOLS[name]),
                wrapper_ms=median_ms(kernel), plain_ms=median_ms(plain),
                library_ms=None if library is None else median_ms(library))


def fold_floor_ms() -> float:
    """The device time of a one-element fill under the profiler: what a
    launch of one small block takes at least (the fold's floor)."""
    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    return profiled_ms("one-element fill", lambda: one.fill_(7),
                       ("FillFunctor",))


def fold_times(off):
    """The fold kernel's times on the offset tables off (K, Th*R, 2),
    its bound (the tables read once, its outputs written once) and its
    floor (fold_floor_ms)."""
    return dict(
        timed("crop_fold", lambda: cs.fold_pixels(off),
              lambda: cs.fold_offsets(off)),
        bound=bound(0.0, nbytes(off, *cs.fold_pixels(off))),
        floor_ms=fold_floor_ms(), tables=off.shape[0],
    )


@contextlib.contextmanager
def capturing_orders(calls: list, limit=None):
    """Within it, each row order taken from crop_score.order_rows goes
    into `calls` as it was taken: (key, ctr, groups, extent, keywords,
    outputs), the tensors copied (at most `limit` calls of each form,
    tracked and with row_start; None: all)."""
    real, seen = cs.order_rows, {}

    def spy(key, ctr, groups, extent, **kw):
        got = real(key, ctr, groups, extent, **kw)
        form = bool(kw.get("starts"))
        seen[form] = seen.get(form, 0) + 1
        if limit is None or seen[form] <= limit:
            calls.append((key.clone(), None if ctr is None else ctr.clone(),
                          groups, extent, kw, tuple(
                              x.clone() if isinstance(x, torch.Tensor) else x
                              for x in got)))
        return got

    cs.order_rows = spy
    try:
        yield calls
    finally:
        cs.order_rows = real


def captured_orders(fn) -> list:
    """The row orders one call of fn() takes (capturing_orders)."""
    with capturing_orders([]) as calls:
        fn()
    return calls


def check_orders(label, calls) -> None:
    """Each captured order (captured_orders) against order_rows_plain on
    the same card tensors, bit for bit: the sorted keys, perm (its index
    type too), kshift and row_start; every call must have taken one."""
    check(calls, f"{label}: no row order was taken")
    for key, ctr, groups, extent, kw, got in calls:
        want = cs.order_rows_plain(key, ctr, groups, extent, **kw)
        same = got[2] == want[2] and (got[3] is None) == (want[3] is None)
        for a, b in zip(got, want):
            if isinstance(a, torch.Tensor):
                same = same and a.dtype == b.dtype and torch.equal(a, b)
        check(same, f"{label}: the order kernel's keys, perm or row_start "
              f"differ from order_rows_plain's ({key.shape[0]} rows, "
              f"{groups} groups, {kw})")
    forms = sorted({(c[2], bool(c[4].get("starts"))) for c in calls})
    log(f"[{label}] the order kernel's sorted keys, perm and row_start equal "
        f"order_rows_plain's bit for bit on {len(calls)} row order(s) "
        f"((groups, row_start): {forms})")


def device_events(fn, runs: int = 1) -> list:
    """The device events under torch.profiler of `runs` calls of fn,
    after 3 to warm up (key_averages: a name, its count and device time);
    a profile with none (an empty device trace) is taken again, up to
    three in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if events:
            break
    check(events, "a profile holds no device event")
    return events


def library_sorts(fn) -> dict:
    """{name: count} of the device kernels of one call of fn whose name
    holds "sort" (a library sort: torch.sort's CUB radix sort and its
    helpers)."""
    return {e.key: e.count for e in device_events(fn)
            if "sort" in e.key.lower()}


def order_times(calls, errs) -> dict:
    """The order kernel on the rows the tracked wrapper takes on D's
    clustered cell (calls: captured_orders of it, held first to
    order_rows_plain): its device time (profiler), its wrapper's and plain
    version's host times, torch.sort(stable=True)'s on the same keys (host
    clock; its device time, all its launches, under the profiler), the
    wrapper and torch.sort by CUDA events, and the bound: the keys and
    centres read once, the sorted keys, perm and row_start written once."""
    check_orders("D clustered", calls)
    key, ctr, groups, extent, kw, got = calls[0]
    kshift, tbits = cs.order_bits(groups, extent)
    # and every tile coordinate of both axes, centres beyond either edge
    tiles = torch.arange(1 << (kshift // 2), dtype=torch.int32,
                         device=ctr.device) << tbits
    edges = torch.tensor([[-1, -(1 << 30)], [1 << 30, 2**31 - 1],
                          [extent + 900, -400]], dtype=torch.int32,
                         device=ctr.device)
    every = torch.cat([torch.stack([tiles, tiles.flip(0)], 1), edges])
    check_orders("D every tile", captured_orders(lambda: cs.order_rows(
        torch.arange(every.shape[0], device=ctr.device) % groups, every,
        groups, extent, **kw)))
    keys = cs.order_keys_plain(key, ctr, kshift, tbits)
    errs["abs"]["crop_order"] = 0.0
    kernel = lambda: cs.order_rows(key, ctr, groups, extent, **kw)  # noqa
    library = lambda: torch.sort(keys, stable=True)  # noqa: E731
    out = dict(
        timed("crop_order", kernel,
              lambda: cs.order_rows_plain(key, ctr, groups, extent, **kw)),
        bound=bound(0.0, nbytes(key, ctr, *(x for x in got
                                            if isinstance(x, torch.Tensor)))),
        events_ms=events_ms(kernel), library_events_ms=events_ms(library),
        # the line's yardstick: torch.sort's device time, all its launches
        library_ms=sum(device_us(e) for e in device_events(library, 20))
        / 20 / 1e3,
        library_host_ms=median_ms(library), rows=key.shape[0], groups=groups,
    )
    log(f"[D] crop_order on the clustered cell ({key.shape[0]} rows, "
        f"{groups} groups, kshift {kshift}): kernel {out['ms']:.4f} ms, "
        f"by CUDA events {out['events_ms']:.4f} ms; torch.sort(stable=True)"
        f" of the same keys {out['library_ms']:.4f} ms of device "
        f"time (all its launches), by CUDA events "
        f"{out['library_events_ms']:.4f} ms, host {out['library_host_ms']:.4f}"
        f" ms; bound {out['bound'][0]:.4f} ms ({out['bound'][1]})")
    return out


def l2_route(name, kernel, windows) -> dict:
    """A code tracked cell's windows: the share the plain rule stages
    (crop_score.staged_share), and the kernel's time at budget 0, every
    block's gather from L2."""
    with mock.patch.object(cs, "WINDOW_BUDGET", 0):
        l2 = profiled_ms(f"{name} at budget 0", kernel, SYMBOLS[name])
    return dict(staged=cs.staged_share(windows), l2_ms=l2)


def phase_d(dev, pf, world, errs):
    """Times of the known-scale cells, and kernel vs plain on the cells'
    own inputs (the 3-class drive map)."""
    scan = scan_at(world, 0, dev)
    cw = torch.tensor([0.1, 1.5, 3.0], device=dev)
    cmap = pf._get_map(1)
    maps = cmap.packed
    sten = pf._device_consts()[1]  # the filter's own: its fold is kept
    tr = sten.shape[0] * sten.shape[1]
    f = SCALE_GT * RES  # a host number, as the filter passes it
    one = torch.tensor([N])  # every particle in the one bucket
    out = {}

    # timed updates start at step 1: the GMM refit (every 10th update)
    # is timed on its own below
    pf.initialize_particles()  # spread cloud, no theta prior
    spread = pf.state.replace(step=1)
    ctr = spread.particles.pose_px()
    args = (cmap, 3, sten, scan, cw, ctr)

    def init_update():
        as_updated(pf, spread, False)
        pf.update(scan, RES)

    pair = crop_pair(args, spread.particles.theta, f)
    npix = cs.fold_offsets(cs.crop_offsets(sten, f)[None])[1]
    out["crop_score_init"] = dict(
        timed("crop_score_init", *pair[1]),
        update_ms=median_ms(init_update),
        bound=tc_bound(cmap.compact(3), 3, 40, npix, one, (ctr,)),
        bound_f32=crop_bound(maps, 3, tr, 40, (ctr,)),
        # the tracked kernel on the spread cloud: its tiles spread over
        # all Th shifts, each folding the weights of its own
        tracked_spread_ms=profiled_ms("tracked on the spread cloud",
                                      pair[0][0],
                                      SYMBOLS["crop_score_tracked"]),
        pixels=int(npix[0]),
    )
    compare("D spread, C=3", errs, CROP, *pair)
    check_orders("D spread", captured_orders(
        lambda: [kernel() for kernel, _ in pair]))
    raw = raw_triple(args, f)
    out["crop_score_init_raw"] = dict(
        timed("crop_score_init_raw", *raw[:2]),
        bound=tc_bound(cmap.compact(3), 3, 40, npix, one, (ctr,), 81),
        bound_f32=crop_bound(maps, 3, tr, 40, (ctr,)),
        pixels=int(npix[0]),
    )
    compare_raw("D spread raw, C=3", errs, RAW[0], *raw)
    # the code kernels on the same cell: the same map quantized
    # (TDR_MAP_INT4=1), 2 bytes a pixel where the compact map takes 16
    cmap4 = cs.CropMap(maps, int4=True)
    codes = cmap4.codes(3)
    args4 = (cmap4, 3, sten, scan, cw, ctr)
    pair4 = crop_pair(args4, spread.particles.theta, f)
    out["crop_score_init"]["map_bytes"] = nbytes(cmap.compact(3))
    out["crop_score_init_i4"] = dict(
        timed("crop_score_init_i4", *pair4[1]),
        bound=tc_bound(codes, 3, 40, npix, one, (ctr,), products=2),
        bound_f32=crop_bound(codes, 3, tr, 40, (ctr,)),
        tracked_spread_ms=profiled_ms("tracked i4 on the spread cloud",
                                      pair4[0][0],
                                      SYMBOLS["crop_score_tracked_i4"]),
        pixels=int(npix[0]), map_bytes=nbytes(codes),
    )
    compare("D spread i4, C=3", errs, CROP_I4, *pair4)
    raw4 = raw_triple(args4, f)
    out["crop_score_init_raw_i4"] = dict(
        timed("crop_score_init_raw_i4", *raw4[:2]),
        bound=tc_bound(codes, 3, 40, npix, one, (ctr,), 81,
                       products=2),
        bound_f32=crop_bound(codes, 3, tr, 40, (ctr,)),
        pixels=int(npix[0]), map_bytes=nbytes(codes),
    )
    compare_raw("D spread raw i4, C=3", errs, RAW_I4[0], *raw4)
    # the single-plane kernels on the same cell (TDR_M_HILO=0) beside
    # their hi/lo twins: two products a k16 step on the float map, one on
    # the codes
    lokf_maps = {i4: cs.CropMap(maps, int4=i4, m_hilo=False)
                 for i4 in (False, True)}
    for int4, lm in lokf_maps.items():
        operand, tag = lm.operand(3), "_i4" * int4 + "_lokf"
        prods = 1 if int4 else 2
        argsL = (lm, 3, sten, scan, cw, ctr)
        pairL = crop_pair(argsL, spread.particles.theta, f)
        name = "crop_score_init" + tag
        out[name] = dict(
            timed(name, *pairL[1]),
            bound=tc_bound(operand, 3, 40, npix, one, (ctr,),
                           products=prods),
            bound_f32=crop_bound(operand, 3, tr, 40, (ctr,)),
            pixels=int(npix[0]), map_bytes=nbytes(operand),
        )
        compare(f"D spread{tag}, C=3", errs,
                ("crop_score_tracked" + tag, name), *pairL,
                kf_tol=LOKF_KF_TOL)
        rawL = raw_triple(argsL, f)
        name = "crop_score_init_raw" + tag
        out[name] = dict(
            timed(name, *rawL[:2]),
            bound=tc_bound(operand, 3, 40, npix, one, (ctr,), 81,
                           products=prods),
            bound_f32=crop_bound(operand, 3, tr, 40, (ctr,)),
            pixels=int(npix[0]), map_bytes=nbytes(operand),
        )
        compare_raw(f"D spread raw{tag}, C=3", errs, name, *rawL,
                    kf_tol=LOKF_KF_TOL)

    clustered = clustered_state(dev)
    ctr = clustered.particles.pose_px()
    theta = clustered.particles.theta
    args = (cmap, 3, sten, scan, cw, ctr)

    def tracked_update():
        """The crop update of the clustered cloud: its conv region
        withheld from the dispatch."""
        as_updated(pf, clustered, True)
        pf._conv_region = lambda mo: None
        try:
            pf.update(scan, RES)
        finally:
            del pf._conv_region

    pair = crop_pair(args, theta, f)
    off = cs.crop_offsets(sten, f)[None]
    check_fold("D", off)
    out["crop_fold"] = fold_times(off)
    out["crop_score_tracked"] = dict(
        timed("crop_score_tracked", *pair[0]),
        update_ms=median_ms(tracked_update),
        bound=pixel_bound(cmap.compact(3), 3, npix, one, (ctr, theta)),
        bound_cells=crop_bound(maps, 3, tr, 1, (ctr, theta)),
        pixels=int(npix[0]), map_bytes=nbytes(cmap.compact(3)),
    )
    compare("D clustered, C=3", errs, CROP, *pair)
    out["crop_order"] = order_times(captured_orders(pair[0][0]), errs)
    for label, update in (("tracked", tracked_update), ("init", init_update)):
        sorts = library_sorts(update)
        check(not sorts, f"D: the crop {label} update's profile holds a "
              f"library sort: {sorts}")
    log("[D] the crop tracked and init updates' profiles hold no library "
        "sort kernel")
    pair4 = crop_pair((cmap4, 3, sten, scan, cw, ctr), theta, f)
    out["crop_score_tracked_i4"] = dict(
        timed("crop_score_tracked_i4", *pair4[0]),
        bound=pixel_bound(codes, 3, npix, one, (ctr, theta)),
        bound_cells=crop_bound(codes, 3, tr, 1, (ctr, theta)),
        pixels=int(npix[0]), map_bytes=nbytes(codes),
        **l2_route("crop_score_tracked_i4", pair4[0][0], uniform_windows(
            (cmap4, 3, sten, scan, cw, ctr), theta, f)),
    )
    compare("D clustered i4, C=3", errs, CROP_I4, *pair4)
    slabs = slab_bytes(3, npix, rotation_shift(theta, sten.shape[0]),
                       sten.shape[0])
    for int4, lm in lokf_maps.items():
        operand, tag = lm.operand(3), "_i4" * int4 + "_lokf"
        pairL = crop_pair((lm, 3, sten, scan, cw, ctr), theta, f)
        name = "crop_score_tracked" + tag
        out[name] = dict(
            timed(name, *pairL[0]),
            both_ms=both_ms(name, pairL[0][0]),
            bound=pixel_bound(operand, 3, npix, one, (ctr, theta), slabs),
            bound_cells=crop_bound(operand, 3, tr, 1, (ctr, theta)),
            pixels=int(npix[0]), map_bytes=nbytes(operand),
        )
        compare(f"D clustered{tag}, C=3", errs,
                (name, "crop_score_init" + tag), *pairL, kf_tol=LOKF_KF_TOL)
    # the weights pass the single-plane tracked wrappers launch first, on
    # this cell's fold (float map)
    lm = lokf_maps[False]
    fold = lm.fold(sten, f)
    out["crop_lokf_weights"] = dict(
        timed("crop_lokf_weights",
              lambda: cs.tracked_table(scan, cw, lm.m_qinv, fold, 3, False),
              lambda: cs.tracked_lokf(cs.tracked_weights(
                  scan, cw, fold[2], fold[3], lm.m_qinv), False, 3)),
        bound=weights_bound(scan, cw, lm.m_qinv, fold),
    )
    gmm_ms = median_ms(lambda: gmm_mod.compute_gmm(
        clustered.particles, clustered.n_active, clustered.gmm.k))
    log(f"[D] GMM refit (every {pf.gmm_every}th update): {gmm_ms:.4f} ms")
    conv = conv_times(pf, clustered, scan, cw, sten, f)
    out["conv_field_i8"], out["conv_quant_i8"] = conv_i8_times(
        dev, world, clustered, scan, cw, sten, f, conv, errs)
    return out, conv


def conv_times(pf, clustered, scan, cw, sten, f):
    """The conv path on the clustered cloud: its plan, the cost field
    alone (CUDA events; the block cut and the cuDNN convolution) with its
    bound (float32 FMAs outside the tensor cores, TF32 off; the block and
    the kernel read once, the field written once), the kernel build, and
    the conv update beside the crop update of phase D (host clock)."""
    pf.state, pf._all_have_init = clustered, True
    plan = pf._fast_mode(RES)
    check(plan.path == "conv", f"the clustered cloud plans {plan}")
    cmap = pf._get_conv_map()
    kernel = conv_score.build_conv_kernel(scan, cw, sten, f, plan.mo,
                                          "tracked", window_w=plan.ww,
                                          s0=plan.s0)
    pose = clustered.particles.pose_px()
    origin = torch.round(pose.flip(-1)).to(torch.int64).amin(0) + cmap.pad
    s_out, cp, dr, dc = kernel.shape
    field = conv_score.cost_field(cmap.padded, kernel, origin, plan.mo,
                                  plan.region)
    ops = 2.0 * plan.region**2 * dr * dc * cp * s_out
    moved = (nbytes(kernel, field)
             + (plan.region + dr - 1) * (plan.region + dc - 1) * cp * 4)

    def conv_update():
        as_updated(pf, clustered, True)
        pf.update(scan, RES)

    calls = conv_calls()
    conv_update()
    check(conv_calls() == calls + 1, "the conv update made no cost field")
    return dict(
        plan=plan,
        field_ms=events_ms(lambda: conv_score.cost_field(
            cmap.padded, kernel, origin, plan.mo, plan.region)),
        build_ms=events_ms(lambda: conv_score.build_conv_kernel(
            scan, cw, sten, f, plan.mo, "tracked", window_w=plan.ww,
            s0=plan.s0)),
        bound=bound(ops, moved),
        flops=ops,
        update_ms=median_ms(conv_update),
        origin=origin,
    )


def int_mm_operands(codes, ints, origin, mo, region):
    """torch._int_mm's operands for the int8 field's sums: the block's
    im2col (region^2, dr dc CP) int8 in (dy, dx, c) order, built here
    outside any timed window, and the integers (2 S_out rounded up to 8,
    dr dc CP) int8 (zeros past 2 S_out; the library call takes their
    transpose)."""
    dr, dc = conv_score.conv_dims(mo)
    s_out, _, cp = ints.shape[:3]
    oy, ox = (int(v) for v in origin.tolist())
    block = codes[oy - dr // 2 : oy - dr // 2 + region + dr - 1,
                  ox - dc // 2 : ox - dc // 2 + region + dc - 1]
    a = block.unfold(0, dr, 1).unfold(1, dc, 1)  # (R, R, CP, dr, dc)
    a = a.permute(0, 1, 3, 4, 2).reshape(region * region, dr * dc * cp)
    b = torch.zeros((-(-2 * s_out // 8) * 8, dr * dc * cp), dtype=torch.int8,
                    device=codes.device)
    b[: 2 * s_out] = ints.permute(0, 1, 3, 4, 2).reshape(2 * s_out, -1)
    return a.contiguous(), b


def conv_i8_times(dev, world, clustered, scan, cw, sten, f, conv, errs):
    """The int8 field on D's clustered cell (conv_times' plan, kernel and
    origin): each kernel's own time under the profiler (the field kernel
    on the quantizer kernel's integers; a split tile's sums are added in
    its cluster), the field with its two launches (host clock, and by CUDA
    events beside cuDNN's float32 field), the plain versions' (the field's;
    quantize_conv_kernel and i8_layout for the quantizer) and
    torch._int_mm's on the im2col (host clock, and by events); the field's
    bound on the taps with a nonzero integer (2 region^2 K N int8
    operations, or the block, the integers and the field at the HBM rate)
    and on the dense K; the quantizer's bound (the float kernel and qinv
    read once; the integers, 2 S_out CP dr dc bytes without the layout's
    padding, the flags and the scales written once; at the HBM rate); the
    conv update under conv_int8=True beside the float32 route's.  Both
    kernels are held to their plain versions bit for bit here too."""
    plan = conv["plan"]
    check(int8_plan(plan), f"D: the clustered cell's plan {plan} takes no "
          "int8 field")
    pf, _ = make_filter(dev, N, seed=0, world=world, conv_int8=True)
    cmap = pf._get_conv_map()
    kernel = conv_score.build_conv_kernel(scan, cw, sten, f, plan.mo,
                                          "tracked", window_w=plan.ww,
                                          s0=plan.s0)
    ints, scales = conv_score.quantize_conv_kernel(kernel, cmap.qinv)
    args = (cmap.codes, ints, scales, conv["origin"], plan.mo, plan.region)
    quantized = (cmap.codes, cmap.qinv, kernel, conv["origin"], plan.mo,
                 plan.region)
    b, nonzero, qscales = conv_score.quantize_i8(kernel, cmap.qinv)
    ref_b, ref_nz = conv_score.i8_layout(ints)
    field, sums = conv_score.conv_field_i8(*quantized, sums=True)
    ref, ref_sums = conv_score.cost_field_i8_plain(*args)
    a, bt = int_mm_operands(cmap.codes, ints, conv["origin"], plan.mo,
                            plan.region)
    lib = torch._int_mm(a, bt.T)[:, : sums.shape[0]].T.reshape(sums.shape)
    torch.cuda.synchronize()
    check(torch.equal(b, ref_b) and torch.equal(nonzero, ref_nz)
          and same_bits((qscales,), (scales,)),
          "D: the quantizer kernel differs from its plain version")
    check(torch.equal(sums, ref_sums) and same_bits((field,), (ref,)),
          "D: the int8 field differs from its plain version")
    check(torch.equal(lib, sums), "D: torch._int_mm's sums differ")
    errs["abs"]["conv_field_i8"] = max(errs["abs"]["conv_field_i8"],
                                       float((field - ref).abs().max()))
    s_out, _, cp, dr, dc = ints.shape
    r = plan.region
    k_nnz = int(ints.reshape(2 * s_out, -1).ne(0).any(0).sum())
    k_dense = dr * dc * cp
    moved = ((r + dr - 1) * (r + dc - 1) * cp + nbytes(ints, scales, field))
    groups, width = conv_score.i8_columns(s_out)
    dcp = conv_score.i8_dcp(dc, cp)
    splits = conv_score.i8_splits(cp, width, dr, dcp, r, groups, dev.index)

    def update():
        as_updated(pf, clustered, True)
        pf.update(scan, RES)

    before = [kernels.LAUNCHES[k] for k in CONV_I8] + [conv_calls()]
    update()
    check([kernels.LAUNCHES[k] for k in CONV_I8] + [conv_calls()]
          == [before[0] + 1, before[1] + 1, before[2]],
          "D: the int8 conv update launched no quantizer or int8 field, or "
          "a cuDNN one")
    ms, tries = kernel_ms(
        lambda: conv_score.launch_field_i8(
            cmap.codes, b, nonzero, qscales, conv["origin"], plan.mo,
            plan.region, s_out),
        SYMBOLS["conv_field_i8"])
    if tries > 1:
        log(f"[D] conv_field_i8: the kernel time took {tries} profiles")
    quant_ms = profiled_ms(
        "conv_quant_i8", lambda: conv_score.quantize_i8(kernel, cmap.qinv),
        SYMBOLS["conv_quant_i8"])
    out = dict(
        ms=ms, splits=splits,
        wrapper_ms=median_ms(lambda: conv_score.conv_field_i8(*quantized)),
        plain_ms=median_ms(lambda: conv_score.cost_field_i8_plain(*args)),
        library_ms=median_ms(lambda: torch._int_mm(a, bt.T)),
        field_ms=events_ms(lambda: conv_score.conv_field_i8(*quantized)),
        library_events_ms=events_ms(lambda: torch._int_mm(a, bt.T)),
        bound=bound(2.0 * r * r * k_nnz * 2 * s_out, moved, PEAK_INT8_OPS),
        bound_dense=bound(2.0 * r * r * k_dense * 2 * s_out, moved,
                          PEAK_INT8_OPS),
        taps=(k_nnz, k_dense), im2col_bytes=nbytes(a),
        chunks=(int(nonzero.sum()), nonzero.numel()),
        update_ms=median_ms(update),
    )
    quant = dict(
        ms=quant_ms,
        wrapper_ms=median_ms(lambda: conv_score.quantize_i8(kernel,
                                                            cmap.qinv)),
        plain_ms=median_ms(lambda: conv_score.i8_layout(
            conv_score.quantize_conv_kernel(kernel, cmap.qinv)[0])),
        library_ms=None,
        bound=bound(0.0, nbytes(kernel, cmap.qinv[:cp], ints, nonzero,
                           qscales)),
        floor_fill_ms=fold_floor_ms(),
        largest=quant_largest(dev),
    )
    return out, quant


def quant_largest(dev) -> dict:
    """The quantizer at the largest shape the int8 field takes (W 64, six
    classes, mo 48: S_out 129, CP 8, dr = dc = 98, two column groups, a
    39.6 MB float kernel): B, flags and scales bit for bit its plain
    version's (quantize_conv_kernel laid out by i8_layout), twice; its
    kernel time under the profiler, its wrapper's and plain version's
    (host clock) and its bound (bytes, as at D's cell)."""
    args, kernel, qinv = conv_i8_case(dev, 6, 64, 48, 64, None, 30)
    ints, scales = args[1], args[2]
    ref_b, ref_nz = conv_score.i8_layout(ints)
    got = [conv_score.quantize_i8(kernel, qinv) for _ in range(2)]
    torch.cuda.synchronize()
    for b, nz, sc in got:
        check(torch.equal(b, ref_b) and torch.equal(nz, ref_nz)
              and same_bits((sc,), (scales,)),
              "D: the quantizer at S_out 129, CP 8, mo 48 differs from its "
              "plain version")
    cp = kernel.shape[1]
    out = dict(
        shape=list(kernel.shape),
        ms=profiled_ms("conv_quant_i8 (largest)",
                       lambda: conv_score.quantize_i8(kernel, qinv),
                       SYMBOLS["conv_quant_i8"]),
        wrapper_ms=median_ms(lambda: conv_score.quantize_i8(kernel, qinv)),
        plain_ms=median_ms(lambda: conv_score.i8_layout(
            conv_score.quantize_conv_kernel(kernel, qinv)[0])),
    )
    out["bound_ms"], out["bound_by"] = bound(
        0.0, nbytes(kernel, qinv[:cp], ints, got[0][1], got[0][2]))
    log(f"[D] conv_quant_i8 at S_out 129, CP 8, mo 48 ({nbytes(kernel)} B "
        f"float kernel): B, flags and scales equal the plain version's bit "
        f"for bit, twice; kernel {out['ms']:.4f} ms (with its wrapper "
        f"{out['wrapper_ms']:.4f} ms), plain {out['plain_ms']:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']})")
    return out


def phase_d2(dev, world, errs):
    """Times of the unknown-scale cells, at 102,400 particles from the 10
    scale hypotheses (a fresh spread init): the first update (theta
    search), and the same population with a theta each (tracked); their
    kernels against the plain versions on the same inputs."""
    pf, _ = make_filter(dev, N, seed=0, world=world, fixed_scale=-1.0)
    scan = scan_at(world, 0, dev)
    cw = torch.tensor([0.1, 1.5, 3.0], device=dev)
    sten = torch.as_tensor(pf.map.stencil, device=dev)
    tr = sten.shape[0] * sten.shape[1]
    out = {}
    fresh = pf.state.replace(step=1)  # step 1: no GMM refit
    p = fresh.particles
    with_theta = fresh.replace(particles=p.replace(
        have_init=torch.ones_like(p.have_init)))
    cells = (("crop_score_multi_init", fresh, False),
             ("crop_score_multi_tracked", with_theta, True))
    for name, state, have in cells:
        pf.state, pf._all_have_init = state, have
        plan = pf._multi_mode(RES)
        check(plan is not None, f"{name}: the cell falls to the exact step")
        host_ms = median_ms(lambda: pf._multi_mode(RES))
        pyr = pf._get_pyramid_maps(plan.levels)
        p = state.particles
        slots = torch.as_tensor(plan.slots, device=dev)
        pair = multi_pair(pair_args(pyr, sten, scan, cw, p), p.theta,
                          p.scale, slots, plan.bmi)

        def update():
            as_updated(pf, state, have)
            pf.update(scan, RES)

        tracked = name == MULTI[0]
        inputs = (p.pose_px(), p.scale) + ((p.theta,) if tracked else ())
        mips, _ = pyr.bucket_tables(plan.bmi)
        off = ms.bucket_offsets(sten, slots, RES, mips)
        npix = cs.fold_offsets(off)[1]
        if "crop_fold_multi" not in out:
            check_fold(f"D2 K={off.shape[0]}", off)
            out["crop_fold_multi"] = fold_times(off)
        counts = torch.bincount(ms.assign_buckets(p.scale, slots).long(),
                                minlength=len(slots))
        cells = crop_bound(pyr.flat, 3, tr, 1 if tracked else 40, inputs)
        out[name] = dict(
            timed(name, *pair[0 if tracked else 1]),
            update_ms=median_ms(update),
            host_ms=host_ms,
            pixels=npix.tolist(),
        )
        if tracked:
            out[name].update(
                bound=pixel_bound(pyr.compact(3), 3, npix, counts, inputs),
                bound_cells=cells)
        else:
            out[name].update(
                bound=tc_bound(pyr.compact(3), 3, 40, npix, counts, inputs),
                bound_f32=cells)
        log(f"[D2] {name}: {plan.mode}, K {plan.kp}, mo {plan.mo}, levels "
            f"{plan.levels}; host part of the dispatch {host_ms:.4f} ms")
        compare(f"D2 {plan.mode}, C=3", errs, MULTI, *pair)
        # the code kernel on the same cell: the code pyramid of the same
        # map (quantized once at full resolution)
        pyr4 = ms.build_pyramid_maps(pf.map.grid.dist.to(dev), plan.levels,
                                     int4=True)
        codes = pyr4.codes(3)
        pair4 = multi_pair(pair_args(pyr4, sten, scan, cw, p), p.theta,
                           p.scale, slots, plan.bmi)
        name4 = name + "_i4"
        out[name]["map_bytes"] = nbytes(pyr.compact(3))
        out[name4] = dict(timed(name4, *pair4[0 if tracked else 1]),
                          pixels=npix.tolist(), map_bytes=nbytes(codes))
        cells4 = crop_bound(codes, 3, tr, 1 if tracked else 40, inputs)
        if tracked:
            out[name4].update(
                bound=pixel_bound(codes, 3, npix, counts, inputs),
                bound_cells=cells4,
                **l2_route(name4, pair4[0][0], multi_windows(
                    pair_args(pyr4, sten, scan, cw, p), p.theta, p.scale,
                    slots, plan.bmi)))
        else:
            out[name4].update(
                bound=tc_bound(codes, 3, 40, npix, counts, inputs,
                               products=2),
                bound_f32=cells4)
        compare(f"D2 {plan.mode} i4, C=3", errs, MULTI_I4, *pair4)
        # the single-plane kernels on the same cell, float and code
        for int4 in (False, True):
            pyrL = ms.build_pyramid_maps(pf.map.grid.dist.to(dev),
                                         plan.levels, int4=int4,
                                         m_hilo=False)
            operand, tag = pyrL.operand(3), "_i4" * int4 + "_lokf"
            if not int4:
                qinvK = pyrL.m_qinv  # the float map's, for the weights pass
            prods = 1 if int4 else 2
            argsL = pair_args(pyrL, sten, scan, cw, p)
            pairL = multi_pair(argsL, p.theta, p.scale, slots, plan.bmi)
            nameL = name + tag
            out[nameL] = dict(timed(nameL, *pairL[0 if tracked else 1]),
                              pixels=npix.tolist(),
                              map_bytes=nbytes(operand))
            cellsL = crop_bound(operand, 3, tr, 1 if tracked else 40, inputs)
            if tracked:
                th = sten.shape[0]
                key = (ms.assign_buckets(p.scale, slots).long() * th
                       + rotation_shift(p.theta, th).long())
                out[nameL].update(
                    both_ms=both_ms(nameL, pairL[0][0]),
                    bound=pixel_bound(operand, 3, npix, counts, inputs,
                                      slab_bytes(3, npix, key, th)),
                    bound_cells=cellsL)
            else:
                out[nameL].update(
                    bound=tc_bound(operand, 3, 40, npix, counts, inputs,
                                   products=prods),
                    bound_f32=cellsL)
            compare(f"D2 {plan.mode}{tag}, C=3", errs,
                    MULTI_I4_LOKF if int4 else MULTI_LOKF, *pairL,
                    kf_tol=LOKF_KF_TOL)
            if not tracked:
                rawL = multi_raw_triple(argsL, p.scale, slots, plan.bmi)
                rname = RAW[1] + tag
                out[rname] = dict(
                    timed(rname, *rawL[:2]),
                    bound=tc_bound(operand, 3, 40, npix, counts, inputs, 81,
                                   products=prods),
                    bound_f32=cellsL, pixels=npix.tolist(),
                    map_bytes=nbytes(operand),
                )
                compare_raw(f"D2 raw{tag}, C=3", errs, rname, *rawL,
                            kf_tol=LOKF_KF_TOL)
        if tracked:  # the weights pass on this cell's K tables
            foldK = cs.fold_pixels(off)
            out["crop_lokf_weights_multi"] = dict(
                timed("crop_lokf_weights",
                      lambda: cs.tracked_table(scan, cw, qinvK, foldK, 3,
                                               False),
                      lambda: cs.tracked_lokf(cs.tracked_weights(
                          scan, cw, foldK[2], foldK[3], qinvK), False, 3)),
                bound=weights_bound(scan, cw, qinvK, foldK),
                tables=off.shape[0])
        if not tracked:
            raw4 = multi_raw_triple(pair_args(pyr4, sten, scan, cw, p),
                                    p.scale, slots, plan.bmi)
            out[RAW_I4[1]] = dict(
                timed(RAW_I4[1], *raw4[:2]),
                bound=tc_bound(codes, 3, 40, npix, counts, inputs, 81,
                               products=2),
                bound_f32=cells4, pixels=npix.tolist(),
                map_bytes=nbytes(codes),
            )
            compare_raw("D2 raw i4, C=3", errs, RAW_I4[1], *raw4)
        if not tracked:
            raw = multi_raw_triple(pair_args(pyr, sten, scan, cw, p), p.scale,
                                   slots, plan.bmi)
            out[RAW[1]] = dict(
                timed(RAW[1], *raw[:2]),
                bound=tc_bound(pyr.compact(3), 3, 40, npix, counts, inputs,
                               81),
                bound_f32=cells,
                pixels=npix.tolist(),
            )
            compare_raw("D2 raw, C=3", errs, RAW[1], *raw)
    return out


def pair_args(pyr, sten, scan, cw, p):
    return (pyr, 3, sten, scan, cw, p.pose_px())


def fill_times(rows0, valid0):
    """The fill's times (timed) and bound on rows0, valid0, after a check
    that the kernel equals its plain version and repeats bit for bit."""
    got, again = rs.fill_rows(rows0, valid0), rs.fill_rows(rows0, valid0)
    ref = rs.fill_rows_plain(rows0, valid0)
    torch.cuda.synchronize()
    check(torch.equal(got, ref) and torch.equal(got.view(torch.int32),
                                                again.view(torch.int32)),
          f"the fill at {rows0.shape[0]} rows differs or does not repeat")
    idx = torch.where(valid0, torch.arange(rows0.shape[0],
                                           device=rows0.device), 0)
    return dict(
        timed("fill_rows", lambda: rs.fill_rows(rows0, valid0),
              lambda: rs.fill_rows_plain(rows0, valid0),
              lambda: rows0.index_select(0, torch.cummax(idx, 0).values)),
        bound=bound(0.0, nbytes(rows0, valid0) + rows0.numel() * 4),
    )


def phase_d3(dev, pf):
    """The fill's times on the resample inputs of C3's last state, and on
    2^22 random rows (about 30 % of the slots valid), where the launch no
    longer hides the bytes."""
    p = pf.state.particles
    n_act = pf.state.n_active
    rng = np.random.default_rng(3)
    w = torch.as_tensor(rng.exponential(1.0, N).astype(np.float32),
                        device=dev)
    w = torch.where(p.alive, w, 0.0)
    w = w / w.sum()
    rows0, valid0 = rs._segment_starts(rs.pack_fields(p), w, n_act, n_act,
                                       torch.tensor(0.37, device=dev))
    out = fill_times(rows0, valid0)
    n = 2**22
    big = fill_times(torch.rand((n, 8), device=dev),
                     torch.rand(n, device=dev) < 0.3)
    out.update({f"{k}_2p22": big[k] for k in ("ms", "wrapper_ms", "plain_ms",
                                                "library_ms")})
    out["bound_2p22"] = big["bound"]
    return {"fill_rows": out}


def launch_counts(names):
    return np.asarray([kernels.LAUNCHES[k] for k in names] + [conv_calls()])


def drive_standing(pf, world, dev, steps, names):
    """`steps` updates with the robot standing (no motion pending): the
    max_likelihood after each, the launches of `names` (and a last column
    of conv cost fields) per update, and the plans."""
    mls, per = [], []
    with PlanLog() as plans:
        for i in range(steps):
            before = launch_counts(names)
            pf.update(scan_at(world, i, dev, move=False), RES)
            per.append(launch_counts(names) - before)
            mls.append(pf.max_likelihood())
    return np.stack(mls), np.stack(per), plans


M_NAMES = ("crop_score_multi_init_raw", "crop_score_multi_tracked",
           "crop_score_multi_init", "crop_score_init", "crop_score_tracked")


def mesh_drives(dev, world, mesh):
    """M's three drives on filters over `mesh` (None: one device), at
    102,400 particles on the drive world: (a) M_MULTI unknown-scale
    updates from the 10 hypotheses; (b) M_CONV updates of the clustered
    cloud, generator seeded 7; (c) one update of a fresh known-scale
    spread cloud, on one device forced to the exact step.  No motion is
    pending anywhere, so both run the same draws.  Returns per drive the
    max_likelihoods, plans, dispatch keys and launches per update (of
    M_NAMES, then conv cost fields), and the filters with their start
    states under "pf"."""
    out, pfs = {}, {}
    pf, _ = make_filter(dev, N, seed=0, world=world, fixed_scale=-1.0,
                        mesh=mesh)
    pfs["multi"] = (pf, pf.state)
    ml, per, plans = drive_standing(pf, world, dev, M_MULTI, M_NAMES)
    out["multi"] = dict(
        ml=ml, launches=per, keys=sorted(pf._sharded_fns, key=repr),
        plans=[None if p is None else (p.mode, p.kp, p.bmi, p.mo)
               for p in plans])

    pf, _ = make_filter(dev, N, seed=0, world=world, mesh=mesh)
    start = clustered_state(dev)
    pf.state = start if mesh is None else sharding.shard_filter_state(
        start, mesh)
    pf._all_have_init = True
    pf.generator.manual_seed(7)
    pfs["conv"] = (pf, pf.state)
    ml, per, plans = drive_standing(pf, world, dev, M_CONV, M_NAMES)
    out["conv"] = dict(
        ml=ml, launches=per, keys=sorted(pf._sharded_fns, key=repr),
        plans=[(p.mode, p.mo, p.region, p.ww, p.path) for p in plans])

    pf, _ = make_filter(dev, N, seed=0, world=world, mesh=mesh)
    exact, step_fn = [], pf._update_fn

    def exact_step(*a, **kw):
        exact.append(1)
        return step_fn(*a, **kw)

    pf._update_fn = exact_step
    if mesh is None:
        pf._fast_mode = lambda res: None
    ml, per, plans = drive_standing(pf, world, dev, 1, M_NAMES)
    out["exact"] = dict(
        ml=ml, launches=per, keys=sorted(pf._sharded_fns, key=repr),
        exact=len(exact),
        plans=[None if p is None else (p.mode, p.mo, p.path) for p in plans])
    out["pf"] = pfs
    return out


M_NAMES_I4 = tuple(k + "_i4" for k in M_NAMES[:3]) + M_NAMES
# the single-plane K-bucket kernels (float map, then code map) first, then
# every other crop kernel
M_NAMES_LOKF = tuple(k + "_lokf" for k in M_NAMES[:3]) + HILO_CROP
M_NAMES_I4_LOKF = (tuple(k + "_i4_lokf" for k in M_NAMES[:3])
                   + M_NAMES_LOKF[:3] + HILO_CROP)


def variant_drive(dev, world, mesh, names, **kw):
    """Two unknown-scale updates standing (the theta search, then
    tracked) of a filter made with `kw` (map_int4=True: the code map;
    m_hilo=False: the single-plane M) over `mesh` (None: one device), from
    the 10 hypotheses: (max_likelihoods, launches per update of `names`
    and conv cost fields)."""
    pf, _ = make_filter(dev, N, seed=0, world=world, fixed_scale=-1.0,
                        mesh=mesh, **kw)
    ml, per, _ = drive_standing(pf, world, dev, 2, names)
    return ml, per


def check_mesh_plans(label, got, n_ranks) -> None:
    """The mesh's plans, keys and launches per update as the reference's
    _update_sharded would dispatch them."""
    a = got["multi"]
    check([p[0] for p in a["plans"]] == ["init"] + ["tracked"] * (M_MULTI - 1),
          f"{label} (a): plans {a['plans']}")
    check(a["keys"] == sorted({("multi",) + p for p in a["plans"]}, key=repr),
          f"{label} (a): keys {a['keys']} for plans {a['plans']}")
    raw, tracked = a["launches"][:, 0], a["launches"][:, 1]
    check(raw[0] == 1 and not raw[1:].any() and tracked[0] == 0
          and (tracked[1:] == 1).all() and not a["launches"][:, 2:].any(),
          f"{label} (a): launches per update {a['launches'].tolist()}")
    b = got["conv"]
    keys = set()
    for mode, mo, region, ww, path in b["plans"]:
        check(path == "conv", f"{label} (b): plans {b['plans']}")
        s_out = 2 * ww + 1 if mode == "tracked" else 81
        keys.add((mode, mo, region, ww, conv_score.s2d_gate(mo, s_out), 0))
    check(b["keys"] == sorted(keys, key=repr),
          f"{label} (b): keys {b['keys']} for plans {b['plans']}")
    check(not b["launches"][:, :-1].any() and (b["launches"][:, -1] == 1).all(),
          f"{label} (b): launches per update {b['launches'].tolist()}")
    c = got["exact"]
    check(c["plans"][0][2] == "crop" and c["keys"] == [] and c["exact"] == 1
          and not c["launches"].any(),
          f"{label} (c): plan {c['plans']}, keys {c['keys']}, exact steps "
          f"{c['exact']}, launches {c['launches'].tolist()}")
    log(f"[{label}] {n_ranks} rank(s): (a) {[p[0] for p in a['plans']]}, K "
        f"{a['plans'][0][1]}, mo {a['plans'][0][3]}; (b) "
        f"{b['plans'][0]}; (c) {c['plans'][0]} -> the sharded exact step")


def check_close(label, got, ref) -> None:
    for drive in ("multi", "conv", "exact"):
        a, b = got[drive]["ml"], ref[drive]["ml"]
        ok = np.allclose(a, b, rtol=ML_RTOL, atol=ML_ATOL)
        check(ok, f"{label} ({drive}): max_likelihood {a.tolist()} against "
              f"{b.tolist()}")
        log(f"[{label}] {drive}: max_likelihood within rtol {ML_RTOL}, atol "
            f"{ML_ATOL} over {len(a)} update(s), largest |diff| "
            f"{float(np.abs(a - b).max()):.3e}")


def mesh_update_times(world, dev, mesh_pfs, single_pfs):
    """Host-clock median of the world-1 mesh update against the
    single-device one, from the same state: (a)'s theta search (its start
    at step 1, no GMM refit) and (b)'s conv update."""
    scan = scan_at(world, 0, dev, move=False)
    out = {}
    for drive, have in (("multi", False), ("conv", True)):
        for which, pfs in (("mesh", mesh_pfs), ("single", single_pfs)):
            pf, start = pfs[drive]
            start = start.replace(step=1)

            def update(pf=pf, start=start, have=have):
                as_updated(pf, start, have)
                pf.update(scan, RES)

            out[f"{drive}_{which}_ms"] = median_ms(update)
    return out


def m2_rank(rank, world_size):
    """One of M2's two ranks: the three drives on a gloo mesh over the one
    card (spawn_ranks.run_ranks' target)."""
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.ones(1, device=dev)  # the card is this rank's current device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = sharding.make_mesh(world_size, device_type="cuda")
    t0 = time.perf_counter()
    out = mesh_drives(dev, make_world(HW, HW), mesh)
    del out["pf"]
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_m(dev, world, read_launches):
    """M1 on a world-1 NCCL mesh in this process, then M2 on two ranks
    over gloo; returns the mesh update times."""
    store = tempfile.mkdtemp(dir=kernels.BUILD_DIR)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store, "m1"), 1), rank=0, world_size=1, device_id=dev)
    try:
        mesh = sharding.make_mesh(1)
        kernels.reset_launch_counts()
        calls = conv_calls()
        m1 = mesh_drives(dev, world, mesh)
        check(conv_calls() - calls == M_CONV,
              "M1: not one cost field per conv update")
        read_launches("M1", ("crop_score_multi_init_raw",
                             "crop_score_multi_tracked", "crop_fold",
                             "crop_order"))
        check_mesh_plans("M1", m1, 1)
        # the mesh's K-bucket steps on the code pyramid: the init step's
        # raw rows through crop_score_multi_init_raw_i4
        ml4, per4 = variant_drive(dev, world, mesh, M_NAMES_I4,
                                  map_int4=True)
        read_launches("M1 i4", ("crop_score_multi_init_raw_i4",
                                "crop_score_multi_tracked_i4", "crop_fold",
                                "crop_order"))
        want = np.zeros_like(per4)
        want[0, 0] = want[1, 1] = 1
        check(np.array_equal(per4, want),
              f"M1 i4: launches per update {per4.tolist()}")
        ml4_single, per4 = variant_drive(dev, world, None, M_NAMES_I4,
                                         map_int4=True)
        want = np.zeros_like(per4)
        want[0, 2] = want[1, 1] = 1
        check(np.array_equal(per4, want),
              f"M1 i4 one device: launches per update {per4.tolist()}")
        check(np.allclose(ml4, ml4_single, rtol=ML_RTOL, atol=ML_ATOL),
              f"M1 i4: max_likelihood {ml4.tolist()} against one device's "
              f"{ml4_single.tolist()}")
        log(f"[M1 i4] two K-bucket updates on the code map over the mesh "
            f"(raw rows, then tracked) within rtol {ML_RTOL}, atol "
            f"{ML_ATOL} of one device's, largest |diff| "
            f"{float(np.abs(ml4 - ml4_single).max()):.3e}")
        # and with the single-plane M, float and code map: the init step's
        # raw rows through crop_score_multi_init_raw[_i4]_lokf, no other
        # crop kernel
        for int4 in (False, True):
            label = "M1 i4 lokf" if int4 else "M1 lokf"
            names = M_NAMES_I4_LOKF if int4 else M_NAMES_LOKF
            kernels.reset_launch_counts()
            mlL, perL = variant_drive(dev, world, mesh, names,
                                      map_int4=int4, m_hilo=False)
            read_launches(label, names[:2] + ("crop_fold", "crop_order",
                                              "crop_lokf_weights"))
            want = np.zeros_like(perL)
            want[0, 0] = want[1, 1] = 1
            check(np.array_equal(perL, want),
                  f"{label}: launches per update {perL.tolist()}")
            mlL_single, perL = variant_drive(dev, world, None, names,
                                             map_int4=int4, m_hilo=False)
            want = np.zeros_like(perL)
            want[0, 2] = want[1, 1] = 1
            check(np.array_equal(perL, want),
                  f"{label} one device: launches per update {perL.tolist()}")
            check(np.allclose(mlL, mlL_single, rtol=ML_RTOL, atol=ML_ATOL),
                  f"{label}: max_likelihood {mlL.tolist()} against one "
                  f"device's {mlL_single.tolist()}")
            log(f"[{label}] two K-bucket updates with the single-plane M "
                f"over the mesh (raw rows, then tracked) within rtol "
                f"{ML_RTOL}, atol {ML_ATOL} of one device's, largest |diff| "
                f"{float(np.abs(mlL - mlL_single).max()):.3e}")
        kernels.reset_launch_counts()
        single = mesh_drives(dev, world, None)
        kernels.reset_launch_counts()
        check_close("M1 vs one device", m1, single)
        times = mesh_update_times(world, dev, m1["pf"], single["pf"])
        del m1["pf"], single["pf"]
        t0 = time.perf_counter()
        m2 = run_ranks(m2_rank, 2, os.path.join(store, "m2"),
                       timeout=300.0)
        log(f"[M2] two ranks over gloo on the card: {time.perf_counter() - t0:.1f}"
            f" s (their drives {m2[0]['seconds']:.1f} s)")
        for r, got in enumerate(m2):
            check_mesh_plans(f"M2 rank {r}", got, 2)
            check_close(f"M2 rank {r} vs M1", got, m1)
        for drive in ("multi", "conv", "exact"):
            check(m2[0][drive]["plans"] == m2[1][drive]["plans"],
                  f"M2 ({drive}): the ranks planned differently")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return times


# phase P: the probe path
def init_cases(dev, pf, world):
    """The theta search's ablation cases (K4): phase D's crop-init spread
    cell (a fresh spread init of C's filter, 3 classes, f = 1), the TPU
    clone's 6-class spread cloud (probes.ablate_init_cases) and D2's
    multi-init cell (fixed_scale -1 from the 10 hypotheses, K buckets as
    the dispatch plans them)."""
    scan = scan_at(world, 0, dev)
    cw = torch.tensor([0.1, 1.5, 3.0], device=dev)
    sten = pf._device_consts()[1]
    pf.initialize_particles()  # spread cloud, no theta prior
    spread = ("D spread C=3", False, (pf._get_map(1), 3, sten, scan, cw,
                                      pf.state.particles.pose_px(),
                                      SCALE_GT * RES))
    mpf, _ = make_filter(dev, N, seed=0, world=world, fixed_scale=-1.0)
    mpf._all_have_init = False
    plan = mpf._multi_mode(RES)
    check(plan is not None and plan.mode == "init",
          f"D2's multi-init cell plans {plan}")
    p = mpf.state.particles
    multi = ("D2 multi-init C=3", True, pair_args(
        mpf._get_pyramid_maps(plan.levels), torch.as_tensor(
            mpf.map.stencil, device=dev), scan, cw, p) + (
        p.scale, torch.as_tensor(plan.slots, device=dev), plan.bmi, RES))
    return [spread, probes.ablate_init_cases(dev, n=N)[1], multi]


def phase_p(dev, pf, world, errs, read_launches, name_limit):
    """The probes' kernels on their own inputs (probes.__main__), the
    tracked crop ablation also on D's clustered cloud, the theta search's
    on init_cases; returns the times of each probe kernel's headline case,
    with all its cases."""
    scan = scan_at(world, 0, dev)
    cw = torch.tensor([0.1, 1.5, 3.0], device=dev)
    sten = pf._device_consts()[1]
    clustered = clustered_state(dev)
    p = clustered.particles
    d_case = ("D clustered C=3", cs.score_tracked, ca.crop_ablate,
              ca.crop_ablate_plain,
              (pf._get_map(1), 3, sten, scan, cw, p.pose_px(), p.theta,
               SCALE_GT * RES))
    cases = [d_case] + probes.ablate_cases(dev)
    i_cases = init_cases(dev, pf, world)
    # K4: every variant in position order, full and checked in the
    # particles' order too (the whole grid: probes ablate_init)
    i_grid = [("position", v) for v in ca.INIT_VARIANTS] + [
        ("particles", "full"), ("particles", "checked")]
    kernels.reset_launch_counts()
    recs = []
    for label, fn in (
            ("window", probes.run_window), ("mm", probes.run_mm),
            ("ablate", lambda d: probes.run_ablate(d, cases=cases)),
            ("ablate_init",
             lambda d: probes.run_ablate_init(d, cases=i_cases,
                                              grid=i_grid))):
        t0 = time.perf_counter()
        recs += fn(dev)
        log(f"[P] {label}: {time.perf_counter() - t0:.1f} s")
    read_launches("P", tuple(PROBE_HEADLINE))
    out = {}
    for rec in recs:
        log(json.dumps(dict(rec, card=name_limit)))
        for what in ("profile", "production"):
            tries = rec.get(f"{what}_tries")
            if tries is not None and tries > 1:
                log(f"[P] {rec['probe']}: the {what} kernel time took "
                    f"{tries} profiles (an empty device trace before)")
        share = rec.get("share_of_bound")
        check(share is None or share <= 1, f"P: {rec['probe']} runs at "
              f"{share} of its bound, which no kernel can beat")
        if rec["probe"].startswith("ablate_init/"):
            split = "".join(f", {k} {rec[k]:.4f}" for k in (
                "production_ms", "inputs_ms", "m_build_ms", "launch_ms")
                if k in rec)
            log(f"[P] {rec['probe']}: kernel {rec['kernel_ms']:.4f} ms "
                f"(wrapper {rec['wrapper_ms']:.4f}{split}), plain "
                f"{rec['plain_ms']:.2f} ms, bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']}), share {rec['share_of_bound']:.3f}; "
                f"{rec['l2_bytes'] / 1e9:.3f} GB re-read from L2 "
                f"({rec['l2_window_rate_ms']:.4f} ms at K1's rate), "
                f"{rec['blocks_per_sm']} block an SM, max rel err "
                f"{rec['max_rel_err']:.2e} on {name_limit}")
        if rec.get("route") is not None:
            lib = rec["library_ms"]
            log(f"[P] {rec['probe']}: route {rec['route']}"
                + (f" (K in {rec['split_k']} splits)"
                   if rec.get("split_k", 1) > 1 else "")
                + f", kernel {rec['kernel_ms']:.4f} ms (wrapper "
                f"{rec['wrapper_ms']:.4f}), bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']}), share {rec['share_of_bound']:.3f}, "
                "library " + ("none" if lib is None else f"{lib:.4f} ms")
                + f" on {name_limit}")
        name = rec["kernel"]
        if name not in PROBE_HEADLINE:
            continue  # the production kernel's comparison
        errs["abs"][name] = max(errs["abs"][name], rec["max_abs_err"])
        if rec["probe"] == PROBE_HEADLINE[name]:
            out[name] = dict(ms=rec["kernel_ms"], plain_ms=rec["plain_ms"],
                             library_ms=rec["library_ms"],
                             bound=(rec["bound_ms"], rec["bound_by"]),
                             cases=[])
    for rec in recs:
        if rec["kernel"] in out and "kernel_ms" in rec:
            out[rec["kernel"]]["cases"].append({
                k: rec[k] for k in (
                    "probe", "replaces", "route", "split_k", "kernel_ms",
                    "wrapper_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "share_of_bound", "profile_tries",
                    "effective_tbps", "effective_tops", "effective_tflops",
                    "production_ms", "production_tries", "inputs_ms",
                    "m_build_ms", "launch_ms", "l2_bytes",
                    "l2_window_rate_ms", "blocks_per_sm") if k in rec})
    check(set(out) == set(PROBE_HEADLINE), f"P: headline cases {list(out)}")
    return out


# phase N: the node on the card
N_SCANS = 300  # N1, N2: the first scans of the city drive
N3_SCANS = 150
# N1's bound on the mean error (m) of the published poses against the
# true trajectory: twice the mean of the CPU run of the same 300 scans
# through the port (tests/city_drive_torch.py --device cpu --particles
# 8192: converged at scan 31, mean 2.075 m, max 5.01 m over 269 poses),
# rounded up
NODE_ERR_M = 4.2
SYNC_WARNING = "synchronizing CUDA operation"


class UpdateLog:
    """Per ParticleFilter.update of one filter, while open: the dispatch's
    plan (None: the exact step) and the change in the launches of every
    kernel, the conv cost fields and the exact steps run."""

    def __init__(self, pf):
        self.pf, self.rows, self._exact = pf, [], 0

    def _counts(self):
        return dict(kernels.LAUNCHES, conv=conv_calls(), exact=self._exact)

    def __enter__(self):
        pf = self.pf
        self._plan_log = PlanLog()
        plans = self._plan_log.__enter__()
        step_fn, update = pf._update_fn, pf.update

        def exact_step(*a, **kw):
            self._exact += 1
            return step_fn(*a, **kw)

        def logged(scan, res):
            before, n_plans = self._counts(), len(plans)
            update(scan, res)
            after = self._counts()
            if len(plans) > n_plans:
                self.rows.append((plans[-1], {k: after[k] - before[k]
                                              for k in after}))

        self._orig = step_fn
        pf._update_fn, pf.update = exact_step, logged
        return self

    def __exit__(self, *exc):
        self._plan_log.__exit__(*exc)
        del self.pf.update  # the instance attribute: the method again
        self.pf._update_fn = self._orig


# the kernels each plan must launch: (uniform or K-bucket) -> mode ->
# kernel names
PLAN_KERNELS = {
    False: {"tracked": ("crop_score_tracked",), "init": ("crop_score_init",),
            "mixed": ("crop_score_tracked", "crop_score_init")},
    True: {"tracked": ("crop_score_multi_tracked",),
           "init": ("crop_score_multi_init",),
           "mixed": ("crop_score_multi_tracked", "crop_score_multi_init")},
}
SCORERS = CROP + MULTI


def check_node_plans(label, rows) -> dict:
    """Each update ran what its plan names: the crop or K-bucket kernels
    of its mode and no other scorer, a conv cost field and no crop
    launch, or (no plan) the exact step.  Returns the updates per path."""
    paths = {}
    for i, (plan, d) in enumerate(rows):
        if plan is None:
            path, ok = "exact", d["exact"] == 1 and not any(
                d[k] for k in SCORERS) and d["conv"] == 0
        elif isinstance(plan, filter_mod.MultiDispatch):
            want = PLAN_KERNELS[True][plan.mode]
            path = f"multi/{plan.mode}"
            ok = (all(d[k] >= 1 for k in want) and d["exact"] == 0
                  and d["conv"] == 0
                  and not any(d[k] for k in SCORERS if k not in want))
        elif plan.path == "conv":
            path = f"conv/{plan.mode}"
            ok = d["conv"] >= 1 and d["exact"] == 0 and not any(
                d[k] for k in SCORERS)
        else:
            want = PLAN_KERNELS[False][plan.mode]
            path = f"crop/{plan.mode}/mip{plan.mip}"
            ok = (all(d[k] >= 1 for k in want) and d["exact"] == 0
                  and d["conv"] == 0
                  and not any(d[k] for k in SCORERS if k not in want))
        check(ok, f"{label}: update {i} planned {path}, launched "
              f"{ {k: v for k, v in d.items() if v} }")
        paths[path] = paths.get(path, 0) + 1
    log(f"[{label}] each of {len(rows)} updates ran what its plan names: "
        f"{paths}")
    return paths


def city_bag_for_smoke(n_scans):
    """(true trajectory px, true headings, bag) of the city drive's first
    n_scans scans (tests/city_drive_torch.py)."""
    t0 = time.perf_counter()
    maps, traj, psi = city_drive.city_world()
    bag = city_drive.make_bag(maps, traj, psi, n_scans)
    log(f"[N] city drive: {n_scans} scans of "
        f"{bag.scan_points.shape[0] // n_scans} points synthesised in "
        f"{time.perf_counter() - t0:.2f} s")
    return traj, psi, bag


def node_replay(node, traj, bag, max_scans=None, after_scan=None,
                capture=None):
    """Replay the bag through the node with every update logged and every
    blocking read counted: the synchronising calls that torch.cuda's sync
    debug mode reports ("warn"), by site, and the waits on the filter's
    snapshot copy.  after_scan(node, ulog) runs after each scan.  With a
    list `capture`, the first two row orders of either form go into it
    (capturing_orders).  Returns
    (record, errors (m) of the published poses, per-scan timing dicts,
    UpdateLog, per-scan synchronising calls, per-scan snapshot reads,
    sites)."""
    kernels.reset_launch_counts()
    pf = node.filter
    syncs, snaps, sites = [], [], {}
    seen = [0, pf.snapshot_reads]
    with UpdateLog(pf) as ulog, warnings.catch_warnings(
            record=True) as caught, (
                contextlib.nullcontext() if capture is None
                else capturing_orders(capture, limit=2)):
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            def counted(node):
                new = [w for w in caught[seen[0]:]
                       if SYNC_WARNING in str(w.message)]
                seen[0] = len(caught)
                syncs.append(len(new))
                snaps.append(pf.snapshot_reads - seen[1])
                seen[1] = pf.snapshot_reads
                for w in new:
                    site = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                    sites[site] = sites.get(site, 0) + 1
                if after_scan is not None:
                    after_scan(node, ulog)

            rec, errs, times = city_drive.run(
                node, bag, traj, on_scan=counted,
                **({} if max_scans is None else {"max_scans": max_scans}))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return (rec, errs, times, ulog, np.asarray(syncs), np.asarray(snaps),
            sites)


def log_node_times(label, times, syncs, snaps, name_limit):
    reads = syncs + snaps
    stats = {}
    for key in ("render_ms", "filter_ms", "publish_ms"):
        v = np.asarray([t[key] for t in times])
        stats[key] = (float(np.median(v)), float(np.percentile(v, 90)))
    total = np.asarray([sum(t[k] for k in ("render_ms", "filter_ms",
                                           "publish_ms")) for t in times])
    stats["scan_ms"] = (float(np.median(total)),
                        float(np.percentile(total, 90)))
    log(f"[{label}] per scan (host clock, median / p90 over {len(times)} "
        f"scans): " + ", ".join(f"{k} {a:.3f} / {b:.3f}"
                                for k, (a, b) in stats.items())
        + f"; blocking reads per scan {reads.mean():.2f} (max "
        f"{reads.max()}): synchronising calls under sync debug mode "
        f"{syncs.mean():.2f}, snapshot reads {snaps.mean():.2f} ({N} "
        f"particles, 1536^2 city map) on {name_limit}")
    stats["reads"] = float(reads.mean())
    return stats


def first_scan_ms(node, bag, traj):
    t0 = time.perf_counter()
    city_drive.run(node, bag, traj, max_scans=1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_n(dev, name_limit, read_launches):
    """The node on the card at 102,400 particles on the 1536^2 city world
    loaded from benchmarks/data/city.png: N1 the city drive's first
    N_SCANS scans with warmup, N2 the same with async_publish, N3 the
    unknown-scale node over N3_SCANS scans."""
    traj, psi, bag = city_bag_for_smoke(N_SCANS)
    out = {}

    t0 = time.perf_counter()
    cold = city_drive.make_node(particles=N, device=dev)
    build_s = time.perf_counter() - t0
    check(cold.filter.n_max == N, f"n_max {cold.filter.n_max}")
    out["first_cold_ms"] = first_scan_ms(cold, bag, traj)
    del cold
    node = city_drive.make_node(particles=N, device=dev)
    t0 = time.perf_counter()
    node.warmup()
    torch.cuda.synchronize()
    out["warmup_ms"] = (time.perf_counter() - t0) * 1e3
    caches = (len(node.filter._fast_fns), len(node.filter._maps_cache))
    log(f"[N1] node built from city.png in {build_s:.2f} s; first scan "
        f"without warmup {out['first_cold_ms']:.1f} ms; warmup "
        f"{out['warmup_ms']:.1f} ms (step functions, maps cached: {caches})")

    orders = []
    rec, errs, times, ulog, syncs, snaps, sites = node_replay(
        node, traj, bag, capture=orders)
    read_launches("N1", ("crop_score_init", "crop_score_tracked",
                         "crop_fold", "crop_order"))
    before = kernels.LAUNCHES["crop_order"]
    check_orders("N1", orders)  # its first orders of either form
    kernels.LAUNCHES["crop_order"] = before  # the check's own launches
    out["first_warm_ms"] = sum(times[0][k] for k in ("render_ms", "filter_ms",
                                                    "publish_ms"))
    paths = check_node_plans("N1", ulog.rows)
    first = rec["first_converged_stamp"]
    check(first is not None and node.is_converged, "N1: did not converge")
    check(errs.size > 0 and errs.mean() < NODE_ERR_M,
          f"N1: mean error {errs.mean() if errs.size else None} m of the "
          f"published poses, bound {NODE_ERR_M} m")
    log(f"[N1] converged at scan {int(round(first / city_drive.DT))}; "
        f"{len(rec['poses'])} poses published, error against the true "
        f"trajectory mean {errs.mean():.3f} m, median "
        f"{np.median(errs):.3f} m, max {errs.max():.3f} m (bound "
        f"{NODE_ERR_M} m); first scan with warmup "
        f"{out['first_warm_ms']:.1f} ms against {out['first_cold_ms']:.1f} "
        f"ms without")
    out["n1"] = log_node_times("N1", times, syncs, snaps, name_limit)
    top = sorted(sites.items(), key=lambda kv: -kv[1])[:8]
    log(f"[N1] synchronising call sites (count over {len(times)} scans): "
        + "; ".join(f"{k} x{v}" for k, v in top))
    out["paths"] = paths
    out.update(traj=traj, psi=psi, bag=bag, n1_poses=rec["poses"])
    pts = node._upload(bag.scan(0))
    res = torch.full((), 4.0, device=dev)
    parts = {
        "upload": lambda: node._upload(bag.scan(0)),
        "semantic": lambda: render_semantic_polar(
            pts, node.flatten_lut, res, node._ang_res, 6, 100, 25),
        "geometric": lambda: render_geometric_polar(
            pts, res, node._ang_res, 100, 25),
    }
    out["render_parts_ms"] = {k: median_ms(f) for k, f in parts.items()}
    log(f"[N1] a scan's render by parts (host clock, synchronised, median "
        f"of 20; 8,192 points): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in out["render_parts_ms"].items())
        + f" on {name_limit}")
    del node

    # N2: async publish; the nowait read must make no synchronising call
    node = city_drive.make_node(particles=N, device=dev, async_publish=True)
    node.warmup()
    orig, served = node.filter.publish_stats, {"fresh": 0, "stale": 0,
                                               "none": 0}

    def guarded(block=True):
        if block:
            return orig(block=True)
        pf = node.filter
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = orig(block=False)
        finally:
            torch.cuda.set_sync_debug_mode("warn")
        fresh = pf._snap is not None and pf._snap[0] is pf.state and (
            pf._snap[1] is not None)
        served["none" if got is None else "fresh" if fresh else "stale"] += 1
        return got

    node.filter.publish_stats = guarded
    rec, errs, times, ulog, syncs, snaps, _ = node_replay(node, traj, bag)
    read_launches("N2", ("crop_score_init", "crop_score_tracked",
                         "crop_fold", "crop_order"))
    check_node_plans("N2", ulog.rows)
    check(rec["first_converged_stamp"] is not None and node.is_converged,
          "N2: did not converge")
    log(f"[N2] async publish: converged at scan "
        f"{int(round(rec['first_converged_stamp'] / city_drive.DT))}, mean "
        f"error {errs.mean():.3f} m; publish_stats(block=False) made no "
        f"synchronising call in {sum(served.values())} publishes "
        f"(snapshot served {served})")
    out["n2"] = log_node_times("N2", times, syncs, snaps, name_limit)
    del node

    # N3: unknown scale.  The node's propagate diffuses the 10 scale
    # hypotheses by 2 % at the first scan (standing too), so the first
    # updates plan the exact step, as the reference's dispatch does, until
    # resampling clusters the scales and the K-bucket tracked kernel runs;
    # a relocalisation kick (reinitialize_fraction) on the first K-bucket
    # update from scan 20 on makes the next update mixed: the K-bucket
    # theta search for the fresh particles, tracked for the rest
    node = city_drive.make_node(particles=N, device=dev, unknown_scale=True)
    node.warmup()
    kicked = []

    def kick(node, ulog):
        plan = ulog.rows[-1][0] if ulog.rows else None
        if (not kicked and len(ulog.rows) >= 20
                and isinstance(plan, filter_mod.MultiDispatch)):
            node.filter.reinitialize_fraction(0.05)
            kicked.append(len(ulog.rows))

    rec, errs, times, ulog, syncs, snaps, _ = node_replay(
        node, traj, bag, max_scans=N3_SCANS, after_scan=kick)
    read_launches("N3", ("crop_score_multi_init", "crop_score_multi_tracked",
                         "crop_fold", "crop_order"))
    paths = check_node_plans("N3", ulog.rows)
    check(kicked and paths.get("multi/mixed"),
          f"N3: no mixed K-bucket update after the kick ({kicked})")
    frozen = node.filter.is_scale_frozen
    log(f"[N3] unknown scale over {rec['n_scans']} scans (5 % of the cloud "
        f"redrawn after update {kicked[0]}): scale "
        + (f"frozen at {node.filter.scale():.4f}" if frozen
           else "not frozen") + f" (true {city_drive.SCALE}), converged "
        f"{node.is_converged}, {len(rec['poses'])} poses published")
    out["n3"] = log_node_times("N3", times, syncs, snaps, name_limit)
    return out


# phase R: the operator's path on the card
R4_SAVE, R4_END = 150, 170  # R4: saved after scan 150, scans 151-170 again
R5_SCANS = (0, 5)  # R5: the updates traced (0-based scans [0, 5))
R2_AT = (5, 10)  # R2: the GMM means after these scans, and at the end
R_SPANS = ("tdr.render", "tdr.update", "tdr.publish")
# the crop kernels' names in the city node's trace (6 classes)
R5_SYMBOLS = {"crop_fold": "crop_fold_kernel",
              "crop_order": "crop_order_kernel",
              "crop_score_tracked": "crop_tracked_kernel<",
              "crop_score_init": "crop_init_kernel<"}
R_TOPICS = ["--scan-topic", "/pc", "--prior-topic", "/odom",
            "--gps-topic", "/gps"]
NODE_HOST_FIELDS = ("current_range_scale", "is_converged", "published_pose",
                    "last_prior_pose", "gt_pose", "motion_prior_buf",
                    "last_pc")


def write_node_configs(d: str, svg_path: str) -> str:
    """classes.yaml, map.yaml and node.yaml in `d` for the city node
    (city_drive.make_node's class config, map scale and filter overrides,
    with the SVG as the map); returns node.yaml's path."""
    cc = city_drive.class_config()
    names = city_drive.city_bag.CLASS_NAMES
    lines = ["# the city world's six classes", "classes:"]
    for i, name in enumerate(names):
        r, g, b = (int(v) for v in cc.color_lut[i])
        lines.append(
            f"  - {{name: '{name}', color: [{r}, {g}, {b}], flattened_id: "
            f"{cc.class_to_flattened[i]}, exclusive: "
            f"{str(cc.exclusivity[i]).lower()}, loc_weight: "
            f"{cc.loc_weight[i]!r}}}")
    with open(os.path.join(d, "classes.yaml"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(d, "map.yaml"), "w") as f:
        f.write(f"dynamic: false\nsvg_path: \"{svg_path}\"  # vector map\n"
                f"resolution: {city_drive.SCALE!r}\n")
    filt = "".join(
        f"  {k}: {str(v).lower() if isinstance(v, bool) else repr(v)}\n"
        for k, v in city_drive.OVERRIDES.items())
    path = os.path.join(d, "node.yaml")
    with open(path, "w") as f:
        f.write("world:\n  classes: classes.yaml\n  map: map.yaml\n"
                f"runtime:\n  particle_count: {N}\n  use_motion_prior: true\n"
                f"filter:\n{filt}")
    return path


def check_config(node_yaml: str, svg_path: str) -> None:
    """The YAML files give the parameters city_drive.make_node uses."""
    cc, mc, rt, fo = run_node.load_config(node_yaml)
    want = city_drive.class_config()
    for f in ("class_to_flattened", "flattened_to_class", "exclusivity",
              "loc_weight"):
        check(getattr(cc, f) == getattr(want, f), f"R1: classes.yaml {f}")
    check(np.array_equal(cc.color_lut, want.color_lut),
          "R1: classes.yaml colours")
    check(mc.svg_path == svg_path and mc.resolution == city_drive.SCALE
          and not mc.dynamic, f"R1: map.yaml {mc}")
    check(rt.particle_count == N and rt.use_motion_prior,
          f"R1: node.yaml runtime {rt}")
    check(fo == city_drive.OVERRIDES, f"R1: node.yaml filter {fo}")


def same_bag(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("scan_stamps", "scan_points", "scan_offsets",
                         "prior_stamps", "prior_pos", "prior_quat",
                         "gps_stamps", "gps_latlon"))


def same_poses(a, b) -> bool:
    """Published poses equal: the same scans, and position, orientation
    and covariance bit for bit (the stamps may differ by the bag's
    nanosecond rounding)."""
    return len(a) == len(b) and all(
        round(p.stamp / city_drive.DT) == round(q.stamp / city_drive.DT)
        and np.array_equal(p.position, q.position)
        and np.array_equal(p.orientation, q.orientation)
        and np.array_equal(p.covariance, q.covariance)
        for p, q in zip(a, b))


def same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(
            a, b, equal_nan=a.dtype.kind == "f")
    return a == b


def sub_bag(bag, i0: int, i1: int):
    """Scans [i0, i1) of a bag with the priors of their stamps."""
    lo, hi = bag.scan_stamps[i0], bag.scan_stamps[i1 - 1]
    pk = (bag.prior_stamps >= lo) & (bag.prior_stamps <= hi)
    off = bag.scan_offsets[i0:i1 + 1]
    return Bag(scan_stamps=bag.scan_stamps[i0:i1],
               scan_points=bag.scan_points[off[0]:off[-1]],
               scan_offsets=off - off[0],
               prior_stamps=bag.prior_stamps[pk],
               prior_pos=bag.prior_pos[pk], prior_quat=bag.prior_quat[pk])


def scan_stats(times) -> dict:
    """(median, p90) of each part of a scan and of the whole scan (ms)."""
    parts = {k: np.asarray([t[k] for t in times])
             for k in ("render_ms", "filter_ms", "publish_ms")}
    parts["scan_ms"] = sum(parts.values())
    return {k: (float(np.median(v)), float(np.percentile(v, 90)))
            for k, v in parts.items()}


def fmt_stats(stats) -> str:
    return ", ".join(f"{k} {v[0]:.3f} / {v[1]:.3f}"
                     for k, v in stats.items() if k.endswith("_ms"))


def host_ms(fn, runs: int = 5) -> float:
    return median_ms(fn, warmup=1, runs=runs)


def phase_r(dev, name_limit, read_launches, n_out):
    """The operator's path on the card: the city world as an SVG, a ROS
    bag of the drive, the node from its YAML files through run_node.main
    (R1), the map cache and raster directory (R1b), active localisation
    (R2), map refinement (R3), checkpoint and resume (R4) and tracing
    (R5), all at 102,400 particles on the 1536^2 world."""
    tmp = tempfile.mkdtemp(prefix="tdr_smoke_r_")
    try:
        return _phase_r(dev, name_limit, read_launches, n_out, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_r(dev, name_limit, read_launches, n_out, tmp):
    traj, psi, bag = n_out["traj"], n_out["psi"], n_out["bag"]
    n_scans = len(bag.scan_stamps)
    out = {}
    cc = city_drive.class_config()

    # the operator's files
    t0 = time.perf_counter()
    svg_path = os.path.join(tmp, "city.svg")
    counts = city_svg.city_svg(svg_path)
    out["svg_write_s"] = time.perf_counter() - t0
    node_yaml = write_node_configs(tmp, svg_path)
    check_config(node_yaml, svg_path)
    t0 = time.perf_counter()
    bag_path = os.path.join(tmp, "city.bag")
    want_bag = rosbag_write.write_bag(bag_path, bag)
    out["bag_write_s"] = time.perf_counter() - t0
    npz = os.path.join(tmp, "city.npz")
    t0 = time.perf_counter()
    check(rosbag.main([bag_path, npz] + R_TOPICS) == 0, "R1: bag convert")
    out["bag_convert_s"] = time.perf_counter() - t0
    got_bag = Bag.load(npz)
    check(same_bag(got_bag, want_bag), "R1: the converted bag differs from "
          "the bag written")
    check(np.array_equal(got_bag.scan_points, bag.scan_points)
          and np.abs(got_bag.scan_stamps - bag.scan_stamps).max() < 1e-9,
          "R1: the converted bag's scans differ from the drive's")
    log(f"[R1] city.svg: {counts['row_runs']} row runs, {counts['rects']} "
        f"rects, {counts['edges']} edges, {counts['crossings']} crossings "
        f"at resolution 1 ({os.path.getsize(svg_path)} bytes, written in "
        f"{out['svg_write_s']:.2f} s); city.bag: {n_scans} scans in "
        f"{-(-n_scans // 20)} bz2 chunks ({os.path.getsize(bag_path)} bytes, "
        f"written in {out['bag_write_s']:.2f} s), converted by "
        f"`python -m top_down_renderer_torch.io.rosbag` in "
        f"{out['bag_convert_s']:.2f} s, equal to the bag written bit for "
        f"bit")

    # the map's parts, alone; first the native library (built by g++ at
    # first use, unless this checkout has built it already)
    t0 = time.perf_counter()
    check(native.available(), "R1: the native SVG library is unavailable")
    out["native_build_s"] = time.perf_counter() - t0
    parse = {}
    polys = {}
    for parser, fn in (("native", svg._polys_native),
                       ("python", svg._polys_python)):
        t0 = time.perf_counter()
        got = fn(svg_path, cc.color_lut, cc.flatten_lut(), C)
        parse[parser] = (time.perf_counter() - t0) * 1e3
        check(got is not None, f"R1: the {parser} parser failed")
        size, polys[parser] = got
    check(all(len(a) == len(b) and all(np.array_equal(p, q)
                                       for p, q in zip(a, b))
              for a, b in zip(polys["native"], polys["python"])),
          "R1: the native and Python parsers disagree")
    excl = cc.exclusive_classes()
    raster_ms = host_ms(lambda: rasterize.rasterize_map(
        polys["native"], size, 1.0, excl, device=dev))
    crossings = rasterize.LAST_CROSSINGS
    # the card's part alone: the scanline on the packed edge table
    packed = [rasterize.pack_polygons(p) for p in polys["native"]]
    first = np.cumsum([0] + [len(p) for p in polys["native"]])
    edges = torch.as_tensor(np.concatenate([e for e, _ in packed]),
                            device=dev)
    pid = torch.as_tensor(np.concatenate(
        [ids.astype(np.int64) + f for (_, ids), f in zip(packed, first)]),
        device=dev)
    pcls = torch.as_tensor(np.repeat(np.arange(C), np.diff(first)),
                           device=dev)
    py, px = rasterize.pixel_coords(int(size[1]), int(size[0]), 1.0, size,
                                    dev)
    scan_ms = host_ms(lambda: rasterize.scanline(edges, pid, pcls, C, py, px))
    check(crossings == counts["crossings"], f"R1: {crossings} crossings, "
          f"the SVG's rects make {counts['crossings']}")
    maps_t = rasterize.rasterize_map(polys["native"], size, 1.0, excl,
                                     device=dev)
    png_maps = class_maps_from_index_image(
        cc.color_to_ind(read_png_rgb(city_drive.PNG)), cc.flatten_lut(), C)
    check(np.array_equal(maps_t.cpu().numpy(), png_maps),
          "R1: the SVG's class maps, rasterised on the card, differ from "
          "city.png's")
    edt_ms = host_ms(lambda: compute_dists(maps_t, 1.0, 50.0))
    out.update(parse_native_ms=parse["native"], parse_python_ms=parse["python"],
               raster_ms=raster_ms, scanline_ms=scan_ms, crossings=crossings,
               edt_ms=edt_ms)
    log(f"[R1] native library ready in {out['native_build_s']:.2f} s; SVG "
        f"parse {parse['native']:.1f} ms native, "
        f"{parse['python']:.1f} ms Python (the same polygons); rasterised "
        f"in {raster_ms:.3f} ms (the edge table packed on the host, then "
        f"the scanline on the card: {scan_ms:.3f} ms alone; {crossings} "
        f"crossings; host clock, synchronised, median of 5), equal to "
        f"city.png's class maps bit for bit; the EDT of the 6 classes "
        f"{edt_ms:.3f} ms on {name_limit}")

    # R1: the node through run_node.main, in-process, on the card
    cache = os.path.join(tmp, "cache")
    trace_dir = os.path.join(tmp, "trace")
    ckpt = os.path.join(tmp, "state_150.npz")
    run = {"times": [], "poses": [], "gmm": {}, "launch": {}}

    def on_node(node):
        run["node"] = node
        run["build_s"] = time.perf_counter() - t_main
        node.on("pose_est", run["poses"].append)
        orig = node.take_step
        traced = contextlib.ExitStack()

        def step(stamp, points, prior):
            i = len(run["times"])
            if i == R5_SCANS[0]:
                run["launch"]["before"] = dict(kernels.LAUNCHES)
                run["trace"] = traced.enter_context(device_trace(trace_dir))
            orig(stamp, points, prior)
            run["times"].append(dict(node.timing))
            if i + 1 == R5_SCANS[1]:
                torch.cuda.synchronize()
                traced.close()
                run["launch"]["after"] = dict(kernels.LAUNCHES)
            st = node.filter.state
            if i + 1 in R2_AT:
                k = int(st.gmm.k)
                run["gmm"][f"scan {i + 1}"] = st.gmm.means[:k].cpu().numpy()
            if i + 1 == R2_AT[0]:
                # R2's 8 hypotheses: 8 particles of the spread cloud
                p = st.particles
                pick = torch.linspace(0, N - 1, 8, device=dev).long()
                run["spread8"] = torch.stack(
                    [p.pose_px()[pick, 0], p.pose_px()[pick, 1],
                     p.theta[pick]], 1).cpu().numpy()
            if i + 1 == R4_SAVE:
                save_filter_state(ckpt, st, filter_generators(node.filter))
                run["host"] = copy.deepcopy(
                    {f: getattr(node, f) for f in NODE_HOST_FIELDS})
            if i + 1 == R4_END:
                run["state_end"] = filter_state_to_numpy(st)
                run["gen_end"] = node.filter.generator.get_state()

        node.take_step = step

    kernels.reset_launch_counts()
    calls = rasterize.CALLS["rasterize_map"]
    t_main = time.perf_counter()
    # main's two halves, so that the node is instrumented before it runs
    args = run_node.parse_args(["--config", node_yaml, "--bag", npz,
                                "--cache-dir", cache])
    on_node(run_node.build_node(args))
    rc = run_node.run(run["node"], args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_main
    read_launches("R1", ("crop_score_init", "crop_score_tracked",
                         "crop_fold", "crop_order"))
    node = run["node"]
    check(rc == 0, f"R1: run_node.main returned {rc}")
    check(node.device.type == "cuda", f"R1: the node ran on {node.device}")
    check(svg.LAST_PARSER == "native", "R1: the node's map was not parsed "
          "by the native parser")
    check(rasterize.CALLS["rasterize_map"] - calls == 1,
          "R1: not one rasterisation")
    check(np.array_equal(node.map.class_maps_binary, png_maps),
          "R1: the node's class maps differ from city.png's")
    check(node.is_converged and run["poses"], "R1: did not converge")
    check(same_poses(run["poses"], n_out["n1_poses"]),
          f"R1: the {len(run['poses'])} published poses differ from N1's "
          f"{len(n_out['n1_poses'])}")
    errs = city_drive.pose_errors(node, run["poses"], traj)
    out["r1"] = dict(scan_stats(run["times"]), build_s=run["build_s"],
                     wall_s=wall)
    log(f"[R1] run_node.main --config node.yaml --bag city.npz --cache-dir "
        f"(on the card): node built in {run['build_s']:.2f} s (YAML, SVG "
        f"parse, rasterisation, EDT, cache write, filter), {n_scans} scans "
        f"replayed, {len(run['poses'])} poses published equal bit for bit "
        f"to N1's (built from city.png), mean error {errs.mean():.3f} m; per "
        f"scan (host clock, median / p90) {fmt_stats(out['r1'])}; wall "
        f"{wall:.2f} s on {name_limit}")
    log(f"[R5] StepTimer.report() over R1's scans: {node.timer.report()}")

    # R1c: the control for R1's times at this point of the run: a node
    # built from city.png in code (as N1's, without warmup) replays the
    # converted bag
    ctrl = city_drive.make_node(particles=N, device=dev)
    rec_c, _, times_c = city_drive.run(ctrl, got_bag, traj)
    check(same_poses(rec_c["poses"], run["poses"]),
          "R1c: the PNG node's poses differ from R1's")
    out["r1c"] = scan_stats(times_c)
    log(f"[R1c] the same bag through a node built from city.png in code, "
        f"right after R1: per scan (host clock, median / p90) "
        f"{fmt_stats(out['r1c'])}, the same poses, on {name_limit}")
    del ctrl

    # R1b: the cache and the raster directory
    cc2, mc, rt, fo = run_node.load_config(node_yaml)
    calls = rasterize.CALLS["rasterize_map"]
    t0 = time.perf_counter()
    node2 = TopDownRenderNode(cc2, mc, rt, filter_overrides=fo,
                              map_cache_dir=cache, device=dev)
    torch.cuda.synchronize()
    out["cache_load_s"] = time.perf_counter() - t0
    check(rasterize.CALLS["rasterize_map"] == calls,
          "R1b: the cached load rasterised")
    g1, g2 = node.map.grid, node2.map.grid
    check(all(torch.equal(getattr(g1, f), getattr(g2, f))
              for f in ("dist", "geo_dist", "mask", "road_ok", "map_center"))
          and (g1.resolution, g1.num_classes) == (g2.resolution,
                                                  g2.num_classes),
          "R1b: the cached grid differs from R1's")
    raster_dir = svg_path[:-4] + "_raster_cache"
    dir_params = dataclasses.replace(node.map_params, map_path=raster_dir,
                                     cache_dir="")
    t0 = time.perf_counter()
    from_dir = TopDownMap(dir_params, device=dev)
    dir_s = time.perf_counter() - t0
    check(np.array_equal(from_dir.class_maps_binary,
                         node.map.class_maps_binary),
          "R1b: the raster directory's class maps differ from R1's")
    # the same load with the reader's unfiltered-scanline shortcut off:
    # every PNG through the anti-diagonal wavefront
    with mock.patch.object(png, "_unfilter", png._wavefront):
        t0 = time.perf_counter()
        from_dir_w = TopDownMap(dir_params, device=dev)
        dir_w_s = time.perf_counter() - t0
    check(np.array_equal(from_dir_w.class_maps_binary,
                         node.map.class_maps_binary),
          "R1b: the raster directory through the wavefront differs")
    out.update(raster_dir_s=dir_s, raster_dir_wavefront_s=dir_w_s)
    log(f"[R1b] node built from the cache in {out['cache_load_s']:.2f} s "
        f"(no rasterisation; the grid equal to R1's bit for bit) against "
        f"{run['build_s']:.2f} s from the SVG; the map from "
        f"city_raster_cache/ in {dir_s:.2f} s, its class maps equal to "
        f"R1's; {dir_w_s:.2f} s with every PNG through the wavefront "
        f"(host clock)")

    # R2: active localisation on the node's GMM means
    run["gmm"]["end"] = node.filter.state.gmm.means[
        :int(node.filter.state.gmm.k)].cpu().numpy()
    run["gmm"]["8 particles of scan 5"] = run.pop("spread8")
    al = ActiveLocalizer(node.filter.map)
    dist_cpu = node.map.grid.dist.cpu()
    r2 = {}
    for label, means in run["gmm"].items():
        got = al.get_best_rel_pos(means)
        k = len(means)
        pad = np.zeros((max(k, 1), 3), np.float32)
        pad[:k] = means
        ref = tuple(float(v) for v in get_best_rel_pos(
            dist_cpu, node.map.stencil, pad, k, C,
            map_resolution=node.map.resolution))
        check(got == ref, f"R2 {label}: card {got}, CPU {ref}")
        r2[label] = (k, got, median_ms(lambda: al.get_best_rel_pos(means),
                                       warmup=2, runs=20))
    check(any(k > 1 for k, _, _ in r2.values()),
          f"R2: one hypothesis at every point ({list(r2)})")
    out["r2"] = r2
    log(f"[R2] ActiveLocalizer.get_best_rel_pos on the node's GMM means "
        f"(equal to the CPU's; host clock, median of 20): " + "; ".join(
            f"{lbl}: K {k}, (dist {d:.1f} px, theta {t:.4f}) in {ms:.3f} ms"
            for lbl, (k, (d, t), ms) in r2.items()) + f" on {name_limit}")

    # R3: the refinement sweep over the drive's points in the map frame
    pts, cls = [], []
    for i in range(n_scans):
        p = bag.scan(i)
        p = p[(p[:, 0] != 0) | (p[:, 1] != 0)]  # the padding
        c, s = math.cos(psi[i]), math.sin(psi[i])
        x, y = p[:, 0] * city_drive.SCALE, p[:, 1] * city_drive.SCALE
        pts.append(np.stack([traj[i, 0] + c * x - s * y,
                             traj[i, 1] + s * x + c * y, p[:, 2]], 1))
        cls.append(p[:, 3])
    pts = np.concatenate(pts).astype(np.float32)
    cls = np.concatenate(cls).astype(np.int32)
    h, w = node.map.size()[::-1]
    args = (1.0, (0.0, 0.0), C, int(h), int(w))
    pts_d, cls_d = torch.as_tensor(pts, device=dev), torch.as_tensor(
        cls, device=dev)
    counts_d = accumulate_counts(pts_d, cls_d, *args)
    counts_c = accumulate_counts(torch.as_tensor(pts), torch.as_tensor(cls),
                                 *args)
    check(torch.equal(counts_d.cpu(), counts_c), "R3: counts differ from "
          "the CPU's")
    sweep_ms = median_ms(lambda: accumulate_counts(pts_d, cls_d, *args),
                         warmup=3, runs=20)
    occ = os.path.join(tmp, "occ.npz")
    np.savez(occ, points=pts, classes=cls)
    ref = MapRefiner(num_classes=C, device=dev)
    for majority in (False, True):
        t0 = time.perf_counter()
        refined, viz = ref.refine(occ, raster_dir, apply_majority=majority)
        ms = (time.perf_counter() - t0) * 1e3
        check(np.array_equal(read_png_rgb(
            os.path.join(raster_dir, "map_viz.png")), viz),
            f"R3: map_viz.png (majority {majority}) does not read back")
        out[f"refine_ms_{majority}"] = ms
    out["sweep_ms"] = sweep_ms
    log(f"[R3] accumulate_counts over {len(pts)} points of {n_scans} scans "
        f"on the {w}x{h}x{C} grid: {sweep_ms:.3f} ms (host clock, median of "
        f"20), {len(pts) / sweep_ms * 1e3:.4g} points/s, counts equal to the "
        f"CPU's ({int(counts_c.sum())} in the grid); MapRefiner.refine "
        f"{out['refine_ms_False']:.1f} ms (majority off), "
        f"{out['refine_ms_True']:.1f} ms (on), map_viz.png read back equal "
        f"on {name_limit}")

    # R4: resume the checkpoint of scan R4_SAVE in R1b's node
    pf2 = node2.filter
    pf2.state = load_filter_state(ckpt, pf2.state, filter_generators(pf2))
    for f, v in copy.deepcopy(run["host"]).items():
        setattr(node2, f, v)
    kernels.reset_launch_counts()
    rec = replay(node2, sub_bag(got_bag, R4_SAVE, R4_END))
    read_launches("R4", ())
    check(same_tree(filter_state_to_numpy(pf2.state), run["state_end"])
          and torch.equal(pf2.generator.get_state(), run["gen_end"]),
          f"R4: the state after scan {R4_END} differs")
    lo, hi = got_bag.scan_stamps[R4_SAVE], got_bag.scan_stamps[R4_END - 1]
    r1_poses = [p for p in run["poses"] if lo <= p.stamp <= hi]
    check(r1_poses and same_poses(rec["poses"], r1_poses),
          f"R4: {len(rec['poses'])} resumed poses differ from R1's "
          f"{len(r1_poses)}")
    log(f"[R4] filter state and generator saved after scan {R4_SAVE}, "
        f"restored into R1b's node: scans {R4_SAVE + 1}-{R4_END} give the "
        f"state and the {len(r1_poses)} poses of R1 bit for bit")

    # R5: the trace of R1's first updates
    with open(run["trace"].trace_path) as f:
        text = f.read()
    missing = [s for s in R_SPANS if s not in text]
    before, after = run["launch"]["before"], run["launch"]["after"]
    ran = [k for k in R5_SYMBOLS if after[k] > before[k]]
    missing += [R5_SYMBOLS[k] for k in ran if R5_SYMBOLS[k] not in text]
    check(not missing and len(ran) >= 2,
          f"R5: the trace lacks {missing} (kernels launched {ran})")
    log(f"[R5] device_trace over R1's scans {R5_SCANS[0] + 1}-{R5_SCANS[1]}:"
        f" {os.path.getsize(run['trace'].trace_path)} bytes of Chrome trace "
        f"naming the spans {list(R_SPANS)} and the kernels launched "
        f"{[R5_SYMBOLS[k] for k in ran]}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 plain matmuls
    torch.backends.cudnn.allow_tf32 = False
    name_limit = card_name_and_limit()
    log(f"[0] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; {name_limit}")

    t0 = time.perf_counter()
    ready = kernels.build_all()
    log(f"[A] built {', '.join(f'{k}.cu in {v:.2f} s' for k, v in ready.items())}"
        f" (wall {time.perf_counter() - t0:.2f} s, in parallel)")
    for name, opcodes in SASS_NEEDS.items():
        log_sass(name, opcodes)
    log_init_sass()
    log_ablate_init_sass()
    log_tracked_lokf_sass()
    log_tracked_i4_sass()

    errs = {"abs": dict.fromkeys(KERNELS, 0.0), "rel": dict.fromkeys(INIT, 0.0)}
    b_args, b_theta = phase_b(dev, errs)
    phase_b2(dev, errs, b_args, b_theta)
    phase_b3(dev, errs, b_args, b_theta)
    phase_b4(dev, errs, b_args, b_theta)
    del b_args, b_theta
    phase_b5(dev, errs)

    # each path runs with the counts set to 0 just before it and read
    # just after: its own kernels (`names`) must have launched.  Every
    # kernel's count is read after every path and summed over the paths,
    # so that each kernel's `launches` below is a sum of counts read (the
    # uniform raw-row kernel is on no path: its reads are all 0)
    launches = {}

    def read_launches(label, names):
        got = {k: kernels.LAUNCHES[k] for k in KERNELS}
        log(f"[{label}] launches on its path: {got}")
        check(all(got[k] > 0 for k in names), got)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        kernels.reset_launch_counts()

    kernels.reset_launch_counts()
    pf, world = phase_c(dev)
    read_launches("C", CROP + FOLD + ORDER)
    phase_c2(dev, world)
    read_launches("C2", MULTI + FOLD + ORDER)
    pf_fill = phase_c3(dev, world)
    read_launches("C3", ("fill_rows",))
    phase_c5(dev, world)
    read_launches("C5", CROP_I4 + MULTI_I4 + FOLD + ORDER)
    phase_c6(dev, world)
    read_launches("C6", CROP_LOKF + MULTI_LOKF + CROP_I4_LOKF + MULTI_I4_LOKF
                  + FOLD + ORDER + SCALES)

    kernels.reset_launch_counts()
    calls = conv_calls()
    c4_ml = phase_c4(dev, pf, world)
    check(conv_calls() - calls == 40, "C4: not one cost field per update")
    check(not any(kernels.LAUNCHES[k] for k in CROP + CONV_I8),
          f"C4: crop or int8 field launches {kernels.LAUNCHES}")
    log(f"[C4] conv cost fields on its path: {conv_calls() - calls}")
    read_launches("C4", ())
    phase_c7(dev, world, c4_ml)
    read_launches("C7", CONV_I8)

    log_clocks("D start")
    times, conv = phase_d(dev, pf, world, errs)
    times.update(phase_d2(dev, world, errs))
    times.update(phase_d3(dev, pf_fill))
    log_clocks("D end")
    t0 = time.perf_counter()
    times.update(phase_p(dev, pf, world, errs, read_launches, name_limit))
    log(f"[P] the probe path ran in {time.perf_counter() - t0:.1f} s on "
        f"{name_limit}")
    mesh_times = phase_m(dev, world, read_launches)
    log(f"[D] world-1 mesh update against the single-device update (host "
        f"clock, median of 20; {N} particles, {HW}^2 map): K-bucket theta "
        f"search {mesh_times['multi_mesh_ms']:.4f} against "
        f"{mesh_times['multi_single_ms']:.4f} ms, conv "
        f"{mesh_times['conv_mesh_ms']:.4f} against "
        f"{mesh_times['conv_single_ms']:.4f} ms on {name_limit}")
    node = phase_n(dev, name_limit, read_launches)
    log(f"[N] node per scan (median ms, host clock): N1 "
        f"{node['n1']['scan_ms'][0]:.3f}, N2 (async publish) "
        f"{node['n2']['scan_ms'][0]:.3f}, N3 (unknown scale) "
        f"{node['n3']['scan_ms'][0]:.3f} on {name_limit}")
    t0 = time.perf_counter()
    oper = phase_r(dev, name_limit, read_launches, node)
    log(f"[R] the operator's path ran in {time.perf_counter() - t0:.1f} s: "
        f"R1 per scan median {oper['r1']['scan_ms'][0]:.3f} ms against N1's "
        f"{node['n1']['scan_ms'][0]:.3f} ms on {name_limit}")
    for name, t in times.items():
        if "cases" in t:
            continue  # the probes: their lines are phase P's
        extra = "".join(f", {k} {t[k]:.4f} ms"
                        for k in ("update_ms", "host_ms") if k in t)
        if "pixels" in t:
            extra += f", distinct pixels {t['pixels']}"
        if "bound_f32" in t:
            extra += (f", bound on float32 outside the tensor cores "
                      f"{t['bound_f32'][0]:.4f} ms, largest rel err vs "
                      f"plain {errs['rel'][name]:.3e}")
        if "bound_cells" in t:
            extra += (f", bound per stencil cell (the earlier basis) "
                      f"{t['bound_cells'][0]:.4f} ms")
        if "map_bytes" in t:
            extra += f", map operand {t['map_bytes']} B"
        if "floor_ms" in t:
            extra += (f", {t['tables']} offset table(s), floor (a "
                      f"one-element fill) {t['floor_ms']:.4f} ms")
        if "both_ms" in t:
            extra += (f", with the weights pass (both launches) "
                      f"{t['both_ms']:.4f} ms")
        if "tables" in t and "floor_ms" not in t:
            extra += f", {t['tables']} offset tables"
        if "staged" in t:
            extra += (f", windows staged {t['staged'][0]:.4f} (their rows "
                      f"{t['staged'][1]:.4f}), at budget 0 (every gather "
                      f"from L2) {t['l2_ms']:.4f} ms")
        if "tracked_spread_ms" in t:
            extra += (f", the tracked kernel on the spread cloud "
                      f"{t['tracked_spread_ms']:.4f} ms")
        if "ms_2p22" in t:
            extra += (f"; at 2^22 rows: kernel {t['ms_2p22']:.4f} ms (with "
                      f"its wrapper {t['wrapper_ms_2p22']:.4f} ms), plain "
                      f"{t['plain_ms_2p22']:.4f} ms, bound "
                      f"{t['bound_2p22'][0]:.4f} ms, cummax + index_select "
                      f"{t['library_ms_2p22']:.4f} ms")
        if t["library_ms"] is not None:
            extra += f", library_ms {t['library_ms']:.4f} ms"
        log(f"[D] {name}: kernel {t['ms']:.4f} ms (with its wrapper "
            f"{t['wrapper_ms']:.4f} ms), plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms "
            f"({t['bound'][1]}){extra} ({N} particles, {HW}^2 map) on "
            f"{name_limit}")
    p = conv["plan"]
    log(f"[D] conv path on the clustered cloud (region {p.region}, mo "
        f"{p.mo}, window {p.ww} at {p.s0}): cost field {conv['field_ms']:.4f}"
        f" ms (CUDA events; {conv['flops']:.3e} FLOPs, bound "
        f"{conv['bound'][0]:.4f} ms, {conv['bound'][1]}), kernel build "
        f"{conv['build_ms']:.4f} ms, conv update {conv['update_ms']:.4f} ms "
        f"against the crop update {times['crop_score_tracked']['update_ms']:.4f}"
        f" ms ({N} particles, {HW}^2 map) on {name_limit}")
    i8, q8 = times["conv_field_i8"], times["conv_quant_i8"]
    log(f"[D] int8 conv field on the same cell (TDR_CONV_INT8=1): field "
        f"kernel {i8['ms']:.4f} ms ({i8['splits']} block(s) a tile, "
        f"{i8['chunks'][0]} of {i8['chunks'][1]} chunks listed), quantizer "
        f"kernel {q8['ms']:.4f} ms (bound {q8['bound'][0]:.4f} ms, "
        f"{q8['bound'][1]}; floor, a one-element fill, "
        f"{q8['floor_fill_ms']:.4f} ms; its wrapper {q8['wrapper_ms']:.4f} "
        f"ms; its plain version {q8['plain_ms']:.4f} ms), the "
        f"field with its two launches {i8['field_ms']:.4f} ms (CUDA events; "
        f"the float32 cuDNN field {conv['field_ms']:.4f} ms), bound "
        f"{i8['bound'][0]:.4f} ms ({i8['bound'][1]}; {i8['taps'][0]} taps "
        f"with a nonzero integer of {i8['taps'][1]}; dense "
        f"{i8['bound_dense'][0]:.4f} ms), torch._int_mm on the "
        f"{i8['im2col_bytes']} B im2col {i8['library_events_ms']:.4f} ms "
        f"(CUDA events); conv update {i8['update_ms']:.4f} ms against the "
        f"float32 route's {conv['update_ms']:.4f} ms (host clock) on "
        f"{name_limit}")

    result = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": launches[name],
            "max_abs_err": errs["abs"][name],
            "ms": times[name]["ms"],
            "plain_ms": times[name]["plain_ms"],
            "bound_ms": times[name]["bound"][0],
            "bound_by": times[name]["bound"][1],
            "library_ms": times[name]["library_ms"],
            **({"bound_f32_ms": times[name]["bound_f32"][0],
                "max_rel_err": errs["rel"][name]} if name in INIT else {}),
            **({"bound_cells_ms": times[name]["bound_cells"][0]}
               if "bound_cells" in times[name] else {}),
            **({"cases": times[name]["cases"]}
               if "cases" in times[name] else {}),
            # the fold: its floor, and its times at D2's K tables
            **({"floor_ms": times[name]["floor_ms"],
                "crop_fold_multi": {
                    k: times["crop_fold_multi"][k]
                    for k in ("tables", "ms", "wrapper_ms", "plain_ms",
                              "floor_ms")}
                | {"bound_ms": times["crop_fold_multi"]["bound"][0],
                   "bound_by": times["crop_fold_multi"]["bound"][1]}}
               if name == "crop_fold" else {}),
            **({"both_ms": times[name]["both_ms"]}
               if "both_ms" in times[name] else {}),
            # the quantizer: its floor, and its times at the largest shape
            **({"floor_ms": times[name]["floor_fill_ms"],
                "largest": times[name]["largest"]}
               if name == "conv_quant_i8" else {}),
            # the order: by CUDA events, its wrapper's and torch.sort's
            # host times (library_ms is torch.sort's device time)
            **({k: times[name][k] for k in (
                "events_ms", "library_events_ms", "wrapper_ms",
                "library_host_ms")} if name == "crop_order" else {}),
            # the weights pass: its times at D2's K tables
            **({"k_bucket": {
                k: times["crop_lokf_weights_multi"][k]
                for k in ("tables", "ms", "wrapper_ms", "plain_ms")}
                | {"bound_ms": times["crop_lokf_weights_multi"]["bound"][0],
                   "bound_by": times["crop_lokf_weights_multi"]["bound"][1]}}
               if name == "crop_lokf_weights" else {}),
            **({k: times[name][k] for k in ("ms_2p22", "plain_ms_2p22",
                                            "library_ms_2p22")}
               | {"bound_ms_2p22": times[name]["bound_2p22"][0]}
               if "ms_2p22" in times[name] else {}),
        }
        for name in KERNELS
    ]}
    log(f"[E] chip_smoke ran {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(result))
    print(name_limit)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
