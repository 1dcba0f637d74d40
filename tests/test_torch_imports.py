"""The port stands apart from JAX: importing it, its scorers, its kernel
loader, its node, replay and PNG reader, the operator's modules (YAML
reader, SVG loader and rasteriser, rosbag reader, ROS shim, run_node),
active localisation, refinement, checkpoints and tracing, the probes,
the script twins (tools.live_view, tools.preproc_survey), and
chip_smoke.py's imports (and running the nibble-packed map's path) leaves
jax, every module of the JAX package
(top_down_renderer_tpu), pyyaml, Pillow and lz4 (none of which the
machine with the card has) out of sys.modules, and nothing is compiled
(or needs nvcc) until a kernel is launched."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, env=None):
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize(
    "modules",
    [
        "top_down_renderer_torch",
        "top_down_renderer_torch.filter.crop_score, "
        "top_down_renderer_torch.kernels",
        "top_down_renderer_torch.filter.multiscale, "
        "top_down_renderer_torch.filter.resample, "
        "top_down_renderer_torch.config",
        "top_down_renderer_torch.filter.filter, "
        "top_down_renderer_torch.maps.map, "
        "top_down_renderer_torch.render.semantic, "
        "top_down_renderer_torch.utils.convert, "
        "top_down_renderer_torch.testing",
        "top_down_renderer_torch.parallel",
        "top_down_renderer_torch.maps.png, "
        "top_down_renderer_torch.render.geometric, "
        "top_down_renderer_torch.runtime.node, "
        "top_down_renderer_torch.runtime.viz, "
        "top_down_renderer_torch.io.replay, "
        "top_down_renderer_torch.io.points",
        "top_down_renderer_torch.utils.yaml_subset, "
        "top_down_renderer_torch.config, "
        "top_down_renderer_torch.maps, "
        "top_down_renderer_torch.maps.svg, "
        "top_down_renderer_torch.maps.native, "
        "top_down_renderer_torch.maps.rasterize",
        "top_down_renderer_torch.io.rosbag, "
        "top_down_renderer_torch.runtime.ros_shim, "
        "top_down_renderer_torch.runtime.run_node",
        "top_down_renderer_torch.active, "
        "top_down_renderer_torch.tools, "
        "top_down_renderer_torch.utils, "
        "top_down_renderer_torch.utils.checkpoint, "
        "top_down_renderer_torch.utils.tracing, "
        "top_down_renderer_torch.render",
        "city_svg_torch, rosbag_write_torch, city_drive_torch",
        "top_down_renderer_torch.probes, "
        "top_down_renderer_torch.probes.window, "
        "top_down_renderer_torch.probes.mm, "
        "top_down_renderer_torch.probes.crop_ablate, "
        "top_down_renderer_torch.probes.__main__",
        "top_down_renderer_torch.probes.variants",
        "top_down_renderer_torch.tools.live_view, "
        "top_down_renderer_torch.tools.preproc_survey",
        "chip_smoke",
        "time_torch_tracked, time_torch_ablate_init",
        "sass_diff_torch",
    ],
)
def test_imports_leave_jax_out(modules):
    out = _run(
        "import sys\nsys.path.insert(0, 'tests')\n"
        f"import {modules}\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'yaml',\n"
        "                                    'PIL', 'lz4')\n"
        "             or m.startswith('top_down_renderer_tpu'))\n"
        "print(bad)\n"
    )
    assert out.strip() == "[]", out


def test_code_map_path_leaves_jax_out():
    """The nibble-packed map (TDR_MAP_INT4=1) on the CPU: its quantizer
    and codes, the uniform and K-bucket scorers on them, and a filter with
    map_int4=True through one update, with nothing of JAX or the JAX
    package imported."""
    out = _run(
        "import sys\nsys.path.insert(0, 'tests')\n"
        "import numpy as np, torch\n"
        "from top_down_renderer_torch.filter import crop_score as cs\n"
        "from top_down_renderer_torch.filter import multiscale as ms\n"
        "from top_down_renderer_torch.maps.polar import polar_stencil\n"
        "from drive_consumer_torch import make_filter\n"
        "m = torch.rand((32, 32, 8)); m[..., 1] = 1\n"
        "a = (1, torch.as_tensor(polar_stencil(100, 25)),\n"
        "     torch.ones((1, 100, 25)), torch.ones(1), torch.full((3, 2), 16.))\n"
        "cs.score_init_sel(cs.CropMap(m, int4=True), *a, 0.5)\n"
        "cs.score_tracked(cs.CropMap(m, int4=True), *a, torch.zeros(3), 0.5)\n"
        "pyr = ms.build_pyramid_maps(m, (1, 2), int4=True)\n"
        "ms.score_init_multi_raw(pyr, *a, torch.ones(3), torch.tensor([1.]),\n"
        "                        (0,), 0.5)\n"
        "pf, _ = make_filter('cpu', 256, map_int4=True)\n"
        "pf.update(np.random.default_rng(0).random((3, 100, 25))\n"
        "          .astype(np.float32), 1.0)\n"
        "maps = [v for v in pf._maps_cache.values() if hasattr(v, 'int4')]\n"
        "print('int4', bool(maps) and all(v.int4 for v in maps))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax')\n"
        "             or m.startswith('top_down_renderer_tpu'))\n"
        "print(bad)\n"
    )
    assert out.split("\n")[:2] == ["int4 True", "[]"], out


def test_kernel_module_needs_no_nvcc_until_launch(tmp_path):
    env = dict(os.environ)
    env["PATH"] = "/usr/bin:/bin"
    env["CUDA_HOME"] = str(tmp_path / "no-cuda")
    out = _run(
        "import torch\n"
        "from top_down_renderer_torch import kernels\n"
        "from top_down_renderer_torch.filter import crop_score as cs\n"
        "from top_down_renderer_torch.maps.polar import polar_stencil\n"
        "try:\n"
        "    kernels.find_nvcc()\n"
        "    print('nvcc found')\n"
        "except RuntimeError as e:\n"
        "    print('no nvcc:', 'nvcc not found' in str(e))\n"
        "m = torch.zeros((32, 32, 8)); m[..., 1] = 1\n"
        "out = cs.score_init_sel(cs.CropMap(m), 1, torch.as_tensor(polar_stencil(100, 25)),\n"
        "    torch.ones((1, 100, 25)), torch.ones(1), torch.full((3, 2), 16.),\n"
        "    0.5)\n"
        "print('cpu ok', tuple(out[0].shape), sum(kernels.LAUNCHES.values()))\n",
        env=env,
    )
    assert "no nvcc: True" in out, out
    assert "cpu ok (3,) 0" in out, out


def test_operator_path_runs_without_yaml_pillow_lz4(tmp_path):
    """With yaml, PIL and lz4 unimportable: the example YAML config loads,
    an SVG map loads, rasterises, writes its raster directory and cache,
    the raster directory and the cache load back, an lz4 bag converts, and
    the refiner writes map_viz.png."""
    out = _run(
        "import sys\n"
        "for m in ('yaml', 'PIL', 'lz4'):\n"
        "    sys.modules[m] = None\n"
        "sys.path.insert(0, 'tests')\n"
        "import numpy as np\n"
        "from top_down_renderer_torch.runtime.run_node import load_config\n"
        "from top_down_renderer_torch.config import MapParams\n"
        "from top_down_renderer_torch.maps.map import TopDownMap\n"
        "from top_down_renderer_torch.io.rosbag import convert_rosbag\n"
        "from top_down_renderer_torch.tools.refine import MapRefiner\n"
        "import rosbag_write_torch as w\n"
        "cc, mc, rt, fo = load_config('config/example/node.yaml')\n"
        f"d = {str(tmp_path)!r}\n"
        "open(d + '/m.svg', 'w').write('<svg width=\"32\" height=\"24\">'\n"
        "    '<rect x=\"2\" y=\"3\" width=\"9\" height=\"7\" "
        "fill=\"#ff0000\"/></svg>')\n"
        "p = MapParams(map_path=d + '/m.svg', num_classes=6,\n"
        "              class_config=cc, cache_dir=d + '/cache')\n"
        "a = TopDownMap(p, device='cpu')\n"
        "b = TopDownMap(p, device='cpu')\n"
        "import dataclasses\n"
        "c = TopDownMap(dataclasses.replace(p, map_path=d + "
        "'/m_raster_cache', cache_dir=''), device='cpu')\n"
        "assert (a.class_maps_binary[1] == 0).sum() == 63\n"
        "assert np.array_equal(b.class_maps_binary, a.class_maps_binary)\n"
        "assert np.array_equal(c.class_maps_binary, a.class_maps_binary)\n"
        "w.write_test_bag(d + '/t.bag', 'lz4')\n"
        "bag = convert_rosbag(d + '/t.bag', '/pc', '/odom', '/gps')\n"
        "np.savez(d + '/occ.npz', points=np.zeros((3, 3), np.float32),\n"
        "         classes=np.zeros(3, np.int32))\n"
        "r, v = MapRefiner(device='cpu').refine(d + '/occ.npz',\n"
        "                                       d + '/m_raster_cache')\n"
        "print('ok', len(bag.scan_stamps), v.shape,\n"
        "      sorted(m for m in ('yaml', 'PIL', 'lz4')\n"
        "             if sys.modules.get(m) is not None))\n"
    )
    assert "ok 5 (24, 32, 3) []" in out, out
