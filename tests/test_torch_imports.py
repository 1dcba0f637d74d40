"""The port stands apart from JAX: importing it, its scorers, its kernel
loader and chip_smoke.py's imports leaves jax, and every module of the
JAX package (top_down_renderer_tpu), out of sys.modules, and nothing is
compiled (or needs nvcc) until a kernel is launched."""

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
        "chip_smoke",
    ],
)
def test_imports_leave_jax_out(modules):
    out = _run(
        f"import sys\nimport {modules}\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax')\n"
        "             or m.startswith('top_down_renderer_tpu'))\n"
        "print(bad)\n"
    )
    assert out.strip() == "[]", out


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
