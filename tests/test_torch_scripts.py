"""The port's script twins (top_down_renderer_torch/tools) against the JAX
package's scripts on the same inputs: preproc_survey's geo.txt byte for
byte and the same kept frames; live_view --out on a 5-scan bag at 512
particles writes as many frames as scripts/live_view.py does, each the
port node's scan image beside its map overlay."""

import os
import subprocess
import sys

import numpy as np
import pytest

import city_drive_torch as city_drive
from top_down_renderer_torch.maps.png import read_png_rgb
from top_down_renderer_torch.tools import live_view, preproc_survey

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCANS = 5


def _survey_inputs(d):
    """24 frames 0.4 s apart and a GPS track at 0.1 s: climbing through
    the altitude filter, moving 0-3 m a frame, with a gap the frames
    straddle, a comment and a blank line."""
    rng = np.random.default_rng(0)
    frames = d / "frames"
    frames.mkdir()
    for i in range(24):
        (frames / f"{100 + 0.4 * i:.2f}.jpg").write_bytes(
            rng.integers(0, 256, 64 + i, dtype=np.uint8).tobytes())
    (frames / "notes.txt").write_text("not a frame")
    rows = ["# stamp, lat, lon, alt", ""]
    lat, lon = 39.95, -75.19
    for j in range(100):
        t = 99.9 + 0.1 * j
        if 104.0 < t < 105.2:
            continue  # no fix: the frames there are dropped
        lat += rng.random() * 3e-6
        lon += rng.random() * 3e-6
        rows.append(f"{t:.3f},{lat:.9f},{lon:.9f},{10 + 0.5 * j:.2f}")
    (d / "gps.csv").write_text("\n".join(rows) + "\n")
    return str(frames), str(d / "gps.csv")


def test_preproc_survey_equals_the_script(tmp_path):
    frames, gps = _survey_inputs(tmp_path)
    outs = {}
    for name, cmd in (
            ("jax", [sys.executable, "scripts/preproc_survey.py"]),
            ("torch", [sys.executable, "-m",
                       "top_down_renderer_torch.tools.preproc_survey"])):
        out = tmp_path / name
        proc = subprocess.run(
            cmd + ["--frames", frames, "--gps", gps, "--out", str(out),
                   "--min-spacing", "2.5"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        outs[name] = out
    geo = [(o / "geo.txt").read_bytes() for o in outs.values()]
    assert geo[0] == geo[1]
    kept = [sorted(os.listdir(o / "images")) for o in outs.values()]
    assert kept[0] == kept[1] and 3 <= len(kept[0]) < 24
    for f in kept[0]:
        assert (outs["jax"] / "images" / f).read_bytes() == (
            outs["torch"] / "images" / f).read_bytes()
    assert preproc_survey.main(["--frames", frames, "--gps", gps, "--out",
                                str(tmp_path / "again"), "--min-alt",
                                "1e9"]) == 1


@pytest.fixture(scope="module")
def small_bag(tmp_path_factory):
    """A 256^2 window of the city world as PNG, its classes.yaml, and its
    first SCANS scans as an npz."""
    d = tmp_path_factory.mktemp("view")
    maps, traj, psi = city_drive.city_world()
    maps, traj = city_drive.crop(maps, traj, slice(0, SCANS), 256)
    png = str(d / "world.png")
    city_drive.write_world_png(maps, png)
    cc = city_drive.class_config()
    lines = ["classes:"]
    for i in range(6):
        rgb = ", ".join(str(int(v)) for v in cc.color_lut[i])
        lines.append(f"  - {{name: c{i}, color: [{rgb}], flattened_id: {i},"
                     f" exclusive: true, loc_weight: {cc.loc_weight[i]}}}")
    (d / "classes.yaml").write_text("\n".join(lines) + "\n")
    npz = str(d / "drive.npz")
    city_drive.make_bag(maps, traj, psi, SCANS).save(npz)
    return {"dir": d, "png": png, "classes": str(d / "classes.yaml"),
            "npz": npz}


def _flags(b, out):
    return ["--bag", b["npz"], "--map", b["png"], "--classes", b["classes"],
            "--scale", "2.0", "--out", out, "--particles", "512"]


def test_live_view_writes_the_scripts_frames(small_bag):
    out_j = str(small_bag["dir"] / "frames_jax")
    env = dict(os.environ, JAX_PLATFORMS="cpu", MPLBACKEND="Agg")
    proc = subprocess.run(
        [sys.executable, "scripts/live_view.py", *_flags(small_bag, out_j)],
        cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_jax = len(os.listdir(out_j))

    out_t = str(small_bag["dir"] / "frames_torch")
    args = live_view.parse_args(_flags(small_bag, out_t) + ["--device", "cpu"])
    node = live_view.build_node(args)
    seen = {"scan": [], "map_viz": []}
    for topic, got in seen.items():
        node.on(topic, got.append)
    assert live_view.run(node, args) == n_jax
    assert n_jax == len(seen["map_viz"]) and n_jax >= SCANS - 1
    frames = sorted(os.listdir(out_t))
    assert frames == [f"frame_{i:05d}.png" for i in range(n_jax)]
    for name, scan, viz in zip(frames, seen["scan"], seen["map_viz"]):
        img = read_png_rgb(os.path.join(out_t, name))
        np.testing.assert_array_equal(img, live_view.side_by_side(scan, viz))
        h, w = scan.shape[:2]
        np.testing.assert_array_equal(img[:h, :w], scan)
        np.testing.assert_array_equal(
            img[:viz.shape[0], w:], viz[::-1])


def test_live_view_without_out_needs_matplotlib(small_bag, tmp_path):
    """Without --out the viewer draws with matplotlib; where it cannot be
    imported the viewer raises, and writes no frame."""
    code = (
        "import sys\nsys.modules['matplotlib'] = None\n"
        "sys.modules['matplotlib.pyplot'] = None\n"
        "from top_down_renderer_torch.tools import live_view\n"
        "a = live_view.parse_args(sys.argv[1:])\n"
        "node = live_view.build_node(a)\n"
        "try:\n    live_view.run(node, a)\n"
        "except RuntimeError as e:\n    print('raised:', e)\n")
    flags = _flags(small_bag, "")
    proc = subprocess.run(
        [sys.executable, "-c", code, *flags, "--device", "cpu"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "raised: live_view without --out draws with matplotlib" in \
        proc.stdout
