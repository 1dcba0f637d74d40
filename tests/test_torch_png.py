"""The port's PNG reader (maps/png.py) against PIL's decode: the colour
maps under benchmarks/data, and hand-built PNGs that use each scanline
filter; the formats it does not read raise; and a TopDownMap builds from
city.png with PIL unimportable."""

import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from top_down_renderer_torch.config import ClassConfig, MapParams
from top_down_renderer_torch.maps import map as map_t
from top_down_renderer_torch.maps.png import read_png, read_png_rgb

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "data")


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(img, filters, colour=None, depth=8, interlace=0,
               idat_parts=2) -> bytes:
    """A PNG of img (H, W, C) uint8 whose row y uses scanline filter
    filters[y % len(filters)], its data split over idat_parts chunks."""
    h, w, c = img.shape
    colour = {3: 2, 4: 6, 1: 0}[c] if colour is None else colour
    prev = np.zeros(w * c, np.int64)
    raw = bytearray()
    for y in range(h):
        line = img[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(c, np.int64), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        f = filters[y % len(filters)]
        pred = [0, left, prev, (left + prev) // 2,
                _paeth(left, prev, upleft)][f]
        raw.append(f)
        raw += ((line - pred) & 255).astype(np.uint8).tobytes()
        prev = line
    data = zlib.compress(bytes(raw))
    cut = np.linspace(0, len(data), idat_parts + 1).astype(int)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                          0, 0, interlace))
            + _chunk(b"tEXt", b"Comment\x00ancillary chunk")
            + b"".join(_chunk(b"IDAT", data[a:b])
                       for a, b in zip(cut[:-1], cut[1:]))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("name", ["city", "city_hard", "town"])
def test_repo_maps_decode_as_pil_does(name):
    path = os.path.join(DATA, f"{name}.png")
    got = read_png(path)
    ref = np.asarray(Image.open(path))
    assert got.shape == ref.shape == (1536, 1536, 3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4],
                                     [0, 1, 2, 3, 4], [4, 3, 1, 2, 0]])
def test_each_scanline_filter_decodes_as_pil_does(tmp_path, channels,
                                                  filters):
    rng = np.random.default_rng(len(filters) * 10 + filters[0] + channels)
    img = rng.integers(0, 256, (23, 37, channels), dtype=np.uint8)
    img[5:9] = 255  # runs that the predictors carry across 255 -> 0
    img[:, 3] = 0
    path = tmp_path / "f.png"
    path.write_bytes(encode_png(img, filters))
    np.testing.assert_array_equal(read_png(str(path)), img)
    np.testing.assert_array_equal(read_png(str(path)),
                                  np.asarray(Image.open(path)))
    np.testing.assert_array_equal(
        read_png_rgb(str(path)),
        np.asarray(Image.open(path).convert("RGB")))


def _write(tmp_path, data: bytes) -> str:
    path = tmp_path / "x.png"
    path.write_bytes(data)
    return str(path)


def test_unread_formats_raise(tmp_path):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    pal = tmp_path / "p.png"
    Image.fromarray(rgb).convert("P").save(pal)
    grey = tmp_path / "g.png"
    Image.fromarray(rgb[..., 0]).save(grey)
    cases = {
        str(pal): "palette",
        str(grey): "greyscale",
        _write(tmp_path, encode_png(rgb, [0], depth=16)): "16-bit",
    }
    for path, what in cases.items():
        with pytest.raises(ValueError, match=what):
            read_png(path)
    interlaced = tmp_path / "i.png"
    interlaced.write_bytes(encode_png(rgb, [0], interlace=1))
    with pytest.raises(ValueError, match="interlaced"):
        read_png(str(interlaced))
    good = bytearray(encode_png(rgb, [1]))
    good[-20] ^= 0xFF  # inside the last IDAT
    bad_crc = tmp_path / "c.png"
    bad_crc.write_bytes(bytes(good))
    with pytest.raises(ValueError, match="CRC"):
        read_png(str(bad_crc))
    jpg = tmp_path / "j.jpg"
    Image.fromarray(rgb).save(jpg)
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(jpg))


def test_city_map_builds_without_pil(monkeypatch):
    """TopDownMap(MapParams(map_path="benchmarks/data/city.png")) with PIL
    unimportable: the class maps equal those of PIL's decode."""
    sys.path.insert(0, os.path.dirname(DATA))
    from city_bag import CLASS_COLORS

    lut = np.full((256, 3), 255, np.uint8)
    lut[:6] = CLASS_COLORS
    cc = ClassConfig(lut, list(range(6)), list(range(6)), [True] * 6,
                     [0.1, 1.0, 2.5, 1.5, 2.0, 2.0])
    params = MapParams(map_path=os.path.join(DATA, "city.png"), num_classes=6,
                       flatten_lut=cc.flatten_lut(), class_config=cc)
    want = map_t.class_maps_from_index_image(
        cc.color_to_ind(np.asarray(Image.open(params.map_path))),
        cc.flatten_lut(), 6)
    for name in [m for m in sys.modules if m.split(".")[0] == "PIL"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    tdm = map_t.TopDownMap(params, device="cpu")
    assert tdm.have_map and tdm.size().tolist() == [1536, 1536]
    np.testing.assert_array_equal(tdm.class_maps_binary, want)
