"""The port's PNG reader / writer and area downscale
(snvc_tpu_torch/data/png.py) against cv2, which the JAX package reads and
writes images with (snvc_tpu/data/kitti.py:89-146, data/synthetic.py).

* ``decode_png`` equals ``cv2.imread(IMREAD_COLOR)`` + BGR->RGB bit for bit
  on the frames the JAX renderer wrote, and on the same frames re-written
  by cv2 with each of libpng's row filters and with adaptive filtering;
  the filter bytes of those files cover all five types.
* ``encode_png`` -> ``decode_png`` gives the array back for each filter;
  cv2 reads the port's files the same.
* RGBA drops alpha, as ``IMREAD_COLOR`` does; 16-bit, palette, grey and
  interlaced files, a bad filter byte and a bad CRC raise ``ValueError``.
* ``resize_area`` equals ``cv2.INTER_AREA`` bit for bit at 375x1242 ->
  96x320 and at other ratios that are not integers: it repeats OpenCV's
  float32 sums in their order, so no level of difference is allowed.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from snvc_tpu.data.synthetic import make_synthetic_kitti
from snvc_tpu_torch.data import png


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_png"))
    make_synthetic_kitti(root, num_frames=2, boxes_per_frame=2, seed=3)
    paths = []
    for d in ("image_2", "image_3"):
        for name in ("000000.png", "000001.png"):
            paths.append(os.path.join(root, "training", d, name))
    return root, paths


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def _filter_bytes(path):
    """The filter byte of every row of an 8-bit PNG."""
    data = open(path, "rb").read()
    chunks = list(png._chunks(data, path))
    w, h, _, color = struct.unpack(">IIBB", chunks[0][1][:10])
    raw = zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT"))
    rows = np.frombuffer(raw, np.uint8).reshape(h, -1)
    return set(int(v) for v in rows[:, 0])


_CV2_FILTERS = {
    "none": cv2.IMWRITE_PNG_FILTER_NONE,
    "sub": cv2.IMWRITE_PNG_FILTER_SUB,
    "up": cv2.IMWRITE_PNG_FILTER_UP,
    "avg": cv2.IMWRITE_PNG_FILTER_AVG,
    "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
    "all": cv2.IMWRITE_PNG_ALL_FILTERS,
}


def test_decode_equals_cv2_on_rendered_frames(frames):
    _, paths = frames
    for p in paths:
        got = png.decode_png(p)
        assert got.dtype == np.uint8 and got.shape == (375, 1242, 3)
        np.testing.assert_array_equal(got, _cv2_rgb(p), err_msg=p)
        assert png.png_size(p) == (375, 1242)


def test_decode_equals_cv2_over_all_filter_types(frames, tmp_path):
    root, paths = frames
    seen = set()
    for p in paths[:2]:
        bgr = cv2.imread(p, cv2.IMREAD_COLOR)
        for name, flag in _CV2_FILTERS.items():
            out = str(tmp_path / f"{name}_{os.path.basename(p)}")
            assert cv2.imwrite(out, bgr, [cv2.IMWRITE_PNG_FILTER, flag])
            seen |= _filter_bytes(out)
            np.testing.assert_array_equal(png.decode_png(out), _cv2_rgb(out),
                                          err_msg=out)
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, (0, 1, 2, 3, 4)])
def test_encode_decode_round_trip(filters, tmp_path):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    img[:10] = img[:10] // 32 * 32  # flat runs beside noise
    path = str(tmp_path / "rt.png")
    png.encode_png(path, img, filters)
    want = {filters} if isinstance(filters, int) else set(filters)
    assert _filter_bytes(path) == want
    np.testing.assert_array_equal(png.decode_png(path), img)
    np.testing.assert_array_equal(_cv2_rgb(path), img)


def test_rgba_drops_alpha(tmp_path):
    rng = np.random.default_rng(8)
    rgba = rng.integers(0, 256, (20, 31, 4), dtype=np.uint8)
    path = str(tmp_path / "rgba.png")
    png.encode_png(path, rgba, (4, 3, 1))
    got = png.decode_png(path)
    np.testing.assert_array_equal(got, rgba[..., :3])
    np.testing.assert_array_equal(got, _cv2_rgb(path))


def _write_raw(path, ihdr_fields, raw_rows):
    ihdr = struct.pack(">IIBBBBB", *ihdr_fields)
    with open(path, "wb") as fh:
        fh.write(png.PNG_SIGNATURE + png._chunk(b"IHDR", ihdr)
                 + png._chunk(b"IDAT", zlib.compress(raw_rows))
                 + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["16bit", "palette", "grey", "interlaced"])
def test_refuses_other_formats(kind, tmp_path):
    path = str(tmp_path / f"{kind}.png")
    if kind == "16bit":
        img = np.zeros((4, 5, 3), np.uint16)
        assert cv2.imwrite(path, img)
    elif kind == "palette":
        _write_raw(path, (5, 4, 8, 3, 0, 0, 0), bytes(4 * 6))
    elif kind == "grey":
        assert cv2.imwrite(path, np.zeros((4, 5), np.uint8))
    else:
        _write_raw(path, (5, 4, 8, 2, 0, 0, 1), bytes(4 * 16))
    with pytest.raises(ValueError):
        png.decode_png(path)


def test_refuses_bad_filter_byte_and_crc(tmp_path):
    path = str(tmp_path / "bad_filter.png")
    _write_raw(path, (2, 2, 8, 2, 0, 0, 0), bytes([0] + [9] * 6 + [7] * 7))
    with pytest.raises(ValueError, match="filter type 7"):
        png.decode_png(path)
    img = np.zeros((3, 3, 3), np.uint8)
    path = str(tmp_path / "bad_crc.png")
    png.encode_png(path, img)
    data = bytearray(open(path, "rb").read())
    data[data.index(b"IDAT") + 4] ^= 0xFF  # the IDAT payload's first byte
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        png.decode_png(path)


@pytest.mark.parametrize("src_hw,out_hw", [
    ((375, 1242), (96, 320)),
    ((375, 1242), (39, 128)),
    ((101, 93), (34, 41)),
])
def test_resize_area_equals_cv2(frames, src_hw, out_hw):
    _, paths = frames
    img = png.decode_png(paths[0])[:src_hw[0], :src_hw[1]]
    img = np.ascontiguousarray(img)
    want = cv2.resize(img, (out_hw[1], out_hw[0]),
                      interpolation=cv2.INTER_AREA)
    got = png.resize_area(img, out_hw)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
