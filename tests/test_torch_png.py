"""The port's PNG reader / writer and area downscale
(snvc_tpu_torch/data/png.py) against cv2, which the JAX package reads and
writes images with (snvc_tpu/data/kitti.py:89-146, data/synthetic.py).

* ``decode_png`` equals ``cv2.imread(IMREAD_COLOR)`` + BGR->RGB bit for bit
  on the frames the JAX renderer wrote, and on the same frames re-written
  by cv2 with each of libpng's row filters and with adaptive filtering;
  the filter bytes of those files cover all five types.
* ``encode_png`` -> ``decode_png`` gives the array back for each filter;
  cv2 reads the port's files the same.
* RGBA drops alpha, as ``IMREAD_COLOR`` does.  Every other PNG of the
  specification decodes to cv2's pixels bit for bit (JAX's
  ``KittiScene.load_image``): grey at 1, 2, 4, 8 and 16 bits, 16-bit RGB,
  palette at 1, 2, 4 and 8 bits, grey + alpha and RGBA at 8 and 16 bits,
  ``tRNS`` on grey, RGB and palette images, Adam7 (a 3 x 2 image with
  empty passes and a 37 x 53 one), each written by
  ``chip_smoke.write_png_kind`` from seeded samples whose RGB it knows,
  with seeded row filters, the image data in two IDAT chunks.  What the
  specification does not allow still raises ``ValueError``: a 16-bit
  palette, 3-bit grey, a palette image without PLTE, image data of the
  wrong size for its passes, interlace method 2, a bad filter byte, a
  bad CRC.
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

from chip_smoke import PNG_KIND_SIZES, PNG_KINDS, write_png_kind
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


@pytest.mark.parametrize("kind", list(PNG_KINDS))
def test_decodes_every_png_kind(kind, tmp_path):
    rng = np.random.default_rng(sorted(PNG_KINDS).index(kind))
    for hw in PNG_KIND_SIZES:
        path = str(tmp_path / f"{kind}_{hw[0]}.png")
        want = write_png_kind(path, kind, hw, rng)
        np.testing.assert_array_equal(_cv2_rgb(path), want, err_msg=path)
        np.testing.assert_array_equal(png.decode_png(path), want,
                                      err_msg=path)


@pytest.mark.parametrize("kind", ["16bit", "palette", "grey", "interlaced"])
def test_refuses_other_formats(kind, tmp_path):
    """Each kind that was refused decodes to cv2's pixels; a file of that
    kind that the PNG specification does not allow raises."""
    path = str(tmp_path / f"{kind}.png")
    bad = str(tmp_path / f"bad_{kind}.png")
    rng = np.random.default_rng(5)
    if kind == "16bit":
        img = rng.integers(0, 65536, (4, 5, 3)).astype(np.uint16)
        assert cv2.imwrite(path, img)
        _write_raw(bad, (5, 4, 16, 3, 0, 0, 0), bytes(4 * 11))
    elif kind == "palette":
        write_png_kind(path, "palette8", (4, 5), rng)
        _write_raw(bad, (5, 4, 8, 3, 0, 0, 0), bytes(4 * 6))  # no PLTE
    elif kind == "grey":
        assert cv2.imwrite(path, rng.integers(0, 256, (4, 5), np.uint8))
        _write_raw(bad, (5, 4, 3, 0, 0, 0, 0), bytes(4 * 3))
    else:
        write_png_kind(path, "rgb8_adam7", (4, 5), rng)
        # image data of the rows' size, not the passes'
        _write_raw(bad, (5, 4, 8, 2, 0, 0, 1), bytes(4 * 16))
        unknown = str(tmp_path / "interlace2.png")
        _write_raw(unknown, (5, 4, 8, 2, 0, 0, 2), bytes(4 * 16))
        with pytest.raises(ValueError):
            png.decode_png(unknown)
    np.testing.assert_array_equal(png.decode_png(path), _cv2_rgb(path))
    with pytest.raises(ValueError):
        png.decode_png(bad)


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
