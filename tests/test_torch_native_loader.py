"""The port's native batch image loader (snvc_tpu_torch/data/native_loader.py,
csrc/dataloader.cpp: zlib, no libpng) against the JAX package's
(snvc_tpu/data/native_loader.py, cpp/dataloader.cpp: libpng, built here
with g++) and against the port's plain reader ``data/png.py``.

* The same seeded images (37x53, 375x1242, 16x16; written by the port's
  PNG writer over all five row filters, as RGB and as RGBA, and by cv2)
  decode to the same bytes in the three readers, exactly: at their own
  size, zero-padded, cropped, and as one batch on several threads (also
  with empty slots).
* ``load_velodyne`` equals JAX's, truncation at ``max_points`` included.
* Every PNG of the specification (``chip_smoke.PNG_KINDS``: grey at 1,
  2, 4, 8 and 16 bits, 16-bit RGB, palette at 1, 2, 4 and 8 bits, grey +
  alpha and RGBA at 8 and 16 bits, ``tRNS`` on grey, RGB and palette
  images, Adam7 on a 3 x 2 image with empty passes and a 37 x 53 one;
  seeded samples whose RGB is known) decodes one at a time, zero-padded,
  and all kinds in one batch on 4 threads to cv2's pixels (JAX's
  ``KittiScene.load_image``) bit for bit, and to ``png.decode_png``'s.
  They equal JAX's libpng loader where it is right: on every kind but
  those with a ``tRNS`` chunk (``png_set_tRNS_to_alpha`` adds an alpha
  channel its colour-type test does not see, so it copies 4-byte pixels
  as 3-byte ones, cpp/dataloader.cpp:63-68) and the Adam7 ones (it never
  calls ``png_set_interlace_handling``, so it copies the passes' rows as
  the image's), where it gives other pixels.
* Where JAX returns None the port raises: a missing file
  (FileNotFoundError), PNGs the specification does not allow (a 16-bit
  palette, 3-bit grey, a palette image without PLTE, image data of the
  wrong size for Adam7's passes), a bad CRC, a bad filter byte, image
  data of the wrong size and headers with a zero side, a side over 1e6
  or more pixels than the data could inflate to (ValueError naming the
  path, no allocation), in a batch too; the files of the four kinds that
  were refused before (16-bit, palette, grey, interlaced) decode to
  cv2's pixels.
* ``KittiScene.load_image_padded`` / ``load_image_scaled``, the stereo
  pipeline's ``load_views_scaled`` and the Vernier pipeline's
  ``make_batch`` (both views of two frames in one
  batch decode, an empty frame slot) equal JAX's arrays on a small
  synthetic tree, and equal the one-view-at-a-time path of ``png.py``.
"""

import os
import struct
import zlib
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

from chip_smoke import PNG_KIND_SIZES, PNG_KINDS, write_png_kind
from snvc_tpu import config as jconfig
from snvc_tpu.data import instance_db as jdb
from snvc_tpu.data import native_loader as jloader
from snvc_tpu.data.kitti import KittiDataset as JDataset
from snvc_tpu.data.kitti import KittiScene as JScene
from snvc_tpu.data.pipeline import RefinementPipeline as JPipe
from snvc_tpu.data.synthetic import make_synthetic_kitti, write_predictions
from snvc_tpu_torch.data import instance_db as tdb
from snvc_tpu_torch.data import native_loader, png
from snvc_tpu_torch.data.kitti import KittiDataset, _place
from snvc_tpu_torch.data.pipeline import RefinementPipeline
from snvc_tpu_torch.data.stereo_pipeline import load_views_scaled
from tests.torch_port_helpers import torch_vernier_config

SIZES = ((37, 53), (375, 1242), (16, 16))


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """(path, RGB array) of each seeded image, written three ways."""
    d = tmp_path_factory.mktemp("loader")
    rng = np.random.default_rng(0)
    out = []
    for i, (h, w) in enumerate(SIZES):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        p = str(d / f"{i}_port.png")
        png.encode_png(p, img, (0, 1, 2, 3, 4))
        out.append((p, img))
        p = str(d / f"{i}_rgba.png")
        png.encode_png(p, np.concatenate([img, img[..., :1]], -1), (4, 3))
        out.append((p, img))
        p = str(d / f"{i}_cv2.png")
        assert cv2.imwrite(p, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        out.append((p, img))
    return out


def test_available():
    assert native_loader.available()
    assert jloader.available(), "JAX's loader did not build (libpng)"


@pytest.mark.parametrize("out_hw", [None, (400, 1280), (20, 20), (10, 2000)])
def test_decode_equals_jax_and_png_py(images, out_hw):
    for path, img in images:
        hw = img.shape[:2] if out_hw is None else out_hw
        got = native_loader.decode_png_padded(path, hw)
        assert got.shape == (*hw, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jloader.decode_png_padded(path, hw))
        np.testing.assert_array_equal(got, _place(png.decode_png(path), hw))
        np.testing.assert_array_equal(got, _place(img, hw))


@pytest.mark.parametrize("n_threads", [1, 3, 16])
def test_batch_equals_jax(images, n_threads):
    """Every image in one batch, then with empty (None) slots among them:
    those stay zero, the others equal JAX's batch of the same files."""
    paths = [p for p, _ in images]
    got = native_loader.decode_batch_padded(paths, (384, 1248), n_threads)
    want = jloader.decode_batch_padded(paths, (384, 1248), n_threads)
    assert got.shape == (len(paths), 384, 1248, 3)
    np.testing.assert_array_equal(got, want)
    holes = [paths[1], None, paths[3], None]
    got = native_loader.decode_batch_padded(holes, (40, 60), n_threads)
    assert got.shape == (4, 40, 60, 3)
    np.testing.assert_array_equal(got[[0, 2]], jloader.decode_batch_padded(
        [paths[1], paths[3]], (40, 60), n_threads))
    assert not got[[1, 3]].any()


def test_velodyne_equals_jax(tmp_path):
    pts = np.random.default_rng(1).standard_normal((1000, 4)).astype(
        np.float32)
    path = str(tmp_path / "v.bin")
    pts.tofile(path)
    for max_points in (200000, 1000, 17):
        got = native_loader.load_velodyne(path, max_points)
        np.testing.assert_array_equal(got, jloader.load_velodyne(
            path, max_points))
        np.testing.assert_array_equal(got, pts[:max_points])


def _write_raw(path, ihdr_fields, raw_rows):
    ihdr = struct.pack(">IIBBBBB", *ihdr_fields)
    with open(path, "wb") as fh:
        fh.write(png.PNG_SIGNATURE + png._chunk(b"IHDR", ihdr)
                 + png._chunk(b"IDAT", zlib.compress(raw_rows))
                 + png._chunk(b"IEND", b""))


def _bad_file(kind, d) -> str:
    path = os.path.join(d, f"{kind}.png")
    if kind == "16bit":  # a 16-bit palette
        _write_raw(path, (5, 4, 16, 3, 0, 0, 0), bytes(4 * 11))
    elif kind == "palette":  # no PLTE
        _write_raw(path, (5, 4, 8, 3, 0, 0, 0), bytes(4 * 6))
    elif kind == "grey":  # 3-bit grey
        _write_raw(path, (5, 4, 3, 0, 0, 0, 0), bytes(4 * 3))
    elif kind == "interlaced":  # the rows' size, not the passes'
        _write_raw(path, (5, 4, 8, 2, 0, 0, 1), bytes(4 * 16))
    elif kind == "filter":
        _write_raw(path, (2, 2, 8, 2, 0, 0, 0), bytes([0] + [9] * 6 + [7] * 7))
    elif kind == "long":
        _write_raw(path, (2, 2, 8, 2, 0, 0, 0), bytes(2 * 7 + 1))
    elif kind == "short":
        _write_raw(path, (2, 2, 8, 2, 0, 0, 0), bytes(2 * 7 - 1))
    elif kind == "zero":
        _write_raw(path, (0, 2, 8, 2, 0, 0, 0), bytes(2))
    elif kind == "wide":
        _write_raw(path, (2000000, 1, 8, 2, 0, 0, 0), bytes(6000001))
    elif kind == "huge":  # a valid header over 14 bytes of image data:
        # 3.6 TB if it were allocated
        _write_raw(path, (1000000, 1000000, 8, 6, 0, 0, 0), bytes(14))
    else:  # "crc": one payload byte of the IDAT flipped
        png.encode_png(path, np.zeros((3, 3, 3), np.uint8))
        data = bytearray(open(path, "rb").read())
        data[data.index(b"IDAT") + 4] ^= 0xFF
        open(path, "wb").write(bytes(data))
    return path


@pytest.mark.parametrize("kind", ["16bit", "palette", "grey", "interlaced",
                                  "crc", "filter", "long", "short", "zero",
                                  "wide", "huge"])
def test_unread_png_raises_with_its_path(kind, tmp_path, images):
    path = _bad_file(kind, str(tmp_path))
    with pytest.raises(ValueError, match=path):
        native_loader.decode_png_padded(path, (8, 8))
    with pytest.raises(ValueError, match=path):
        native_loader.decode_batch_padded([images[0][0], path], (8, 8), 2)
    with pytest.raises(ValueError):
        png.decode_png(path)
    if kind in REFUSED_BEFORE:  # a valid file of the kind now decodes
        good = os.path.join(str(tmp_path), f"good_{kind}.png")
        REFUSED_BEFORE[kind](good)
        np.testing.assert_array_equal(
            native_loader.decode_png_padded(good, (4, 5)), _cv2_rgb(good))


def _cv2_rgb(path):
    """JAX's ``KittiScene.load_image`` of ``path`` (cv2.imread,
    IMREAD_COLOR | IMREAD_IGNORE_ORIENTATION, BGR -> RGB)."""
    return JScene.load_image(SimpleNamespace(left_image_path=path), "left")


# the kinds the loader refused before, each with a writer of a valid file
REFUSED_BEFORE = {
    "16bit": lambda p: cv2.imwrite(p, np.random.default_rng(1).integers(
        0, 65536, (4, 5, 3)).astype(np.uint16)),
    "palette": lambda p: write_png_kind(p, "palette8", (4, 5),
                                        np.random.default_rng(2)),
    "grey": lambda p: cv2.imwrite(p, np.random.default_rng(3).integers(
        0, 256, (4, 5), np.uint8)),
    "interlaced": lambda p: write_png_kind(p, "rgb8_adam7", (4, 5),
                                           np.random.default_rng(4)),
}
# the kinds JAX's libpng loader decodes to other pixels (module docstring)
JAX_WRONG = {k for k, (_, _, trns, adam7) in PNG_KINDS.items()
             if trns or adam7}


@pytest.fixture(scope="module")
def kinds(tmp_path_factory):
    """kind -> [(path, RGB)] of each size."""
    d = tmp_path_factory.mktemp("kinds")
    out = {}
    for i, kind in enumerate(PNG_KINDS):
        rng = np.random.default_rng(100 + i)
        out[kind] = [(str(d / f"{kind}_{hw[0]}.png"), None)
                     for hw in PNG_KIND_SIZES]
        out[kind] = [(p, write_png_kind(p, kind, hw, rng))
                     for (p, _), hw in zip(out[kind], PNG_KIND_SIZES)]
    return out


@pytest.mark.parametrize("kind", list(PNG_KINDS))
def test_every_png_kind_decodes_to_cv2s_pixels(kinds, kind):
    for path, rgb in kinds[kind]:
        hw = rgb.shape[:2]
        np.testing.assert_array_equal(_cv2_rgb(path), rgb, err_msg=path)
        for out_hw in (hw, (40, 60), (2, 1)):
            got = native_loader.decode_png_padded(path, out_hw)
            np.testing.assert_array_equal(got, _place(rgb, out_hw))
        np.testing.assert_array_equal(png.decode_png(path), rgb)
        jax = jloader.decode_png_padded(path, hw)
        assert np.array_equal(jax, rgb) != (kind in JAX_WRONG), path


def test_every_png_kind_in_one_batch(kinds):
    items = [item for kind in PNG_KINDS for item in kinds[kind]]
    got = native_loader.decode_batch_padded([p for p, _ in items], (40, 60),
                                            4)
    for g, (_, rgb) in zip(got, items):
        np.testing.assert_array_equal(g, _place(rgb, (40, 60)))


def test_missing_file_raises(tmp_path, images):
    missing = str(tmp_path / "missing.png")
    assert jloader.decode_png_padded(missing, (8, 8)) is None
    with pytest.raises(FileNotFoundError, match=missing):
        native_loader.decode_png_padded(missing, (8, 8))
    with pytest.raises(FileNotFoundError, match=missing):
        native_loader.decode_batch_padded([images[0][0], missing], (8, 8))
    with pytest.raises(FileNotFoundError):
        native_loader.load_velodyne(str(tmp_path / "missing.bin"))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loader_tree"))
    boxes = make_synthetic_kitti(root, num_frames=3, boxes_per_frame=2,
                                 seed=9)
    pred_dir = os.path.join(root, "proposals")
    write_predictions(pred_dir, boxes, noise=0.2)
    return root, pred_dir


def test_scene_images_equal_jax(tree):
    root, _ = tree
    for js, ts in zip(JDataset(root, "val").scenes(),
                      KittiDataset(root, "val").scenes()):
        for cam in ("left", "right"):
            path = ts.image_path(cam)
            for hw in ((384, 1248), (300, 1000)):
                got = ts.load_image_padded(cam, hw)
                np.testing.assert_array_equal(got,
                                              js.load_image_padded(cam, hw))
                np.testing.assert_array_equal(
                    got, _place(png.decode_png(path), hw))
            for hw in ((96, 320), (384, 1248)):
                (ti, tsc), (ji, jsc) = (ts.load_image_scaled(cam, hw),
                                        js.load_image_scaled(cam, hw))
                assert tsc == jsc
                np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("out_hw", [(384, 1248), (375, 1242), (374, 1242),
                                    (96, 320)])
def test_views_scaled_equal_jax(tree, out_hw):
    """The stereo pipeline's ``load_views_scaled`` (one batch decode for
    the views that fit, ``load_image_scaled`` for the others) gives JAX's
    ``load_image_scaled`` of each view, at canvases that fit the 375x1242
    views exactly, by a row too few and by a downscale."""
    root, _ = tree
    jscenes = JDataset(root, "val").scenes()
    tscenes = KittiDataset(root, "val").scenes()
    views = [(sc, cam) for cam in ("left", "right") for sc in tscenes]
    got = load_views_scaled(views, out_hw)
    assert len(got) == 2 * len(jscenes)
    for (img, s), (sc, cam) in zip(got, views):
        want, ws = jscenes[tscenes.index(sc)].load_image_scaled(cam, out_hw)
        assert s == ws
        np.testing.assert_array_equal(img, want)


def test_make_batch_equals_jax_and_the_view_path(tree):
    """Two frames a batch: 3 frames give a batch with an empty slot."""
    root, pred_dir = tree
    jc = jconfig.tiny_vernier_config(max_instances=4, image_size=(384, 1248),
                                     frames_per_batch=2)
    tc = torch_vernier_config(jc)
    want = JPipe(jdb.build_db_from_predictions(JDataset(root, "val"), jc,
                                               pred_dir),
                 jc, training=False, load_lidar=True, max_points=256)
    got = RefinementPipeline(
        tdb.build_db_from_predictions(KittiDataset(root, "val"), tc,
                                      pred_dir),
        tc, training=False, load_lidar=True, max_points=256)
    gb, wb = list(got.batches()), list(want.batches())
    assert len(gb) == len(wb) == 2
    frames = 0
    for g, w in zip(gb, wb):
        for k, v in w.arrays().items():
            np.testing.assert_array_equal(g.arrays()[k], v, err_msg=k)
        names = sorted({n for n in g.scene_names if n})
        frames += len(names)
        for view, imgs in (("image_2", g.images_left),
                           ("image_3", g.images_right)):
            for fi, name in enumerate(names):
                np.testing.assert_array_equal(imgs[fi], _place(
                    png.decode_png(os.path.join(root, "training", view,
                                                name + ".png")),
                    (384, 1248)))
            assert (imgs[len(names):] == 0).all()
    assert frames == 3
