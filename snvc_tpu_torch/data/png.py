"""Host image I/O without cv2, PIL or libpng: a PNG reader and writer
built on ``zlib`` and numpy, and the area downscale of
``cv2.resize(..., interpolation=cv2.INTER_AREA)``.

The JAX package reads and writes images through cv2 and a libpng loader
(snvc_tpu/data/kitti.py:89-146, data/native_loader.py); the card's machine
has neither.  ``decode_png`` gives what ``cv2.imread(path,
IMREAD_COLOR)`` followed by ``COLOR_BGR2RGB`` gives for every PNG of the
specification: colour types 0, 2, 3, 4 and 6 at each bit depth they
allow (1, 2, 4, 8, 16), ``PLTE`` and ``tRNS``, Adam7 interlacing, any of
the five row filters.  Grey is replicated, 16-bit samples keep their
high byte, grey below 8 bits is scaled to 0-255, palette indices are
looked up, alpha and ``tRNS`` are dropped.  A corrupt chunk, image data
of the wrong size, a bad filter byte or a header the specification does
not allow raises ``ValueError``.  The chunks are parsed and inflated
here; the pixels are reconstructed (each row a sequential loop) in the
native loader's library (``snvc_png_pixels`` of ``csrc/dataloader.cpp``,
built at first use by ``data/native_loader.py``), the one reconstruction
both readers share.  The loader decodes the same files without Python in
the pixel path; ``decode_png`` is its plain version.  The writer writes
8-bit RGB or RGBA.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Sequence, Tuple, Union

import numpy as np

from snvc_tpu_torch.data import native_loader

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# the largest side read (libpng's default limit, as csrc/dataloader.cpp)
MAX_SIDE = 1000000
# csrc/dataloader.cpp's Status codes of snvc_png_pixels
_FORMAT, _BAD_FILTER = 4, 6


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk, with its CRC checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def png_size(path: str) -> Tuple[int, int]:
    """(H, W) from the IHDR header, without decoding."""
    with open(path, "rb") as fh:
        head = fh.read(24)
    if head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def decode_png(path: str) -> np.ndarray:
    """RGB uint8 [H, W, 3] of a PNG (the module docstring)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    ihdr, plte, idat = None, b"", []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, color, comp, filt, interlace = ihdr
    lib = native_loader.library()
    want = lib.snvc_png_raw_bytes(w, h, depth, color, interlace)
    if want < 0 or comp != 0 or filt != 0:
        raise ValueError(
            f"{path}: {w} x {h} pixels, bit depth {depth}, colour type "
            f"{color}, compression {comp}, filter {filt}, interlace "
            f"{interlace}: not a PNG the specification allows (sides 1 to "
            f"{MAX_SIDE})")
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != want:
        raise ValueError(f"{path}: image data holds {len(raw)} bytes, "
                         f"{want} expected")
    out = np.empty((h, w, 3), np.uint8)
    bad = ctypes.c_int64(-1)
    rc = lib.snvc_png_pixels(raw, len(raw), w, h, depth, color, interlace,
                             plte, len(plte), out.ctypes.data,
                             ctypes.byref(bad))
    if rc == _BAD_FILTER:
        raise ValueError(f"{path}: a scanline has filter type "
                         f"{raw[bad.value]} (byte {bad.value} of the image "
                         "data)")
    if rc == _FORMAT:
        raise ValueError(f"{path}: a palette image without a PLTE chunk of "
                         f"1 to 256 entries ({len(plte)} bytes)")
    if rc:
        raise ValueError(f"{path}: {native_loader._MESSAGES.get(rc, rc)}")
    return out


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rgb: np.ndarray, filters: Sequence[int]) -> bytes:
    """The filtered scanlines of ``rgb`` [H, W, C] uint8, row r with
    filter type ``filters[r % len(filters)]`` (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth)."""
    h, w, c = rgb.shape
    x = rgb.reshape(h, w * c).astype(np.int32)
    left = np.zeros_like(x)
    left[:, c:] = x[:, :-c]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, c:] = x[:-1, :-c]
    pred = {0: np.zeros_like(x), 1: left, 2: up, 3: (left + up) >> 1,
            4: _paeth(left, up, upleft)}
    ft = np.array([filters[r % len(filters)] for r in range(h)], np.int64)
    if not np.isin(ft, list(pred)).all():
        raise ValueError(f"PNG filter types are 0-4, got {sorted(set(ft))}")
    out = np.empty((h, w * c + 1), np.uint8)
    out[:, 0] = ft
    for f, p in pred.items():
        rows = ft == f
        out[rows, 1:] = ((x[rows] - p[rows]) & 0xFF).astype(np.uint8)
    return out.tobytes()


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(path: str, rgb: np.ndarray,
               filters: Union[int, Sequence[int]] = 1) -> None:
    """Write ``rgb`` [H, W, 3] (or [H, W, 4]) uint8 as an 8-bit PNG, row r
    filtered with ``filters[r % len(filters)]`` (one int: every row)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] not in (3, 4):
        raise ValueError(f"encode_png takes uint8 [H, W, 3|4], got "
                         f"{rgb.dtype} {rgb.shape}")
    if isinstance(filters, int):
        filters = (filters,)
    h, w, c = rgb.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    idat = zlib.compress(_filter_rows(rgb, filters), 6)
    with open(path, "wb") as fh:
        fh.write(PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                 + _chunk(b"IDAT", idat) + _chunk(b"IEND", b""))


def _area_table(ssize: int, dsize: int) -> Tuple[np.ndarray, np.ndarray]:
    """Source index [dsize, m] and float32 weight [dsize, m] of each output
    cell along one axis, in the order of OpenCV's computeResizeAreaTab
    (unused slots weigh 0)."""
    scale = 1.0 / (dsize / ssize)
    cells = []
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        width = min(scale, ssize - f1)
        s2 = min(int(np.floor(f2)), ssize - 1)
        s1 = min(int(np.ceil(f1)), s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / width))
        taps += [(s, 1.0 / width) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), width) / width))
        cells.append(taps)
    m = max(len(t) for t in cells)
    idx = np.zeros((dsize, m), np.int64)
    wgt = np.zeros((dsize, m), np.float32)
    for d, taps in enumerate(cells):
        for j, (s, a) in enumerate(taps):
            idx[d, j], wgt[d, j] = s, np.float32(a)
    return idx, wgt


def resize_area(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Area downscale of uint8 ``img`` [H, W, C] to ``out_hw``: the
    arithmetic of OpenCV's ResizeArea_Invoker (float32 weights, each row's
    taps summed in order, then the rows'; rounded half to even), so it
    gives ``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)``."""
    H, W = img.shape[:2]
    oh, ow = out_hw
    if oh > H or ow > W:
        raise ValueError(f"resize_area downscales only: {(H, W)} -> {out_hw}")
    xi, xw = _area_table(W, ow)
    yi, yw = _area_table(H, oh)
    src = img.astype(np.float32)
    rows = np.zeros((H, ow) + img.shape[2:], np.float32)
    tail = (None,) * (img.ndim - 2)
    for j in range(xi.shape[1]):
        rows = rows + src[:, xi[:, j]] * xw[(None, slice(None), j) + tail]
    out = np.zeros((oh, ow) + img.shape[2:], np.float32)
    for j in range(yi.shape[1]):
        out = out + yw[(slice(None), j, None) + tail] * rows[yi[:, j]]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
