"""The native batch image loader (port of snvc_tpu/data/native_loader.py):
ctypes bindings of ``csrc/dataloader.cpp``.

The library decodes PNGs (zlib inflate, the five row filters and
Adam7, no libpng) straight into zero-padded uint8 batch buffers, a batch
spread over a pool of threads, and reads velodyne files in bulk.  It is
built with the host compiler into ``build/snvc_tpu_torch/`` at first use
(``_build.build_host``, linked with ``-lz -lpthread``).

It reads what ``data/png.py`` reads, with the same pixel reconstruction
(``snvc_png_pixels``): every colour type, bit depth, palette, ``tRNS``
and Adam7 case of the PNG specification, into the 8-bit RGB that
``cv2.imread(IMREAD_COLOR)`` gives; each chunk's CRC is checked.  Where
JAX's libpng loader differs (it copies Adam7 passes as rows and
4-byte pixels as 3-byte ones after a ``tRNS`` chunk), the port follows
cv2, which gives the image's true pixels.  Where the JAX
package returns ``None`` (a missing file, a PNG it cannot read, a build
that failed) these functions raise: ``FileNotFoundError`` for a file
that does not open, ``ValueError`` naming the path for a PNG that is not
read, ``RuntimeError`` with the compiler's output for a failed build.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from snvc_tpu_torch import _build

SOURCE = _build.CSRC / "dataloader.cpp"
LIBS = ("-lz", "-lpthread")

# return codes of csrc/dataloader.cpp (its Status)
_NO_FILE = 1
_MESSAGES = {
    2: "not a PNG file",
    3: "corrupt chunk (length, CRC or no IEND)",
    4: "not a PNG the decoder takes: a colour type / bit depth the PNG "
       "specification does not allow, a palette image without a valid "
       "PLTE, an unknown compression, filter or interlace method, or a "
       "side of 0 or over 1e6 pixels",
    5: "the image data does not inflate to the image's size",
    6: "a row's filter type is not 0-4",
    7: "no IHDR or IDAT chunk",
    8: "the file does not read to its end",
    9: "the image's buffers could not be allocated",
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_cache: Dict[str, ctypes.CDLL] = {}


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed, its entry points'
    argtypes and restypes declared."""
    lib = _cache.get("lib")
    if lib is None:
        lib = ctypes.CDLL(str(_build.build_host(SOURCE, shared=True,
                                                libs=LIBS)))
        lib.snvc_png_raw_bytes.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                           _I, _I, _I]
        lib.snvc_png_raw_bytes.restype = ctypes.c_int64
        lib.snvc_png_pixels.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32,
            ctypes.c_uint32, _I, _I, _I, ctypes.c_char_p, _I, _P,
            ctypes.POINTER(ctypes.c_int64)]
        lib.snvc_png_pixels.restype = _I
        lib.snvc_decode_png_rgb.argtypes = [ctypes.c_char_p, _P, _I, _I]
        lib.snvc_decode_png_rgb.restype = _I
        lib.snvc_decode_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), _I,
                                          _P, _I, _I, _I, _P]
        lib.snvc_decode_batch.restype = _I
        lib.snvc_load_velodyne.argtypes = [ctypes.c_char_p, _P,
                                           ctypes.c_long]
        lib.snvc_load_velodyne.restype = ctypes.c_long
        _cache["lib"] = lib
    return lib


def available() -> bool:
    """Builds and loads the library: True, or raises RuntimeError with the
    compiler's output."""
    library()
    return True


def _raise(path: str, rc: int) -> None:
    if rc == _NO_FILE:
        raise FileNotFoundError(path)
    raise ValueError(f"{path}: {_MESSAGES.get(rc, f'error {rc}')}")


def _hw(out_hw) -> Tuple[int, int]:
    H, W = (int(v) for v in out_hw)
    if H <= 0 or W <= 0:
        raise ValueError(f"out_hw must be positive, got {tuple(out_hw)}")
    return H, W


def decode_png_padded(path: str, out_hw) -> np.ndarray:
    """Decode one PNG into a zero-padded (and cropped) [H, W, 3] uint8
    array, ``out_hw`` = (H, W)."""
    H, W = _hw(out_hw)
    buf = np.empty((H, W, 3), np.uint8)
    rc = library().snvc_decode_png_rgb(str(path).encode(), buf.ctypes.data,
                                       H, W)
    if rc:
        _raise(path, rc)
    return buf


def decode_batch_padded(paths: Sequence[Optional[str]], out_hw,
                        n_threads: int = 4) -> np.ndarray:
    """Decode a batch of PNGs on ``n_threads`` threads into [N, H, W, 3]
    uint8, image i zero-padded in slot i; a ``None`` path leaves its slot
    zero.  Raises for the first image that does not decode."""
    H, W = _hw(out_hw)
    n = len(paths)
    out = np.zeros((n, H, W, 3), np.uint8)
    if n == 0:
        return out
    arr = (ctypes.c_char_p * n)(*[None if p is None else str(p).encode()
                                  for p in paths])
    rcs = np.zeros(n, np.int32)
    if library().snvc_decode_batch(arr, n, out.ctypes.data, H, W,
                                   max(int(n_threads), 1), rcs.ctypes.data):
        i = int(np.flatnonzero(rcs)[0])
        _raise(paths[i], int(rcs[i]))
    return out


def load_velodyne(path: str, max_points: int = 200000) -> np.ndarray:
    """Read a velodyne .bin into [N, 4] float32, at most ``max_points``
    points (the rest of the file is not read)."""
    buf = np.empty(max_points * 4, np.float32)
    got = library().snvc_load_velodyne(str(path).encode(), buf.ctypes.data,
                                       buf.size)
    if got < 0:
        raise FileNotFoundError(path)
    return buf[:got].reshape(-1, 4).copy()
