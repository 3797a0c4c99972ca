"""ctypes bindings for the native threaded dataloader.

The shared library is built from ``dataloader.cpp`` at first use
(``make -C plslam_tpu/native libplslam_native.so``, about two seconds).
Where it cannot be built (no compiler or no libpng), ``available()`` is
False and io/euroc.py remains the pure-Python path.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(__file__)
_LIB_PATH = os.path.join(_DIR, "libplslam_native.so")
_lib = None


def _build() -> bool:
    """Build the library from source once; a file lock keeps concurrent
    processes (test workers) from racing on the same output file."""
    with open(os.path.join(_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(_LIB_PATH):
            r = subprocess.run(["make", "-C", _DIR, "libplslam_native.so"],
                               capture_output=True)
            if r.returncode != 0:
                return False
    return os.path.exists(_LIB_PATH)


def available() -> bool:
    return _load() is not None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int,
    ]
    lib.loader_get.restype = ctypes.c_int
    lib.loader_get.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_float),
                               ctypes.POINTER(ctypes.c_float)]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.decode_png_gray.restype = ctypes.c_int
    lib.decode_png_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.remap_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
    _lib = lib
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeStereoLoader:
    """Threaded prefetching loader over two sorted PNG file lists, with
    optional rectification maps (float32 HxW each)."""

    def __init__(self, files_l, files_r, width, height,
                 maps=None, n_threads=4, queue_cap=8):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "native loader could not be built; run "
                "make -C plslam_tpu/native to see why")
        self._lib = lib
        self.width, self.height = width, height
        self.n = len(files_l)
        arr_l = (ctypes.c_char_p * self.n)(
            *[f.encode() for f in files_l])
        arr_r = (ctypes.c_char_p * self.n)(
            *[f.encode() for f in files_r])
        if maps is not None:
            (mlx, mly), (mrx, mry) = maps
            self._maps = [np.ascontiguousarray(m, np.float32)
                          for m in (mlx, mly, mrx, mry)]
            ptrs = [_fptr(m) for m in self._maps]
        else:
            self._maps = None
            ptrs = [None] * 4
        self._handle = lib.loader_create(
            arr_l, arr_r, self.n, width, height, *ptrs,
            n_threads, queue_cap)

    def __len__(self):
        return self.n

    def get(self, index: int):
        out_l = np.empty((self.height, self.width), np.float32)
        out_r = np.empty((self.height, self.width), np.float32)
        ok = self._lib.loader_get(self._handle, index, _fptr(out_l), _fptr(out_r))
        if not ok:
            raise IOError(f"native loader failed on frame {index}")
        return out_l, out_r

    def close(self):
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def decode_png(path: str) -> np.ndarray:
    lib = _load()
    assert lib is not None
    buf = np.empty(4096 * 4096, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    ok = lib.decode_png_gray(path.encode(), _fptr(buf), buf.size,
                             ctypes.byref(w), ctypes.byref(h))
    if not ok:
        raise IOError(f"failed to decode {path}")
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


def remap(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(img, np.float32)
    map_x = np.ascontiguousarray(map_x, np.float32)
    map_y = np.ascontiguousarray(map_y, np.float32)
    out = np.empty_like(map_x)
    lib.remap_f32(_fptr(img), img.shape[1], img.shape[0], _fptr(map_x),
                  _fptr(map_y), map_x.shape[1], map_x.shape[0], _fptr(out))
    return out
