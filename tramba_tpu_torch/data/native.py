"""ctypes bindings for the host-side C++ preprocessing library.

The port's own copy of ``tramba_tpu/data/native.py``, over its own copy of
the C++ source (``tramba_tpu_torch/native/preprocess.cpp``): a bilinear
resize byte-equal to ``PIL.Image.resize(..., BILINEAR)``, a nearest resize
byte-equal to PIL's ``NEAREST`` (index tables taken from PIL itself), and a
threaded eval-batch preprocessor (resize + ImageNet normalisation).

Nothing is built when this module is imported: the first call builds the
library with ``g++ -O3 -march=native`` into ``tramba_tpu_torch/_build/``
(listed in ``.gitignore``) under a name that carries a hash of the source,
the flags and the host CPU's features, so an edited source, or a copy on
another host, is rebuilt and an unchanged one is loaded as it is.
Concurrent first uses, from threads or processes, take a lock on the build
directory; the compiler writes to a temporary name that is renamed into
place, so no caller ever loads a half-written library.  A missing compiler
or a failed build raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from typing import Sequence, Tuple

import numpy as np

__all__ = ["SOURCE", "BUILD_DIR", "CXX", "build", "library", "available", "resize_bilinear",
           "resize_nearest", "preprocess_eval_batch"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "preprocess.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_U8 = ctypes.POINTER(ctypes.c_uint8)
_F32 = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I = ctypes.c_int
_SIGNATURES = {
    "resize_bilinear_u8": [_U8, _I, _I, _I, _U8, _I, _I],
    "resize_nearest_u8": [_U8, _I, _I, _I, _U8, _I, _I],
    "normalize_f32": [_U8, _I, _I, _F32, _F32, _F32],
    "preprocess_eval_batch": [_U8, _I64, _I32, _I32, _U8, _I64, _I, _I, _F32, _F32, _F32, _F32,
                              _I],
}


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: ``-march=native`` builds for them, so a
    build directory copied to another host is not loaded there."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return platform.processor().encode()


@functools.lru_cache(maxsize=None)
def _digest(source: str) -> str:
    h = hashlib.sha1(" ".join(_FLAGS).encode() + b"\0" + _cpu_flags() + b"\0")
    with open(source, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile ``preprocess.cpp`` into ``BUILD_DIR`` unless an up-to-date
    build is there; returns the library's path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"libtramba_preprocess_{_digest(SOURCE)}.so")
    if os.path.exists(out):
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found: the C++ preprocessing library cannot be built")
    lock = os.open(BUILD_DIR, os.O_RDONLY)
    try:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one build at a time, across processes
        if os.path.exists(out):  # another caller built it while this one waited
            return out
        fd, tmp = tempfile.mkstemp(prefix=".preprocess_", suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run([cxx, *_FLAGS, "-o", tmp, SOURCE, "-lpthread"],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"{CXX} failed ({res.returncode}) on {SOURCE}:\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    finally:
        os.close(lock)  # releases the lock
    return out


@functools.lru_cache(maxsize=None)
def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    return _load(build())


def available() -> bool:
    """True once the library is built and loaded (the JAX module's API); a
    missing compiler or a failed build raises."""
    library()
    return True


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _check_u8(img: np.ndarray, ndims: Tuple[int, ...], what: str) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in ndims or 0 in img.shape:
        dims = " or ".join(map(str, ndims))
        raise ValueError(f"{what}: expected a non-empty uint8 array of {dims} dims, got "
                         f"{img.dtype} {img.shape}")
    return np.ascontiguousarray(img)


def _check_size(size: int) -> int:
    if int(size) < 1:
        raise ValueError(f"size must be positive, got {size}")
    return int(size)


def resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, C) or (H, W) uint8 -> (size, size, ...) uint8, byte-equal to
    PIL's BILINEAR resize."""
    lib, size = library(), _check_size(size)
    img = _check_u8(img, (2, 3), "resize_bilinear")
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    out = np.empty((size, size, c), np.uint8)
    lib.resize_bilinear_u8(_ptr(img, _U8), h, w, c, _ptr(out, _U8), size, size)
    return out[..., 0] if squeeze else out


@functools.lru_cache(maxsize=None)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """PIL's NEAREST source index for each output position.

    PIL's mapping has float-accumulation quirks that defy a closed form, so
    the table is taken from PIL itself on a one-pixel strip of indices
    (two strips, low and high bytes, past 255)."""
    from PIL import Image

    def strip(values):
        a = Image.fromarray(values.astype(np.uint8)[None, :], "L")
        return np.asarray(a.resize((out_size, 1), Image.NEAREST))[0].astype(np.int64)

    idx = np.arange(in_size)
    if in_size <= 255:
        return strip(idx)
    return (strip(idx >> 8) << 8) | strip(idx & 0xFF)


def resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, ...) -> (size, size, ...), byte-equal to PIL's NEAREST resize:
    cached index tables and one gather."""
    size = _check_size(size)
    h, w = img.shape[:2]
    return img[_nearest_index(h, size)][:, _nearest_index(w, size)]


def preprocess_eval_batch(images: Sequence[np.ndarray], masks: Sequence[np.ndarray], size: int,
                          mean, std, num_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """(H_i, W_i, 3) uint8 images and (H_i, W_i) uint8 masks -> the
    normalised (N, size, size, 3) float32 batch (bilinear resize, /255,
    ImageNet ``mean`` / ``std``) and (N, size, size, 1) float32 masks in [0,
    1] (nearest resize), over ``num_threads`` threads."""
    lib, size = library(), _check_size(size)
    n = len(images)
    if n == 0 or len(masks) != n:
        raise ValueError(f"{n} images and {len(masks)} masks: expected as many, at least one")
    images = [_check_u8(im, (3,), "preprocess_eval_batch image") for im in images]
    masks = [_check_u8(m, (2,), "preprocess_eval_batch mask") for m in masks]
    for im, m in zip(images, masks):
        if im.shape[2] != 3 or m.shape != im.shape[:2]:
            raise ValueError(f"image {im.shape} and mask {m.shape}: expected (H, W, 3) and (H, W)")
    img_flat = np.concatenate([im.reshape(-1) for im in images])
    mask_flat = np.concatenate([m.reshape(-1) for m in masks])
    img_off = np.concatenate([[0], np.cumsum([im.size for im in images[:-1]])]).astype(np.int64)
    mask_off = np.concatenate([[0], np.cumsum([m.size for m in masks[:-1]])]).astype(np.int64)
    hs = np.asarray([im.shape[0] for im in images], np.int32)
    ws = np.asarray([im.shape[1] for im in images], np.int32)
    out_img = np.empty((n, size, size, 3), np.float32)
    out_mask = np.empty((n, size, size, 1), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.shape != (3,) or std.shape != (3,):
        raise ValueError(f"mean {mean.shape} and std {std.shape}: expected 3 values each")
    lib.preprocess_eval_batch(_ptr(img_flat, _U8), _ptr(img_off, _I64), _ptr(hs, _I32),
                              _ptr(ws, _I32), _ptr(mask_flat, _U8), _ptr(mask_off, _I64), n,
                              size, _ptr(mean, _F32), _ptr(std, _F32), _ptr(out_img, _F32),
                              _ptr(out_mask, _F32), int(num_threads))
    # the masks again through PIL's exact nearest tables (the C++ nearest
    # samples at floor((i + 0.5) * scale), which PIL does not always)
    for i, m in enumerate(masks):
        out_mask[i, :, :, 0] = resize_nearest(m, size).astype(np.float32) / 255.0
    return out_img, out_mask
