"""Build and load the hand-written CUDA kernels (``tramba_tpu_torch/csrc``).

The sources have a plain C interface and include no PyTorch header, so one
``nvcc`` call builds them in seconds into a shared library that ``ctypes``
loads.  The library goes to ``tramba_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that carries a hash of the sources, so an edited
source is rebuilt and an unchanged one is loaded as it is.  Nothing is built
when this module is imported: the first kernel launch builds.  A missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

__all__ = ["on_card", "check_f32", "library", "build", "launch", "stream_handle"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("ss2d.cu", "expand.cu")
HEADERS = ("common.cuh",)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
# C signature of each launcher: pointers, ints, then the stream
_SIGNATURES = {
    "ss2d_scan_launch": [_P] * 9 + [_I] * 5 + [_P],
    "ss2d_merge_launch": [_P] * 6 + [_I] * 6 + [_P],
    "expand_ln_launch": [_P] * 5 + [_I] * 5 + [_P],
    "final_head_launch": [_P] * 7 + [_L, _I, _P],
}


def on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor (the
    plain version runs); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain version for device {x.device}")


def check_f32(**tensors) -> None:
    """The kernels take contiguous, 16-byte aligned fp32 CUDA tensors."""
    for name, t in tensors.items():
        if not t.is_cuda or t.dtype != torch.float32:
            raise TypeError(f"{name}: expected a float32 CUDA tensor, got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {home}/bin); "
                           "the CUDA kernels cannot be built")
    return path


def _digest() -> str:
    h = hashlib.sha1()
    for name in HEADERS + SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels for sm_90a unless an up-to-date build exists;
    returns the library path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"libtramba_kernels_{_digest()}.so")
    if os.path.exists(out):
        return out
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-o", tmp]
    cmd += [os.path.join(CSRC, s) for s in SOURCES]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tramba_error_string.argtypes = [ctypes.c_int]
    lib.tramba_error_string.restype = ctypes.c_char_p
    return lib


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, *args) -> None:
    """Call a C launcher; raise if CUDA refused the launch."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: "
                           f"{lib.tramba_error_string(rc).decode()}")
