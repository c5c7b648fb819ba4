"""Build and load the hand-written CUDA kernels (``tramba_tpu_torch/csrc``).

The sources have a plain C interface and include no PyTorch header, so
``nvcc`` builds them in seconds (one process per source, in parallel, then
one link) into a shared library that ``ctypes`` loads.  The library goes to ``tramba_tpu_torch/_build/`` (listed in
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

__all__ = ["on_card", "check_args", "needs_grad", "recompute_vjp", "F32", "BF16", "F32_BF16",
           "library", "build", "launch", "native_launch_count", "stream_handle"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("ss2d.cu", "ss2d_bwd.cu", "expand.cu", "prologue.cu", "mlp.cu", "mlp_bwd.cu",
           "attn.cu", "scan.cu")
HEADERS = ("common.cuh",)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_LP = ctypes.POINTER(ctypes.c_long)
# C signature of each launcher: pointers, ints, then the stream
_SIGNATURES = {
    "ss2d_scan_launch": [_P] * 11 + [_I] * 6 + [_P],
    "ss2d_scan_segment_steps": [_I] * 5,
    "ss2d_merge_launch": [_P] * 7 + [_I] * 7 + [_P],
    "ss2d_scan_chunk": [],
    "ss2d_scan_bwd_rows": [],
    "ss2d_scan_bwd_launch": [_P] * 23 + [_I] * 7 + [_P],
    "expand_ln_launch": [_P] * 5 + [_I] * 6 + [_P],
    "final_head_launch": [_P] * 7 + [_L, _I, _I, _P],
    "layer_norm_bf16_launch": [_P] * 4 + [_L, _I, _F, _P],
    "prologue_launch": [_P] * 6 + [_I] * 5 + [_P],
    "prologue_plan": [_I] * 5 + [_IP],
    "ln_mlp_splits": [_L, _I, _I, _IP],
    "ln_mlp_launch": [_P] * 9 + [_L, _I, _I, _I, _P],
    "ln_dwms_mlp_splits": [_I] * 5 + [_IP],
    "ln_dwms_mlp_launch": [_P] * 16 + [_I] * 6 + [_P],
    "ln_dwmlp_splits": [_I] * 5 + [_IP],
    "ln_dwmlp_launch": [_P] * 9 + [_I] * 6 + [_P],
    "mlp_bwd_scratch": [_I] * 6 + [_LP],
    "mlp_bwd_column_groups": [_I] * 3,
    "ln_mlp_bwd_launch": [_P] * 15 + [_I] * 3 + [_P],
    "ln_dwms_mlp_bwd_launch": [_P] * 27 + [_I] * 5 + [_P],
    "attn_proj_in_launch": [_P] * 4 + [_L, _I, _I, _I, _F, _P],
    "sra_attn_launch": [_P] * 6 + [_I] * 6 + [_P],
    "window_attn_launch": [_P] * 6 + [_I] * 6 + [_P],
    "linear_scan_launch": [_P] * 3 + [_I] * 4 + [_P],
}

# dtypes a kernel argument may take (see check_args)
F32 = (torch.float32,)
BF16 = (torch.bfloat16,)
F32_BF16 = (torch.float32, torch.bfloat16)


def on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor (the
    plain version runs); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain version for device {x.device}")


def check_args(**args) -> None:
    """Each keyword is ``(tensor, dtypes)``: the kernel takes the tensor as a
    contiguous, 32-byte aligned CUDA tensor of one of ``dtypes`` (``F32``,
    ``BF16`` or ``F32_BF16``); anything else raises."""
    for name, (t, dtypes) in args.items():
        if not t.is_cuda or t.dtype not in dtypes:
            want = " or ".join(str(d).replace("torch.", "") for d in dtypes)
            raise TypeError(f"{name}: expected a {want} CUDA tensor, got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{name}: must be contiguous and 32-byte aligned")


def needs_grad(*tensors) -> bool:
    """True when autograd records: grad mode is on and a tensor requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def recompute_vjp(fn, inputs, needs, grad_out):
    """The VJP of ``fn(*inputs)`` for ``grad_out``, by recomputing ``fn`` with
    autograd on detached inputs: the backward of a kernel whose TPU original
    differentiates its composed (XLA) version.  ``needs``: which inputs want
    a gradient (``ctx.needs_input_grad``); the others get None, as do
    inputs that are None."""
    with torch.enable_grad():
        xs = [None if t is None else t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        out = fn(*xs)
        wrt = [t for t, n in zip(xs, needs) if n]
        grads = iter(torch.autograd.grad(out, wrt, grad_out) if wrt else ())
    return tuple(next(grads) if n else None for n in needs)


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
    returns the library path.  One ``nvcc`` per source, all started
    together, then one link."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"libtramba_kernels_{_digest()}.so")
    if os.path.exists(out):
        return out
    nvcc = _nvcc()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-lineinfo",
             "-Xcompiler", "-fPIC"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.replace(".cu", ".o")) for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *flags, "-c", os.path.join(CSRC, src), "-o", obj],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(src, p.returncode, log) for src, p, log in zip(SOURCES, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(f"{src} ({rc}):\n{log}"
                                                            for src, rc, log in failed))
        lib = os.path.join(tmp, "lib.so")
        res = subprocess.run([nvcc, "-shared", "-o", lib, *objs], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        os.replace(lib, out)
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
    lib.tramba_native_launches.argtypes = []
    lib.tramba_native_launches.restype = ctypes.c_long
    return lib


def native_launch_count() -> int:
    """Kernels the built library has launched so far (every launch site of
    ``csrc/`` counts one): the difference over a wrapper call is the number
    of kernels that call launched."""
    return library().tramba_native_launches()


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, *args) -> None:
    """Call a C launcher; raise if CUDA refused the launch."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: "
                           f"{lib.tramba_error_string(rc).decode()}")
