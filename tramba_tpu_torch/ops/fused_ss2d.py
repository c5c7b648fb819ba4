"""SS2D core: kernel K1 ``ss2d_scan`` and kernel K2 ``ss2d_merge``.

Port of the inference half of ``tramba_tpu/ops/fused_ss2d.py``.  There the
TPU runs each scan order through its own family of Pallas kernels (paired
directions, two-phase chunk carries, one-hot line gathers, a merge fold per
order).  Here every order is one gather table and one inverse table
(``ops/scan_orders.py``), so two CUDA kernels (``csrc/ss2d.cu``) serve all of
them:

* K1 ``ss2d_scan``: ys[b, k, t] = selective scan of x[b, idx[k, t]] with the
  per-direction Δ/B/C projections; fp32 state, d_state 1.
* K2 ``ss2d_merge``: sum of each pixel's direction outputs through the
  inverse table, LayerNorm, exact GELU, out projection.

Both run in fp32 or bf16, with the rounding points of ``_small_pallas``
(``fused_ss2d_small.py:150-228``): K1 takes a bf16 or fp32 ``x`` and always
projects, scans and writes ``ys`` in fp32 against the fp32 ``x_proj_weight``;
K2 takes fp32 ``ys`` and computes in the dtype of ``w_out``: with a bf16
``w_out`` the GELU output is rounded to bf16 before the out projection
(fp32 accumulation) and the result is bf16.

Beside each kernel is its plain PyTorch version (``*_ref``).  The wrappers
pick by the tensors' device: CPU tensors take the plain version, CUDA tensors
launch the kernel (a build or launch error raises).  Each wrapper counts its
launches in ``<wrapper>.launches``.  Weights are in torch.nn.Linear layout
(out_features, in_features).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tramba_tpu_torch.ops import _native
from tramba_tpu_torch.ops._native import F32, F32_BF16, check_args, on_card
from tramba_tpu_torch.ops.scan_orders import order_tables
from tramba_tpu_torch.ops.selective_scan import linear_scan

__all__ = ["ss2d_core_ref", "ss2d_scan", "ss2d_scan_ref", "ss2d_merge", "ss2d_merge_ref",
           "ss2d_full"]


def _check_table(name: str, t: torch.Tensor, shape: tuple) -> None:
    if not t.is_cuda or t.dtype != torch.int32 or not t.is_contiguous():
        raise TypeError(f"{name}: expected a contiguous int32 CUDA tensor")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


# ---------------------------------------------------------------------------
# plain versions (mirror composed_ss2d_core, fused_ss2d.py:38-57, and
# _ln_gelu_proj, :478)
# ---------------------------------------------------------------------------


def ss2d_core_ref(xs, x_proj_w, dt_w, dt_b, A_logs, Ds):
    """xs (B, K, L, D); x_proj_w (K, R+2, D); dt_w (K, D, R); dt_b (K, D);
    A_logs (K, D, 1); Ds (K, D).  Returns ys (B, K, L, D), fp32."""
    R = x_proj_w.shape[1] - 2
    xs = xs.float()
    dbc = torch.einsum("bkld,kcd->bklc", xs, x_proj_w.float())
    dts, Bc, Cc = torch.split(dbc, [R, 1, 1], dim=-1)
    dts = torch.einsum("bklr,kdr->bkld", dts, dt_w.float())
    delta = F.softplus(dts + dt_b.float()[None, :, None, :])
    A = -torch.exp(A_logs.float())[..., 0]
    a = torch.exp(delta * A[None, :, None, :])
    h = linear_scan(a, delta * xs * Bc)
    return h * Cc + xs * Ds.float()[None, :, None, :]


def ss2d_scan_ref(x, idx, x_proj_w, dt_w, dt_b, A_logs, Ds):
    """x (B, L, D); idx (K, L) int.  Returns ys (B, K, L, D)."""
    return ss2d_core_ref(x[:, idx.long()], x_proj_w, dt_w, dt_b, A_logs, Ds)


def ss2d_merge_ref(ys, inv, ln_w, ln_b, w_out):
    """ys (B, K, L, D) fp32; inv (K, M, L) int, slot value L = none; ln_w, ln_b
    (D) fp32; w_out (dm, D) fp32 or bf16.  Returns (B, L, dm) in w_out's
    dtype; with a bf16 w_out the GELU output is rounded to bf16 first."""
    B, K, L, D = ys.shape
    pad = torch.cat([ys, ys.new_zeros(B, K, 1, D)], dim=2)
    inv = inv.long()
    y = ys.new_zeros(B, L, D)
    for k in range(K):
        for m in range(inv.shape[1]):
            y = y + pad[:, k, inv[k, m]]
    y = F.gelu(F.layer_norm(y, (D,), ln_w, ln_b, 1e-5))
    cd = w_out.dtype
    return (y.to(cd).float() @ w_out.float().t()).to(cd)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def ss2d_scan(x, idx, x_proj_w, dt_w, dt_b, A_logs, Ds):
    """Kernel K1 on CUDA tensors, :func:`ss2d_scan_ref` on CPU tensors."""
    if not on_card(x):
        return ss2d_scan_ref(x, idx, x_proj_w, dt_w, dt_b, A_logs, Ds)
    B, L, D = x.shape
    K, C, _ = x_proj_w.shape
    R = C - 2
    check_args(x=(x, F32_BF16), x_proj_w=(x_proj_w, F32), dt_w=(dt_w, F32), dt_b=(dt_b, F32),
               A_logs=(A_logs, F32), Ds=(Ds, F32))
    _check_table("idx", idx, (K, L))
    if D % 32 or R > 64:
        raise ValueError(f"ss2d_scan: D={D} must be a multiple of 32 and R={R} at most 64")
    if (tuple(x_proj_w.shape) != (K, C, D) or tuple(dt_w.shape) != (K, D, R)
            or dt_b.numel() != K * D or A_logs.numel() != K * D or Ds.numel() != K * D):
        raise ValueError("ss2d_scan: parameter shapes do not match x and x_proj_w")
    dbc = torch.empty(B, L, K, C, device=x.device, dtype=torch.float32)
    ys = torch.empty(B, K, L, D, device=x.device, dtype=torch.float32)
    _native.launch("ss2d_scan_launch", x.data_ptr(), idx.data_ptr(), x_proj_w.data_ptr(),
                   dt_w.data_ptr(), dt_b.data_ptr(), A_logs.data_ptr(), Ds.data_ptr(),
                   dbc.data_ptr(), ys.data_ptr(), B, L, D, K, R, int(x.dtype == torch.bfloat16),
                   _native.stream_handle(x))
    ss2d_scan.launches += 1
    return ys


ss2d_scan.launches = 0


def ss2d_merge(ys, inv, ln_w, ln_b, w_out):
    """Kernel K2 on CUDA tensors, :func:`ss2d_merge_ref` on CPU tensors."""
    if not on_card(ys):
        return ss2d_merge_ref(ys, inv, ln_w, ln_b, w_out)
    B, K, L, D = ys.shape
    dm = w_out.shape[0]
    check_args(ys=(ys, F32), ln_w=(ln_w, F32), ln_b=(ln_b, F32), w_out=(w_out, F32_BF16))
    _check_table("inv", inv, (K, inv.shape[1], L))
    vec = 16 // w_out.element_size()  # one 16-byte load of w_out
    if D % vec or tuple(w_out.shape) != (dm, D) or ln_w.numel() != D or ln_b.numel() != D:
        raise ValueError(f"ss2d_merge: D must be a multiple of {vec} and w_out (dm, D)")
    out = torch.empty(B, L, dm, device=ys.device, dtype=w_out.dtype)
    _native.launch("ss2d_merge_launch", ys.data_ptr(), inv.data_ptr(), ln_w.data_ptr(),
                   ln_b.data_ptr(), w_out.data_ptr(), out.data_ptr(), B, K, inv.shape[1], L,
                   D, dm, int(w_out.dtype == torch.bfloat16), _native.stream_handle(ys))
    ss2d_merge.launches += 1
    return out


ss2d_merge.launches = 0


def ss2d_full(x_flat, x_proj_w, dt_w, dt_b, A_logs, Ds, ln_w, ln_b, w_out,
              kind: str, H: int, W: int, param: int = 0):
    """Scan -> merge -> LN -> GELU -> out projection of one SS2D:
    (B, L, D) -> (B, L, dm), over the scan order ``kind`` of an H x W map.
    The output takes ``w_out``'s dtype."""
    idx, inv = order_tables(kind, H, W, param, x_flat.device)
    ys = ss2d_scan(x_flat, idx, x_proj_w, dt_w, dt_b, A_logs, Ds)
    return ss2d_merge(ys, inv, ln_w, ln_b, w_out)
