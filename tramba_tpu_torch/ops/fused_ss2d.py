"""SS2D core: kernels K1 ``ss2d_scan``, K2 ``ss2d_merge`` and K8 ``ss2d_scan_bwd``.

Port of ``tramba_tpu/ops/fused_ss2d.py``.  There the TPU runs each scan order
through its own family of Pallas kernels (paired directions, two-phase chunk
carries, one-hot line gathers, a merge fold per order, one backward call per
direction).  Here every order is one gather table and one inverse table
(``ops/scan_orders.py``), so three CUDA kernels serve all of them:

* K1 ``ss2d_scan`` (``csrc/ss2d.cu``): ys[b, k, t] = selective scan of
  x[b, idx[k, t]] with the per-direction Δ/B/C projections; fp32 state,
  d_state 1.  Train variant: also the fp32 state entering each chunk of
  :func:`scan_chunk` steps and the projections ``dbc``.  Its first launch
  is the projection (:func:`ss2d_proj` runs it alone): ``wgmma`` with the
  fp32 weight (and an fp32 x) split into three bf16 terms, as accurate as
  an fp32 product; the weight's terms are split once a weight version
  (:func:`proj_weight_terms`); ``ops/proj_stages.py`` mirrors the tiling
  and split.
* K2 ``ss2d_merge`` (``csrc/ss2d.cu``): sum of each pixel's direction
  outputs through the inverse table, LayerNorm, exact GELU, out projection.
  Train variant: also the pre-LN sum ``y_sum``, in the compute dtype (the
  TPU routes save it so: ``fused_ss2d_small.py:269``, ``fused_ss2d.py:464``).
* K8 ``ss2d_scan_bwd`` (``csrc/ss2d_bwd.cu``): the adjoint of K1 for every
  order, from the carries, ``dbc`` and the cotangent of ``y_sum``.

K1 and K2 run in fp32 or bf16, with the rounding points of ``_small_pallas``
(``fused_ss2d_small.py:150-228``): K1 takes a bf16 or fp32 ``x`` and always
projects, scans and writes ``ys`` in fp32 against the fp32 ``x_proj_weight``;
K2 takes fp32 ``ys`` and computes in the dtype of ``w_out``: with a bf16
``w_out`` the GELU output is rounded to bf16 before the out projection
(fp32 accumulation) and the result is bf16.  Training runs in both dtypes:
in bf16, K1's train variant takes K5's bf16 output (#13's ``emit_train``),
K2's writes a bf16 ``y_sum`` and K8 reads bf16 ``x`` and ``g_y`` and writes a
bf16 ``dx``.

Beside each kernel is its plain PyTorch version (``*_ref``).  The wrappers
pick by the tensors' device: CPU tensors take the plain version, CUDA tensors
launch the kernel (a build or launch error raises).  Each wrapper counts its
launches in ``<wrapper>.launches``.  Weights are in torch.nn.Linear layout
(out_features, in_features).  Under autograd on the card (and in bf16 on the
CPU, with plain launches), :func:`ss2d_full` runs :class:`SS2DCore` (K1 → K2
forward, K8 backward), as ``fused_ss2d_full`` / ``fused_ss2d_freq`` /
``fused_ss2d_small`` run their custom VJPs; fp32 CPU tensors differentiate
the plain versions.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from tramba_tpu_torch.ops import _native
from tramba_tpu_torch.ops._native import F32, F32_BF16, check_args, needs_grad, on_card
from tramba_tpu_torch.ops.proj_stages import PLAN_FIELDS
from tramba_tpu_torch.ops.scan_orders import order_tables
from tramba_tpu_torch.ops.selective_scan import dt_projection, linear_scan, linear_scan_ref
from tramba_tpu_torch.utils.profiling import span

__all__ = ["composed_ss2d_core", "ss2d_core_ref", "ss2d_scan", "ss2d_scan_ref",
           "ss2d_scan_train_ref", "ss2d_proj", "ss2d_proj_ref", "ss2d_proj_plan",
           "proj_weight_terms", "ss2d_merge", "ss2d_merge_ref", "ss2d_merge_train_ref",
           "check_merge_shape", "ss2d_scan_bwd", "ss2d_scan_bwd_ref", "SS2DCore", "ss2d_full",
           "SCAN_CHUNK", "scan_chunk", "scan_segment_steps"]

SCAN_CHUNK = 64  # the plain versions' default carry stride; the kernels' is scan_chunk()


def scan_chunk() -> int:
    """Steps per chunk of K1 and K8, the carries' stride, as the built
    library defines it (``kScanChunk`` in ``csrc/common.cuh``)."""
    return _native.library().ss2d_scan_chunk()


def scan_segment_steps(B: int, L: int, D: int, K: int, bwd: bool = False) -> int:
    """Steps per segment of K1's scan (or, with ``bwd``, K8's) at these
    sizes, as the built library cuts each direction (``scan_seg_chunks`` in
    ``csrc/common.cuh``): a whole number of :func:`scan_chunk` chunks, the
    last segment shorter where L ends it."""
    return _native.library().ss2d_scan_segment_steps(B, L, D, K, int(bwd))


def _check_table(name: str, t: torch.Tensor, shape: tuple) -> None:
    if not t.is_cuda or t.dtype != torch.int32 or not t.is_contiguous():
        raise TypeError(f"{name}: expected a contiguous int32 CUDA tensor")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


# ---------------------------------------------------------------------------
# plain versions (mirror composed_ss2d_core, fused_ss2d.py:38-57,
# _ln_gelu_proj, :478, and _bwd_chunk_math, :520-583)
# ---------------------------------------------------------------------------


def composed_ss2d_core(xs, x_proj_w, dt_w, dt_b, A_logs, Ds, scan=linear_scan):
    """The composed SS2D core of d_state 1 (``composed_ss2d_core``,
    fused_ss2d.py:38-57): fp32 projections -> softplus -> exp -> ``scan`` ->
    y = h C + D u.  xs (B, K, L, D); x_proj_w (K, R+2, D); dt_w (K, D, R);
    dt_b (K, D); A_logs (K, D, 1); Ds (K, D).  Returns ys (B, K, L, D) in
    xs's dtype.  ``scan`` is :func:`linear_scan` (kernel K14 on the card)
    unless the caller swaps in another: the sequence-parallel scan, or the
    plain loop in :func:`ss2d_core_ref`."""
    R = x_proj_w.shape[1] - 2
    xf = xs.float()
    dbc = torch.einsum("bkld,kcd->bklc", xf, x_proj_w.float())
    dts, Bc, Cc = torch.split(dbc, [R, 1, 1], dim=-1)
    dts = dt_projection(dts, dt_w.float())
    delta = F.softplus(dts + dt_b.float()[None, :, None, :])
    A = -torch.exp(A_logs.float())[..., 0]
    h = scan(torch.exp(delta * A[None, :, None, :]), delta * xf * Bc)
    return (h * Cc + xf * Ds.float()[None, :, None, :]).to(xs.dtype)


def ss2d_core_ref(xs, x_proj_w, dt_w, dt_b, A_logs, Ds):
    """:func:`composed_ss2d_core` in fp32 with the plain scan: K1's plain
    core.  Returns ys (B, K, L, D), fp32."""
    return composed_ss2d_core(xs.float(), x_proj_w, dt_w, dt_b, A_logs, Ds, scan=linear_scan_ref)


def ss2d_scan_ref(x, idx, x_proj_w, dt_w, dt_b, A_logs, Ds):
    """x (B, L, D); idx (K, L) int.  Returns ys (B, K, L, D)."""
    return ss2d_core_ref(x[:, idx.long()], x_proj_w, dt_w, dt_b, A_logs, Ds)


def _in_scan_order(x, idx, dbc):
    """xs (B, K, L, D) and dbcs (B, K, L, R+2): x and each direction's own
    projections at position t of direction k (pixel idx[k, t])."""
    il = idx.long()
    dbcs = torch.stack([dbc[:, il[k], k] for k in range(il.shape[0])], dim=1)
    return x.float()[:, il], dbcs


def _decay_terms(dbcs, dt_w, dt_b, A_logs):
    """(v, delta, a, A): dt before the softplus, softplus(v), exp(delta A) and
    A = -exp(A_logs), each (B, K, L, D) but A (K, 1, D)."""
    R = dt_w.shape[-1]
    K, D = dt_b.shape
    v = dt_projection(dbcs[..., :R], dt_w.float()) + dt_b.float()[:, None, :]
    delta = F.softplus(v)
    A = -torch.exp(A_logs.float()).reshape(K, 1, D)
    return v, delta, torch.exp(delta * A), A


def ss2d_proj_ref(x, x_proj_w):
    """K1's projection: x (B, L, D), x_proj_w (K, R+2, D) -> dbc (B, L, K,
    R+2), the per-pixel projections of every direction, an fp32 product."""
    return torch.einsum("bld,kcd->blkc", x.float(), x_proj_w.float())


def ss2d_scan_train_ref(x, idx, x_proj_w, dt_w, dt_b, A_logs, Ds, chunk=SCAN_CHUNK):
    """K1's train variant: (ys (B, K, L, D), carries (B, K, ceil(L / chunk),
    D), dbc (B, L, K, R+2)).  carries[:, :, c] is the state entering step
    chunk * c (0 for c = 0); dbc are the per-pixel projections of every
    direction (:func:`ss2d_proj_ref`)."""
    K, L = idx.shape
    dbc = ss2d_proj_ref(x, x_proj_w)
    xs, dbcs = _in_scan_order(x, idx, dbc)
    R = dt_w.shape[-1]
    _, delta, a, _ = _decay_terms(dbcs, dt_w, dt_b, A_logs)
    h = linear_scan_ref(a, delta * xs * dbcs[..., R:R + 1])
    starts = torch.arange(0, L, chunk, device=x.device)
    carries = torch.cat([torch.zeros_like(h[:, :, :1]), h[:, :, starts[1:] - 1]], dim=2)
    ys = h * dbcs[..., R + 1:R + 2] + xs * Ds.float().reshape(K, 1, -1)
    return ys, carries, dbc


def _merge_sum(ys, inv):
    """Each pixel's sum over directions k and slots m of ys[:, k, inv[k, m]]
    (slot value L = none): (B, K, L, D) -> (B, L, D)."""
    B, K, L, D = ys.shape
    pad = torch.cat([ys, ys.new_zeros(B, K, 1, D)], dim=2)
    inv = inv.long()
    y = ys.new_zeros(B, L, D)
    for k in range(K):
        for m in range(inv.shape[1]):
            y = y + pad[:, k, inv[k, m]]
    return y


def _ln_gelu_proj_fp32(y, ln_w, ln_b, w_out):
    """The function the TPU backward differentiates over the saved pre-LN sum
    (``_ln_gelu_proj``, fused_ss2d.py:478): fp32 throughout, w_out in fp32,
    only the output rounded to y's dtype.  The forward kernels round the
    GELU output in bf16 instead; the adjoint is held to JAX's."""
    a = F.gelu(F.layer_norm(y.float(), (y.shape[-1],), ln_w, ln_b, 1e-5))
    return (a @ w_out.float().t()).to(y.dtype)


def _ln_gelu_proj(y, ln_w, ln_b, w_out):
    """LayerNorm (eps 1e-5) -> exact GELU -> out projection; with a bf16
    w_out the GELU output is rounded to bf16 first.  Returns w_out's dtype."""
    y = F.gelu(F.layer_norm(y, (y.shape[-1],), ln_w, ln_b, 1e-5))
    cd = w_out.dtype
    return (y.to(cd).float() @ w_out.float().t()).to(cd)


def ss2d_merge_ref(ys, inv, ln_w, ln_b, w_out):
    """ys (B, K, L, D) fp32; inv (K, M, L) int, slot value L = none; ln_w, ln_b
    (D) fp32; w_out (dm, D) fp32 or bf16.  Returns (B, L, dm) in w_out's
    dtype; with a bf16 w_out the GELU output is rounded to bf16 first."""
    return _ln_gelu_proj(_merge_sum(ys, inv), ln_w, ln_b, w_out)


def ss2d_merge_train_ref(ys, inv, ln_w, ln_b, w_out):
    """K2's train variant: (out, y_sum), y_sum (B, L, D) the pre-LN sum in
    w_out's dtype."""
    y = _merge_sum(ys, inv)
    return _ln_gelu_proj(y, ln_w, ln_b, w_out), y.to(w_out.dtype)


def ss2d_scan_bwd_ref(x, idx, inv, g_y, carries, dbc, x_proj_w, dt_w, dt_b, A_logs, Ds,
                      chunk=SCAN_CHUNK):
    """The explicit adjoint of K1 followed by K2's merge sum, in fp32; dx in
    x's dtype.

    ``g_y`` (B, L, D) is the cotangent of the pre-LN sum; ``carries`` and
    ``dbc`` are what :func:`ss2d_scan_train_ref` returns for ``chunk``.  The
    states of each chunk are recomputed from its carry, then the adjoint
    ``lam_t = g_t C_t + a_{t+1} lam_{t+1}`` runs backwards.  Returns (dx
    (B, L, D), dwx (K, R+2, D), dwdt (K, D, R), dbias (K, D), dA_logs (K, D)
    = dA · A, dDs (K, D))."""
    K, L = idx.shape
    R = dt_w.shape[-1]
    xs, dbcs = _in_scan_order(x, idx, dbc.float())
    g = g_y.float()[:, idx.long()]  # the merge's adjoint: a gather
    Bc, Cc = dbcs[..., R:R + 1], dbcs[..., R + 1:R + 2]
    v, delta, a, A = _decay_terms(dbcs, dt_w, dt_b, A_logs)
    b_in = delta * Bc * xs
    h_prev, h = [], None
    for t in range(L):
        h = carries[:, :, t // chunk].float() if t % chunk == 0 else h
        h_prev.append(h)
        h = a[:, :, t] * h + b_in[:, :, t]
    h_prev = torch.stack(h_prev, dim=2)
    hs = a * h_prev + b_in
    lam, a_next, lams = torch.zeros_like(h), torch.zeros_like(h), [None] * L
    for t in range(L - 1, -1, -1):
        lam = g[:, :, t] * Cc[:, :, t] + a_next * lam
        a_next = a[:, :, t]
        lams[t] = lam
    lam = torch.stack(lams, dim=2)
    daA = lam * h_prev * a
    ddt = (daA * A + lam * xs * Bc) * torch.sigmoid(v)
    d_dbc = torch.cat([torch.einsum("bkld,kdr->bklr", ddt, dt_w.float()),
                       (lam * delta * xs).sum(-1, keepdim=True),
                       (g * hs).sum(-1, keepdim=True)], dim=-1)
    du = lam * delta * Bc + g * Ds.float().reshape(K, 1, -1)
    du = du + torch.einsum("bklc,kcd->bkld", d_dbc, x_proj_w.float())
    dx = _merge_sum(du, inv)
    dwx = torch.einsum("bklc,bkld->kcd", d_dbc, xs)
    dwdt = torch.einsum("bkld,bklr->kdr", ddt, dbcs[..., :R])
    dA = (daA * delta).sum((0, 2))
    return (dx.to(x.dtype), dwx, dwdt, ddt.sum((0, 2)), dA * A[:, 0], (g * xs).sum((0, 2)))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def ss2d_scan(x, idx, x_proj_w, dt_w, dt_b, A_logs, Ds, *, emit=False):
    """Kernel K1 on CUDA tensors, :func:`ss2d_scan_ref` on CPU tensors.
    ``emit=True`` (training): returns (ys, carries, dbc) as
    :func:`ss2d_scan_train_ref` does."""
    with span("K1 ss2d_scan"):
        if not on_card(x):
            if emit:
                return ss2d_scan_train_ref(x, idx, x_proj_w, dt_w, dt_b, A_logs, Ds)
            return ss2d_scan_ref(x, idx, x_proj_w, dt_w, dt_b, A_logs, Ds)
        B, L, D = x.shape
        K, C, _ = x_proj_w.shape
        R = C - 2
        check_args(x=(x, F32_BF16), x_proj_w=(x_proj_w, F32), dt_w=(dt_w, F32),
                   dt_b=(dt_b, F32), A_logs=(A_logs, F32), Ds=(Ds, F32))
        _check_table("idx", idx, (K, L))
        if D % 32 or R > 64:
            raise ValueError(f"ss2d_scan: D={D} must be a multiple of 32 and R={R} at most 64")
        if (tuple(x_proj_w.shape) != (K, C, D) or tuple(dt_w.shape) != (K, D, R)
                or dt_b.numel() != K * D or A_logs.numel() != K * D or Ds.numel() != K * D):
            raise ValueError("ss2d_scan: parameter shapes do not match x and x_proj_w")
        dbc = torch.empty(B, L, K, C, device=x.device, dtype=torch.float32)
        summ = torch.empty(2, B, K, -(-L // scan_segment_steps(B, L, D, K)), D, device=x.device,
                           dtype=torch.float32)
        ys = torch.empty(B, K, L, D, device=x.device, dtype=torch.float32)
        carries = (torch.empty(B, K, -(-L // scan_chunk()), D, device=x.device,
                               dtype=torch.float32) if emit else None)
        terms = proj_weight_terms(x_proj_w)
        _native.launch("ss2d_scan_launch", x.data_ptr(), idx.data_ptr(), terms.data_ptr(),
                       dt_w.data_ptr(), dt_b.data_ptr(), A_logs.data_ptr(), Ds.data_ptr(),
                       dbc.data_ptr(), summ.data_ptr(), ys.data_ptr(),
                       carries.data_ptr() if emit else None,
                       B, L, D, K, R, int(x.dtype == torch.bfloat16), _native.stream_handle(x))
        ss2d_scan.launches += 1
        return (ys, carries, dbc) if emit else ys


ss2d_scan.launches = 0


# x_proj_w -> (its version, its data pointer, its three bf16 terms): the
# projection's split weight, kept while the weight lives and is unchanged
_TERMS = WeakIdKeyDictionary()


def proj_weight_terms(x_proj_w):
    """The three bf16 terms of K1's fp32 weight x_proj_w (K, R+2, D) on the
    card, (3, K (R+2), Dp) with Dp = D rounded up to 8: split by one launch
    (``ss2d_proj_terms_launch``: h = bf16(w), m = bf16(w - h), l = bf16(w -
    h - m), the span ``K1 weight terms``) where the weight is new or its
    version counter or storage has moved since (an optimizer step, ``copy_``,
    ``load_state_dict``), else the terms kept from before.  A write that
    bypasses the tensor's version counter (through ``.data``) is not seen."""
    key = (x_proj_w._version, x_proj_w.data_ptr())
    kept = _TERMS.get(x_proj_w)
    if kept is not None and kept[:2] == key:
        return kept[2]
    with span("K1 weight terms"):
        K, C, D = x_proj_w.shape
        shape = (3, K * C, -(-D // 8) * 8)
        terms = kept[2] if kept is not None and tuple(kept[2].shape) == shape else torch.empty(
            shape, device=x_proj_w.device, dtype=torch.bfloat16)
        _native.launch("ss2d_proj_terms_launch", x_proj_w.data_ptr(), terms.data_ptr(), K * C,
                       D, _native.stream_handle(x_proj_w))
        _TERMS[x_proj_w] = (*key, terms)
    return terms


def ss2d_proj(x, x_proj_w):
    """K1's projection launch alone on CUDA tensors (the one K1 makes before
    its scans), :func:`ss2d_proj_ref` on CPU tensors: x (B, L, D) fp32 or
    bf16 (D a multiple of 4 or 8), x_proj_w (K, R+2, D) fp32 -> dbc (B, L, K,
    R+2) fp32.  Its weight's terms come from :func:`proj_weight_terms`."""
    with span("K1 ss2d_proj"):
        if not on_card(x):
            return ss2d_proj_ref(x, x_proj_w)
        B, L, D = x.shape
        K, C, _ = x_proj_w.shape
        check_args(x=(x, F32_BF16), x_proj_w=(x_proj_w, F32))
        vec = 8 if x.dtype == torch.bfloat16 else 4
        if x_proj_w.shape[2] != D or D % vec or B * L < 1:
            raise ValueError(f"ss2d_proj: x_proj_w {tuple(x_proj_w.shape)} must match D={D}, a "
                             f"multiple of {vec}, and x rows")
        terms = proj_weight_terms(x_proj_w)
        dbc = torch.empty(B, L, K, C, device=x.device, dtype=torch.float32)
        _native.launch("ss2d_proj_launch", x.data_ptr(), terms.data_ptr(), dbc.data_ptr(), B * L, D,
                       K * C, int(x.dtype == torch.bfloat16), _native.stream_handle(x))
        ss2d_proj.launches += 1
        return dbc


ss2d_proj.launches = 0


def ss2d_proj_plan(M: int, D: int, N: int, dtype: torch.dtype) -> dict:
    """The projection's plan as the built library makes it (``plan_proj`` in
    ``csrc/ss2d.cu``; :func:`tramba_tpu_torch.ops.proj_stages.proj_plan` is its
    plain mirror), {field: value} over ``proj_stages.PLAN_FIELDS``.  No launch;
    raises for shapes the kernel does not take."""
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    _native.launch("ss2d_proj_plan", M, D, N, int(dtype == torch.bfloat16), out)
    return dict(zip(PLAN_FIELDS, out))


def check_merge_shape(K: int, slots: int, D: int, dm: int, dtype) -> None:
    """Raise ValueError unless K2 takes ``K`` directions with a table of
    ``slots`` slots, of width ``D`` into ``dm`` outputs in ``dtype``: a warp
    reads K directions' table entries at once (K divides 32; any number of
    slots), a lane sums up to 16 groups of 4 channels (D <= 2048), and
    w_out's rows are copied 16 bytes at a time (D a multiple of 8 in bf16, of
    4 in fp32).  No launch: the tests hold every model's shapes to it on the
    CPU."""
    vec = 8 if dtype == torch.bfloat16 else 4
    if K < 1 or 32 % K or slots < 1 or D % vec or not 0 < D <= 2048 or dm < 1:
        raise ValueError(f"ss2d_merge: K={K} must divide 32, slots={slots} be positive, "
                         f"D={D} a multiple of {vec} up to 2048, dm={dm} positive")


def ss2d_merge(ys, inv, ln_w, ln_b, w_out, *, emit_ysum=False):
    """Kernel K2 on CUDA tensors, :func:`ss2d_merge_ref` on CPU tensors.
    ``emit_ysum=True`` (training): returns (out, y_sum) as
    :func:`ss2d_merge_train_ref` does."""
    with span("K2 ss2d_merge"):
        if not on_card(ys):
            if emit_ysum:
                return ss2d_merge_train_ref(ys, inv, ln_w, ln_b, w_out)
            return ss2d_merge_ref(ys, inv, ln_w, ln_b, w_out)
        B, K, L, D = ys.shape
        dm = w_out.shape[0]
        check_args(ys=(ys, F32), ln_w=(ln_w, F32), ln_b=(ln_b, F32),
                   w_out=(w_out, F32_BF16))
        _check_table("inv", inv, (K, inv.shape[1], L))
        check_merge_shape(K, inv.shape[1], D, dm, w_out.dtype)
        if tuple(w_out.shape) != (dm, D) or ln_w.numel() != D or ln_b.numel() != D:
            raise ValueError("ss2d_merge: w_out must be (dm, D) and the LN parameters (D,)")
        out = torch.empty(B, L, dm, device=ys.device, dtype=w_out.dtype)
        y_sum = torch.empty(B, L, D, device=ys.device, dtype=w_out.dtype) if emit_ysum else None
        _native.launch("ss2d_merge_launch", ys.data_ptr(), inv.data_ptr(), ln_w.data_ptr(),
                       ln_b.data_ptr(), w_out.data_ptr(), out.data_ptr(),
                       y_sum.data_ptr() if emit_ysum else None, B, K, inv.shape[1], L, D, dm,
                       int(w_out.dtype == torch.bfloat16), _native.stream_handle(ys))
        ss2d_merge.launches += 1
        return (out, y_sum) if emit_ysum else out


ss2d_merge.launches = 0


def ss2d_scan_bwd(x, idx, inv, g_y, carries, dbc, x_proj_w, dt_w, dt_b, A_logs, Ds):
    """Kernel K8 on CUDA tensors, :func:`ss2d_scan_bwd_ref` on CPU tensors."""
    with span("K8 ss2d_scan_bwd"):
        if not on_card(x):
            return ss2d_scan_bwd_ref(x, idx, inv, g_y, carries, dbc, x_proj_w, dt_w, dt_b, A_logs,
                                     Ds)
        B, L, D = x.shape
        K, C, _ = x_proj_w.shape
        R = C - 2
        check_args(x=(x, F32_BF16), g_y=(g_y, (x.dtype,)), carries=(carries, F32), dbc=(dbc, F32),
                   x_proj_w=(x_proj_w, F32), dt_w=(dt_w, F32), dt_b=(dt_b, F32),
                   A_logs=(A_logs, F32), Ds=(Ds, F32))
        _check_table("idx", idx, (K, L))
        _check_table("inv", inv, (K, inv.shape[1], L))
        if D % 32 or R > 64:
            raise ValueError(f"ss2d_scan_bwd: D={D} must be a multiple of 32 and R={R} at most 64")
        if (tuple(g_y.shape) != (B, L, D) or tuple(dbc.shape) != (B, L, K, C)
                or tuple(carries.shape) != (B, K, -(-L // scan_chunk()), D)
                or tuple(dt_w.shape) != (K, D, R) or dt_b.numel() != K * D
                or A_logs.numel() != K * D or Ds.numel() != K * D):
            raise ValueError("ss2d_scan_bwd: shapes do not match x, idx and x_proj_w")
        chunks = -(-B * L // _native.library().ss2d_scan_bwd_rows())
        S = -(-L // scan_segment_steps(B, L, D, K, bwd=True))

        def f32(*shape):
            return torch.empty(*shape, device=x.device, dtype=torch.float32)

        dx = torch.empty(B, L, D, device=x.device, dtype=x.dtype)
        dwx, dwdt, sums = f32(K, C, D), f32(K, D, R), f32(3, B * S, K, D)
        # summaries, dxs, ddt, dB / dC partials, d_dbc (rows padded to 16 bytes),
        # the weight partials
        scratch = (f32(2, B, K, S, D), f32(B, K, L, D), f32(B, K, L, D), f32(B, K, L, D // 32),
                   f32(B, K, L, D // 32), f32(B, K, L, -(-C // 4) * 4), f32(chunks, K, C, D),
                   f32(chunks, K, D, R))
        _native.launch("ss2d_scan_bwd_launch", x.data_ptr(), idx.data_ptr(), inv.data_ptr(),
                       g_y.data_ptr(), carries.data_ptr(), dbc.data_ptr(), x_proj_w.data_ptr(),
                       dt_w.data_ptr(), dt_b.data_ptr(), A_logs.data_ptr(), Ds.data_ptr(),
                       dx.data_ptr(), dwx.data_ptr(), dwdt.data_ptr(), sums.data_ptr(),
                       *(t.data_ptr() for t in scratch), B, L, D, K, R, inv.shape[1],
                       int(x.dtype == torch.bfloat16), _native.stream_handle(x))
        ss2d_scan_bwd.launches += 1
        # the per-image, per-segment (K, D) partials summed in a fixed order, as
        # _full_bwd sums the per-image ones in XLA (:1081)
        dbias, dA, dDs = sums.sum(1)
        return dx, dwx, dwdt, dbias, dA * -torch.exp(A_logs.reshape(K, D)), dDs


ss2d_scan_bwd.launches = 0


class SS2DCore(torch.autograd.Function):
    """Scan -> merge -> LN -> GELU -> out projection of one SS2D with its
    backward, in x's dtype, fp32 or bf16 (``fused_ss2d_full`` /
    ``fused_ss2d_freq`` / ``fused_ss2d_small`` and their custom VJPs,
    ``fused_ss2d.py:1030-1126``, ``:1799-1869``, ``fused_ss2d_small.py:343-472``).

    Forward: K1's train variant (ys, carries, dbc), then K2's (out, y_sum)
    with w_out cast to x's dtype; ys is dropped, and x, dbc, the carries and
    y_sum are saved.  Backward: the LN -> GELU -> out projection adjoint by
    autograd over y_sum with the fp32 w_out (JAX runs it as one XLA vjp of
    ``_ln_gelu_proj``, ``:1062``), then K8.  On CPU tensors every launch is
    the plain version."""

    @staticmethod
    def forward(ctx, x, idx, inv, x_proj_w, dt_w, dt_b, A_logs, Ds, ln_w, ln_b, w_out):
        ys, carries, dbc = ss2d_scan(x, idx, x_proj_w, dt_w, dt_b, A_logs, Ds, emit=True)
        out, y_sum = ss2d_merge(ys, inv, ln_w, ln_b, w_out.to(x.dtype), emit_ysum=True)
        ctx.save_for_backward(x, idx, inv, carries, dbc, y_sum, x_proj_w, dt_w, dt_b, A_logs, Ds,
                              ln_w, ln_b, w_out)
        return out

    @staticmethod
    def backward(ctx, g):
        (x, idx, inv, carries, dbc, y_sum, x_proj_w, dt_w, dt_b, A_logs, Ds, ln_w, ln_b,
         w_out) = ctx.saved_tensors
        need = ctx.needs_input_grad
        g_y, d_ln_w, d_ln_b, d_w_out = _native.recompute_vjp(
            _ln_gelu_proj_fp32, (y_sum, ln_w, ln_b, w_out), (True, *need[8:]), g.contiguous())
        dx, dwx, dwdt, dbias, dA_logs, dDs = ss2d_scan_bwd(
            x, idx, inv, g_y.contiguous(), carries, dbc, x_proj_w, dt_w, dt_b, A_logs, Ds)
        return (dx, None, None, dwx, dwdt, dbias.reshape(dt_b.shape),
                dA_logs.reshape(A_logs.shape), dDs.reshape(Ds.shape), d_ln_w, d_ln_b, d_w_out)


def ss2d_full(x_flat, x_proj_w, dt_w, dt_b, A_logs, Ds, ln_w, ln_b, w_out,
              kind: str, H: int, W: int, param: int = 0):
    """Scan -> merge -> LN -> GELU -> out projection of one SS2D:
    (B, L, D) -> (B, L, dm), over the scan order ``kind`` of an H x W map.
    ``w_out`` is the fp32 parameter; the output takes x's dtype.  Under
    autograd on the card, and in bf16 on the CPU, it runs :class:`SS2DCore`
    (plain launches on the CPU), so a bf16 gradient rounds where the TPU
    adjoint rounds; an fp32 SS2D on the CPU differentiates the plain
    versions."""
    idx, inv = order_tables(kind, H, W, param, x_flat.device)
    params = (x_proj_w, dt_w, dt_b, A_logs, Ds, ln_w, ln_b, w_out)
    if needs_grad(x_flat, *params) and (on_card(x_flat) or x_flat.dtype == torch.bfloat16):
        return SS2DCore.apply(x_flat, idx, inv, *params)
    ys = ss2d_scan(x_flat, idx, x_proj_w, dt_w, dt_b, A_logs, Ds)
    return ss2d_merge(ys, inv, ln_w, ln_b, w_out.to(x_flat.dtype))
