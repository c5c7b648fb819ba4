"""Attention of the bf16 Tramba-P and Tramba-S encoders: kernels K12 ``sra``
and K13 ``window_attn``.

Port of ``tramba_tpu/ops/fused_attn.py``:

* K12 ``sra`` replaces ``_sra_pallas`` (:96, kernel :58), PVTv2's
  spatial-reduction attention: LN (eps 1e-6) -> q -> per head
  softmax(q_h k_hᵀ) v_h -> merged heads -> out projection, with the reduced
  keys and values (B, nh, Lk, hd) from the composed sr-conv path outside.
* K13 ``window_attn`` replaces ``_wattn_pallas`` (:254, kernel :204), Swin's
  window attention: LN (eps 1e-5) -> qkv -> per head softmax(q kᵀ + bias[h]
  (+ mask[window])) v -> merged heads -> out projection per w x w window of
  the (B, H, W, C) map, partition and reverse inside.  The cyclic shift and
  the gather of the relative-position bias stay outside, as in JAX.

Both run in ``csrc/attn.cu``: K12 as one launch with its LayerNorm folded
in (its plan: :func:`sra_plan`; widths its block cannot hold, which no
PVTv2 model has, as three launches of its "wide route"), K13 as two (an LN
+ qkv front, then the attention).  They round where the TPU kernels round: the LN output; q
after its bias and scale, k and v (K13: after their bias); the softmax
probabilities; the merged head outputs; the result.  The plain versions
(``*_ref``) do fp32 math on operands rounded to ``x``'s dtype at the same
points, so for fp32 inputs they are the composed fp32 functions.  The
wrappers pick by device (CPU tensors: the plain version; CUDA tensors: the
kernel or an error), count launches in ``<wrapper>.launches``, and under
autograd in bf16 (and on the card) run :class:`Sra` / :class:`WindowAttn`,
whose backward is the VJP of the plain version by recomputation, as
``_sra_bwd`` (:163) and ``_wattn_bwd`` (:343) differentiate the composed
versions (no gradient for the mask).  Weights are in torch layout: Linear
(out, in).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tramba_tpu_torch.ops import _native
from tramba_tpu_torch.ops._native import BF16, F32, check_args, needs_grad, on_card
from tramba_tpu_torch.ops.fused_mlp import _linear, _ln_rounded
from tramba_tpu_torch.utils.profiling import span

__all__ = ["sra", "sra_ref", "sra_fusable", "check_sra_shape", "sra_plan", "sra_smem",
           "sra_least_slots", "sra_wide_smem", "sra_wide_keys",
           "SRA_PLAN_FIELDS", "SRA_MAX_C", "window_attn", "window_attn_ref",
           "window_attn_fusable", "attn_plan", "check_window_attn_shape", "window_attn_plan",
           "window_smem", "WINDOW_HEAD_WIDTHS", "WINDOW_PLAN_FIELDS", "Sra", "WindowAttn"]


def sra_fusable(N: int, C: int, nh: int, Lk: int, dtype) -> bool:
    """Where the JAX package runs ``_sra_pallas`` on a TPU (``sra_fusable``,
    fused_attn.py:34-45, whose VMEM budgets hold at every PVTv2-b4 width):
    bf16, N, Lk and the head width multiples of 8; and where K12 has a route
    for the shape (:func:`check_sra_shape`: the one-launch kernel up to C 768
    and heads 128 wide, every PVTv2 width at any image size; the wide route
    beyond, for heads up to about 2,000 wide).  K12 takes every such shape,
    any number of keys."""
    if not (dtype == torch.bfloat16 and N % 8 == 0 and nh >= 1 and C % nh == 0
            and (C // nh) % 8 == 0 and Lk % 8 == 0):
        return False
    try:
        check_sra_shape(C, nh, Lk)
    except ValueError:
        return False
    return True


def window_attn_fusable(H: int, W: int, C: int, nh: int, w: int, dtype) -> bool:
    """Where the JAX package runs ``_wattn_pallas`` on a TPU
    (``window_attn_fusable``, fused_attn.py:187-201, whose VMEM budgets hold
    at every Swin-B width): bf16, whole windows, head width and window size
    multiples of 8 (so w*w is a multiple of 16); and where K13's attention
    launch holds a window's scores in registers and its rows' merged outputs
    and two heads' operands in one block's shared memory: at most 144
    tokens a window (Swin's 12 x 12), heads at most 64 wide (Swin-B's are
    32) and :func:`window_smem` within 227 KB (Swin-B's stages 1-3, the ones
    that run; not its C 1024 stage 4).  K13 takes every such shape, its
    heads padded where needed (:func:`check_window_attn_shape`)."""
    if not (dtype == torch.bfloat16 and C % nh == 0 and (C // nh) % 8 == 0
            and C // nh <= 64 and (w * w) % 8 == 0 and w * w <= 144 and H % w == 0
            and W % w == 0):
        return False
    hd16, Cq, _ = attn_plan(C, nh, w * w)
    return window_smem(Cq, hd16, w * w) <= _SMEM_BLOCK


def _scale(hd: int) -> float:
    return hd ** -0.5


# ---------------------------------------------------------------------------
# plain versions (mirror _sra_kernel, fused_attn.py:58-92, and _wattn_kernel,
# :204-250)
# ---------------------------------------------------------------------------


def _heads_out(q, k, v, cd, add=()):
    """q, k, v (G, nh, n, hd) fp32, already rounded; each tensor of ``add``
    is added in turn to the fp32 scores.  Returns the merged (G, n, nh*hd)
    head outputs rounded to cd, as fp32."""
    s = q @ k.transpose(-1, -2)
    for t in add:
        s = s + t
    p = torch.softmax(s, dim=-1).to(cd).float()
    o = p @ v
    G, nh, n, hd = o.shape
    return o.transpose(1, 2).reshape(G, n, nh * hd).to(cd).float()


def sra_ref(x, ln_w, ln_b, wq, bq, k, v, wp, bp, nh, eps=1e-6):
    """x (B, N, C); ln_w, ln_b, bq, bp (C); wq, wp (C, C); k, v (B, nh, Lk,
    hd).  Returns (B, N, C) in x's dtype."""
    cd = x.dtype
    B, N, C = x.shape
    hd = C // nh
    q = (_linear(_ln_rounded(x, ln_w, ln_b, eps), wq, cd) + bq.float()) * _scale(hd)
    q = q.reshape(B, N, nh, hd).transpose(1, 2).to(cd).float()
    o = _heads_out(q, k.to(cd).float(), v.to(cd).float(), cd)
    return (_linear(o, wp, cd) + bp.float()).to(cd)


def window_attn_ref(x, ln_w, ln_b, wqkv, bqkv, bias, mask, wp, bp, nh, eps=1e-5):
    """x (B, H, W, C), already rolled for a shifted block; wqkv (3C, C);
    bqkv (3C); bias (nh, N, N) fp32 with N = w*w; mask (nW, N, N) fp32 or
    None; wp (C, C); bp (C).  Returns (B, H, W, C) in x's dtype."""
    cd = x.dtype
    B, H, W, C = x.shape
    N = bias.shape[-1]
    w = int(round(N ** 0.5))
    nWh, nWw = H // w, W // w
    hd = C // nh
    y = _ln_rounded(x, ln_w, ln_b, eps)
    win = y.reshape(B, nWh, w, nWw, w, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, N, C)
    qkv = (_linear(win, wqkv, cd) + bqkv.float()).reshape(-1, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q = (qkv[0] * _scale(hd)).to(cd).float()
    k, v = qkv[1].to(cd).float(), qkv[2].to(cd).float()
    add = [bias.float()]
    if mask is not None:  # each window's mask on every head: (B * nW, 1, N, N)
        add.append(mask.float()[:, None].repeat(B, 1, 1, 1))
    o = _heads_out(q, k, v, cd, add)
    out = _linear(o, wp, cd) + bp.float()
    out = out.reshape(B, nWh, nWw, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)
    return out.to(cd)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def sra(x, ln_w, ln_b, wq, bq, k, v, wp, bp, nh, eps=1e-6):
    """Kernel K12 on CUDA tensors, :func:`sra_ref` on CPU tensors; under
    autograd in bf16 (and on the card) :class:`Sra`."""
    with span("K12 sra"):
        args = (x, ln_w, ln_b, wq, bq, k, v, wp, bp)
        if needs_grad(*args) and (on_card(x) or x.dtype == torch.bfloat16):
            return Sra.apply(*args, nh, eps)
        return _sra_launch(*args, nh, eps) if on_card(x) else sra_ref(*args, nh, eps)


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _up16(n: int) -> int:
    return _up(n, 16)


def attn_plan(C: int, nh: int, n: int) -> tuple:
    """How K13 takes a shape that its gate admits: (hd16, Cq, n16).  The
    kernels work in multiples of 16, so the wrapper zero-pads each head's
    width hd = C / nh to hd16 (q k^T and p v are unchanged by zero columns)
    and runs the heads and the output projection at Cq = nh * hd16, keeping
    the first C output channels; n16 is the window's tokens rounded up to
    16.  Raises where no padding makes the shape one the kernels take."""
    if nh < 1 or C % nh or n < 1:
        raise ValueError(f"attention: C={C} over {nh} heads with {n} keys")
    hd16 = _up16(C // nh)
    return hd16, nh * hd16, _up16(n)


def _pad_heads(w: torch.Tensor, nh: int, hd16: int, groups: int = 1) -> torch.Tensor:
    """Rows of ``w`` (groups * C, ...) as ``groups`` blocks of nh heads of hd
    rows, each head zero-padded to hd16 rows: (groups * nh * hd16, ...)."""
    rows = w.reshape(groups, nh, -1, *w.shape[1:])
    pad = [0, 0] * (w.dim() - 1) + [0, hd16 - rows.shape[2]]
    return torch.nn.functional.pad(rows, pad).reshape(groups * nh * hd16, *w.shape[1:])


def _pad_out_proj(wp, bp, nh, hd16):
    """wp (C, C) -> (Cq, Cq): its input columns per head padded to hd16, its
    output rows padded with zeros to Cq; bp (C) -> (Cq)."""
    Cq = nh * hd16
    wp = _pad_heads(wp.t(), nh, hd16).t()
    wp = torch.nn.functional.pad(wp, (0, 0, 0, Cq - wp.shape[0])).contiguous()
    return wp, torch.nn.functional.pad(bp, (0, Cq - bp.numel())).contiguous()



# K12's one-launch kernel (``sra_launch`` in csrc/attn.cu): C a multiple of 8
# up to SRA_MAX_C, heads padded with zeros to a multiple of 64 up to
# SRA_MAX_HEAD
SRA_MAX_C, SRA_MAX_HEAD = 768, 128
# the plan sra_plan reports (``plan_sra`` in csrc/attn.cu): head-width chunks
# of 64, warpgroups a block, query rows a block, blocks a row tile (the
# cluster), row tiles an image, key tiles of 64 held in registers, key
# chunks (two passes where > 1), ring slots, whether the merged heads share
# the LayerNorm's tile, blocks an SM, shared bytes, blocks, whether the wide
# route runs, keys a chunk
SRA_PLAN_FIELDS = ("nq", "nwg", "rows", "cluster", "tiles", "kt", "chunks", "stages", "alias",
                   "per_sm", "smem", "blocks", "wide", "keys")
# the wide route's attention launch (``sra_wide_attn_kernel``): query rows a
# block, and the keys a chunk it may take
SRA_WIDE_ROWS, SRA_WIDE_KEYS = 16, (64, 32, 16, 8)


def sra_smem(C: int, Cq: int, rows: int, stages: int, alias: bool = False) -> int:
    """Shared bytes of a K12 block: its rows' LayerNorm (C rounded up to 64),
    its merged heads (Cq; none where they share the LayerNorm's tile),
    ``stages`` 8 KB ring slots, 1 KB for the mbarriers and alignment."""
    return 1024 + 2 * rows * (-(-C // 64) * 64 + (0 if alias else Cq)) + stages * 64 * 64 * 2


def sra_least_slots(hdp: int) -> int:
    """Ring slots a K12 block needs: two, and one more than a key tile's
    boxes (hdp / 64)."""
    return max(2, hdp // 64 + 1)


def sra_wide_smem(hd: int, keys: int) -> int:
    """Shared bytes of the wide route's attention block (``sra_wide_smem`` in
    csrc/attn.cu): 16 rows of O_h in fp32, of scores over ``keys`` keys, each
    row's max and sum, q_h in bf16, and a chunk of k_h or v_h in bf16 rows of
    hd + 2."""
    r = SRA_WIDE_ROWS
    return r * hd * 4 + r * keys * 4 + 2 * r * 4 + r * hd * 2 + keys * (hd + 2) * 2


def sra_wide_keys(hd: int) -> int:
    """Keys a chunk of the wide route for heads ``hd`` wide: the most of
    :data:`SRA_WIDE_KEYS` whose working set fits one block; 0 where none
    does."""
    return next((n for n in SRA_WIDE_KEYS if sra_wide_smem(hd, n) <= _SMEM_BLOCK), 0)


def check_sra_shape(C: int, nh: int, Lk: int) -> tuple:
    """(hdp, Cq, wide) of a K12 call, or ValueError where K12 does not take
    the shape.  C a multiple of 8 over nh whole heads, any Lk >= 1; then
    either the one-launch kernel (wide False): C up to :data:`SRA_MAX_C`,
    each head padded to hdp (a multiple of 64 up to :data:`SRA_MAX_HEAD`),
    Cq = nh hdp, a block of 64 rows within 227 KB (its merged heads in the
    LayerNorm's tile where each block of a cluster of nh <= 8 takes one head
    of 64); or else the wide route (wide True: hdp = hd, Cq = C), heads a
    multiple of 8 whose attention block holds 8 keys a chunk
    (:func:`sra_wide_keys`).  No launch."""
    if nh < 1 or C < 8 or C % nh or C % 8 or Lk < 1:
        raise ValueError(f"sra: C={C} over {nh} heads with {Lk} keys: C a multiple of 8, whole "
                         "heads")
    hd = C // nh
    hdp = _up(hd, 64)
    Cq = nh * hdp
    alias = nh <= 8 and Cq == _up(C, 64)
    if (C <= SRA_MAX_C and hdp <= SRA_MAX_HEAD
            and sra_smem(C, Cq, 64, sra_least_slots(hdp), alias) <= _SMEM_BLOCK):
        return hdp, Cq, False
    if hd % 8 == 0 and sra_wide_keys(hd):
        return hd, C, True
    raise ValueError(f"sra: C={C} over {nh} heads: heads a multiple of 8 whose wide-route "
                     "attention block fits one block's shared memory")


@functools.lru_cache(maxsize=None)
def _sra_plan(device: int, *shape) -> tuple:
    out = (ctypes.c_int * len(SRA_PLAN_FIELDS))()
    with torch.cuda.device(device):
        _native.launch("sra_plan", *shape, out)
    return tuple(out)


def sra_plan(B: int, N: int, C: int, nh: int, Lk: int, device: int = 0) -> dict:
    """The plan the built library makes for a K12 call on CUDA device
    ``device`` ({field: value} over :data:`SRA_PLAN_FIELDS`);
    ``ops/encoder_stages.sra_plan`` is its plain mirror.  No launch."""
    check_sra_shape(C, nh, Lk)
    return dict(zip(SRA_PLAN_FIELDS, _sra_plan(device, B, N, C, nh, Lk)))


def _sra_operands(x, wq, bq, k, v, wp, bp, nh):
    """K12's operands as its launch takes them, for x (B, N, C): (wq (Cq,
    C), bq (Cq), k and v (B, nh, Lk, hdp), wp (C, Cq), bp (C)), each head's
    width zero-padded to hdp (:func:`check_sra_shape`; q k^T and p v are
    unchanged by zero columns; the wide route pads nothing), and Cq; the
    keys are not padded (the kernel masks its last key tile past Lk).
    Raises on shapes K12 cannot take.  Launches nothing."""
    B, N, C = x.shape
    Lk, hd = k.shape[2], C // nh
    hdp, Cq, _ = check_sra_shape(C, nh, Lk)
    if (tuple(k.shape) != (B, nh, Lk, hd) or v.shape != k.shape or tuple(wq.shape) != (C, C)
            or bq.numel() != C or tuple(wp.shape) != (C, C) or bp.numel() != C):
        raise ValueError("sra: x (B, N, C), k and v (B, nh, Lk, C / nh), wq and wp (C, C), "
                         "bq and bp (C)")
    if hdp != hd:  # zero-padded heads
        wq, bq = _pad_heads(wq, nh, hdp), _pad_heads(bq, nh, hdp)
        k, v = (torch.nn.functional.pad(t, (0, hdp - hd)) for t in (k, v))
        wp = _pad_heads(wp.t(), nh, hdp).t()
    return tuple(t.contiguous() for t in (wq, bq, k, v, wp, bp)), Cq


# head widths K13's attention kernel is built for (window_attn_kernel<HD>)
WINDOW_HEAD_WIDTHS = (16, 32, 48, 64)
# the plan window_attn_plan reports: the qkv front's (plan_front in
# csrc/common.cuh) row tiles, hidden groups, chunks a group, ring stages and
# shared bytes; the attention launch's blocks a window and shared bytes
WINDOW_PLAN_FIELDS = ("rows", "groups", "cps", "stages", "front_smem", "row_groups", "smem")


_SMEM_BLOCK = 227 * 1024  # shared memory one block may use


def window_smem(Cq: int, hd16: int, N: int) -> int:
    """Shared bytes of K13's attention launch (``win_layout`` in
    ``csrc/attn.cu``): the merged outputs of 48 query rows, two heads'
    staged q, k, v and bias rows, the mask rows, the halves' exchange, or
    the projection's ring, whichever is more."""
    x = -(-Cq // 64) * 48 * 128 + 16 * 128
    stage = (48 + 2 * N) * (hd16 + 8) * 2 + 48 * (N + 4) * 4
    heads = 2 * stage + 48 * (N + 4) * 4 + 2 * 4 * 2 * 16 * 4 + 3 * 16 * (hd16 + 8) * 4
    return 1024 + x + max(heads, 3 * 2 * 64 * 64 * 2)


def check_window_attn_shape(B: int, H: int, W: int, C: int, nh: int, w: int) -> tuple:
    """(hd16, Cq) of a K13 call, or ValueError where the kernels do not take
    the shape: whole w x w windows of at most 144 tokens, a multiple of 16;
    C a multiple of 8 (the LayerNorm's rows, 16-byte groups); heads padded
    to hd16 in :data:`WINDOW_HEAD_WIDTHS` (:func:`attn_plan`); the
    attention launch's :func:`window_smem` within 227 KB.  No launch."""
    N = w * w
    hd16, Cq, N16 = attn_plan(C, nh, N)
    if (min(B, H, W, w) < 1 or H % w or W % w or N16 != N or N > 144 or C % 8
            or hd16 not in WINDOW_HEAD_WIDTHS or window_smem(Cq, hd16, N) > _SMEM_BLOCK):
        raise ValueError(f"window_attn: B={B}, {H}x{W} map of {w}x{w} windows, C={C}, "
                         f"{nh} heads: whole windows of a multiple of 16 tokens up to 144, C a "
                         f"multiple of 8, head width padded to one of {WINDOW_HEAD_WIDTHS}, "
                         "its tiles within one block's shared memory")
    return hd16, Cq


@functools.lru_cache(maxsize=None)
def _window_plan(device: int, *shape) -> tuple:
    out = (ctypes.c_int * len(WINDOW_PLAN_FIELDS))()
    with torch.cuda.device(device):
        _native.launch("window_attn_plan", *shape, out)
    return tuple(out)


def window_attn_plan(B: int, H: int, W: int, C: int, nh: int, w: int, device: int = 0) -> dict:
    """The plan the built library makes for a K13 call on CUDA device
    ``device`` ({field: value} over :data:`WINDOW_PLAN_FIELDS`);
    ``ops/encoder_stages.window_plan`` is its plain mirror.  No launch."""
    _, Cq = check_window_attn_shape(B, H, W, C, nh, w)
    return dict(zip(WINDOW_PLAN_FIELDS, _window_plan(device, B, H, W, C, Cq, nh, w)))


def _window_operands(x, wqkv, bqkv, bias, mask, wp, bp, nh):
    """K13's weights as the kernels take them for x (B, H, W, C): (wqkv,
    bqkv, wp, bp) with each head's rows zero-padded where needed (wqkv
    (3 Cq, C): the LayerNorm runs on x's own C columns), Cq and the window
    side; raises on shapes K13 cannot take.  Launches nothing."""
    B, H, W, C = x.shape
    N = bias.shape[-1]
    w = int(round(N ** 0.5))
    if w * w != N:
        raise ValueError(f"window_attn: {N} tokens are no square window")
    hd16, Cq = check_window_attn_shape(B, H, W, C, nh, w)
    nW = (H // w) * (W // w)
    if (tuple(bias.shape) != (nh, N, N) or tuple(wqkv.shape) != (3 * C, C)
            or bqkv.numel() != 3 * C or tuple(wp.shape) != (C, C) or bp.numel() != C
            or (mask is not None and tuple(mask.shape) != (nW, N, N))):
        raise ValueError("window_attn: bias (nh, N, N), mask (nW, N, N), wqkv (3C, C), "
                         "bqkv (3C), wp (C, C), bp (C)")
    if Cq != C:  # zero-padded heads
        wqkv, bqkv = _pad_heads(wqkv, nh, hd16, 3).contiguous(), _pad_heads(bqkv, nh, hd16, 3)
        wp, bp = _pad_out_proj(wp, bp, nh, hd16)
    return (wqkv, bqkv.contiguous(), wp, bp), Cq, w


def _sra_launch(x, ln_w, ln_b, wq, bq, k, v, wp, bp, nh, eps):
    cd = x.dtype
    B, N, C = x.shape
    (wq, bq, k, v, wp, bp), Cq = _sra_operands(x, wq.to(cd), bq, k.to(cd), v.to(cd), wp.to(cd),
                                               bp, nh)
    check_args(x=(x, BF16), ln_w=(ln_w, F32), ln_b=(ln_b, F32), wq=(wq, BF16), bq=(bq, F32),
               k=(k, BF16), v=(v, BF16), wp=(wp, BF16), bp=(bp, F32))
    if ln_w.numel() != C or ln_b.numel() != C:
        raise ValueError(f"sra: LN parameters must have {C} elements")
    out = torch.empty(B, N, C, device=x.device, dtype=x.dtype)
    # the wide route's q, then its merged heads (:func:`check_sra_shape`)
    scratch = torch.empty_like(out) if check_sra_shape(C, nh, k.shape[2])[2] else None
    _native.launch("sra_launch", x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wq.data_ptr(),
                   bq.data_ptr(), k.data_ptr(), v.data_ptr(), wp.data_ptr(), bp.data_ptr(),
                   out.data_ptr(), None if scratch is None else scratch.data_ptr(), B, N, C, nh,
                   k.shape[2], ctypes.c_float(_scale(C // nh)), ctypes.c_float(eps),
                   _native.stream_handle(x))
    sra.launches += 1
    return out


sra.launches = 0


def window_attn(x, ln_w, ln_b, wqkv, bqkv, bias, mask, wp, bp, nh, eps=1e-5):
    """Kernel K13 on CUDA tensors, :func:`window_attn_ref` on CPU tensors;
    under autograd in bf16 (and on the card) :class:`WindowAttn`."""
    with span("K13 window_attn"):
        args = (x, ln_w, ln_b, wqkv, bqkv, bias, mask, wp, bp)
        if needs_grad(*args) and (on_card(x) or x.dtype == torch.bfloat16):
            return WindowAttn.apply(*args, nh, eps)
        if on_card(x):
            return _window_attn_launch(*args, nh, eps)
        return window_attn_ref(*args, nh, eps)


def _window_attn_launch(x, ln_w, ln_b, wqkv, bqkv, bias, mask, wp, bp, nh, eps):
    cd = x.dtype
    wqkv, wp, bias = wqkv.to(cd), wp.to(cd), bias.float().contiguous()
    mask = None if mask is None else mask.float().contiguous()
    check_args(x=(x, BF16), ln_w=(ln_w, F32), ln_b=(ln_b, F32), wqkv=(wqkv, BF16),
               bqkv=(bqkv, F32), bias=(bias, F32), wp=(wp, BF16), bp=(bp, F32),
               **({} if mask is None else {"mask": (mask, F32)}))
    B, H, W, C = x.shape
    if ln_w.numel() != C or ln_b.numel() != C:
        raise ValueError(f"window_attn: LN parameters must have {C} elements")
    (wqkv, bqkv, wp, bp), Cq, w = _window_operands(x, wqkv, bqkv, bias, mask, wp, bp, nh)
    qkv = torch.empty(B * H * W, 3 * Cq, device=x.device, dtype=torch.bfloat16)
    out = torch.empty(B, H, W, Cq, device=x.device, dtype=x.dtype)
    _native.launch("window_attn_launch", x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                   wqkv.data_ptr(), bqkv.data_ptr(), bias.data_ptr(),
                   None if mask is None else mask.data_ptr(), wp.data_ptr(), bp.data_ptr(),
                   qkv.data_ptr(), out.data_ptr(), B, H, W, C, Cq, nh, w,
                   ctypes.c_float(_scale(C // nh)), ctypes.c_float(eps),
                   _native.stream_handle(x))
    window_attn.launches += 1
    return out if Cq == C else out[..., :C].contiguous()


window_attn.launches = 0


class Sra(torch.autograd.Function):
    """K12 forward (its plain version on CPU tensors); backward: the VJP of
    :func:`sra_ref` by recomputation (``_sra_bwd``, fused_attn.py:163-165)."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wq, bq, k, v, wp, bp, nh, eps):
        ctx.save_for_backward(x, ln_w, ln_b, wq, bq, k, v, wp, bp)
        ctx.nh, ctx.eps = nh, eps
        args = (x, ln_w, ln_b, wq, bq, k, v, wp, bp, nh, eps)
        return _sra_launch(*args) if on_card(x) else sra_ref(*args)

    @staticmethod
    def backward(ctx, g):
        grads = _native.recompute_vjp(lambda *a: sra_ref(*a, ctx.nh, ctx.eps), ctx.saved_tensors,
                                      ctx.needs_input_grad[:9], g)
        return (*grads, None, None)


class WindowAttn(torch.autograd.Function):
    """K13 forward (its plain version on CPU tensors); backward: the VJP of
    :func:`window_attn_ref` by recomputation, none for the mask
    (``_wattn_bwd``, fused_attn.py:343-350)."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wqkv, bqkv, bias, mask, wp, bp, nh, eps):
        ctx.save_for_backward(x, ln_w, ln_b, wqkv, bqkv, bias, mask, wp, bp)
        ctx.nh, ctx.eps = nh, eps
        args = (x, ln_w, ln_b, wqkv, bqkv, bias, mask, wp, bp, nh, eps)
        return _window_attn_launch(*args) if on_card(x) else window_attn_ref(*args)

    @staticmethod
    def backward(ctx, g):
        needs = list(ctx.needs_input_grad[:9])
        needs[6] = False  # the mask
        grads = _native.recompute_vjp(lambda *a: window_attn_ref(*a, ctx.nh, ctx.eps),
                                      ctx.saved_tensors, needs, g)
        return (*grads, None, None)
