"""Smoke run of the PyTorch port (tramba_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. device    a CUDA card is present; prints its name and power limit
  2. build     nvcc builds kernels K1-K14 from tramba_tpu_torch/csrc, and
               g++ the host-side preprocessing library of
               tramba_tpu_torch/data/native.py; the seconds of each build
  3. kernels   each kernel vs its plain PyTorch version on the card, at the
               shapes of the 384px forwards: Tramba-V's K1-K4 in fp32
               (rtol 1e-3, atol 1e-4), then in bf16 K1-K4 and K5-K7, and K2
               as _lgp_pallas (one-slot identity table); Tramba-P's and
               Tramba-S's encoder kernels K11 ln_dwmlp, K12 sra and K13
               window_attn (shifted and unshifted) in bf16 at B2 and B16,
               with weights at fan-in scale, an N(0, 1) relative-position
               bias and output bias 0, each shape also holding its plain
               version with a planted fault (K11 centre tap only; K12
               uniform softmax; K13 no bias, uniform softmax, no mask) to
               the same check, which it must fail; K11, K12 and K13 also
               launched twice and compared bit for bit, with their native
               launches a call (K11 1, or 2 where its plan splits the
               hidden chunks; K12 1 and K13 2, no LayerNorm launch), the
               library's plans equal to ops/encoder_stages.py's, whose
               mirrors of their splits pass the check at B2 and fail it
               with each planted fault that bears (K11: h not zero outside
               the image, the halo cut at the tile edge, no last chunk, no
               last split; K12: head slices swapped in the merged row, row
               tiles from row 0, padded keys not masked, no second key
               pass; K13: window 0's mask on every window, every row
               group's queries from row 0, heads swapped in the merged
               row), K12 also at PVT stage 3's 512 px shape (256 keys), each
               timed beside the same function as PyTorch's own calls
               ("lib": a yardstick the port never calls); K1-K4 (fp32,
               bf16) and K5-K7 at Tramba-P's decoder widths 320/128/64 and
               at Tramba-R's 512/256 (Tramba-S's decoder has Tramba-V's), and
               K7 at the shape of Queue 2 #21 (_dwms_pallas2's own test:
               12 x 8 px, d 16, hidden 256); bf16 outputs at rtol
               1.6e-2, atol 1e-2; then the training kernels at every
               shape of the train steps of Tramba-V (and -S), -P and -R:
               K1's and K2's train variants in fp32
               (fp32 tolerance) and bf16, K8 in fp32 (max abs error <= 1e-4 x
               the largest magnitude of each output) and bf16, and K9
               ln_mlp_bwd and K10 ln_dwms_mlp_bwd (bf16 adjoints: <= 1e-2 x
               the largest magnitude of each output); K14 linear_scan in fp32,
               forward and reversed, at the shapes the parallel layer
               launches (the tensor-parallel core at 96/48/24/12 px, the
               decoder's K = 8 line core, an SS2D of d_state 16) and at a
               ragged shape (L and C no multiple of the segment and of the
               block's channels), each launched twice and compared bit for
               bit, with one native launch a call and the library's plan
               equal to ops/scan_segments.py's, whose mirror at the
               kernel's segments passes the check; each with L > 256 also
               holding the plain version with the carry dropped between
               256-row chunks, and the mirror with the carry dropped
               between segments or the running product of a taken over a
               walker's whole rows, which must fail; K1 at B1 and K8 at
               B4 (the forward's and the train step's batches) at the
               96 px raster and line SS2Ds, fp32 and bf16, each launched
               twice and compared bit for bit, with the segment mirror
               (ops/scan_segments.py) at the kernels' own segment length
               passing the same check and, with the carry between
               segments dropped, failing it, and K8's launches by kernel
               name (torch.profiler); K2 ss2d_merge (fp32 and bf16, both
               variants, K = 1 / 4 / 8, at every shape above) and K6 ln_mlp
               (every d) each launched twice and compared bit for bit, each
               shape also holding its plain version with planted faults to
               the same check, which it must fail (K2: the last direction
               left out of the gather; the last 16 channels of D left out
               of the product; K6: the last 64 hidden units, one
               warpgroup's slice of its last chunk, left out); likewise K7
               ln_dwms_mlp (every shape) and K9 ln_mlp_bwd (every shape),
               each launched twice and compared bit for bit, with its
               native launches a call (the library's count), the plain
               mirror of its stage split
               (ops/ffn_stages.py) with planted faults failing the same check
               (K7: no 3x3 taps; h not zero outside the image; the last
               hidden chunk left out; K9: the LN adjoint's mean term left
               out; one column group's share of its row sums left out, where
               stage (c) splits d into groups); likewise K5 prologue (every
               shape: one native launch, the LayerNorm folded in; the tile
               mirror ops/prologue_stages.py passes the check at the
               kernel's own plan, and fails it with u not zero outside the
               image, the halo's ring of rows not normalised, or the halo
               clamped to the image's edge) and K10 ln_dwms_mlp_bwd (every
               shape: 6 native launches a call; the merged-tap mirror with
               dacc not zero outside, no identity in dh, or dk3 taken
               off-centre); likewise K3 expand_ln and K4 final_head (every
               shape of Tramba-V, -P and -R, fp32 and bf16, and Tramba-V's
               bf16 shapes again at B16: one native launch a call, the plan
               the library reports equal to ops/expand_stages.py's, whose
               block mirror passes the check and fails it with p1 and p2
               swapped in the store, the padded columns left in the
               statistics or the last K chunk left out, K4 also with the
               mean left out of the head sum); each of K2-K7, K9 and K10
               printed beside its matrix products alone as torch.matmul on
               the same operands ("gemm": a reference for what the tensor
               cores give at that shape, never called by the port); native
               launches a call are the library's own count of its kernel
               launches, read around three calls that must agree; errors,
               times, and each kernel's bound (bytes over the HBM rate or,
               per type of operation, its count over that type's peak
               rate: the largest); last, K1 and K2 over each of the other
               scan orders (line4, spiral, spiral8, hilbert, diagonal,
               diagonal8, ab1, ab2) at 48 px, d_model 256, fp32 and bf16,
               where the K1 check must also reject the plain version
               reading its last direction's table backwards and K2's
               planted faults fail as above, and K1's and K2's train
               variants and K8 over spiral8 (K = 8) in both dtypes
  4. model     full-width Tramba-V-TSOD, Tramba-P-TSOD, Tramba-S-TSOD,
               Tramba-R-TSOD and BaseUMamba-SOD at
               384px, seeded weights, batch 2 on the card, each in fp32
               (TF32 off) and in bf16: head shapes, finite values, launches
               per forward as the model's modules give them (Tramba-V fp32
               and bf16: K1 33, K2 33, K3 9, K4 1; bf16 also K5 33, K6 24, K7
               6; Tramba-P and -S: K1 12, K2 12, K3 9, K4 1, bf16 also K5 12,
               K7 6, and K6 3, K12 41, K11 38 (Tramba-P) or K6 25, K13 22
               (Tramba-S); Tramba-R (its ResNet-50 in cuDNN, three heads):
               K1 8, K2 8, K3 6, K4 1, bf16 also K5 8, K6 2, K7 4;
               BaseUMamba: K1 27, K2 27, K3 3, K4 1, bf16 also K5 27, K6
               27; no K11-K13 in fp32); the same weights and image
               on the CPU (plain versions, batch 1) agree with mean abs
               difference <= 1e-3 (fp32) per head, and in bf16 <= 2e-2 or,
               where bf16's own noise is larger, <= 1.25 x the CPU's bf16-vs-
               fp32 difference on that head; and the analytic FLOP count
               (``utils/profiling.analytic_model_flops``, the CPU run's
               plain versions) of Tramba-V and BaseUMamba at batch 1
  5. dump      ``python -m tramba_tpu_torch.dump --measure_fps`` on synthetic
               TSOD10K-style images writes one map per image at its original
               size, then runs the 200-iteration FPS loop; then the same dump
               with ``--dtype bfloat16``, for Tramba-V, -P, -S and -R; then
               ``python -m tramba_tpu_torch.dump_sod`` (BaseUMamba, fp32 and
               ``--dtype bfloat16``) over two datasets into the one folder
               ``<image_save_path>/<method>/SOD`` at the images' sizes, and
               ``python -m tramba_tpu_torch.evaluate_sod`` / ``evaluate_tsod``
               on the fp32 maps: results rows of finite metrics, PR curves
  6. timing    ms per forward: bf16 at batch 1, 8 and 16 and fp32 at 1 for
               each model, Tramba-V's fp32 also at 8; then Tramba-P's and
               -S's bf16 B1 in turns with a copy whose encoder weights are
               cast to bf16 once (the cost of the per-call casts)
  7. profile   device time of the bf16 forward by kernel group (torch.profiler)
               and the device's idle share, at B1 and B16 for each model
  8. train     fp32, then bf16 training of Tramba-V, -S, -P, -R and
               BaseUMamba at full width, batch 4: one train
               step launches exactly the kernels the model's modules give
               (Tramba-V fp32: K1 33, K2 33, K8 33, K3 9, K4 1 and no K5-K7,
               K9, K10; bf16 also K5 33, K6 24, K9 24, K7 6, K10 6), and
               leaves every parameter a finite gradient (Tramba-R's stage-4
               parameters none: that stage feeds no head); the loss falls
               over 10 steps on one batch; ms per step, peak memory and the
               device time by kernel group; a reduced-depth step (Tramba-V
               and BaseUMamba dims 128, depths (1, 1, 2, 1), 96 px; Tramba-S
               depths 2 per
               stage, 96 px; Tramba-P depth 1 per stage, 128 px; Tramba-R one
               bottleneck per stage, 64 px, in train() with drop path 0 so
               that BatchNorm takes batch statistics) against the CPU's
               plain step: fp32 loss rtol 1e-4 and per-parameter gradient
               (and Tramba-R's running statistic) relative norm <= 1e-3;
               bf16 both <= 2e-2 or 1.25 x the CPU's own bf16-vs-fp32 gap of
               that value, whichever is larger
  8b. loader   16 seeded 1920x1080 frames with masks in the TSOD10K layout:
               the native resizes byte-equal to PIL's on each (bilinear
               image, nearest mask) and ``preprocess_eval_batch`` equal to
               ``eval_transform`` (atol 1e-6); the median ms per B8 eval
               batch to 384 px through ``BatchLoader`` (8 threads, two
               batches an epoch) with ``static_resize`` on PIL and on the
               native resizes, and with each batch decoded and then
               preprocessed by ``preprocess_eval_batch`` in the same pool,
               in turns; and the median ms of one frame's resize alone on
               each route; beside the card's name and power limit and the
               host's CPU model
 9. run       ``tramba_tpu_torch.run`` (the training CLI) on a synthetic
               TSOD10K-layout dataset (8 train, 4 test images), in fp32 and
               then ``--dtype bfloat16``: 2 epochs with the in-loop eval,
               record and best-MAE weights, exact launch counts; a
               weights-only ``--resume <best-MAE file>`` to epoch 5, which
               writes the rolling resume dict (every 5 epochs); then
               ``python -m tramba_tpu_torch.run --resume last`` to epoch 6;
               then Tramba-S, -P and -R at reduced depth in bf16 with
               ``--pretrained_path auto``, which finds the released file
               name under ``--pretrained_model``: there the phase writes a
               synthetic encoder checkpoint under the upstream key names,
               which the CLI grafts before one epoch of 2 steps
 10. parallel  an NCCL world of one process: the full-width Tramba-V-TSOD
               forward at batch 2 on each parallel SS2D backend
               (tensor_parallel, seq_parallel, hybrid_tp_sp), fp32 and bf16,
               with exact launches (K14 once per SS2D), heads against the
               default route's of phase 4 (fp32 mean abs <= 1e-3, bf16
               phase 4's gate: max(2e-2, 1.25 x the CPU's bf16-vs-fp32
               gap)), ms in turns with the default route; one fp32
               train step at batch 2 in each of the dry run's four grids
               (dp, dp x tp, dp x sp, dp x tp x sp) with exact launches (K14
               33 forward + 33 reversed on the parallel backends), ms per
               step, peak memory and a profile; then
               ``python -m tramba_tpu_torch.dryrun --n 1``

Nothing is cut but where a phase says so (the reduced-depth steps of phase
8 and phase 9's Tramba-S, -P and -R runs): every model runs at full depth
and width.  The CPU comparisons of phase 4 run at batch 1.
The last lines are the kernels' JSON summary, the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# kernel vs plain version at full width: the kernels sum in another order and
# use CUDA's expf/log1pf/erff, and K1's scan runs up to 9216 steps
KERNEL_TOL = dict(rtol=1e-3, atol=1e-4)
# bf16 outputs: the same rounding points as the plain versions, but another
# summation order may flip a rounding (torch's bf16 rtol)
KERNEL_TOL_BF16 = dict(rtol=1.6e-2, atol=1e-2)
HEAD_MEAN_ABS_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}  # card vs CPU, per head
# Two bf16 runs that sum in other orders round the residual stream apart, and
# the gap grows by about one rounding per block: at full depth with seed-0
# weights it reaches bf16's own distance from fp32 (2.8e-2 on the 24 px head).
# So a bf16 head may also differ by up to this multiple of the CPU's
# bf16-vs-fp32 difference on the same head.
BF16_NOISE_FACTOR = 1.25
# K8 vs its plain version: sums over whole sequences and batches in another
# order, so each output's max abs error is held to this share of its largest
# magnitude
BWD_REL_TOL = 1e-4
# the bf16 adjoints (K8 on bf16 x and g_y, K9, K10) round dx, or dh before the
# long sums of dW1 and dx, to bf16, so one flipped rounding moves a whole sum:
# each output's max abs error is held to this share of its largest magnitude
BWD_REL_TOL_BF16 = 1e-2
# reduced-depth train step, card vs CPU: fp32; bf16 as the forward's heads
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL = 1e-4, 1e-3
NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16"}
# one H100 SXM (NVIDIA's data sheet, dense rates): bf16 on the tensor cores,
# fp32 outside them (TF32 is off), and the HBM rate; a kernel's bound is the
# largest of its bytes over the HBM rate and each type's operations over its rate
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


# the models of phases 4-7, and what phase 6 times: (dtype, ((batch, reps), ...))
MODELS = ("Tramba-V-TSOD", "Tramba-P-TSOD", "Tramba-S-TSOD", "Tramba-R-TSOD", "BaseUMamba-SOD")
_BF16_TIMED = (torch.bfloat16, ((1, 20), (8, 5), (16, 5)))
TIMED = {"Tramba-V-TSOD": ((torch.float32, ((1, 20), (8, 5))), _BF16_TIMED),
         "Tramba-P-TSOD": ((torch.float32, ((1, 20),)), _BF16_TIMED),
         "Tramba-S-TSOD": ((torch.float32, ((1, 20),)), _BF16_TIMED),
         "Tramba-R-TSOD": ((torch.float32, ((1, 20),)), _BF16_TIMED),
         "BaseUMamba-SOD": ((torch.float32, ((1, 20),)), _BF16_TIMED)}
# the models whose analytic FLOP count (fvcore's accounting) phase 4 prints
FLOP_COUNTED = ("Tramba-V-TSOD", "BaseUMamba-SOD")


_START = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - _START:.0f} s)", flush=True)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wrappers():
    from tramba_tpu_torch.ops import fused_attn as ta
    from tramba_tpu_torch.ops import fused_expand as te
    from tramba_tpu_torch.ops import fused_mlp as tm
    from tramba_tpu_torch.ops import fused_prologue as tp
    from tramba_tpu_torch.ops import fused_ss2d as tf
    from tramba_tpu_torch.ops import selective_scan as ts

    return (tf.ss2d_scan, tf.ss2d_merge, tf.ss2d_scan_bwd, te.expand_ln, te.final_head,
            tp.prologue, tm.ln_mlp, tm.ln_dwms_mlp, tm.ln_mlp_bwd, tm.ln_dwms_mlp_bwd,
            tm.ln_dwmlp, ta.sra, ta.window_attn, ts.linear_scan)


def reset_counts():
    for w in wrappers():
        w.launches = 0


def read_counts():
    torch.cuda.synchronize()
    return {w.__name__: w.launches for w in wrappers()}


def expected_launches(model, train: bool) -> dict:
    """Kernel launches of one forward (``train=False``) or one train step of
    ``model``, from its modules: each SS2D of the default route runs K1 and
    K2, and in bf16 K5; each SS2D of a parallel backend (or of d_state > 1)
    runs K14 once forward and once reversed in the backward; each
    bf16 FFN runs K6 (Mlp) or K7 (DWMSMlp); each expand K3, the head K4; a
    train step adds the backwards K8 per SS2D and K9 / K10 per bf16 FFN.  In
    bf16 each Swin block runs K13 and each PVTv2 block K12 and K11 where the
    kernels' gates hold at the block's map (from the patch embeds' strides)."""
    from tramba_tpu_torch.models.pvt import PVTv2Encoder
    from tramba_tpu_torch.models.swin import SwinBlock
    from tramba_tpu_torch.nn.layers import DWMSMlp, FinalPatchExpandX4, Mlp, _Expand
    from tramba_tpu_torch.nn.ssm import SS2D
    from tramba_tpu_torch.ops import fused_attn as ta
    from tramba_tpu_torch.ops import fused_mlp as tm

    n = dict.fromkeys((w.__name__ for w in wrappers()), 0)
    # in bf16 at 384 px the gates hold in every block that JAX's TPU routing
    # fuses: K13 in all Swin blocks that run (22 in Swin-B), K12 in all PVT
    # blocks (41 in PVTv2-b4) and K11 in those of stages 1-3 (38)
    full = model.dtype == torch.bfloat16 and getattr(model, "img_size", 0) == 384
    swin_blocks = 0
    for m in model.modules():
        bf16 = getattr(m, "dtype", None) == torch.bfloat16
        if isinstance(m, SwinBlock):
            C, r = m.norm1.normalized_shape[0], m.resolution
            n["window_attn"] += ta.window_attn_fusable(r, r, C, m.attn.num_heads, m.window,
                                                       model.dtype)
            swin_blocks += 1
        elif isinstance(m, PVTv2Encoder):
            res = model.img_size
            depths = [len(getattr(m, f"block{s}")) for s in range(1, m.n_stages + 1)]
            for s in range(1, m.n_stages + 1):
                conv = getattr(m, f"patch_embed{s}").proj
                res = (res + 2 * conv.padding[0] - conv.kernel_size[0]) // conv.stride[0] + 1
                for blk in getattr(m, f"block{s}"):
                    C, sr = blk.norm1.normalized_shape[0], blk.attn.sr_ratio
                    lk = (res // sr) ** 2
                    n["sra"] += ta.sra_fusable(res * res, C, blk.attn.num_heads, lk, model.dtype)
                    n["ln_dwmlp"] += tm.dwmlp_fusable(res, res, C, blk.mlp.fc1.out_features,
                                                      model.dtype)
            if full and (n["sra"], n["ln_dwmlp"]) != (sum(depths), sum(depths[:3])):
                raise AssertionError(f"PVT depths {depths}: K12 {n['sra']}, K11 {n['ln_dwmlp']}")
        elif isinstance(m, SS2D) and (m.backend is not None or m.d_state > 1):
            n["linear_scan"] += 1 + train
        elif isinstance(m, SS2D):
            n["ss2d_scan"] += 1
            n["ss2d_merge"] += 1
            n["prologue"] += bf16
            n["ss2d_scan_bwd"] += train
        elif isinstance(m, (Mlp, DWMSMlp)) and bf16:
            name = "ln_mlp" if isinstance(m, Mlp) else "ln_dwms_mlp"
            n[name] += 1
            n[name + "_bwd"] += train
        elif isinstance(m, _Expand):
            n["expand_ln"] += 1
        elif isinstance(m, FinalPatchExpandX4):
            n["final_head"] += 1
    if full and n["window_attn"] != swin_blocks:
        raise AssertionError(f"{swin_blocks} Swin blocks, K13 {n['window_attn']}")
    return n


def ops(dt, products, simt=0):
    """Operations of one call by type: ``products`` in dtype ``dt``'s type (the
    tensor-core products of bf16 operands, fp32 ones outside them), ``simt`` in
    fp32 outside the tensor cores."""
    out = {"fp32": simt}
    out[NAMES[dt]] = out.get(NAMES[dt], 0) + products
    return out


def bound(tensors, flops):
    """(bound_ms, bound_by): the least time one H100 could take for a call
    that reads each input once and writes each output once (``tensors``) and
    does ``flops`` (operations by type, as :func:`ops` gives them).  The
    tensor cores and the fp32 pipes run at the same time, so the operations
    take the longest of their types' times, not the sum."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(n / PEAK_OPS_PER_S[k] for k, n in flops.items())
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


class Checks:
    """Phase 3 results: {(kernel, tag): [(shape label, max_abs_err, ms, plain_ms,
    bound_ms, bound_by)]}; the tag is the dtype's name, or "fp32 train" /
    "bf16 train" for the training kernels."""

    def __init__(self):
        self.rows = {}

    def compare(self, name, dt, label, kernel, plain, reps, inputs, flops, plain_warmup=1,
                tag=None, rel_tol=None, gemm=None, lib=None):
        """``kernel`` and ``plain`` return a tensor or a tuple of tensors.  With
        ``rel_tol`` each output's max abs error must be <= rel_tol x its
        largest magnitude; else assert_close at the dtype's tolerance.
        ``inputs`` (the kernel's tensors) and ``flops`` (:func:`ops`) give the
        call's bound.  ``gemm``: the kernel's matrix products alone as
        torch.matmul calls on the same operands, timed beside it as a
        reference for what the tensor cores give at that shape (the port
        never calls it).  ``lib``: the same function as a chain of PyTorch's
        own calls (cuBLAS, cuDNN, SDPA), timed beside it as a yardstick only
        (printed as "lib")."""
        tag = tag or NAMES[dt]
        got = kernel()
        plain_ms = None
        if plain_warmup == 0:  # this first call is the plain version's timed one
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            want = plain()
            end.record()
            end.synchronize()
            plain_ms = start.elapsed_time(end)
        else:
            want = plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = rel = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            tol = KERNEL_TOL_BF16 if g.dtype == torch.bfloat16 else KERNEL_TOL
            g, w = g.float(), w.float()
            e = (g - w).abs().max().item()
            err = max(err, e)
            if rel_tol is None:
                rel = max(rel, ((g - w).abs() / w.abs().clamp_min(1e-3)).max().item())
                torch.testing.assert_close(g, w, **tol,
                                           msg=lambda m: f"{name} {tag} {label} output {i}: {m}")
            else:
                scale = w.abs().max().item()
                rel = max(rel, e / max(scale, 1e-30))
                if not e <= rel_tol * scale:
                    raise AssertionError(f"{name} {tag} {label} output {i}: max abs error {e} "
                                         f"> {rel_tol} x {scale}")
        bound_ms, bound_by = bound((*inputs, *got), flops)
        del got, want
        ms = cuda_ms(kernel, reps)
        if plain_ms is None:
            plain_ms = cuda_ms(plain, 1, warmup=plain_warmup)
        gemm_ms = f" gemm {cuda_ms(gemm, reps):.4f} ms" if gemm is not None else ""
        if lib is not None:
            gemm_ms += f" lib {cuda_ms(lib, reps, warmup=2):.4f} ms"
        self.rows.setdefault((name, tag), []).append((label, err, ms, plain_ms, bound_ms,
                                                      bound_by))
        what = "err/max|plain|" if rel_tol is not None else "max_rel_err"
        print(f"{name:15s} {tag:10s} {label:34s} max_abs_err {err:.3e} {what} {rel:.3e} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms "
              f"({bound_by}){gemm_ms}", flush=True)

    @staticmethod
    def planted(name, label, want, faults, tol=KERNEL_TOL_BF16, rel_tol=None):
        """Proof that :meth:`compare`'s check (``tol``: bf16's unless given;
        with ``rel_tol`` the per-output max-abs check) can see a wrong kernel
        at these inputs: each of ``faults`` (fault name -> the plain version
        with that fault planted) must fail the check against ``want``, the
        plain version's output (a tensor or a tuple)."""
        want = want if isinstance(want, tuple) else (want,)
        for fault, fn in faults.items():
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            failed, err, share = False, 0.0, 0.0
            for g, w in zip(got, want):
                g, w = g.float(), w.float()
                e = (g - w).abs().max().item()
                err = max(err, e)
                if rel_tol is None:
                    bad = ~torch.isclose(g, w, **tol)
                    share = max(share, bad.float().mean().item())
                    failed |= bool(bad.any())
                else:
                    scale = w.abs().max().item()
                    share = max(share, e / max(scale, 1e-30))
                    failed |= not e <= rel_tol * scale
            what = "of outputs outside the check" if rel_tol is None else "x max|plain| at worst"
            print(f"{name:15s} planted {fault!r:18s} {label:34s} max_abs_err {err:.3e}, "
                  f"{share:.3f} {what}", flush=True)
            if not failed:
                raise AssertionError(f"{name} {label}: a kernel with the fault {fault!r} "
                                     "would pass the check")


# (order, map size, d_model, window/rate): every SS2D shape of the main path --
# encoder stages (raster), decoder blocks (line), guides (window and dilation)
SS2D_SHAPES = (("raster", 96, 128, 0), ("raster", 48, 256, 0), ("raster", 24, 512, 0),
               ("raster", 12, 1024, 0), ("line", 96, 128, 0), ("line", 48, 256, 0),
               ("line", 24, 512, 0), ("window", 96, 128, 16), ("window", 48, 256, 12),
               ("window", 24, 512, 8), ("dilation", 96, 128, 4), ("dilation", 48, 256, 4),
               ("dilation", 24, 512, 4))


# Tramba-P's decoder: the same SS2Ds at its widths 320 / 128 / 64 (d_inner
# 640 / 256 / 128, dt_rank 20 / 8 / 4); Tramba-S's decoder has Tramba-V's
SS2D_SHAPES_P = (("line", 24, 320, 0), ("line", 48, 128, 0), ("line", 96, 64, 0),
                 ("window", 24, 320, 8), ("window", 48, 128, 12), ("window", 96, 64, 16),
                 ("dilation", 24, 320, 4), ("dilation", 48, 128, 4), ("dilation", 96, 64, 4))
# Tramba-R's three-stage decoder: the same SS2Ds at its widths 512 / 256 on
# 48 / 96 px maps (d_inner 1024 / 512, dt_rank 32 / 16)
SS2D_SHAPES_R = (("line", 48, 512, 0), ("line", 96, 256, 0), ("window", 48, 512, 12),
                 ("window", 96, 256, 16), ("dilation", 48, 512, 4), ("dilation", 96, 256, 4))
# the scan orders of Queue 1 item 11 (no model at 384 px runs them; BaseUMamba's
# VSSMDecoderBlock takes any): each at one decoder shape, 48 px with d_model
# 256, where SS2D_SHAPES has raster and line
NEW_ORDER_SHAPES = tuple((kind, 48, 256, 0) for kind in (
    "line4", "spiral", "spiral8", "hilbert", "diagonal", "diagonal8", "ab1", "ab2"))
# (map size, C, factor): PatchExpand (f=2) and FreqExpand2D (f=4) inputs
EXPAND_SHAPES = ((12, 1024, 2), (24, 512, 2), (48, 256, 2), (12, 512, 4), (24, 256, 4),
                 (48, 128, 4))
EXPAND_SHAPES_P = ((12, 512, 2), (24, 320, 2), (48, 128, 2), (12, 320, 4), (24, 128, 4),
                   (48, 64, 4))
EXPAND_SHAPES_R = ((24, 1024, 2), (48, 512, 2), (24, 512, 4), (48, 256, 4))


def ss2d_case(dev, gen, dt, kind, H, d_model, param, B):
    """A seeded SS2D of one main-path shape and an input for its core."""
    from tramba_tpu_torch.nn.init import init_weights
    from tramba_tpu_torch.nn.ssm import SS2D
    from tramba_tpu_torch.ops.scan_orders import get_order, order_tables

    m = init_weights(SS2D(d_model, k_group=get_order(kind, H, H, param).K, scan_kind=kind,
                          scan_param=param), gen).to(dev)
    K, D = m.k_group, m.d_inner
    x = torch.nn.functional.silu(torch.randn(B, H * H, D, generator=gen)).to(dev, dt)
    core = (m.x_proj_weight.data, m.dt_projs_weight.data, m.dt_projs_bias.data,
            m.A_logs.data.view(K, D, 1), m.Ds.data.view(K, D))
    idx, inv = order_tables(kind, H, H, param, dev)
    return m, x, core, idx, inv, f"{kind}{param or ''} {H}px B{B} K{K} D{D}"


def scan_ops(x, core):
    """K1: the projections (C = R + 2 outputs of D, then dt of R) and about
    12 fp32 operations per step of the recurrence, per (b, k, l, d)."""
    B, L, D = x.shape
    K, C, _ = core[0].shape
    return ops(torch.float32, 2 * B * K * L * D * (2 * C - 2), 12 * B * K * L * D)


def merge_ops(ys, w_out):
    """K2: the out projection in w_out's type; the K-way sum, LN and GELU."""
    B, K, L, D = ys.shape
    return ops(w_out.dtype, 2 * B * L * D * w_out.shape[0], (K + 10) * B * L * D)


def check_merge(checks, dt, label, shape, inv, tail, emit=False, tag=None):
    """K2 (``emit``: its train variant) on direction outputs ys of ``shape``
    (B, K, L, D) against its plain version, timed beside the out projection
    alone as torch.matmul on the same operands (the GELU'd rows in w_out's
    dtype); two launches give the same bits; and the check must reject the
    plain version with the last direction left out of the gather (its table
    entries emptied) and, separately, with the last 16 channels of D left
    out of the product.  ys is N(0, 1) and w_out (tail[2]'s shape and dtype)
    N(0, 1 / D), so the output is O(1) and each direction's share of the sum
    shows: an SS2D's own ys carry the skip term Ds x, the same in every
    direction, so without one direction the sum mostly shrinks, which the
    LayerNorm undoes, and the fault would hide under bf16's tolerance."""
    from tramba_tpu_torch.ops import fused_ss2d as tf

    ref = tf.ss2d_merge_train_ref if emit else tf.ss2d_merge_ref
    B, K, L, D = shape
    gen = torch.Generator().manual_seed(B * K * L + D)
    ys = torch.randn(shape, generator=gen).to(inv.device)
    w_out = (torch.randn(tail[2].shape, generator=gen) * D ** -0.5).to(inv.device, tail[2].dtype)
    tail = (tail[0], tail[1], w_out)
    a = torch.nn.functional.gelu(torch.nn.functional.layer_norm(
        tf._merge_sum(ys, inv), (D,), tail[0], tail[1], 1e-5)).to(w_out.dtype).reshape(B * L, D)
    checks.compare("ss2d_merge", dt, label, lambda: tf.ss2d_merge(ys, inv, *tail, emit_ysum=emit),
                   lambda: ref(ys, inv, *tail), reps=5, inputs=(ys, inv, *tail),
                   flops=merge_ops(ys, w_out), tag=tag, gemm=lambda: a @ w_out.t())
    del a
    first, second = ((o if emit else (o,)) for o in
                     (tf.ss2d_merge(ys, inv, *tail, emit_ysum=emit) for _ in range(2)))
    if not all(torch.equal(p, q) for p, q in zip(first, second)):
        raise AssertionError(f"ss2d_merge {label}: two launches differ")
    del first, second
    no_dir = inv.clone()
    no_dir[K - 1] = L  # the last direction's entries: none
    part = w_out.clone()
    part[:, D - 16:] = 0  # the last 16 channels out of the product
    tol = KERNEL_TOL_BF16 if w_out.dtype == torch.bfloat16 else KERNEL_TOL
    checks.planted("ss2d_merge", label, ref(ys, inv, *tail), {
        "no last direction": lambda: ref(ys, no_dir, *tail),
        "no last 16 of D": lambda: ref(ys, inv, *tail[:2], part)}, tol=tol)


def check_ln_mlp(checks, label, args, flops):
    """K6 against its plain version, timed beside its two products alone as
    torch.matmul on the same bf16 operands (bf16(LN(x)) w1^T and the GELU'd
    hidden rows w2^T); two launches give the same bits; and the check must
    reject the plain version with the last hidden chunk (the last 64 hidden
    units, one warpgroup's slice of K6's last chunk) left out."""
    from tramba_tpu_torch.ops import fused_mlp as tm

    x, ln_w, ln_b, w1, b1, w2, b2 = args
    d, hid = x.shape[-1], w1.shape[0]
    y = torch.nn.functional.layer_norm(x.float(), (d,), ln_w, ln_b, 1e-5).to(x.dtype)
    y = y.reshape(-1, d)
    h = torch.nn.functional.gelu((y.float() @ w1.float().t()) + b1).to(x.dtype)
    checks.compare("ln_mlp", torch.bfloat16, label, lambda: tm.ln_mlp(*args),
                   lambda: tm.ln_mlp_ref(*args), reps=10, inputs=args, flops=flops,
                   gemm=lambda: (y @ w1.t(), h @ w2.t()))
    del y, h
    if not torch.equal(tm.ln_mlp(*args), tm.ln_mlp(*args)):
        raise AssertionError(f"ln_mlp {label}: two launches differ")
    short = w2.clone()
    short[:, hid - 64:] = 0
    checks.planted("ln_mlp", label, tm.ln_mlp_ref(*args), {
        "no last chunk": lambda: tm.ln_mlp_ref(x, ln_w, ln_b, w1, b1, short, b2)})


def native_launches(fn) -> int:
    """Kernels one call of ``fn`` launches, from the library's own count of
    its launches (every launch site of csrc/ adds one), read around each of
    three calls; raises unless the three agree.  (torch.profiler on the card
    may miss kernels launched at the start of its window, so it does not
    count them.)"""
    from tramba_tpu_torch.ops import _native

    counts = []
    for _ in range(3):
        n0 = _native.native_launch_count()
        fn()
        counts.append(_native.native_launch_count() - n0)
    torch.cuda.synchronize()
    if len(set(counts)) != 1:
        raise AssertionError(f"three calls launched {counts} kernels")
    return counts[0]


def check_ln_dwms_mlp(checks, label, args, flops):
    """K7 against its plain version, timed beside its two products alone as
    torch.matmul on the same bf16 operands (bf16(LN(x)) w1^T and GELU'd
    hidden rows w2^T); two launches give the same bits; its native launches
    a call; and the check must reject the merged-tap mirror
    (ops/ffn_stages.py) with each planted fault."""
    from tramba_tpu_torch.ops import ffn_stages as fs
    from tramba_tpu_torch.ops import fused_mlp as tm

    x, ln_w, ln_b, w1 = args[:4]
    w2, d = args[-2], x.shape[-1]
    y = torch.nn.functional.layer_norm(x.float(), (d,), ln_w, ln_b, 1e-5).to(x.dtype)
    y = y.reshape(-1, d)
    h = torch.nn.functional.gelu(y.float() @ w1.float().t()).to(x.dtype)
    checks.compare("ln_dwms_mlp", torch.bfloat16, label, lambda: tm.ln_dwms_mlp(*args),
                   lambda: tm.ln_dwms_mlp_ref(*args), reps=10, inputs=args, flops=flops,
                   gemm=lambda: (y @ w1.t(), h @ w2.t()))
    del y, h
    if not torch.equal(tm.ln_dwms_mlp(*args), tm.ln_dwms_mlp(*args)):
        raise AssertionError(f"ln_dwms_mlp {label}: two launches differ")
    n = native_launches(lambda: tm.ln_dwms_mlp(*args))
    print(f"ln_dwms_mlp     {label}: {n:g} native launches a call", flush=True)
    checks.planted("ln_dwms_mlp", label, tm.ln_dwms_mlp_ref(*args),
                   {f: functools.partial(fs.dwms_merged_ref, *args, fault=f)
                    for f in fs.DWMS_FAULTS})


def scan_bwd_ops(x, core):
    """K8: K1's projections recomputed, their two adjoints and the weight
    products (three times K1's), and about 30 fp32 operations per step."""
    B, L, D = x.shape
    K, C, _ = core[0].shape
    return ops(torch.float32, 6 * B * K * L * D * (2 * C - 2), 30 * B * K * L * D)


def check_train_kernels(checks, dev, gen, dt, shapes=SS2D_SHAPES):
    """K1's and K2's train variants and K8 at every SS2D shape of ``shapes``
    (by default Tramba-V's and -S's), B=2, in the compute dtype ``dt``
    (bf16: #13's emit_train; K1 takes bf16 x, K2 a bf16 w_out and writes a
    bf16 y_sum, K8 reads bf16 x and g_y).  K8 gets the
    carries and projections of the plain train forward and a cotangent of the
    pre-LN sum at the scale of the output's."""
    from tramba_tpu_torch.ops import fused_ss2d as tf

    B, tag, chunk = 2, f"{NAMES[dt]} train", tf.scan_chunk()
    rel_tol = BWD_REL_TOL if dt == torch.float32 else BWD_REL_TOL_BF16
    for kind, H, d_model, param in shapes:
        m, x, core, idx, inv, label = ss2d_case(dev, gen, dt, kind, H, d_model, param, B)
        checks.compare("ss2d_scan", None, label,
                       lambda: tf.ss2d_scan(x, idx, *core, emit=True),
                       lambda: tf.ss2d_scan_train_ref(x, idx, *core, chunk), reps=5,
                       inputs=(x, idx, *core), flops=scan_ops(x, core), plain_warmup=0, tag=tag)
        ys, carries, dbc = tf.ss2d_scan_train_ref(x, idx, *core, chunk)
        tail = (m.out_norm.weight.data, m.out_norm.bias.data, m.out_proj.weight.data.to(dt))
        check_merge(checks, None, label, ys.shape, inv, tail, emit=True, tag=tag)
        g_y = torch.randn(x.shape, generator=gen).to(dev, dt)
        args = (x, idx, inv, g_y, carries, dbc, *core)
        checks.compare("ss2d_scan_bwd", None, label, lambda: tf.ss2d_scan_bwd(*args),
                       lambda: tf.ss2d_scan_bwd_ref(*args, chunk), reps=3, inputs=args,
                       flops=scan_bwd_ops(x, core), plain_warmup=0, tag=tag, rel_tol=rel_tol)
        del ys, carries, dbc, g_y, args


def check_segmented_scans(checks, dev, gen):
    """K1 and K8 split each direction's steps into segments joined by a
    carry pass (csrc/ss2d.cu, ss2d_bwd.cu).  At Tramba-V's 96 px raster and
    line SS2Ds, fp32 and bf16: K1 at B1 (the forward's batch) and K8 at B4
    (the train step's) against their plain versions with phase 3's checks,
    and timed; two launches of each give the same bits; the segment mirror
    (ops/scan_segments.py, at the kernels' own segment length) passes the
    same check, and with the carry between segments dropped (h for K1, lam
    for K8) it must fail it.  Then K8's launches by kernel name
    (torch.profiler) at the line shape, B4."""
    from torch.profiler import ProfilerActivity, profile

    from tramba_tpu_torch.ops import fused_ss2d as tf
    from tramba_tpu_torch.ops import scan_segments as sm

    rel_tol = {torch.float32: BWD_REL_TOL, torch.bfloat16: BWD_REL_TOL_BF16}
    for dt in (torch.float32, torch.bfloat16):
        for kind in ("raster", "line"):
            m, x, core, idx, inv, label = ss2d_case(dev, gen, dt, kind, 96, 128, 0, 1)
            B, L, D = x.shape
            K = idx.shape[0]
            seg = tf.scan_segment_steps(B, L, D, K)
            print(f"ss2d_scan {NAMES[dt]} {label}: {-(-L // seg)} segments of {seg} steps, "
                  f"{(D // 32) * -(-L // seg) * K * B} warps", flush=True)
            checks.compare("ss2d_scan", dt, label, lambda: tf.ss2d_scan(x, idx, *core),
                           lambda: tf.ss2d_scan_ref(x, idx, *core), reps=10,
                           inputs=(x, idx, *core), flops=scan_ops(x, core), plain_warmup=0)
            if not torch.equal(tf.ss2d_scan(x, idx, *core), tf.ss2d_scan(x, idx, *core)):
                raise AssertionError(f"ss2d_scan {label}: two launches differ")
            want = tf.ss2d_scan_ref(x, idx, *core)
            la, b, xs, dbcs, _ = sm.scan_terms(x, idx, *core)
            entries = sm.carry_in(*sm.scan_summaries(la, b, seg))
            torch.testing.assert_close(
                sm.scan_outputs(sm.scan_from(la, b, entries, seg), xs, dbcs, core[4])[0], want,
                **KERNEL_TOL)
            checks.planted("ss2d_scan", label, want, {"no segment carry": lambda: sm.scan_outputs(
                sm.scan_from(la, b, torch.zeros_like(entries), seg), xs, dbcs, core[4])[0]},
                tol=KERNEL_TOL)
            del want, la, b, xs, dbcs, entries

            m, x, core, idx, inv, label = ss2d_case(dev, gen, dt, kind, 96, 128, 0, 4)
            B, L, D = x.shape
            seg = tf.scan_segment_steps(B, L, D, K, bwd=True)
            _, carries, dbc = tf.ss2d_scan(x, idx, *core, emit=True)
            g_y = torch.randn(x.shape, generator=gen).to(dev, dt)
            args = (x, idx, inv, g_y, carries, dbc, *core)
            checks.compare("ss2d_scan_bwd", None, label, lambda: tf.ss2d_scan_bwd(*args),
                           lambda: tf.ss2d_scan_bwd_ref(*args, tf.scan_chunk()), reps=3,
                           inputs=args, flops=scan_bwd_ops(x, core), plain_warmup=0,
                           tag=f"{NAMES[dt]} train", rel_tol=rel_tol[dt])
            r1, r2 = tf.ss2d_scan_bwd(*args), tf.ss2d_scan_bwd(*args)
            if not all(torch.equal(p, q) for p, q in zip(r1, r2)):
                raise AssertionError(f"ss2d_scan_bwd {label}: two launches differ")
            del r1, r2
            want = tf.ss2d_scan_bwd_ref(*args, tf.scan_chunk())
            terms = sm.adjoint_terms(x, idx, g_y, dbc, *core[1:4])
            E = sm.carry_back(*sm.adjoint_summaries(terms[0], terms[1], seg))

            def adjoint(E_in):
                lam = sm.adjoint_from(terms[0], terms[1], E_in, seg)
                return sm.adjoint_outputs(lam, terms, inv, carries, x.dtype, core[0], core[1],
                                          core[4], tf.scan_chunk())

            worst = 0.0
            for i, (g, w) in enumerate(zip(adjoint(E), want)):
                e, scale = (g.float() - w.float()).abs().max().item(), w.float().abs().max().item()
                worst = max(worst, e / max(scale, 1e-30))
                if not e <= rel_tol[dt] * scale:
                    raise AssertionError(f"segment mirror {label} output {i}: {e} > "
                                         f"{rel_tol[dt]} x {scale}")
            print(f"ss2d_scan_bwd   segment mirror     {label:34s} {worst:.3e} x max|plain| at "
                  "worst", flush=True)
            checks.planted("ss2d_scan_bwd", label, want,
                           {"no segment carry": lambda: adjoint(torch.zeros_like(E))},
                           rel_tol=rel_tol[dt])
            if kind == "line":
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    tf.ss2d_scan_bwd(*args)
                    torch.cuda.synchronize()
                parts = {}
                for e in prof.key_averages():
                    if e.self_device_time_total > 0:
                        m = re.search(r"::(\w+)[<(]", e.key)
                        name = m[1] if m else e.key[:40]
                        parts[name] = parts.get(name, 0.0) + e.self_device_time_total / 1e3
                print(f"ss2d_scan_bwd {NAMES[dt]} {label} by kernel [{card_line()}]: " + "; ".join(
                    f"{k} {t:.4f} ms" for k, t in parts.items()), flush=True)
            del want, terms, E, args, carries, dbc, g_y
    torch.cuda.empty_cache()


def ffn_case(gen, dev, d, dwms):
    """Seeded LN and FFN parameters of width d (hidden 4d) as the modules hold
    them (fp32): [ln_w, ln_b, w1, b1, (k3, c3, k5, c5, k7, c7,) w2, b2]."""
    from tramba_tpu_torch.nn.init import init_weights
    from tramba_tpu_torch.nn.layers import DWMSMlp, Mlp

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

    hid = 4 * d
    m = init_weights((DWMSMlp if dwms else Mlp)(d, hid), gen).to(dev)
    convs = [t for c in (m.dwc3, m.dwc5, m.dwc7)
             for t in (c.dw_conv.weight.data, rnd(hid, scale=0.1))] if dwms else []
    return [rnd(d, scale=0.1, shift=1.0), rnd(d, scale=0.1), m.fc1.weight.data,
            rnd(hid, scale=0.1), *convs, m.fc2.weight.data, rnd(d, scale=0.1)]


# (map, d, DWMS?) of the bf16 train steps' FFN adjoints: K9 at every LN-MLP
# (Tramba-V's and -S's encoder stages, whose widths the guides' FFNs share;
# Tramba-P's and -R's guides), K10 at every DWMS FFN of the decoder blocks
MLP_BWD_SHAPES = ((96, 128, False), (48, 256, False), (24, 512, False), (12, 1024, False),
                  (96, 128, True), (48, 256, True), (24, 512, True))
MLP_BWD_SHAPES_P = ((96, 64, False), (48, 128, False), (24, 320, False), (96, 64, True),
                    (48, 128, True), (24, 320, True))
MLP_BWD_SHAPES_R = ((96, 256, False), (48, 512, False), (96, 256, True), (48, 512, True))


def check_mlp_bwd(checks, dev, gen, shapes=MLP_BWD_SHAPES):
    """K9 and K10 at every shape of ``shapes``, B=2, against their plain
    adjoints, with a cotangent g of the output's scale, each timed beside
    its five products alone as torch.matmul on the same bf16 operands,
    launched twice and compared bit for bit, its native launches a call, and
    the planted faults of its split mirror (ops/ffn_stages.py) failing the
    same check."""
    from tramba_tpu_torch.ops import ffn_stages as fs
    from tramba_tpu_torch.ops import fused_mlp as tm

    bf, B, tag = torch.bfloat16, 2, "bf16 train"
    for H, d, dwms in shapes:
        params = ffn_case(gen, dev, d, dwms)[:-1]  # b2 has no part in the adjoint
        x = torch.randn(B, H, H, d, generator=gen).to(dev, bf)
        g = torch.randn(B, H, H, d, generator=gen).to(dev, bf)
        M, hid = B * H * H, 4 * d
        label = f"{H}px B{B} d{d} hid{hid}"
        # the kernel reads the weights in bf16: count them so
        inputs = (x, g, *(p.to(bf) if p.dim() > 1 else p for p in params))
        w1, w2 = params[2].to(bf), params[-1].to(bf)
        xf = torch.nn.functional.layer_norm(x.float(), (d,), params[0], params[1], 1e-5)
        xf, g2 = xf.to(bf).reshape(M, d), g.reshape(M, d)
        hg = torch.nn.functional.gelu(xf.float() @ w1.float().t()).to(bf)
        gemm = lambda: (xf @ w1.t(), g2 @ w2, hg @ w1, g2.t() @ hg, hg.t() @ xf)  # noqa: E731
        if dwms:
            name, kernel, plain = "ln_dwms_mlp_bwd", tm.ln_dwms_mlp_bwd, tm.ln_dwms_mlp_bwd_ref
            # the merged taps: one 49-tap stencil a value for acc, one for
            # dh, one 49-offset correlation for the three tap gradients
            flops = ops(bf, 10 * M * d * hid, 3 * 2 * 49 * M * hid + 20 * M * hid)
        else:
            name, kernel, plain = "ln_mlp_bwd", tm.ln_mlp_bwd, tm.ln_mlp_bwd_ref
            flops = ops(bf, 10 * M * d * hid, 20 * M * hid)
        checks.compare(name, None, label, lambda: kernel(x, g, *params),
                       lambda: plain(x, g, *params), reps=5, inputs=inputs, flops=flops, tag=tag,
                       rel_tol=BWD_REL_TOL_BF16, gemm=gemm)
        del xf, g2, hg, gemm
        a, b = kernel(x, g, *params), kernel(x, g, *params)
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise AssertionError(f"{name} {label}: two launches differ")
        del a, b
        n = native_launches(lambda: kernel(x, g, *params))
        G = tm.mlp_bwd_column_groups(M, d, hid)  # the kernel's own plan of stage (c)
        print(f"{name:15s} {label}: {n:g} native launches a call, {G} column group(s) in (c)",
              flush=True)
        if n != (6 if dwms else 4):
            raise AssertionError(f"{name} {label}: {n} native launches a call")
        if dwms:
            faults = {f: functools.partial(fs.dwms_bwd_merged_ref, x, g, *params, fault=f)
                      for f in fs.DWMS_BWD_FAULTS}
        else:
            faults = {f: functools.partial(fs.mlp_bwd_split_ref, x, g, *params, groups=G, fault=f)
                      for f in fs.MLP_BWD_FAULTS if f != "no last group's row sums" or G > 1}
        checks.planted(name, label, plain(x, g, *params), faults, rel_tol=BWD_REL_TOL_BF16)


def check_ss2d_expand(checks, dev, gen, dt, ss2d_shapes=SS2D_SHAPES, expand_shapes=EXPAND_SHAPES,
                      head_c=128, B=2, table_fault=False):
    """K1-K4 at every shape of the main path (by default Tramba-V's), in
    dtype ``dt``, at batch ``B`` (K4 unless ``head_c`` is None).  With
    ``table_fault`` the K1 check must also reject the plain version reading
    its last direction's table backwards (a wrong gather)."""
    from tramba_tpu_torch.nn.init import init_weights
    from tramba_tpu_torch.nn.layers import _Expand
    from tramba_tpu_torch.ops import fused_ss2d as tf

    for kind, H, d_model, param in ss2d_shapes:
        m, x, core, idx, inv, label = ss2d_case(dev, gen, dt, kind, H, d_model, param, B)
        checks.compare("ss2d_scan", dt, label, lambda: tf.ss2d_scan(x, idx, *core),
                       lambda: tf.ss2d_scan_ref(x, idx, *core), reps=5, inputs=(x, idx, *core),
                       flops=scan_ops(x, core), plain_warmup=0)
        if table_fault:
            flipped = idx.clone()
            flipped[-1] = idx[-1].flip(0)
            checks.planted("ss2d_scan", label, tf.ss2d_scan_ref(x, idx, *core), {
                "last table backwards": lambda: tf.ss2d_scan_ref(x, flipped, *core)},
                tol=KERNEL_TOL)
        tail = (m.out_norm.weight.data, m.out_norm.bias.data, m.out_proj.weight.data.to(dt))
        check_merge(checks, dt, label, (B, idx.shape[0], H * H, x.shape[-1]), inv, tail)
    for H, C, f in expand_shapes:
        m = init_weights(_Expand(C, f), gen).to(dev)
        x = torch.randn(B, H, H, C, generator=gen).to(dev, dt)
        args = (x, m.expand.weight.data.to(dt), m.norm.weight.data, m.norm.bias.data)
        out_c = args[1].shape[0]  # Dense C -> f C (pixel shuffle), LN over C / f
        check_expand(checks, dt, f"f{f} {H}px B{B} C{C}", args,
                     ops(dt, 2 * B * H * H * C * out_c, 8 * B * H * H * out_c))
    if head_c is None:
        return
    C = head_c
    args = head_inputs(dev, gen, dt, C, B)
    M = B * 96 * 96
    check_head(checks, dt, f"96px B{B} C{C}", args, ops(dt, 2 * M * C * 16 * C, 10 * M * 16 * C))


def head_inputs(dev, gen, dt, C, B=2, H=96):
    """K4's arguments for a (B, H, H, C) map: FinalPatchExpandX4's seeded
    expand and LayerNorm, seg_w uniform on [0.05, 0.15] and seg_b N(0, 1).
    seg_w is positive so that sum(ln_w seg_w) is at least 0.05 C: the head
    sum's mean term rstd m sum(ln_w seg_w), which a kernel could leave out,
    then stands well above the check on every draw (a zero-mean seg_w lets
    the sum fall near 0)."""
    from tramba_tpu_torch.nn.init import init_weights
    from tramba_tpu_torch.nn.layers import FinalPatchExpandX4

    m = init_weights(FinalPatchExpandX4(C), gen).to(dev)
    seg_w = (torch.rand(C, generator=gen) * 0.1 + 0.05).to(dev)
    seg_b = torch.randn(1, generator=gen).to(dev)
    x = torch.randn(B, H, H, C, generator=gen).to(dev, dt)
    return (x, m.expand.weight.data.to(dt), m.norm.weight.data, m.norm.bias.data, seg_w, seg_b)


def _plan_text(plan):
    from tramba_tpu_torch.ops import expand_stages as es

    return (f"{es.ROUTES[plan['route']]}, {plan['tiles']} x {plan['sets']} blocks of "
            f"{plan['rows']} rows, wn {plan['wn']}, split {plan['split']}, gpb {plan['gpb']}, "
            f"{plan['stages']} slots, {plan['smem']} B")


def check_expand(checks, dt, label, args, flops):
    """K3 against its plain version, timed beside its product alone as
    torch.matmul on the same operands (x w^T: "gemm"); two launches give the
    same bits; one native launch a call; the plan the library reports is its
    plain mirror's (ops/expand_stages.py), whose block-by-block version passes
    the same check and, with each planted fault that bears on the plan (p1
    and p2 swapped in the store; the padded columns left in the statistics;
    the last K chunk left out), fails it at bf16's tolerance."""
    from tramba_tpu_torch.ops import expand_stages as es
    from tramba_tpu_torch.ops import fused_expand as te

    x, w = args[:2]
    B, H, W, C = x.shape
    co = w.shape[0] // 4
    x2 = x.reshape(-1, C)
    checks.compare("expand_ln", dt, label, lambda: te.expand_ln(*args),
                   lambda: te.expand_ln_ref(*args), reps=10, inputs=args, flops=flops,
                   gemm=lambda: x2 @ w.t())
    if not torch.equal(te.expand_ln(*args), te.expand_ln(*args)):
        raise AssertionError(f"expand_ln {label}: two launches differ")
    n = native_launches(lambda: te.expand_ln(*args))
    plan = te.expand_plan(B, H, W, C, co, dt)
    print(f"expand_ln       {NAMES[dt]} {label}: {n:g} native launches a call; "
          f"{_plan_text(plan)}", flush=True)
    if n != 1:
        raise AssertionError(f"expand_ln {label}: {n} native launches a call, not 1")
    if plan != es.expand_plan(B * H * W, C, co, dt):
        raise AssertionError(f"expand_ln {label}: the library's plan {plan} is not the mirror's")
    want = te.expand_ln_ref(*args)
    tol = KERNEL_TOL_BF16 if dt == torch.bfloat16 else KERNEL_TOL
    torch.testing.assert_close(es.expand_tiled_ref(*args).float(), want.float(), **tol)
    checks.planted("expand_ln", label, want,
                   {f: functools.partial(es.expand_tiled_ref, *args, fault=f)
                    for f in es.expand_faults(plan, co)})


def check_head(checks, dt, label, args, flops):
    """K4 as :func:`check_expand` holds K3: gemm x w1^T; faults: the last K
    chunk left out, the mean left out of the head sum, the padded columns
    left in the statistics (where the plan pads)."""
    from tramba_tpu_torch.ops import expand_stages as es
    from tramba_tpu_torch.ops import fused_expand as te

    x, w1 = args[:2]
    C = x.shape[-1]
    M = x.numel() // C
    x2 = x.reshape(M, C)
    checks.compare("final_head", dt, label, lambda: te.final_head(*args),
                   lambda: te.final_head_ref(*args), reps=10, inputs=args, flops=flops,
                   gemm=lambda: x2 @ w1.t())
    if not torch.equal(te.final_head(*args), te.final_head(*args)):
        raise AssertionError(f"final_head {label}: two launches differ")
    n = native_launches(lambda: te.final_head(*args))
    plan = te.head_plan(M, C, dt)
    print(f"final_head      {NAMES[dt]} {label}: {n:g} native launches a call; "
          f"{_plan_text(plan)}", flush=True)
    if n != 1:
        raise AssertionError(f"final_head {label}: {n} native launches a call, not 1")
    if plan != es.head_plan(M, C, dt):
        raise AssertionError(f"final_head {label}: the library's plan {plan} is not the mirror's")
    want = te.final_head_ref(*args)
    tol = KERNEL_TOL_BF16 if dt == torch.bfloat16 else KERNEL_TOL
    torch.testing.assert_close(es.head_tiled_ref(*args).float(), want.float(), **tol)
    checks.planted("final_head", label, want,
                   {f: functools.partial(es.head_tiled_ref, *args, fault=f)
                    for f in es.head_faults(plan, C)})


# bf16-only kernels at Tramba-V's shapes: (map, d_model, with LN) of K5,
# (map, d) of K6 and of K7; and at Tramba-P's decoder (its SS2Ds' K5, its
# guides' K6, its blocks' K7).  Tramba-S's are Tramba-V's (its encoder FFNs
# are K6 at 96/128, 48/256, 24/512).
BF16_SHAPES = dict(
    prologue=((96, 128, True), (48, 256, True), (24, 512, True), (12, 1024, True),
              (96, 128, False), (48, 256, False), (24, 512, False)),
    ln_mlp=((96, 128), (48, 256), (24, 512), (12, 1024)),
    ln_dwms_mlp=((96, 128), (48, 256), (24, 512)))
BF16_SHAPES_P = dict(
    prologue=((96, 64, True), (48, 128, True), (24, 320, True), (96, 64, False),
              (48, 128, False), (24, 320, False)),
    ln_mlp=((96, 64), (48, 128), (24, 320)),
    ln_dwms_mlp=((96, 64), (48, 128), (24, 320)))
BF16_SHAPES_R = dict(
    prologue=((96, 256, True), (48, 512, True), (96, 256, False), (48, 512, False)),
    ln_mlp=((96, 256), (48, 512)),
    ln_dwms_mlp=((96, 256), (48, 512)))


def check_bf16_only(checks, dev, gen, shapes=BF16_SHAPES):
    """K5-K7 at every bf16 main-path shape of ``shapes``."""
    from tramba_tpu_torch.nn.init import init_weights
    from tramba_tpu_torch.nn.layers import DWMSMlp, Mlp
    from tramba_tpu_torch.nn.ssm import SS2D
    from tramba_tpu_torch.ops import fused_mlp as tm
    from tramba_tpu_torch.ops import fused_prologue as tp

    bf, B = torch.bfloat16, 2

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

    def ln(d):
        return rnd(d, scale=0.1, shift=1.0), rnd(d, scale=0.1)

    # encoder raster and decoder line SS2Ds (with the block's LN), guides (without)
    for H, dm, with_ln in shapes["prologue"]:
        m = init_weights(SS2D(dm), gen).to(dev)
        x = rnd(B, H, H, dm).to(bf)
        norm = ln(dm) if with_ln else (None, None)
        args = (x, *norm, m.in_proj.weight.data.to(bf), m.conv2d.weight.data.to(bf))
        label = f"{'enc/dec LN' if with_ln else 'guide'} {H}px B{B} dm{dm} D{2 * dm}"
        check_prologue(checks, label, args)
    for H, d in shapes["ln_mlp"]:
        m = init_weights(Mlp(d, 4 * d), gen).to(dev)
        args = (rnd(B, H * H, d).to(bf), *ln(d), m.fc1.weight.data.to(bf), rnd(4 * d, scale=0.1),
                m.fc2.weight.data.to(bf), rnd(d, scale=0.1))
        M = B * H * H
        check_ln_mlp(checks, f"{H}px B{B} d{d} hid{4 * d}", args,
                     ops(bf, 4 * M * d * 4 * d, 10 * M * 4 * d))
    for H, d in shapes["ln_dwms_mlp"]:
        m = init_weights(DWMSMlp(d, 4 * d), gen).to(dev)
        convs = [t for c in (m.dwc3, m.dwc5, m.dwc7)
                 for t in (c.dw_conv.weight.data.to(bf), rnd(4 * d, scale=0.1))]
        args = (rnd(B, H, H, d).to(bf), *ln(d), m.fc1.weight.data.to(bf), rnd(4 * d, scale=0.1),
                *convs, m.fc2.weight.data.to(bf), rnd(d, scale=0.1))
        M = B * H * H
        check_ln_dwms_mlp(checks, f"{H}px B{B} d{d} hid{4 * d}", args,
                          ops(bf, 4 * M * d * 4 * d, (2 * 49 + 10) * M * 4 * d))


def check_prologue(checks, label, args):
    """K5 against its plain version, timed beside its product alone as
    torch.matmul on the same bf16 operands (bf16(LN(x)) w_in^T); two launches
    give the same bits; one native launch a call (the LayerNorm folded in:
    no ln_rows_kernel); the tile mirror (ops/prologue_stages.py) at the
    kernel's own plan passes the same check, and with each planted fault that
    bears on these inputs fails it."""
    from tramba_tpu_torch.ops import fused_prologue as tp
    from tramba_tpu_torch.ops import prologue_stages as ps

    x, ln_w, ln_b, w_in, conv_k = args
    B, H, W, dm = x.shape
    M, D = B * H * W, w_in.shape[0]
    y = x if ln_w is None else torch.nn.functional.layer_norm(x.float(), (dm,), ln_w, ln_b,
                                                               1e-5).to(x.dtype)
    y = y.reshape(M, dm)
    checks.compare("prologue", torch.bfloat16, label, lambda: tp.prologue(*args),
                   lambda: tp.prologue_ref(*args), reps=10, inputs=args,
                   flops=ops(torch.bfloat16, 2 * M * dm * D, 2 * 9 * M * D + 10 * M * D),
                   gemm=lambda: y @ w_in.t())
    del y
    if not torch.equal(tp.prologue(*args), tp.prologue(*args)):
        raise AssertionError(f"prologue {label}: two launches differ")
    n = native_launches(lambda: tp.prologue(*args))
    plan = ps.prologue_plan(B, H, W, dm, D)
    print(f"prologue        {label}: {n:g} native launches a call, {plan['tiles']} tiles of "
          f"{plan['tile'][0]}x{plan['tile'][1]} ({plan['mt']} x 64 halo rows), "
          f"{plan['groups']} channel group(s)", flush=True)
    if n != 1:
        raise AssertionError(f"prologue {label}: {n} native launches a call, not 1")
    want = tp.prologue_ref(*args)
    torch.testing.assert_close(ps.prologue_tiled_ref(*args).float(), want.float(),
                               **KERNEL_TOL_BF16)
    checks.planted("prologue", label, want,
                   {f: functools.partial(ps.prologue_tiled_ref, *args, fault=f)
                    for f in ps.prologue_faults(ln_w is not None)})


def check_dwms_grid_shape(checks, dev, gen):
    """K7 at the shape of Queue 2 #21's own test (``_dwms_pallas2``,
    tests/test_fused_mlp.py:195): B 2, 12 x 8 px, d 16, hidden 256."""
    from tramba_tpu_torch.ops import fused_mlp as tm

    bf, (B, H, W, d, hid) = torch.bfloat16, (2, 12, 8, 16, 256)

    def rnd(*shape, scale=0.2, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

    convs = [t for n in (3, 5, 7) for t in (rnd(hid, 1, n, n).to(bf), rnd(hid))]
    args = (rnd(B, H, W, d, scale=1.0).to(bf), rnd(d, shift=1.0), rnd(d), rnd(hid, d).to(bf),
            rnd(hid), *convs, rnd(d, hid).to(bf), rnd(d))
    M = B * H * W
    check_ln_dwms_mlp(checks, f"#21 {H}x{W}px B{B} d{d} hid{hid}", args,
                      ops(bf, 4 * M * d * hid, (2 * 49 + 10) * M * hid))


def check_lgp(checks, dev, gen):
    """K2 as _lgp_pallas (Queue 2 #14): K=1, one-slot identity inverse table,
    in fp32 and bf16."""
    from tramba_tpu_torch.ops import fused_ss2d as tf

    B, L, D, dm = 2, 24 * 24, 1024, 512

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

    for dt in (torch.float32, torch.bfloat16):
        inv = torch.arange(L, dtype=torch.int32, device=dev).reshape(1, 1, L)
        tail = (rnd(D, scale=0.1, shift=1.0), rnd(D, scale=0.1),
                torch.empty(dm, D, device=dev, dtype=dt))  # w_out: check_merge draws it
        check_merge(checks, dt, f"lgp 24px B{B} K1 D{D}", (B, 1, L, D), inv, tail)


# Tramba-P's and Tramba-S's encoder kernels at every 384 px main-path shape:
# K11 (map, d, hid) of PVT stages 1-3; K12 (map, C, heads) of PVT stages 1-4,
# 144 reduced keys each; K13 (map, C, heads) of Swin stages 1-3, 12 x 12
# windows, unshifted and shifted (masked)
K11_SHAPES = ((96, 64, 512), (48, 128, 1024), (24, 320, 1280))
K12_SHAPES = ((96, 64, 1), (48, 128, 2), (24, 320, 5), (12, 512, 8))
K13_SHAPES = ((96, 128, 4), (48, 256, 8), (24, 512, 16))


def dwmlp_lib(x, ln_w, ln_b, w1, b1, k3, c3, w2, b2, eps=1e-6):
    """K11's function as PyTorch's own bf16 calls (a yardstick only):
    F.layer_norm, a cuBLAS linear, cuDNN's depthwise 3x3, GELU, a linear."""
    F, bf = torch.nn.functional, torch.bfloat16
    y = F.layer_norm(x, (x.shape[-1],), ln_w.to(bf), ln_b.to(bf), eps)
    h = F.linear(y, w1, b1.to(bf)).permute(0, 3, 1, 2)
    a = F.conv2d(h, k3, c3.to(bf), padding=1, groups=k3.shape[0])
    return F.linear(F.gelu(a).permute(0, 2, 3, 1), w2, b2.to(bf))


def window_attn_lib(x, ln_w, ln_b, wqkv, bqkv, am, wp, bp, nh, eps=1e-5):
    """K13's function as PyTorch's own bf16 calls (a yardstick only):
    F.layer_norm, the window partition, a cuBLAS linear, SDPA with ``am``
    (bias + mask, (nW or 1, nh, N, N) bf16) as its attn_mask, a linear, the
    reverse."""
    F, bf = torch.nn.functional, torch.bfloat16
    B, H, W, C = x.shape
    N = am.shape[-1]
    w = int(round(N ** 0.5))
    y = F.layer_norm(x, (C,), ln_w.to(bf), ln_b.to(bf), eps)
    win = y.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    win = win.reshape(B, (H // w) * (W // w), N, C)
    q, k, v = F.linear(win, wqkv, bqkv.to(bf)).reshape(*win.shape[:3], 3, nh, C // nh).permute(
        3, 0, 1, 4, 2, 5)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
    out = F.linear(o.transpose(-2, -3).reshape(win.shape), wp, bp.to(bf))
    out = out.reshape(B, H // w, W // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(B, H, W, C)


def check_encoder_kernels(checks, dev, gen, batches=(2, 16)):
    """K11 ln_dwmlp, K12 sra and K13 window_attn against their plain
    versions in bf16, at each batch of ``batches``.  The weights are drawn
    at fan-in scale (std fan_in^-1/2), the relative-position bias N(0, 1)
    and the output bias 0, so the scores are O(1) and the output is the
    kernel's own work.  Each shape then holds the plain version with a
    planted fault to the same check, which it must fail
    (:meth:`Checks.planted`).  K11 and K13 also: two launches give the same
    bits; native launches a call (K11 1, or 2 where the plan splits the
    hidden chunks; K13 2: no LayerNorm launch); the plan the library reports
    is its plain mirror's (ops/encoder_stages.py), and at B2 the mirror of
    the kernels' split passes the check and, with each planted fault that
    bears on the shape, fails it; each printed beside its function as
    PyTorch's own calls ("lib": :func:`dwmlp_lib`, :func:`window_attn_lib`,
    a yardstick the port never calls).  K12: :func:`check_sra`."""
    from tramba_tpu_torch.models.swin import shift_attn_mask
    from tramba_tpu_torch.ops import encoder_stages as es
    from tramba_tpu_torch.ops import fused_attn as ta
    from tramba_tpu_torch.ops import fused_mlp as tm

    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

    def ln(d):
        return rnd(d, scale=0.1, shift=1.0), rnd(d, scale=0.1)

    def dense(n_out, n_in):
        return rnd(n_out, n_in, scale=n_in ** -0.5).to(bf)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(*shape, device=dev, dtype=dtype)

    def same_bits(name, label, fn):
        if not torch.equal(fn(), fn()):
            raise AssertionError(f"{name} {label}: two launches differ")

    for B in batches:
        for H, d, hid in K11_SHAPES:
            x, (g, b), k3 = rnd(B, H, H, d).to(bf), ln(d), rnd(hid, 1, 3, 3, scale=1 / 3).to(bf)
            w1, b1, c3, w2 = dense(hid, d), rnd(hid, scale=0.1), rnd(hid, scale=0.1), dense(d, hid)
            args = (x, g, b, w1, b1, k3, c3, w2, zeros(d))
            label, M = f"{H}px B{B} d{d} hid{hid}", B * H * H
            checks.compare("ln_dwmlp", bf, label, lambda: tm.ln_dwmlp(*args),
                           lambda: tm.ln_dwmlp_ref(*args), reps=10, inputs=args,
                           flops=ops(bf, 4 * M * d * hid, (2 * 9 + 10) * M * hid),
                           lib=lambda: dwmlp_lib(*args))
            same_bits("ln_dwmlp", label, lambda: tm.ln_dwmlp(*args))
            n = native_launches(lambda: tm.ln_dwmlp(*args))
            plan = tm.dwmlp_plan(B, H, H, d, hid, x.device.index)
            print(f"ln_dwmlp        {label}: {n:g} native launches a call; {plan}", flush=True)
            if n != (2 if plan["splits"] > 1 else 1):
                raise AssertionError(f"ln_dwmlp {label}: {n} native launches a call, "
                                     f"{plan['splits']} splits")
            if plan != es.dwmlp_plan(B, H, H, d, hid):
                raise AssertionError(f"ln_dwmlp {label}: the library's plan {plan} is not the "
                                     "mirror's")
            want = tm.ln_dwmlp_ref(*args)
            centre = zeros(hid, 1, 3, 3, dtype=bf)
            centre[..., 1, 1] = k3[..., 1, 1]
            faults = {"centre tap only": lambda: tm.ln_dwmlp_ref(x, g, b, w1, b1, centre, c3,
                                                                 w2, zeros(d))}
            if B == batches[0]:
                tiled = functools.partial(es.dwmlp_tiled_ref, *args, splits=plan["splits"])
                torch.testing.assert_close(tiled().float(), want.float(), **KERNEL_TOL_BF16)
                faults.update({f: functools.partial(tiled, fault=f)
                               for f in es.dwmlp_faults(plan)})
            checks.planted("ln_dwmlp", label, want, faults)
            del want
        for H, C, nh in K13_SHAPES:
            N, M, nW = 144, B * H * H, (H // 12) ** 2
            bias = rnd(nh, N, N)
            for mask in (None, torch.from_numpy(shift_attn_mask(H, H, 12, 6)).to(dev)):
                x, (g, b), wqkv, bqkv, wp = rnd(B, H, H, C, scale=2.0).to(bf), ln(C), \
                    dense(3 * C, C), rnd(3 * C, scale=0.1), dense(C, C)
                args = (x, g, b, wqkv, bqkv, bias, mask, wp, zeros(C))
                label = (f"{H}px B{B} C{C} nh{nh} "
                         f"{'shifted' if mask is not None else 'unshifted'}")
                am = (bias[None] + (0 if mask is None else mask[:, None])).to(bf)
                checks.compare("window_attn", bf, label, lambda: ta.window_attn(*args, nh),
                               lambda: ta.window_attn_ref(*args, nh), reps=10, inputs=args,
                               flops=ops(bf, 8 * M * C * C + 4 * M * N * C, 8 * M * nh * N),
                               lib=lambda: window_attn_lib(x, g, b, wqkv, bqkv, am, wp,
                                                           zeros(C), nh))
                del am
                same_bits("window_attn", label, lambda: ta.window_attn(*args, nh))
                n = native_launches(lambda: ta.window_attn(*args, nh))
                plan = ta.window_attn_plan(B, H, H, C, nh, 12, x.device.index)
                print(f"window_attn     {label}: {n:g} native launches a call; {plan}",
                      flush=True)
                if n != 2:
                    raise AssertionError(f"window_attn {label}: {n} native launches a call, "
                                         "not 2")
                mirror = es.window_plan(B, H, H, C, nh, 12)
                if plan != {k: mirror[k] for k in plan}:
                    raise AssertionError(f"window_attn {label}: the library's plan {plan} is "
                                         f"not the mirror's {mirror}")
                want = ta.window_attn_ref(*args, nh)
                # q = 0 and no bias: uniform over each window's unmasked keys
                wkv, bkv = wqkv.clone(), bqkv.clone()
                wkv[:C], bkv[:C] = 0, 0
                faults = {"no bias": lambda: ta.window_attn_ref(*args[:5], zeros(nh, N, N),
                                                                *args[6:], nh),
                          "uniform softmax": lambda: ta.window_attn_ref(
                              x, g, b, wkv, bkv, zeros(nh, N, N), mask, wp, zeros(C), nh)}
                if mask is not None:
                    faults["no mask"] = lambda: ta.window_attn_ref(*args[:6], None, *args[7:],
                                                                   nh)
                if B == batches[0]:
                    tiled = functools.partial(es.window_tiled_ref, *args, nh)
                    torch.testing.assert_close(tiled().float(), want.float(), **KERNEL_TOL_BF16)
                    faults.update({f: functools.partial(tiled, fault=f)
                                   for f in es.window_faults(N, nW, mask is not None)})
                checks.planted("window_attn", label, want, faults)
                del want
        torch.cuda.empty_cache()
    check_sra(checks, dev, gen, batches)


def sra_lib(x, ln_w, ln_b, wq, bq, k, v, wp, bp, nh, eps=1e-6):
    """K12's function as PyTorch's own bf16 calls (a yardstick only):
    F.layer_norm, a cuBLAS linear, SDPA over the heads, a linear."""
    F, bf = torch.nn.functional, torch.bfloat16
    B, N, C = x.shape
    y = F.layer_norm(x, (C,), ln_w.to(bf), ln_b.to(bf), eps)
    q = F.linear(y, wq, bq.to(bf)).reshape(B, N, nh, C // nh).transpose(1, 2)
    o = F.scaled_dot_product_attention(q, k, v)
    return F.linear(o.transpose(1, 2).reshape(B, N, C), wp, bp.to(bf))


# K12 beyond the 384 px shapes: PVT stage 3 at 512 px (its 32 px map over 256
# reduced keys: the one-pass route's widest key count), at B2
K12_SHAPES_512 = ((32, 320, 5, 256),)
# K12's wide route (three launches), at widths no PVTv2 model has: C 1024
# over 16 heads (a block would not hold its rows' LayerNorm and merged
# heads), and 32 heads of 8 (padded to 64, they would overflow it), at B2
K12_SHAPES_WIDE = ((12, 1024, 16, 144), (12, 256, 32, 144))


def check_sra(checks, dev, gen, batches=(2, 16)):
    """K12 sra against its plain version in bf16 at every shape of
    :data:`K12_SHAPES` (144 keys) at each batch of ``batches``, and at
    :data:`K12_SHAPES_512` and :data:`K12_SHAPES_WIDE` at the first: weights
    at fan-in scale, output bias 0; timed beside :func:`sra_lib` ("lib",
    PyTorch's own LN + cuBLAS + SDPA + cuBLAS, a yardstick the port never
    calls); two launches give the same bits; one native launch a call (no
    LayerNorm launch; three on the wide route); the
    library's plan is ops/encoder_stages.sra_plan's; the plain version with
    q = 0 (uniform softmax) must fail the check, and at the first batch the
    mirror of the kernel's tiling (``sra_tiled_ref``) passes it and, with
    each planted fault that bears on the shape, fails it."""
    from tramba_tpu_torch.ops import encoder_stages as es
    from tramba_tpu_torch.ops import fused_attn as ta

    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

    shapes = [(B, H, C, nh, 144) for B in batches for H, C, nh in K12_SHAPES]
    shapes += [(batches[0], H, C, nh, Lk) for H, C, nh, Lk in K12_SHAPES_512 + K12_SHAPES_WIDE]
    for B, H, C, nh, Lk in shapes:
        M = B * H * H
        k, v = (rnd(B, nh, Lk, C // nh).to(bf) for _ in range(2))
        x, g, b = rnd(B, H * H, C, scale=2.0).to(bf), rnd(C, scale=0.1, shift=1.0), rnd(
            C, scale=0.1)
        wq, bq, wp = rnd(C, C, scale=C ** -0.5).to(bf), rnd(C, scale=0.1), rnd(
            C, C, scale=C ** -0.5).to(bf)
        zero = torch.zeros(C, device=dev)
        args = (x, g, b, wq, bq, k, v, wp, zero)
        wide = (H, C, nh, Lk) in K12_SHAPES_WIDE
        label = f"{'wide ' if wide else ''}{H}px N{H * H} B{B} C{C} nh{nh} Lk{Lk}"
        checks.compare("sra", bf, label, lambda: ta.sra(*args, nh),
                       lambda: ta.sra_ref(*args, nh), reps=10, inputs=args,
                       flops=ops(bf, 4 * M * C * C + 4 * M * Lk * C, 6 * M * nh * Lk + 10 * M * C),
                       lib=lambda: sra_lib(*args, nh))
        if not torch.equal(ta.sra(*args, nh), ta.sra(*args, nh)):
            raise AssertionError(f"sra {label}: two launches differ")
        n = native_launches(lambda: ta.sra(*args, nh))
        plan = ta.sra_plan(B, H * H, C, nh, Lk, x.device.index)
        print(f"sra             {label}: {n:g} native launches a call; {plan}", flush=True)
        if n != 1 + 2 * wide or plan["wide"] != wide:
            raise AssertionError(f"sra {label}: {n} native launches a call, not {1 + 2 * wide}")
        if plan != es.sra_plan(B, H * H, C, nh, Lk):
            raise AssertionError(f"sra {label}: the library's plan {plan} is not the mirror's")
        want = ta.sra_ref(*args, nh)
        faults = {"uniform softmax": lambda: ta.sra_ref(  # q = 0: uniform over the keys
            x, g, b, torch.zeros_like(wq), zero, k, v, wp, zero, nh)}
        if B == batches[0]:
            tiled = functools.partial(es.sra_tiled_ref, *args, nh, plan=plan)
            torch.testing.assert_close(tiled().float(), want.float(), **KERNEL_TOL_BF16)
            faults.update({f: functools.partial(tiled, fault=f)
                           for f in es.sra_faults(plan, H * H, nh, Lk)})
        checks.planted("sra", label, want, faults)
        del want, args, x, k, v
    torch.cuda.empty_cache()


# K14 at the shapes the parallel layer launches, (label, R = B x K, L, C) at
# B=4: the tensor-parallel core of Tramba-V's raster SS2Ds at its 96 / 48 /
# 24 / 12 px maps (C = d_inner; at world size 1 a rank holds all of it), the
# decoder's K = 8 line core at 96 px, and an SS2D of d_state 16 at 24 px
# (d_inner 1024, N folded into C); each forward and reversed (the backward)
LINEAR_SCAN_SHAPES = (("tp raster 96px", 16, 9216, 256), ("tp raster 48px", 16, 2304, 512),
                      ("tp raster 24px", 16, 576, 1024), ("tp raster 12px", 16, 144, 2048),
                      ("tp line 96px K8", 32, 9216, 256), ("d_state 16 24px", 16, 576, 16384))


def scan_inputs(gen, R, L, C, dev):
    """a = exp(-delta), delta log-uniform on [1e-3, 1e-1] as SS2D's dt init
    draws it, and b = delta x N(0, 1): a carry lasts tens to thousands of
    rows, so one dropped at a chunk boundary shows."""
    delta = torch.exp(torch.empty(R, L, C).uniform_(np.log(1e-3), np.log(1e-1), generator=gen))
    b = delta * torch.randn(R, L, C, generator=gen)
    return torch.exp(-delta).to(dev), b.to(dev)


# K14 at a ragged shape: L no multiple of the 256-row segment, C none of the
# block's 32 channels (nor of 4: the copies of one element)
LINEAR_SCAN_RAGGED = ("ragged", 3, 1000, 203)


def check_linear_scan(checks, dev, gen):
    """K14 against linear_scan_ref at every shape of :data:`LINEAR_SCAN_SHAPES`
    and :data:`LINEAR_SCAN_RAGGED`, fp32, forward and reversed: two launches
    give the same bits; one native launch a call; the plan the library
    reports is ops/scan_segments.linear_scan_plan's, and the mirror of its
    segments (``linear_scan_segmented``) passes the same check.  Where L >
    256 the plain version with the carry dropped between 256-row chunks (the
    chunking of JAX's ``_linear_scan_pallas``) must fail the check, and so
    must the mirror with each of its planted faults that bears on the shape
    (the carry dropped between the kernel's segments; the running product
    of a taken over a walker's whole rows)."""
    from tramba_tpu_torch.ops import scan_segments as sm
    from tramba_tpu_torch.ops import selective_scan as ts

    def no_carry(a, b, rev):
        return torch.cat([ts.linear_scan_ref(a[:, t:t + 256], b[:, t:t + 256], rev)
                          for t in range(0, a.shape[1], 256)], dim=1)

    for label, R, L, C in (*LINEAR_SCAN_SHAPES, LINEAR_SCAN_RAGGED):
        a, b = scan_inputs(gen, R, L, C, dev)
        plan = ts.linear_scan_plan(R, L, C, a.device.index)
        if plan != sm.linear_scan_plan(R, L, C):
            raise AssertionError(f"linear_scan {label}: the library's plan {plan} is not the "
                                 "mirror's")
        for rev in (False, True):
            tag = f"{label} B4 {'rev' if rev else 'fwd'} ({R}, {L}, {C})"
            checks.compare("linear_scan", torch.float32, tag,
                           lambda: ts.linear_scan(a, b, rev), lambda: ts.linear_scan_ref(a, b, rev),
                           reps=5, inputs=(a, b), flops=ops(torch.float32, 0, 2 * a.numel()),
                           plain_warmup=0)
            if not torch.equal(ts.linear_scan(a, b, rev), ts.linear_scan(a, b, rev)):
                raise AssertionError(f"linear_scan {tag}: two launches differ")
            n = native_launches(lambda: ts.linear_scan(a, b, rev))
            if n != 1:
                raise AssertionError(f"linear_scan {tag}: {n} native launches a call, not 1")
            want = ts.linear_scan_ref(a, b, rev)
            mirror = functools.partial(sm.linear_scan_segmented, a, b, rev, plan["seg"],
                                       plan["parts"])
            torch.testing.assert_close(mirror(), want, **KERNEL_TOL)
            print(f"linear_scan     {tag}: 1 native launch a call; {plan}; the segment mirror "
                  "passes", flush=True)
            faults = {f: functools.partial(mirror, fault=f)
                      for f in sm.linear_scan_faults(L, plan["seg"], plan["parts"])}
            if L > 256:
                faults["no chunk carry"] = lambda: no_carry(a, b, rev)
            if faults:
                checks.planted("linear_scan", tag, want, faults, tol=KERNEL_TOL)
            del want
        del a, b


def run_model(dev, dtype, x, cpu_fp32_heads=None, method="Tramba-V-TSOD"):
    """Phase 4 for one model in one dtype.  Returns the launch counts of one
    batch-2 forward, the model, its outputs and the CPU run's outputs (batch
    1).  ``cpu_fp32_heads``: the CPU fp32 heads, which set bf16's noise floor."""
    from tramba_tpu_torch.models.registry import build

    model = build(method, 384, device=dev, seed=0, dtype=dtype)
    n_params = sum(p.numel() for p in model.parameters())
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError("parameters must stay fp32")
    reset_counts()
    with torch.no_grad():
        outs = model(x.to(dev))
    launches = read_counts()
    print(f"model {method} 384px {NAMES[dtype]}, {n_params} fp32 parameters; "
          f"launches {launches}", flush=True)
    shapes = [tuple(o.shape) for o in outs]
    n = len(model.decoder.seg_layers)  # a head per decoder stage and the full-size one
    want = [(2, 384 >> (n - s), 384 >> (n - s), 1) for s in range(n - 1)] + [(2, 384, 384, 1)]
    if shapes != want:
        raise AssertionError(f"head shapes {shapes}, expected {want}")
    if any(o.dtype != dtype for o in outs):
        raise AssertionError(f"head dtypes {[o.dtype for o in outs]}, expected {dtype}")
    if not all(torch.isfinite(o).all().item() for o in outs):
        raise AssertionError("non-finite logits")
    want = expected_launches(model, train=False)
    if launches != want:
        raise AssertionError(f"{method} {NAMES[dtype]} launches {launches}, expected {want}")

    t0 = time.perf_counter()
    cpu_model = build(method, 384, device="cpu", seed=0, dtype=dtype)
    with torch.no_grad():
        cpu_outs = cpu_model(x[:1])
    print(f"CPU {method} {NAMES[dtype]} forward (plain versions) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if dtype == torch.float32 and method in FLOP_COUNTED:
        from tramba_tpu_torch.utils.profiling import analytic_model_flops

        t0 = time.perf_counter()
        flops = analytic_model_flops(cpu_model, x[:1])
        print(f"analytic_model_flops {method} 384px B1: {json.dumps(flops)} (the plain "
              f"versions on the CPU, {time.perf_counter() - t0:.1f} s)", flush=True)
    for i, (g, c) in enumerate(zip(outs, cpu_outs)):
        c = c.float()
        d = (g[:1].float().cpu() - c).abs()
        tol, floor = HEAD_MEAN_ABS_TOL[dtype], ""
        if cpu_fp32_heads is not None:
            noise = (c - cpu_fp32_heads[i]).abs().mean().item()
            tol = max(tol, BF16_NOISE_FACTOR * noise)
            floor = f"; CPU bf16 vs CPU fp32 mean abs {noise:.3e}"
        print(f"{method} head {i} {tuple(c.shape)} {NAMES[dtype]}: card vs CPU max abs "
              f"{d.max().item():.3e} mean abs {d.mean().item():.3e} "
              f"(|logit| mean {c.abs().mean().item():.3f}{floor}; limit {tol:.3e})", flush=True)
        if not d.mean().item() <= tol:
            raise AssertionError(f"{method} head {i}: mean abs difference {d.mean().item()} "
                                 f"> {tol}")
    return launches, model, outs, [c.float() for c in cpu_outs]


def encoder_weights_cast_once(model):
    """A copy of the bf16 Tramba-P/S ``model`` whose encoder holds its Linear
    and Conv2d weights in bf16, so that the cast at each use (``w.to(bf16)``
    in the kernels' wrappers and in ``flax_dense`` / ``flax_conv``) does
    nothing: the same function without the encoder's per-call weight casts
    (phase 6)."""
    once = copy.deepcopy(model)
    for m in once.encoder.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
            m.weight.data = m.weight.data.to(torch.bfloat16)
    return once


def run_dump_entry_point(tmp, method, *flags):
    """Phase 5: the port's dump CLI for ``method`` on synthetic images of odd
    sizes."""
    from PIL import Image

    rng = np.random.default_rng(0)
    sizes = {"img_1": (301, 217), "img_2": (97, 155), "img_3": (640, 360)}  # (W, H)
    for sub in ("image", "mask"):
        os.makedirs(os.path.join(tmp, "data", "Test", sub))
    for name, (w, h) in sizes.items():
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(img, "RGB").save(os.path.join(tmp, "data", "Test", "image", name + ".jpg"))
        mask = (rng.random((h, w)) > 0.5).astype(np.uint8) * 255
        Image.fromarray(mask, "L").save(os.path.join(tmp, "data", "Test", "mask", name + ".png"))
    save_root = os.path.join(tmp, "out")
    subprocess.run([sys.executable, "-m", "tramba_tpu_torch.dump", "--data_root",
                    os.path.join(tmp, "data"), "--save_root", save_root, "--batch_size", "2",
                    "--method", method, *flags],
                   check=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    out_dir = os.path.join(save_root, method, "TSOD")
    for name, size in sizes.items():
        with Image.open(os.path.join(out_dir, name + ".png")) as im:
            if im.size != size or im.mode != "L":
                raise AssertionError(f"{name}: map {im.size} {im.mode}, expected {size} L")
    print(f"dump --method {method} {' '.join(flags)} wrote {len(sizes)} maps at their original "
          "sizes", flush=True)


def _results_rows(out, method, datasets):
    """The results rows that a scoring CLI printed for ``method`` and each of
    ``datasets``; each must hold eight finite metrics."""
    rows = {}
    for ln in out.splitlines():
        for ds in datasets:
            if ln.startswith(f"model: {method} | dataset: {ds} || "):
                vals = [float(v) for v in ln.split("|| ", 1)[1].split(" & ")]
                if len(vals) != 8 or not all(np.isfinite(vals)):
                    raise AssertionError(f"results row without 8 finite metrics: {ln}")
                rows[ds] = ln
    if set(rows) != set(datasets):
        raise AssertionError(f"results rows for {sorted(rows)}, expected {datasets}:\n{out}")
    return rows


def run_sod_entry_points(tmp, method, *flags, score=True):
    """Phase 5: ``python -m tramba_tpu_torch.dump_sod`` for ``method`` over two
    datasets of synthetic images of odd sizes, whose maps must land in the
    one folder ``<image_save_path>/<method>/SOD`` at their original sizes;
    then, with ``score``, ``python -m tramba_tpu_torch.evaluate_sod`` (both
    datasets, each against its own masks) and ``evaluate_tsod`` (the SOD
    folder as its dataset, against the first dataset's masks) on those
    maps: each exits 0, prints a results row of finite metrics per dataset
    and writes the PR curves."""
    from PIL import Image

    rng = np.random.default_rng(5)
    sizes = {"A": {"a_1": (301, 217), "a_2": (97, 155)}, "B": {"b_1": (640, 360)}}  # (W, H)
    for ds, imgs in sizes.items():
        for sub in ("image", "mask"):
            os.makedirs(os.path.join(tmp, ds, "Test", sub))
        for name, (w, h) in imgs.items():
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "RGB").save(
                os.path.join(tmp, ds, "Test", "image", name + ".jpg"))
            mask = (rng.random((h, w)) > 0.5).astype(np.uint8) * 255
            Image.fromarray(mask, "L").save(os.path.join(tmp, ds, "Test", "mask", name + ".png"))
    out, here = os.path.join(tmp, "out"), os.path.dirname(os.path.abspath(__file__))

    def cli(module, *args):
        res = subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                             text=True, timeout=600, cwd=here)
        if res.returncode != 0:
            raise AssertionError(f"{module} exited {res.returncode}:\n{res.stdout[-2000:]}\n"
                                 f"{res.stderr[-3000:]}")
        return res.stdout

    cli("tramba_tpu_torch.dump_sod", "--method", method, "--image_save_path", out,
        "--batch_size", "2", "--datasets", *(f"{ds}={os.path.join(tmp, ds)}" for ds in sizes),
        *flags)
    sod = os.path.join(out, method, "SOD")
    want = {f"{n}.png": size for imgs in sizes.values() for n, size in imgs.items()}
    if sorted(os.listdir(sod)) != sorted(want):
        raise AssertionError(f"{sod} holds {sorted(os.listdir(sod))}, expected {sorted(want)}")
    for f, size in want.items():
        with Image.open(os.path.join(sod, f)) as im:
            if im.size != size or im.mode != "L":
                raise AssertionError(f"{f}: map {im.size} {im.mode}, expected {size} L")
    print(f"dump_sod --method {method} {' '.join(flags)} wrote {len(want)} maps of "
          f"{len(sizes)} datasets to <image_save_path>/{method}/SOD at their original sizes",
          flush=True)
    if not score:
        return
    masks = {ds: os.path.join(tmp, ds, "Test", "mask") for ds in sizes}
    runs = (("tramba_tpu_torch.evaluate_sod", list(sizes),
             ["--test_datasets", *(f"{ds}={m}" for ds, m in masks.items())]),
            ("tramba_tpu_torch.evaluate_tsod", ["SOD"],
             ["--test_datasets", "SOD", "--gt_root", masks["A"]]))
    for module, datasets, args in runs:
        for f in ("precision.npy", "recall.npy"):
            if os.path.exists(os.path.join(out, method, f)):
                os.remove(os.path.join(out, method, f))
        rows = _results_rows(cli(module, "--dataset_path", out, "--models", method,
                                 "--workers", "1", *args), method, datasets)
        curves = [np.load(os.path.join(out, method, f)) for f in ("precision.npy", "recall.npy")]
        if any(c.shape != (256,) or not np.isfinite(c).all() for c in curves):
            raise AssertionError(f"{module}: PR curves {[c.shape for c in curves]}")
        for row in rows.values():
            print(f"{module.rsplit('.', 1)[1]}: {row}", flush=True)


# the wrappers' record_function ranges (ops/fused_mlp.py) whose launches the
# profiles tell apart: K9 and K10 launch the same tail kernels (c) - (e)
RANGES = ("ln_mlp_bwd", "ln_dwms_mlp_bwd")
# kernel-name fragments (a tuple: all of them) -> group of the phase 7 / 8
# breakdowns, first match wins; a kernel launched in a range of RANGES is
# named "<kernel> @ <range>"
GROUPS = (("linear_scan_", "K14 linear_scan"),  # both routes' kernels
          ("memset", "memsets (K14's flag reset among them)"),
          ("ln_fc_kernel<1>", "K9 ln_mlp_bwd, front: LN, h and g w2, GELU adjoint"),
          (("mlp_bwd_dx_kernel", "@ ln_mlp_bwd"), "K9 ln_mlp_bwd, (c) dh w1 and LN adjoint"),
          (("mlp_bwd_wgrad_kernel", "@ ln_mlp_bwd"), "K9 ln_mlp_bwd, (d) dW1, dW2 products"),
          (("mlp_bwd_sum_kernel", "@ ln_mlp_bwd"), "K9 ln_mlp_bwd, (e) partial sums"),
          ("ln_fc_kernel<2>", "K10 ln_dwms_mlp_bwd, front: LN, h and g w2 maps"),
          ("mlp_bwd_dwms_acc", "K10 ln_dwms_mlp_bwd, (b1) stencil, dacc, hg"),
          ("mlp_bwd_dwms_adj", "K10 ln_dwms_mlp_bwd, (b2) dh and tap gradients"),
          (("mlp_bwd_dx_kernel", "@ ln_dwms_mlp_bwd"),
           "K10 ln_dwms_mlp_bwd, (c) dh w1 and LN adjoint"),
          (("mlp_bwd_wgrad_kernel", "@ ln_dwms_mlp_bwd"),
           "K10 ln_dwms_mlp_bwd, (d) dW1, dW2 products"),
          (("mlp_bwd_sum_kernel", "@ ln_dwms_mlp_bwd"), "K10 ln_dwms_mlp_bwd, (e) partial sums"),
          ("mlp_bwd_", "K9 / K10 tail, launched outside their ranges"),
          ("bwd_summary_kernel", "K8 ss2d_scan_bwd, (a1) segment summaries"),
          ("bwd_scan_kernel", "K8 ss2d_scan_bwd, (a2) adjoint scan"),
          ("bwd_dbc_kernel", "K8 ss2d_scan_bwd, (b) projection adjoint"),
          ("bwd_dx_kernel", "K8 ss2d_scan_bwd, (c) dx gather"),
          ("bwd_wgrad_kernel", "K8 ss2d_scan_bwd, (d) weight partials"),
          ("sum_parts_kernel", "K8 ss2d_scan_bwd, (e) partial sums"),
          ("ss2d_seg_kernel", "K1 ss2d_scan, segment scans"),
          ("ss2d_proj_kernel", "K1 ss2d_scan, projection launch"),
          ("ss2d_merge_kernel", "K2 ss2d_merge"),
          ("expand_wgmma_kernel", "K3 expand_ln"), ("expand_simt_kernel", "K3 expand_ln"),
          ("head_wgmma_kernel", "K4 final_head"), ("head_simt_kernel", "K4 final_head"),
          ("prologue_kernel", "K5 prologue"),
          ("ln_mlp_kernel", "K6 ln_mlp"),
          ("ln_fc_kernel<0>", "K7 ln_dwms_mlp, (i) LN and fc1"),
          ("dwms_tile_kernel", "K7 ln_dwms_mlp, (ii) stencil, GELU and fc2"),
          ("dwmlp_tile_kernel", "K11 ln_dwmlp"),
          ("ln_fc_kernel<3>", "K13 window_attn, (i) LN and qkv projection"),
          ("window_attn_kernel", "K13 window_attn, (ii) attention and out projection"),
          ("sra_kernel", "K12 sra"),
          ("finish_split_kernel", "split sums of K6/K7/K11"),
          ("layer_norm", "LayerNorm (torch)"), ("softmax", "softmax (torch)"),
          ("dgrad", "conv backward (cuDNN)"), ("wgrad", "conv backward (cuDNN)"),
          ("conv", "conv (cuDNN)"), ("cudnn", "conv (cuDNN)"), ("fprop", "conv (cuDNN)"),
          ("gemm", "GEMM (cuBLAS)"), ("xmma", "GEMM (cuBLAS)"), ("cutlass", "GEMM (cuBLAS)"),
          ("multi_tensor_apply", "Adam (torch._foreach)"),
          ("reduce_kernel", "reductions (torch)"), ("upsample", "bilinear resize (torch)"))


def profile_breakdown(fn, wall_ms, label, grad=False, per="fwd"):
    from tramba_tpu_torch.utils.profiling import device_time_by_kernel

    iters = 3
    times = device_time_by_kernel(fn, iters=iters, grad=grad, ranges=RANGES)
    if not times:
        print(f"profile {label}: the profiler recorded no device activity", flush=True)
        return
    groups = {}
    for name, (us, n) in times.items():
        g = next((grp for frags, grp in GROUPS
                  if all(f in name.lower() or f in name
                         for f in (frags if isinstance(frags, tuple) else (frags,)))),
                 "elementwise / other")
        gus, gn = groups.get(g, (0.0, 0))
        groups[g] = (gus + us, gn + n)
    busy = sum(us for us, _ in groups.values()) / iters / 1e3
    print(f"profile {label}: device busy {busy:.3f} ms per {per} of {wall_ms:.3f} ms wall "
          f"(idle share {max(0.0, 1 - busy / wall_ms):.3f})", flush=True)
    for g, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:52s} {us / iters / 1e3:9.3f} ms/{per} "
              f"{100 * us / iters / 1e3 / busy:6.2f}% {n // iters:5d} launches/{per}", flush=True)


def train_batch(B, size, seed):
    """A seeded batch: normal images and masks of smooth random blobs."""
    g = torch.Generator().manual_seed(seed)
    images = torch.randn(B, size, size, 3, generator=g)
    noise = torch.randn(B, 1, size, size, generator=g)
    blobs = torch.nn.functional.avg_pool2d(noise, 31, stride=1, padding=15)
    return images, (blobs > 0).float().permute(0, 2, 3, 1)


# the trained models of phase 8, and the reduced-depth step each is held to
# the CPU with: (image size, build overrides)
TRAINED = ("Tramba-V-TSOD", "Tramba-S-TSOD", "Tramba-P-TSOD", "Tramba-R-TSOD", "BaseUMamba-SOD")
REDUCED = {"Tramba-V-TSOD": (96, dict(dims=128, enc_depths=(1, 1, 2, 1), dec_depths=(1, 1, 1, 1))),
           "BaseUMamba-SOD": (96, dict(dims=128, enc_depths=(1, 1, 2, 1),
                                       dec_depths=(1, 1, 1, 1))),
           "Tramba-S-TSOD": (96, dict(enc_config=dict(depths=(2, 2, 2, 2)),
                                      dec_depths=(1, 1, 1, 1))),
           "Tramba-P-TSOD": (128, dict(enc_config=dict(depths=(1, 1, 1, 1)),
                                       dec_depths=(1, 1, 1, 1))),
           "Tramba-R-TSOD": (64, dict(enc_config=dict(layers=(1, 1, 1, 1)), dec_depths=(1, 1, 1),
                                      dec_drop_path=0.0))}


def unused_parameter(name: str) -> bool:
    """Tramba-R's stage 4 runs for its running statistics, but its output
    feeds no head: its parameters are frozen and get no gradient (JAX's are
    0)."""
    return name.startswith("encoder.layer4.")


def run_training(dev, card, dtype, method="Tramba-V-TSOD"):
    """Phase 8: train steps of the full-width ``method`` at batch 4 in the
    compute dtype ``dtype`` (parameters fp32)."""
    from tramba_tpu_torch.models.registry import build
    from tramba_tpu_torch.nn.layers import set_drop_path_generator
    from tramba_tpu_torch.train.optim import make_optimizer
    from tramba_tpu_torch.train.step import train_step

    name = NAMES[dtype]
    model = build(method, 384, device=dev, seed=0, dtype=dtype)
    set_drop_path_generator(model, torch.Generator(device=dev).manual_seed(1026))
    opt = make_optimizer(model.named_parameters(), 1e-4, [60], [0.2], 1, mu_dtype=torch.bfloat16)
    images, gts = (t.to(dev) for t in train_batch(4, 384, seed=2))

    def step():
        return train_step(model, opt, images, gts)

    reset_counts()
    step()
    launches = read_counts()
    want = expected_launches(model, train=True)
    print(f"one {method} {name} train step B4: launches {launches}", flush=True)
    if launches != want:
        raise AssertionError(f"{method} {name} train step launches {launches}, expected {want}")
    named = list(model.named_parameters())
    bad = [n for n, p in named if not unused_parameter(n)
           and (p.grad is None or not torch.isfinite(p.grad).all().item())]
    bad += [n for n, p in named if unused_parameter(n) and p.grad is not None]
    bad += [n for n, p in named if p.requires_grad == unused_parameter(n)]
    if bad:
        raise AssertionError(f"{len(bad)} parameters without a finite gradient (or with one "
                             f"where none flows, or frozen where one does), e.g. {bad[:5]}")
    unused = sum(unused_parameter(n) for n, _ in named)
    print(f"every one of {len(named) - unused} parameters has a finite gradient"
          + (f"; the {unused} of stage 4, which feeds no head, none" if unused else ""),
          flush=True)

    losses = [step().item() for _ in range(10)]
    print("loss over 10 steps on one batch: " + " ".join(f"{v:.4f}" for v in losses), flush=True)
    if not (all(np.isfinite(losses)) and np.mean(losses[-3:]) < losses[0]):
        raise AssertionError(f"the loss did not fall over 10 steps: {losses}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(step, reps=5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{method} 384px {name} train step B4: {ms:.2f} ms/step, {4000 / ms:.1f} "
          f"img/s, peak memory {peak:.2f} GiB [{card}]", flush=True)
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3 * 1e3
    profile_breakdown(step, wall, f"{method} {name} train B4", grad=True, per="step")
    return ms, peak


def _rel(a, b):
    return (a - b).norm().item() / max(b.norm().item(), 1e-30)


def compare_reduced_step(dev, dtype, method="Tramba-V-TSOD"):
    """Phase 8: one loss and backward of a reduced-depth ``method``
    (:data:`REDUCED`) on the card and on the CPU, in ``dtype``: eval mode (no
    stochastic depth), but Tramba-R in train mode with drop path 0, so that
    its BatchNorms take batch statistics and move their running ones, which
    are held too.  fp32: loss rtol 1e-4, every gradient (and running
    statistic) within 1e-3 relative norm.  bf16: the loss and each of them
    within 2e-2 relative (norm), or 1.25 x the CPU's own bf16-vs-fp32 gap of
    that value where it is larger (the heads' bf16 gate)."""
    from tramba_tpu_torch.models.registry import build
    from tramba_tpu_torch.train.loss import deep_supervision_loss

    size, cut = REDUCED[method]
    images, gts = train_batch(2, size, seed=3)
    runs = [(dev, dtype), (torch.device("cpu"), dtype)]
    if dtype == torch.bfloat16:
        runs.append((torch.device("cpu"), torch.float32))
    res = []
    for d, dt in runs:
        t0 = time.perf_counter()
        model = build(method, size, device=d, seed=0, dtype=dt, **cut)
        model.train(method == "Tramba-R-TSOD")
        loss = deep_supervision_loss(model(images.to(d)), gts.to(d))
        loss.backward()
        values = {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None}
        values.update({n: b.cpu() for n, b in model.named_buffers() if "running_" in n})
        res.append((loss.item(), values))
        print(f"reduced {method} step on {d.type} {NAMES[dt]}: loss {loss.item():.6f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    (lc, gc), (lp, gp) = res[:2]
    if gc.keys() != gp.keys():
        raise AssertionError(f"card and CPU differ in what has a gradient: "
                             f"{sorted(gc.keys() ^ gp.keys())[:5]}")
    if dtype == torch.float32:
        loss_tol = TRAIN_LOSS_RTOL
        tols = dict.fromkeys(gp, TRAIN_GRAD_REL)
    else:
        lf, gf = res[2]
        loss_tol = max(2e-2, BF16_NOISE_FACTOR * abs(lp - lf) / abs(lf))
        tols = {n: max(2e-2, BF16_NOISE_FACTOR * _rel(g, gf[n])) for n, g in gp.items()}
    worst = max((_rel(gc[n], g) / tols[n], _rel(gc[n], g), tols[n], n) for n, g in gp.items())
    bad = [n for n, g in gp.items() if not _rel(gc[n], g) <= tols[n]]
    print(f"reduced {method} {NAMES[dtype]} step card vs CPU: loss rel diff "
          f"{abs(lc - lp) / abs(lp):.3e} (limit {loss_tol:.3e}); worst per-parameter gradient "
          f"rel norm {worst[1]:.3e} against its limit {worst[2]:.3e} ({worst[3]}); "
          f"{len(gp) - len(bad)} of {len(gp)} values within their limits", flush=True)
    if abs(lc - lp) > loss_tol * abs(lp) or bad:
        raise AssertionError(f"reduced {method} {NAMES[dtype]} step: loss {lc} vs {lp}, worst "
                             f"{worst}, {len(bad)} values beyond their limits")


def write_tsod(root, splits, seed, size=None):
    """A TSOD10K-layout folder {root}/{split}/{image,mask} of seeded images,
    each ``size`` (W, H) or of a random size."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, n in splits.items():
        for sub in ("image", "mask"):
            os.makedirs(os.path.join(root, split, sub))
        for i in range(n):
            w, h = size or (int(rng.integers(300, 640)), int(rng.integers(200, 480)))
            mask = np.zeros((h, w), np.uint8)
            y0, x0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
            mask[y0:y0 + h // 3, x0:x0 + w // 3] = 255
            img = np.clip(np.stack([mask] * 3, -1) * 0.5 + rng.integers(0, 128, (h, w, 3)), 0, 255)
            Image.fromarray(img.astype(np.uint8), "RGB").save(
                os.path.join(root, split, "image", f"{split}_{i}.jpg"))
            Image.fromarray(mask, "L").save(os.path.join(root, split, "mask", f"{split}_{i}.png"))


def host_cpu() -> str:
    """The host's CPU model (its vendor, family and model numbers where the
    name is hidden) and its count of logical CPUs."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for ln in f:
            key, _, value = ln.partition(":")
            info.setdefault(key.strip(), value.strip())
    name = info.get("model name", "unknown")
    if name == "unknown":
        name = (f"{info.get('vendor_id', '?')} family {info.get('cpu family', '?')} model "
                f"{info.get('model', '?')}")
    return f"{name}, {info.get('cpu MHz', '?')} MHz, {os.cpu_count()} CPUs"


LOADER_FRAMES, LOADER_BATCH, LOADER_SIZE, LOADER_REPS = 16, 8, 384, 7


def run_loader(tmp, card):
    """Phase 8b: the eval loader on 1080p frames.  The native resizes and
    ``preprocess_eval_batch`` against PIL's path on every frame (a mismatch
    raises); then, in turns, the median ms per B8 batch of three routes and
    the median ms of one frame's resize on two.  ``static_resize`` is the
    module's own again when the phase ends."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from tramba_tpu_torch.data import native, transforms
    from tramba_tpu_torch.data.pipeline import BatchLoader, SODDataset

    write_tsod(tmp, {"Test": LOADER_FRAMES}, seed=5, size=(1920, 1080))
    ds = SODDataset(tmp, ["Test"], LOADER_SIZE, mode="test")
    S, mean, std = LOADER_SIZE, transforms.IMAGENET_MEAN, transforms.IMAGENET_STD

    def decode(i):
        return (np.asarray(Image.open(ds.images[i]).convert("RGB")),
                np.asarray(Image.open(ds.gts[i]).convert("L")))

    def pil_resize(sample, size):
        sample["image"] = sample["image"].resize((size, size), Image.BILINEAR)
        sample["gt"] = sample["gt"].resize((size, size), Image.NEAREST)
        return sample

    def native_resize(sample, size):
        sample["image"] = Image.fromarray(
            native.resize_bilinear(np.asarray(sample["image"]), size), "RGB")
        sample["gt"] = Image.fromarray(native.resize_nearest(np.asarray(sample["gt"]), size), "L")
        return sample

    def sample(img, gt):
        return {"image": Image.fromarray(img), "gt": Image.fromarray(gt)}

    frames = [decode(i) for i in range(len(ds))]
    for i, (img, gt) in enumerate(frames):
        want = pil_resize(sample(img, gt), S)
        for route, resize in (("static_resize", transforms.static_resize),
                              ("the native resize", native_resize)):
            got = resize(sample(img, gt), S)
            for key in ("image", "gt"):
                if not np.array_equal(np.asarray(got[key]), np.asarray(want[key])):
                    raise AssertionError(f"loader frame {i} {key}: {route} differs from PIL's")
    err = 0.0
    for lo in range(0, len(frames), LOADER_BATCH):
        chunk = frames[lo:lo + LOADER_BATCH]
        out_img, out_mask = native.preprocess_eval_batch([f[0] for f in chunk],
                                                         [f[1] for f in chunk], S, mean, std)
        for j, (img, gt) in enumerate(chunk):
            want = transforms.finalize(pil_resize(sample(img, gt), S))
            err = max(err, float(np.abs(out_img[j] - want["image"]).max()),
                      float(np.abs(out_mask[j] - want["gt"]).max()))
    if err > 1e-6:
        raise AssertionError(f"preprocess_eval_batch differs from the Python path by {err}")
    print(f"loader: {len(frames)} 1920x1080 frames to {S}: native resizes byte-equal to PIL's, "
          f"preprocess_eval_batch within {err:.1e} of eval_transform", flush=True)

    def batched_epoch():
        def load(batch):
            imgs, gts = zip(*(decode(i) for i in batch))
            return native.preprocess_eval_batch(list(imgs), list(gts), S, mean, std)

        batches = [range(lo, min(lo + LOADER_BATCH, len(ds)))
                   for lo in range(0, len(ds), LOADER_BATCH)]
        with ThreadPoolExecutor(max_workers=loader.num_threads) as pool:
            if sum(len(out[0]) for out in pool.map(load, batches)) != len(ds):
                raise AssertionError("preprocess_eval_batch lost frames")

    own = transforms.static_resize
    loader = BatchLoader(ds, batch_size=LOADER_BATCH)  # its default threads
    routes = {"PIL": pil_resize, "native": native_resize, "preprocess_eval_batch": None}
    ms = {name: [] for name in routes}
    try:
        for rep in range(LOADER_REPS + 1):  # the first round warms up
            for name, resize in routes.items():
                transforms.static_resize = resize or own
                t0 = time.perf_counter()
                if resize is None:
                    batched_epoch()
                elif sum(len(b["name"]) for b in loader) != len(ds):
                    raise AssertionError(f"BatchLoader ({name}) lost frames")
                if rep:
                    ms[name].append((time.perf_counter() - t0) * 1e3 / (len(ds) // LOADER_BATCH))
    finally:
        transforms.static_resize = own
    one = {"PIL": [], "native": []}  # one frame's resize in this thread, in turns
    for _ in range(3):
        for name, resize in (("PIL", pil_resize), ("native", native_resize)):
            for img, gt in frames[:8]:
                frame = sample(img, gt)
                t0 = time.perf_counter()
                resize(frame, S)
                one[name].append((time.perf_counter() - t0) * 1e3)
    per_batch = ", ".join(f"{k} {np.median(v):.2f} ms (runs {', '.join(f'{t:.2f}' for t in v)})"
                          for k, v in ms.items())
    per_frame = ", ".join(f"{k} {np.median(v):.3f} ms" for k, v in one.items())
    print(f"loader B{LOADER_BATCH} 1920x1080 -> {S} per batch, median of {LOADER_REPS}: "
          f"{per_batch}; one frame's resize (image and mask), median of 24: {per_frame} "
          f"[{card}] [{host_cpu()}]", flush=True)


def run_train_entry_point(tmp, dtype):
    """Phase 9: the training CLI at full width, batch 4, ``--dtype`` of
    ``dtype``, 2 epochs on 8 train images with the in-loop eval of 4 test
    images from epoch 2, in this process (for the launch counts); a
    weights-only resume from the best-MAE file to epoch 5, which writes the
    rolling resume dict; then ``--resume last`` to epoch 6 as ``python -m
    tramba_tpu_torch.run``.  Returns the launch counts of the first run."""
    from tramba_tpu_torch import run

    data, out = os.path.join(tmp, "data"), os.path.join(tmp, "results")
    write_tsod(data, {"Train": 8, "Test": 4}, seed=4)
    flags = ["--method", "Tramba-V-TSOD", "--data_root", data, "--evaluation_root", data,
             "--batch_size", "4", "--save_model", out, "--tf_log_path", "",
             "--pretrained_path", "", "--see", "2", "--dtype", str(dtype).replace("torch.", "")]
    reset_counts()
    t0 = time.perf_counter()
    model, _ = run.main(flags + ["--train_epochs", "2"])
    launches = read_counts()
    print(f"run {NAMES[dtype]}: 2 epochs in {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}", flush=True)
    # 2 epochs of 2 steps, one eval batch of 4 images
    step, fwd = expected_launches(model, train=True), expected_launches(model, train=False)
    want = {k: 4 * n + fwd[k] for k, n in step.items()}
    del model
    if launches != want:
        raise AssertionError(f"run launches {launches}, expected {want}")
    save_dir = os.path.join(out, "Tramba-V-TSOD")
    best = [f for f in os.listdir(save_dir) if "_MAE_" in f]
    record = os.path.join(out, "Record_Tramba-V-TSOD.txt")
    if len(best) != 1 or "Epoch:2||train_loss" not in open(record).read():
        raise AssertionError(f"run wrote {os.listdir(save_dir)}; record {os.path.exists(record)}")
    print(f"run wrote {best[0]} and the record", flush=True)
    model, opt = run.main(flags + ["--train_epochs", "5", "--resume",
                                   os.path.join(save_dir, best[0])])
    if opt.count != {"encoder": 6, "rest": 6} \
            or not os.path.exists(os.path.join(save_dir, "Tramba-V-TSOD_resume.pth")):
        raise AssertionError(f"weights-only resume: {opt.count} steps; {os.listdir(save_dir)}")
    del model, opt
    torch.cuda.empty_cache()
    res = subprocess.run([sys.executable, "-m", "tramba_tpu_torch.run", *flags,
                          "--train_epochs", "6", "--resume", "last"], capture_output=True,
                         text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    if res.returncode != 0 or "starting from epoch 6" not in res.stdout \
            or "Epoch [006/006] loss" not in res.stdout:
        raise AssertionError(f"--resume last failed ({res.returncode}):\n{res.stdout[-2000:]}\n"
                             f"{res.stderr[-3000:]}")
    print("python -m tramba_tpu_torch.run --resume last: " + next(
        ln for ln in res.stdout.splitlines() if ln.startswith("Epoch [006/006]")), flush=True)
    return launches


# phase 9's encoder variants and the depth they train at: the reduced steps'
GRAFTED = {m: REDUCED[m][1] for m in ("Tramba-S-TSOD", "Tramba-P-TSOD", "Tramba-R-TSOD")}


def run_graft_entry_point(tmp, method):
    """Phase 9: the training CLI for an encoder variant at the depth of
    :data:`GRAFTED` (full width, 384 px, bf16, batch 4), with
    ``--pretrained_path auto``: the phase writes a seeded encoder checkpoint
    under the released file's name in ``--pretrained_model``, the CLI grafts
    it and trains one epoch of 2 steps, with exact launch counts.  Returns
    the launch counts."""
    import contextlib
    import functools
    import io

    from tramba_tpu_torch import run
    from tramba_tpu_torch.compat.torch_weights import upstream_encoder_state_dict
    from tramba_tpu_torch.models.registry import build
    from tramba_tpu_torch.train import loop

    cut = GRAFTED[method]
    pre = os.path.join(tmp, "pretrained")
    os.makedirs(pre)
    path = os.path.join(pre, run._PRETRAINED[method.split("-")[1]])
    torch.save(upstream_encoder_state_dict(build(method, 384, device="cpu", seed=7, **cut)),
               path)
    data = os.path.join(tmp, "data")
    write_tsod(data, {"Train": 8}, seed=5)
    flags = ["--method", method, "--data_root", data, "--batch_size", "4", "--save_model",
             os.path.join(tmp, "results"), "--tf_log_path", "", "--pretrained_model", pre,
             "--see", "2", "--train_epochs", "1", "--dtype", "bfloat16"]
    full_build, loop.build = loop.build, functools.partial(build, **cut)
    out = io.StringIO()
    try:
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            model, _ = run.main(flags)
        launches = read_counts()
    finally:
        loop.build = full_build
    text = out.getvalue()
    print(f"run {method} (depths {cut}) bf16, grafted: 1 epoch in "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}", flush=True)
    loaded = f"Loaded pretrained encoder for {method} from {path}"
    if loaded not in text or "Epoch [001/001] loss" not in text:
        raise AssertionError(f"{method}: the CLI did not graft and train:\n{text[-2000:]}")
    print(next(ln for ln in text.splitlines() if ln.startswith("Epoch [001/001]")), flush=True)
    want = {k: 2 * n for k, n in expected_launches(model, train=True).items()}
    if launches != want:
        raise AssertionError(f"{method} run launches {launches}, expected {want}")
    return launches


BACKENDS = ("tensor_parallel", "seq_parallel", "hybrid_tp_sp")


def run_parallel(dev, card, x, default_heads, noise):
    """Phase 10: the parallel layer on an NCCL world of one process.  The
    full-width 384 px Tramba-V forward on each parallel backend, fp32 and
    bf16, at batch 2, with exact launches, its heads against the default
    route's (``default_heads``, phase 4; fp32 mean abs <= 1e-3 per head;
    bf16 phase 4's gate, max(2e-2, 1.25 x ``noise``, the CPU's bf16-vs-fp32
    gap of the head)) and its ms per forward in turns with the default
    route; then one train step
    of each of the four dry-run phases at full width, batch 2, fp32, with
    exact launches (K14 once forward and once reversed per SS2D), ms per step,
    peak memory and profiles; then ``python -m tramba_tpu_torch.dryrun --n 1``.
    Returns the launches of the tensor-parallel train step."""
    import torch.distributed as dist

    from tramba_tpu_torch import dryrun
    from tramba_tpu_torch.models.registry import build
    from tramba_tpu_torch.parallel.mesh import make_grid
    from tramba_tpu_torch.parallel.seq_scan import use_sequence_group
    from tramba_tpu_torch.parallel.tp import use_tensor_group

    x = x.to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1,
                                rank=0)
        try:
            grid = make_grid(1, 1)
            with torch.no_grad(), use_tensor_group(grid.model), use_sequence_group(grid.seq):
                for dtype in (torch.float32, torch.bfloat16):
                    default = build("Tramba-V-TSOD", 384, device=dev, seed=0, dtype=dtype)
                    for backend in BACKENDS:  # the same parameters on every backend
                        model = build("Tramba-V-TSOD", 384, device=dev, seed=None, dtype=dtype,
                                      ssm_backend=backend)
                        model.load_state_dict(default.state_dict())
                        reset_counts()
                        outs = model(x)
                        launches = read_counts()
                        want = expected_launches(model, train=False)
                        if launches != want:
                            raise AssertionError(f"{backend} {NAMES[dtype]} forward launches "
                                                 f"{launches}, expected {want}")
                        for i, (o, d) in enumerate(zip(outs, default_heads[dtype])):
                            diff = (o.float() - d.float()).abs().mean().item()
                            tol = HEAD_MEAN_ABS_TOL[dtype]
                            if dtype == torch.bfloat16:
                                tol = max(tol, BF16_NOISE_FACTOR * noise[i])
                            print(f"{backend} {NAMES[dtype]} head {i}: vs the default route mean "
                                  f"abs {diff:.3e} (limit {tol:.3e})", flush=True)
                            if not (torch.isfinite(o).all().item() and diff <= tol):
                                raise AssertionError(f"{backend} {NAMES[dtype]} head {i}: {diff}")
                        del outs
                        ms = [cuda_ms(lambda: m(x), 2) for m in (default, model, model, default)]
                        print(f"Tramba-V-TSOD 384px {NAMES[dtype]} B2 forward: {backend} "
                              f"{ms[1]:.2f} / {ms[2]:.2f} ms, default route {ms[0]:.2f} / "
                              f"{ms[3]:.2f} ms; K14 {launches['linear_scan']} launches "
                              f"[{card}]", flush=True)
                        if dtype == torch.float32:
                            profile_breakdown(lambda: model(x), ms[1],
                                              f"{backend} fp32 B2 forward")
                        del model
                    del default
                    torch.cuda.empty_cache()

            step_launches = {}

            def on_step(name, model, step):
                reset_counts()
                step()
                launches = read_counts()
                want = expected_launches(model, train=True)
                if launches != want:
                    raise AssertionError(f"{name} step launches {launches}, expected {want}")
                step_launches[name] = launches
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(step, reps=2)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                print(f"dry-run phase {name}: full-width Tramba-V 384px fp32 train step B2 "
                      f"{ms:.2f} ms/step, peak memory {peak:.2f} GiB; K14 "
                      f"{launches['linear_scan']} launches [{card}]", flush=True)
                profile_breakdown(step, ms, f"{name} fp32 train B2", grad=True, per="step")

            t0 = time.perf_counter()
            res = dryrun.run_phases(dev, img_size=384, batch=2, min_l=4096, model_kw={},
                                    on_step=on_step)
            print(f"dry-run phases at full width: {res} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        finally:
            dist.destroy_process_group()
    out = subprocess.run([sys.executable, "-m", "tramba_tpu_torch.dryrun", "--n", "1"],
                         capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("dryrun(")]
    print("\n".join(lines), flush=True)
    if out.returncode != 0 or len(lines) != 4:
        raise AssertionError(f"python -m tramba_tpu_torch.dryrun --n 1 failed "
                             f"({out.returncode}):\n{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    return step_launches["dp x tp"]


def main() -> int:
    phase("1 device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    phase("2 build")
    from tramba_tpu_torch.data import native
    from tramba_tpu_torch.ops import _native

    t0 = time.perf_counter()
    print(f"built {_native.build()} in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    print(f"built {native.build()} in {time.perf_counter() - t0:.1f} s", flush=True)

    phase("3 kernels vs plain versions")
    checks = Checks()
    gen = torch.Generator().manual_seed(0)
    check_ss2d_expand(checks, dev, gen, torch.float32)
    check_ss2d_expand(checks, dev, gen, torch.bfloat16)
    # K3 / K4 at the batch of the timed bf16 forward, where their B2 calls
    # are dominated by the host's clock
    check_ss2d_expand(checks, dev, gen, torch.bfloat16, (), B=16)
    check_bf16_only(checks, dev, gen)
    check_lgp(checks, dev, gen)
    check_encoder_kernels(checks, dev, gen)
    check_dwms_grid_shape(checks, dev, gen)
    for dtype in (torch.float32, torch.bfloat16):  # K1-K4 at Tramba-P's and -R's decoders
        check_ss2d_expand(checks, dev, gen, dtype, SS2D_SHAPES_P, EXPAND_SHAPES_P, head_c=64)
        check_ss2d_expand(checks, dev, gen, dtype, SS2D_SHAPES_R, EXPAND_SHAPES_R, head_c=256)
    check_bf16_only(checks, dev, gen, BF16_SHAPES_P)
    check_bf16_only(checks, dev, gen, BF16_SHAPES_R)
    for dtype in (torch.float32, torch.bfloat16):
        for shapes in (SS2D_SHAPES, SS2D_SHAPES_P, SS2D_SHAPES_R):
            check_train_kernels(checks, dev, gen, dtype, shapes)
    for shapes in (MLP_BWD_SHAPES, MLP_BWD_SHAPES_P, MLP_BWD_SHAPES_R):
        check_mlp_bwd(checks, dev, gen, shapes)
    check_linear_scan(checks, dev, gen)
    check_segmented_scans(checks, dev, gen)
    # K1 / K2 over the other scan orders; the train variants and K8 over a K=8 one
    for dtype in (torch.float32, torch.bfloat16):
        check_ss2d_expand(checks, dev, gen, dtype, NEW_ORDER_SHAPES, (), head_c=None,
                          table_fault=True)
        check_train_kernels(checks, dev, gen, dtype, NEW_ORDER_SHAPES[2:3])
    torch.cuda.empty_cache()

    phase("4 model")
    x = torch.randn(2, 384, 384, 3, generator=torch.Generator().manual_seed(1))
    launches, models, heads = {}, {}, {}
    for method in MODELS:
        cpu_heads = {}
        for dtype in (torch.float32, torch.bfloat16):
            key = (method, dtype)
            launches[key], models[key], heads[key], cpu_heads[dtype] = run_model(
                dev, dtype, x, cpu_heads.get(torch.float32), method)
        if method == "Tramba-V-TSOD":  # phase 10's reference heads and bf16 noise floor
            v_heads = {dt: [h.clone() for h in heads[method, dt]]
                       for dt in (torch.float32, torch.bfloat16)}
            v_noise = [(b - f).abs().mean().item()
                       for b, f in zip(cpu_heads[torch.bfloat16], cpu_heads[torch.float32])]
        pairs = zip(heads[method, torch.bfloat16], heads[method, torch.float32])
        for i, (b, f) in enumerate(pairs):
            d = (b.float() - f).abs().mean().item()
            mae = (torch.sigmoid(b.float()) - torch.sigmoid(f)).abs().mean().item()
            print(f"{method} head {i}: bf16 card vs fp32 card mean abs {d:.3e}, sigmoid-map MAE "
                  f"{mae:.3e}", flush=True)
    heads.clear()

    phase("5 dump entry point")
    for method, flags in (("Tramba-V-TSOD", ("--measure_fps",)),
                          ("Tramba-V-TSOD", ("--dtype", "bfloat16")),
                          ("Tramba-P-TSOD", ("--dtype", "bfloat16")),
                          ("Tramba-S-TSOD", ("--dtype", "bfloat16")),
                          ("Tramba-R-TSOD", ("--dtype", "bfloat16"))):
        with tempfile.TemporaryDirectory() as tmp:
            run_dump_entry_point(tmp, method, *flags)
    for flags in ((), ("--dtype", "bfloat16")):  # the scoring CLIs on the fp32 maps
        with tempfile.TemporaryDirectory() as tmp:
            run_sod_entry_points(tmp, "BaseUMamba-SOD", *flags, score=not flags)

    phase("6 timing")
    with torch.no_grad():
        for method in MODELS:
            for dtype, batches in TIMED[method]:
                model = models[method, dtype]
                for B, reps in batches:
                    xb = torch.randn(B, 384, 384, 3, device=dev)
                    ms = cuda_ms(lambda: model(xb), reps, warmup=2)
                    print(f"{method} 384px {NAMES[dtype]} B{B}: {ms:.2f} ms/forward, "
                          f"{1000 * B / ms:.1f} img/s [{card}]", flush=True)
        # what the encoders' per-call weight casts cost at B1: the same
        # forward with those weights cast once, in turns with the model
        xb = torch.randn(1, 384, 384, 3, device=dev)
        for method in ("Tramba-P-TSOD", "Tramba-S-TSOD"):
            model = models[method, torch.bfloat16]
            once = encoder_weights_cast_once(model)
            diff = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(model(xb), once(xb)))
            ms = [cuda_ms(lambda: m(xb), 20, warmup=2) for m in (model, once, model, once)]
            print(f"{method} 384px bf16 B1: encoder weights cast at each use {ms[0]:.2f} / "
                  f"{ms[2]:.2f} ms, cast once {ms[1]:.2f} / {ms[3]:.2f} ms (heads differ by "
                  f"{diff:.1e}) [{card}]", flush=True)
            del once

    phase("7 profile")
    for method, B in ((m, B) for m in MODELS for B in (1, 16)):
        model = models[method, torch.bfloat16]
        xb = torch.randn(B, 384, 384, 3, device=dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(3):
                model(xb)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3 * 1e3
        profile_breakdown(lambda: model(xb), wall, f"{method} bf16 B{B}")
        del xb
    models.clear()
    torch.cuda.empty_cache()

    phase("8 train")
    for method in TRAINED:
        for dtype in (torch.float32, torch.bfloat16):
            run_training(dev, card, dtype, method)
            compare_reduced_step(dev, dtype, method)
            torch.cuda.empty_cache()

    phase("8b loader")
    with tempfile.TemporaryDirectory() as tmp:
        run_loader(tmp, card)

    phase("9 training entry point")
    train_launches = {}
    for dtype in (torch.float32, torch.bfloat16):
        with tempfile.TemporaryDirectory() as tmp:
            train_launches[f"{NAMES[dtype]} train"] = run_train_entry_point(tmp, dtype)
        torch.cuda.empty_cache()
    for method in GRAFTED:
        with tempfile.TemporaryDirectory() as tmp:
            run_graft_entry_point(tmp, method)
        torch.cuda.empty_cache()

    phase("10 parallel")
    parallel_launches = run_parallel(dev, card, x, v_heads, v_noise)
    torch.cuda.empty_cache()

    ss2d, expand = "tramba_tpu_torch/csrc/ss2d.cu", "tramba_tpu_torch/csrc/expand.cu"
    mlp, mlp_bwd = "tramba_tpu_torch/csrc/mlp.cu", "tramba_tpu_torch/csrc/mlp_bwd.cu"
    attn = "tramba_tpu_torch/csrc/attn.cu"
    sources = {"ss2d_scan": (ss2d, "tramba_tpu/ops/fused_ss2d.py:1505"),
               "ss2d_merge": (ss2d, "tramba_tpu/ops/fused_ss2d.py:1561"),
               "expand_ln": (expand, "tramba_tpu/ops/fused_expand.py:59"),
               "final_head": (expand, "tramba_tpu/ops/fused_expand.py:165"),
               "prologue": ("tramba_tpu_torch/csrc/prologue.cu",
                            "tramba_tpu/ops/fused_prologue.py:94"),
               "ln_mlp": (mlp, "tramba_tpu/ops/fused_mlp.py:130"),
               "ln_dwms_mlp": (mlp, "tramba_tpu/ops/fused_mlp.py:360 (_dwms_pallas), "
                                    "tramba_tpu/ops/fused_mlp.py:457 (_dwms_pallas2)"),
               "ss2d_scan_bwd": ("tramba_tpu_torch/csrc/ss2d_bwd.cu",
                                 "tramba_tpu/ops/fused_ss2d.py:638"),
               "ln_mlp_bwd": (mlp_bwd, "tramba_tpu/ops/fused_mlp.py:233"),
               "ln_dwms_mlp_bwd": (mlp_bwd, "tramba_tpu/ops/fused_mlp.py:674"),
               "ln_dwmlp": (mlp, "tramba_tpu/ops/fused_mlp.py:844"),
               "sra": (attn, "tramba_tpu/ops/fused_attn.py:96"),
               "window_attn": (attn, "tramba_tpu/ops/fused_attn.py:254"),
               "linear_scan": ("tramba_tpu_torch/csrc/scan.cu",
                               "tramba_tpu/ops/selective_scan.py:642")}
    # in bf16, K1/K2 also stand in for the whole-map _small_pallas (#13), and
    # their bf16 train variants for its emit_train; in training K1 is #1's
    # emit-carries variant and #2's materialising rows/cols kernels, K2
    # #10's emit_ysum and #3's merge (TRAMBA_TWO_PHASE_TRAIN=0); K8 stands
    # for #4 (_dirs_bwd_call) and #5 (_seq_bwd_pallas, fused_ss2d.py:747)
    f, small = "tramba_tpu/ops/fused_ss2d.py", "tramba_tpu/ops/fused_ss2d_small.py:233"
    rows_cols = f"{f}:294 (_rows_pallas), {f}:344 (_cols_pallas)"
    replaced = {("ss2d_scan", "bf16"): small,
                ("ss2d_merge", "bf16"): small,
                ("ss2d_scan", "fp32 train"): f"{f}:101 (_fused_pallas), {rows_cols}",
                ("ss2d_merge", "fp32 train"): f"{f}:1561 (_pair_phase2_rows_merge), "
                                              f"{f}:426 (_merge_pallas)",
                ("ss2d_scan", "bf16 train"): f"{small} (_small_pallas), {rows_cols}",
                ("ss2d_merge", "bf16 train"): f"{small} (_small_pallas), "
                                              f"{f}:426 (_merge_pallas)"}
    # the shape whose time the summary reports: the largest map of each kernel
    shown = {"ss2d_scan": "line 96px", "ss2d_merge": "line 96px", "ss2d_scan_bwd": "line 96px",
             "expand_ln": "f2 48px", "final_head": "96px", "prologue": "enc/dec LN 96px",
             "ln_mlp": "96px", "ln_dwms_mlp": "96px", "ln_mlp_bwd": "96px",
             "ln_dwms_mlp_bwd": "96px", "ln_dwmlp": "96px", "sra": "96px",
             "window_attn": "96px", "linear_scan": "tp raster 96px B4 fwd"}
    # `launches`: the forward of the model whose main path the kernel is on
    # (K11 / K12 Tramba-P, K13 Tramba-S, the rest Tramba-V), or the training
    # CLI's run; K14: phase 10's tensor-parallel train step (forward and
    # reversed launches), its forward and reversed rows under one entry
    home = {"ln_dwmlp": "Tramba-P-TSOD", "sra": "Tramba-P-TSOD", "window_attn": "Tramba-S-TSOD"}
    summary = []
    for (name, tag), rows in checks.rows.items():
        label, _, ms, plain_ms, bound_ms, bound_by = next(r for r in rows
                                                          if r[0].startswith(shown[name]))
        dt = torch.bfloat16 if tag.startswith("bf16") else torch.float32
        if name == "linear_scan":
            n = parallel_launches[name]
        elif tag.endswith("train"):
            n = train_launches[tag][name]
        else:
            n = launches[home.get(name, "Tramba-V-TSOD"), dt][name]
        # no single PyTorch call computes any of these fused functions
        summary.append({"name": name, "dtype": tag, "route": "cuda",
                        "source": sources[name][0],
                        "replaces": replaced.get((name, tag), sources[name][1]),
                        "launches": n,
                        "max_abs_err": max(r[1] for r in rows), "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                        "shape": label})
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
