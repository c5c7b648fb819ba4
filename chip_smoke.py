"""Smoke run of the PyTorch port (tramba_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. device    a CUDA card is present; prints its name and power limit
  2. build     nvcc builds kernels K1-K7 from tramba_tpu_torch/csrc
  3. kernels   each kernel vs its plain PyTorch version on the card, at the
               shapes of the 384px Tramba-V-TSOD forward: K1-K4 in fp32
               (rtol 1e-3, atol 1e-4), then in bf16 K1-K4 and K5-K7, and K2
               as _lgp_pallas (one-slot identity table); bf16 outputs at
               rtol 1.6e-2, atol 1e-2; errors and times
  4. model     full-width Tramba-V-TSOD at 384px, seeded weights, batch 2 on
               the card, in fp32 (TF32 off) and in bf16: head shapes, finite
               values, launches per forward (fp32: every K1-K4, no K5-K7;
               bf16: K1 33, K2 33, K3 9, K4 1, K5 33, K6 24, K7 6); the same
               weights and image on the CPU (plain versions) agree with mean
               abs difference <= 1e-3 (fp32) per head, and in bf16 <= 2e-2 or,
               where bf16's own noise is larger, <= 1.25 x the CPU's bf16-vs-
               fp32 difference on that head
  5. dump      ``python -m tramba_tpu_torch.dump --measure_fps`` on synthetic
               TSOD10K-style images writes one map per image at its original
               size, then runs the 200-iteration FPS loop; then the same dump
               with ``--dtype bfloat16``
  6. timing    ms per forward: fp32 at batch 1 and 8, bf16 at 1, 8 and 16
  7. profile   device time of the bf16 forward by kernel group (torch.profiler)

The last lines are the kernels' JSON summary, the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
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
# launches of one bf16 forward: 21 encoder + 6 decoder + 6 guide SS2Ds,
# 21 + 3 plain FFNs, 6 DWMS FFNs, 6 + 3 expands, 1 head
BF16_LAUNCHES = {"ss2d_scan": 33, "ss2d_merge": 33, "expand_ln": 9, "final_head": 1,
                 "prologue": 33, "ln_mlp": 24, "ln_dwms_mlp": 6}
BF16_ONLY = ("prologue", "ln_mlp", "ln_dwms_mlp")
NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16"}


def phase(name):
    print(f"== {name}", flush=True)


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
    from tramba_tpu_torch.ops import fused_expand as te
    from tramba_tpu_torch.ops import fused_mlp as tm
    from tramba_tpu_torch.ops import fused_prologue as tp
    from tramba_tpu_torch.ops import fused_ss2d as tf

    return (tf.ss2d_scan, tf.ss2d_merge, te.expand_ln, te.final_head, tp.prologue, tm.ln_mlp,
            tm.ln_dwms_mlp)


class Checks:
    """Phase 3 results: {(kernel, dtype): [(shape label, max_abs_err, ms, plain_ms)]}."""

    def __init__(self):
        self.rows = {}

    def compare(self, name, dt, label, kernel, plain, reps, plain_warmup=1):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        tol = KERNEL_TOL_BF16 if got.dtype == torch.bfloat16 else KERNEL_TOL
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **tol,
                                   msg=lambda m: f"{name} {NAMES[dt]} {label}: {m}")
        ms = cuda_ms(kernel, reps)
        plain_ms = cuda_ms(plain, 1, warmup=plain_warmup)
        self.rows.setdefault((name, dt), []).append((label, err, ms, plain_ms))
        print(f"{name:11s} {NAMES[dt]} {label:34s} max_abs_err {err:.3e} max_rel_err "
              f"{((got - want).abs() / want.abs().clamp_min(1e-3)).max().item():.3e} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms", flush=True)


def check_ss2d_expand(checks, dev, gen, dt):
    """K1-K4 at every shape of the main path, in dtype ``dt``."""
    from tramba_tpu_torch.nn.init import init_weights
    from tramba_tpu_torch.nn.layers import FinalPatchExpandX4, _Expand
    from tramba_tpu_torch.nn.ssm import SS2D
    from tramba_tpu_torch.ops import fused_expand as te
    from tramba_tpu_torch.ops import fused_ss2d as tf
    from tramba_tpu_torch.ops.scan_orders import order_tables

    B = 2
    # (order, map size, d_model, window/rate): every SS2D shape of the main
    # path -- encoder stages (raster), decoder blocks (line), guides (window
    # and dilation)
    for kind, H, d_model, param in (("raster", 96, 128, 0), ("raster", 48, 256, 0),
                                    ("raster", 24, 512, 0), ("raster", 12, 1024, 0),
                                    ("line", 96, 128, 0), ("line", 48, 256, 0),
                                    ("line", 24, 512, 0), ("window", 96, 128, 16),
                                    ("window", 48, 256, 12), ("window", 24, 512, 8),
                                    ("dilation", 96, 128, 4), ("dilation", 48, 256, 4),
                                    ("dilation", 24, 512, 4)):
        m = init_weights(SS2D(d_model, k_group=8 if kind == "line" else 4, scan_kind=kind,
                              scan_param=param), gen).to(dev)
        K, D = m.k_group, m.d_inner
        x = torch.nn.functional.silu(torch.randn(B, H * H, D, generator=gen)).to(dev, dt)
        core = (m.x_proj_weight.data, m.dt_projs_weight.data, m.dt_projs_bias.data,
                m.A_logs.data.view(K, D, 1), m.Ds.data.view(K, D))
        idx, inv = order_tables(kind, H, H, param, dev)
        label = f"{kind}{param or ''} {H}px B{B} K{K} D{D}"
        checks.compare("ss2d_scan", dt, label, lambda: tf.ss2d_scan(x, idx, *core),
                       lambda: tf.ss2d_scan_ref(x, idx, *core), reps=5, plain_warmup=0)
        ys = tf.ss2d_scan(x, idx, *core)
        tail = (m.out_norm.weight.data, m.out_norm.bias.data, m.out_proj.weight.data.to(dt))
        checks.compare("ss2d_merge", dt, label, lambda: tf.ss2d_merge(ys, inv, *tail),
                       lambda: tf.ss2d_merge_ref(ys, inv, *tail), reps=5)
    # (map size, C, factor): PatchExpand (f=2) and FreqExpand2D (f=4) inputs
    for H, C, f in ((12, 1024, 2), (24, 512, 2), (48, 256, 2),
                    (12, 512, 4), (24, 256, 4), (48, 128, 4)):
        m = init_weights(_Expand(C, f), gen).to(dev)
        x = torch.randn(B, H, H, C, generator=gen).to(dev, dt)
        args = (x, m.expand.weight.data.to(dt), m.norm.weight.data, m.norm.bias.data)
        checks.compare("expand_ln", dt, f"f{f} {H}px B{B} C{C}", lambda: te.expand_ln(*args),
                       lambda: te.expand_ln_ref(*args), reps=10)
    m = init_weights(FinalPatchExpandX4(128), gen).to(dev)
    seg_w = (torch.randn(128, generator=gen) * 0.1).to(dev)
    seg_b = torch.randn(1, generator=gen).to(dev)
    x = torch.randn(B, 96, 96, 128, generator=gen).to(dev, dt)
    args = (x, m.expand.weight.data.to(dt), m.norm.weight.data, m.norm.bias.data, seg_w, seg_b)
    checks.compare("final_head", dt, f"96px B{B} C128", lambda: te.final_head(*args),
                   lambda: te.final_head_ref(*args), reps=10)


def check_bf16_only(checks, dev, gen):
    """K5-K7 at every bf16 main-path shape, and K2 as _lgp_pallas."""
    from tramba_tpu_torch.nn.init import init_weights
    from tramba_tpu_torch.nn.layers import DWMSMlp, Mlp
    from tramba_tpu_torch.nn.ssm import SS2D
    from tramba_tpu_torch.ops import fused_mlp as tm
    from tramba_tpu_torch.ops import fused_prologue as tp
    from tramba_tpu_torch.ops import fused_ss2d as tf

    bf, B = torch.bfloat16, 2

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

    def ln(d):
        return rnd(d, scale=0.1, shift=1.0), rnd(d, scale=0.1)

    # encoder raster and decoder line SS2Ds (with the block's LN), guides (without)
    for H, dm, with_ln in ((96, 128, True), (48, 256, True), (24, 512, True), (12, 1024, True),
                           (96, 128, False), (48, 256, False), (24, 512, False)):
        m = init_weights(SS2D(dm), gen).to(dev)
        x = rnd(B, H, H, dm).to(bf)
        norm = ln(dm) if with_ln else (None, None)
        args = (x, *norm, m.in_proj.weight.data.to(bf), m.conv2d.weight.data.to(bf))
        label = f"{'enc/dec LN' if with_ln else 'guide'} {H}px B{B} dm{dm} D{2 * dm}"
        checks.compare("prologue", bf, label, lambda: tp.prologue(*args),
                       lambda: tp.prologue_ref(*args), reps=10)
    for H, d in ((96, 128), (48, 256), (24, 512), (12, 1024)):
        m = init_weights(Mlp(d, 4 * d), gen).to(dev)
        args = (rnd(B, H * H, d).to(bf), *ln(d), m.fc1.weight.data.to(bf), rnd(4 * d, scale=0.1),
                m.fc2.weight.data.to(bf), rnd(d, scale=0.1))
        checks.compare("ln_mlp", bf, f"{H}px B{B} d{d} hid{4 * d}", lambda: tm.ln_mlp(*args),
                       lambda: tm.ln_mlp_ref(*args), reps=10)
    for H, d in ((96, 128), (48, 256), (24, 512)):
        m = init_weights(DWMSMlp(d, 4 * d), gen).to(dev)
        convs = [t for c in (m.dwc3, m.dwc5, m.dwc7)
                 for t in (c.dw_conv.weight.data.to(bf), rnd(4 * d, scale=0.1))]
        args = (rnd(B, H, H, d).to(bf), *ln(d), m.fc1.weight.data.to(bf), rnd(4 * d, scale=0.1),
                *convs, m.fc2.weight.data.to(bf), rnd(d, scale=0.1))
        checks.compare("ln_dwms_mlp", bf, f"{H}px B{B} d{d} hid{4 * d}",
                       lambda: tm.ln_dwms_mlp(*args), lambda: tm.ln_dwms_mlp_ref(*args), reps=10)
    # K2 as _lgp_pallas (Queue 2 #14): K=1, one-slot identity inverse table
    for dt in (torch.float32, bf):
        L, D, dm = 24 * 24, 1024, 512
        ys = rnd(B, 1, L, D).to(dt).float()
        inv = torch.arange(L, dtype=torch.int32, device=dev).reshape(1, 1, L)
        tail = (*ln(D), (rnd(dm, D, scale=D ** -0.5)).to(dt))
        checks.compare("ss2d_merge", dt, f"lgp 24px B{B} K1 D{D}",
                       lambda: tf.ss2d_merge(ys, inv, *tail),
                       lambda: tf.ss2d_merge_ref(ys, inv, *tail), reps=5)


def run_model(dev, dtype, x, cpu_fp32_heads=None):
    """Phase 4 in one dtype.  Returns the launch counts of one batch-2
    forward, the model, its outputs and the CPU run's outputs (batch 1).
    ``cpu_fp32_heads``: the CPU fp32 heads, which set bf16's noise floor."""
    from tramba_tpu_torch.models.registry import build

    fns = wrappers()
    model = build("Tramba-V-TSOD", 384, device=dev, seed=0, dtype=dtype)
    n_params = sum(p.numel() for p in model.parameters())
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError("parameters must stay fp32")
    for w in fns:
        w.launches = 0
    with torch.no_grad():
        outs = model(x.to(dev))
        torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in fns}
    print(f"model Tramba-V-TSOD 384px {NAMES[dtype]}, {n_params} fp32 parameters; "
          f"launches {launches}", flush=True)
    shapes = [tuple(o.shape) for o in outs]
    want = [(2, 24, 24, 1), (2, 48, 48, 1), (2, 96, 96, 1), (2, 384, 384, 1)]
    if shapes != want:
        raise AssertionError(f"head shapes {shapes}, expected {want}")
    if any(o.dtype != dtype for o in outs):
        raise AssertionError(f"head dtypes {[o.dtype for o in outs]}, expected {dtype}")
    if not all(torch.isfinite(o).all().item() for o in outs):
        raise AssertionError("non-finite logits")
    if dtype == torch.bfloat16:
        if launches != BF16_LAUNCHES:
            raise AssertionError(f"bf16 launches {launches}, expected {BF16_LAUNCHES}")
    else:
        missing = [k for k, n in launches.items() if n == 0 and k not in BF16_ONLY]
        extra = [k for k in BF16_ONLY if launches[k]]
        if missing or extra:
            raise AssertionError(f"fp32 forward: kernels not launched {missing}, "
                                 f"bf16-only kernels launched {extra}")

    t0 = time.perf_counter()
    cpu_model = build("Tramba-V-TSOD", 384, device="cpu", seed=0, dtype=dtype)
    with torch.no_grad():
        cpu_outs = cpu_model(x[:1])
    print(f"CPU {NAMES[dtype]} forward (plain versions) {time.perf_counter() - t0:.1f} s",
          flush=True)
    for i, (g, c) in enumerate(zip(outs, cpu_outs)):
        c = c.float()
        d = (g[:1].float().cpu() - c).abs()
        tol, floor = HEAD_MEAN_ABS_TOL[dtype], ""
        if cpu_fp32_heads is not None:
            noise = (c - cpu_fp32_heads[i]).abs().mean().item()
            tol = max(tol, BF16_NOISE_FACTOR * noise)
            floor = f"; CPU bf16 vs CPU fp32 mean abs {noise:.3e}"
        print(f"head {i} {tuple(c.shape)} {NAMES[dtype]}: card vs CPU max abs "
              f"{d.max().item():.3e} mean abs {d.mean().item():.3e} "
              f"(|logit| mean {c.abs().mean().item():.3f}{floor}; limit {tol:.3e})", flush=True)
        if not d.mean().item() <= tol:
            raise AssertionError(f"head {i}: mean abs difference {d.mean().item()} > {tol}")
    return launches, model, outs, [c.float() for c in cpu_outs]


def run_dump_entry_point(tmp, *flags):
    """Phase 5: the port's dump CLI on synthetic images of odd sizes."""
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
                    *flags],
                   check=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    out_dir = os.path.join(save_root, "Tramba-V-TSOD", "TSOD")
    for name, size in sizes.items():
        with Image.open(os.path.join(out_dir, name + ".png")) as im:
            if im.size != size or im.mode != "L":
                raise AssertionError(f"{name}: map {im.size} {im.mode}, expected {size} L")
    print(f"dump {' '.join(flags)} wrote {len(sizes)} maps at their original sizes", flush=True)


# kernel-name fragments -> group of the phase 7 breakdown, first match wins
GROUPS = (("ss2d_scan_kernel", "K1 ss2d_scan, scan launch"),
          ("ss2d_proj_kernel", "K1 ss2d_scan, projection launch"),
          ("ss2d_merge_kernel", "K2 ss2d_merge"),
          ("expand_groups_kernel<", "K3 expand_ln / K4 final_head"),
          ("prologue_kernel", "K5 prologue"),
          ("ln_mlp_kernel", "K6 ln_mlp"),
          ("ln_dwms_kernel", "K7 ln_dwms_mlp"),
          ("ln_rows_kernel", "LayerNorm launch of K5-K7"),
          ("finish_split_kernel", "split sums of K6/K7"),
          ("layer_norm", "LayerNorm (torch)"),
          ("conv", "conv (cuDNN)"), ("cudnn", "conv (cuDNN)"), ("fprop", "conv (cuDNN)"),
          ("gemm", "GEMM (cuBLAS)"), ("xmma", "GEMM (cuBLAS)"), ("cutlass", "GEMM (cuBLAS)"))


def profile_breakdown(fn, wall_ms, label):
    from tramba_tpu_torch.utils.profiling import device_time_by_kernel

    iters = 3
    times = device_time_by_kernel(fn, iters=iters)
    if not times:
        print(f"profile {label}: the profiler recorded no device activity", flush=True)
        return
    groups = {}
    for name, (us, n) in times.items():
        g = next((grp for frag, grp in GROUPS if frag in name.lower() or frag in name),
                 "elementwise / other")
        gus, gn = groups.get(g, (0.0, 0))
        groups[g] = (gus + us, gn + n)
    busy = sum(us for us, _ in groups.values()) / iters / 1e3
    print(f"profile {label}: device busy {busy:.3f} ms per forward of {wall_ms:.3f} ms wall "
          f"(idle share {max(0.0, 1 - busy / wall_ms):.3f})", flush=True)
    for g, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:34s} {us / iters / 1e3:9.3f} ms/fwd {100 * us / iters / 1e3 / busy:6.2f}% "
              f"{n // iters:5d} launches/fwd", flush=True)


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
    from tramba_tpu_torch.ops import _native

    t0 = time.perf_counter()
    print(f"built {_native.build()} in {time.perf_counter() - t0:.1f} s", flush=True)

    phase("3 kernels vs plain versions")
    checks = Checks()
    gen = torch.Generator().manual_seed(0)
    check_ss2d_expand(checks, dev, gen, torch.float32)
    check_ss2d_expand(checks, dev, gen, torch.bfloat16)
    check_bf16_only(checks, dev, gen)

    phase("4 model")
    x = torch.randn(2, 384, 384, 3, generator=torch.Generator().manual_seed(1))
    launches, models, heads, cpu_heads = {}, {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        launches[dtype], models[dtype], heads[dtype], cpu_heads[dtype] = run_model(
            dev, dtype, x, cpu_heads.get(torch.float32))
    for i, (b, f) in enumerate(zip(heads[torch.bfloat16], heads[torch.float32])):
        d = (b.float() - f).abs().mean().item()
        mae = (torch.sigmoid(b.float()) - torch.sigmoid(f)).abs().mean().item()
        print(f"head {i}: bf16 card vs fp32 card mean abs {d:.3e}, sigmoid-map MAE {mae:.3e}",
              flush=True)

    phase("5 dump entry point")
    for flags in (("--measure_fps",), ("--dtype", "bfloat16")):
        with tempfile.TemporaryDirectory() as tmp:
            run_dump_entry_point(tmp, *flags)

    phase("6 timing")
    walls = {}
    with torch.no_grad():
        for dtype, batches in ((torch.float32, ((1, 20), (8, 5))),
                               (torch.bfloat16, ((1, 20), (8, 5), (16, 5)))):
            model = models[dtype]
            for B, reps in batches:
                xb = torch.randn(B, 384, 384, 3, device=dev)
                ms = cuda_ms(lambda: model(xb), reps, warmup=2)
                walls[(dtype, B)] = ms
                print(f"Tramba-V-TSOD 384px {NAMES[dtype]} B{B}: {ms:.2f} ms/forward, "
                      f"{1000 * B / ms:.1f} img/s [{card}]", flush=True)

    phase("7 profile")
    for B in (1, 16):
        xb = torch.randn(B, 384, 384, 3, device=dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(3):
                models[torch.bfloat16](xb)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3 * 1e3
        profile_breakdown(lambda: models[torch.bfloat16](xb), wall, f"bf16 B{B}")

    ss2d, expand = "tramba_tpu_torch/csrc/ss2d.cu", "tramba_tpu_torch/csrc/expand.cu"
    sources = {"ss2d_scan": (ss2d, "tramba_tpu/ops/fused_ss2d.py:1505"),
               "ss2d_merge": (ss2d, "tramba_tpu/ops/fused_ss2d.py:1561"),
               "expand_ln": (expand, "tramba_tpu/ops/fused_expand.py:59"),
               "final_head": (expand, "tramba_tpu/ops/fused_expand.py:165"),
               "prologue": ("tramba_tpu_torch/csrc/prologue.cu",
                            "tramba_tpu/ops/fused_prologue.py:94"),
               "ln_mlp": ("tramba_tpu_torch/csrc/mlp.cu", "tramba_tpu/ops/fused_mlp.py:130"),
               "ln_dwms_mlp": ("tramba_tpu_torch/csrc/mlp.cu", "tramba_tpu/ops/fused_mlp.py:360")}
    # in bf16, K1/K2 also stand in for the whole-map _small_pallas (#13)
    bf16_replaces = {"ss2d_scan": "tramba_tpu/ops/fused_ss2d_small.py:233",
                     "ss2d_merge": "tramba_tpu/ops/fused_ss2d_small.py:233"}
    # the shape whose time the summary reports: the largest map of each kernel
    shown = {"ss2d_scan": "line 96px", "ss2d_merge": "line 96px", "expand_ln": "f2 48px",
             "final_head": "96px", "prologue": "enc/dec LN 96px", "ln_mlp": "96px",
             "ln_dwms_mlp": "96px"}
    summary = []
    for (name, dt), rows in checks.rows.items():
        label, _, ms, plain_ms = next(r for r in rows if r[0].startswith(shown[name]))
        replaces = bf16_replaces.get(name, sources[name][1]) if dt == torch.bfloat16 \
            else sources[name][1]
        summary.append({"name": name, "dtype": NAMES[dt], "route": "cuda",
                        "source": sources[name][0], "replaces": replaces,
                        "launches": launches[dt][name],
                        "max_abs_err": max(r[1] for r in rows), "ms": ms, "plain_ms": plain_ms,
                        "shape": label})
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
