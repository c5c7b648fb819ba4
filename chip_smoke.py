"""Smoke run of the PyTorch port (tramba_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. device    a CUDA card is present; prints its name and power limit
  2. build     nvcc builds kernels K1-K4 from tramba_tpu_torch/csrc
  3. kernels   each kernel vs its plain PyTorch version on the card, at the
               shapes of the 384px Tramba-V-TSOD forward; errors and times
  4. model     full-width Tramba-V-TSOD at 384px, seeded weights, fp32 with
               TF32 off, batch 2 on the card: head shapes, finite values, every
               kernel launched; the same weights and image on the CPU (plain
               versions) agree with mean abs difference <= 1e-3 per head
  5. dump      ``python -m tramba_tpu_torch.dump --measure_fps`` on synthetic
               TSOD10K-style images writes one map per image at its original
               size, then runs the 200-iteration FPS loop
  6. timing    forward latency at batch 1 and img/s at batch 8

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
HEAD_MEAN_ABS_TOL = 1e-3  # card (kernels) vs CPU (plain versions), per head


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


def check_kernels(dev, gen):
    """Phase 3.  Returns {kernel: [(shape label, max_abs_err, ms, plain_ms)]}."""
    from tramba_tpu_torch.nn.init import init_weights
    from tramba_tpu_torch.nn.layers import FinalPatchExpandX4, _Expand
    from tramba_tpu_torch.nn.ssm import SS2D
    from tramba_tpu_torch.ops import fused_expand as te
    from tramba_tpu_torch.ops import fused_ss2d as tf
    from tramba_tpu_torch.ops.scan_orders import order_tables

    results = {k: [] for k in ("ss2d_scan", "ss2d_merge", "expand_ln", "final_head")}

    def compare(name, label, kernel, plain, reps):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **KERNEL_TOL, msg=lambda m: f"{name} {label}: {m}")
        ms, plain_ms = cuda_ms(kernel, reps), cuda_ms(plain, 1, warmup=0)
        results[name].append((label, err, ms, plain_ms))
        print(f"{name:10s} {label:34s} max_abs_err {err:.3e} max_rel_err "
              f"{((got - want).abs() / want.abs().clamp_min(1e-3)).max().item():.3e} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms", flush=True)

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
        x = torch.nn.functional.silu(torch.randn(B, H * H, D, generator=gen)).to(dev)
        core = (m.x_proj_weight.data, m.dt_projs_weight.data, m.dt_projs_bias.data,
                m.A_logs.data.view(K, D, 1), m.Ds.data.view(K, D))
        idx, inv = order_tables(kind, H, H, param, dev)
        label = f"{kind}{param or ''} {H}px B{B} K{K} D{D}"
        compare("ss2d_scan", label, lambda: tf.ss2d_scan(x, idx, *core),
                lambda: tf.ss2d_scan_ref(x, idx, *core), reps=5)
        ys = tf.ss2d_scan(x, idx, *core)
        tail = (m.out_norm.weight.data, m.out_norm.bias.data, m.out_proj.weight.data)
        compare("ss2d_merge", label, lambda: tf.ss2d_merge(ys, inv, *tail),
                lambda: tf.ss2d_merge_ref(ys, inv, *tail), reps=5)
    # (map size, C, factor): PatchExpand (f=2) and FreqExpand2D (f=4) inputs
    for H, C, f in ((12, 1024, 2), (24, 512, 2), (48, 256, 2),
                    (12, 512, 4), (24, 256, 4), (48, 128, 4)):
        m = init_weights(_Expand(C, f), gen).to(dev)
        x = torch.randn(B, H, H, C, generator=gen).to(dev)
        args = (x, m.expand.weight.data, m.norm.weight.data, m.norm.bias.data)
        compare("expand_ln", f"f{f} {H}px B{B} C{C}", lambda: te.expand_ln(*args),
                lambda: te.expand_ln_ref(*args), reps=10)
    m = init_weights(FinalPatchExpandX4(128), gen).to(dev)
    seg_w = (torch.randn(128, generator=gen) * 0.1).to(dev)
    seg_b = torch.randn(1, generator=gen).to(dev)
    x = torch.randn(B, 96, 96, 128, generator=gen).to(dev)
    args = (x, m.expand.weight.data, m.norm.weight.data, m.norm.bias.data, seg_w, seg_b)
    compare("final_head", f"96px B{B} C128", lambda: te.final_head(*args),
            lambda: te.final_head_ref(*args), reps=10)
    return results


def run_model(dev):
    """Phase 4.  Returns the per-kernel launch counts of one batch-2 forward."""
    from tramba_tpu_torch.models.registry import build
    from tramba_tpu_torch.ops import fused_expand as te
    from tramba_tpu_torch.ops import fused_ss2d as tf

    wrappers = (tf.ss2d_scan, tf.ss2d_merge, te.expand_ln, te.final_head)
    model = build("Tramba-V-TSOD", 384, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    x = torch.randn(2, 384, 384, 3, generator=torch.Generator().manual_seed(1))
    for w in wrappers:
        w.launches = 0
    with torch.no_grad():
        outs = model(x.to(dev))
        torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    print(f"model Tramba-V-TSOD 384px, {n_params} parameters; launches {launches}", flush=True)
    shapes = [tuple(o.shape) for o in outs]
    want = [(2, 24, 24, 1), (2, 48, 48, 1), (2, 96, 96, 1), (2, 384, 384, 1)]
    if shapes != want:
        raise AssertionError(f"head shapes {shapes}, expected {want}")
    if not all(torch.isfinite(o).all().item() for o in outs):
        raise AssertionError("non-finite logits")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the forward: {missing}")

    t0 = time.perf_counter()
    cpu_model = build("Tramba-V-TSOD", 384, device="cpu", seed=0)
    with torch.no_grad():
        cpu_outs = cpu_model(x[:1])
    print(f"CPU forward (plain versions) {time.perf_counter() - t0:.1f} s", flush=True)
    for i, (g, c) in enumerate(zip(outs, cpu_outs)):
        d = (g[:1].cpu() - c).abs()
        print(f"head {i} {tuple(c.shape)}: card vs CPU max abs {d.max().item():.3e} "
              f"mean abs {d.mean().item():.3e} (|logit| mean {c.abs().mean().item():.3f})",
              flush=True)
        if not d.mean().item() <= HEAD_MEAN_ABS_TOL:
            raise AssertionError(f"head {i}: mean abs difference {d.mean().item()} "
                                 f"> {HEAD_MEAN_ABS_TOL}")
    return launches, model


def run_dump_entry_point(tmp):
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
                    "--measure_fps"],
                   check=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    out_dir = os.path.join(save_root, "Tramba-V-TSOD", "TSOD")
    for name, size in sizes.items():
        with Image.open(os.path.join(out_dir, name + ".png")) as im:
            if im.size != size or im.mode != "L":
                raise AssertionError(f"{name}: map {im.size} {im.mode}, expected {size} L")
    print(f"dump wrote {len(sizes)} maps at their original sizes", flush=True)


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
    checks = check_kernels(dev, torch.Generator().manual_seed(0))

    phase("4 model")
    launches, model = run_model(dev)

    phase("5 dump entry point")
    with tempfile.TemporaryDirectory() as tmp:
        run_dump_entry_point(tmp)

    phase("6 timing")
    with torch.no_grad():
        for B, reps in ((1, 20), (8, 5)):
            x = torch.randn(B, 384, 384, 3, device=dev)
            ms = cuda_ms(lambda: model(x), reps, warmup=2)
            print(f"Tramba-V-TSOD 384px fp32 B{B}: {ms:.2f} ms/forward, {1000 * B / ms:.1f} img/s "
                  f"[{card}]", flush=True)

    sources = {"ss2d_scan": ("tramba_tpu_torch/csrc/ss2d.cu", "tramba_tpu/ops/fused_ss2d.py:1505"),
               "ss2d_merge": ("tramba_tpu_torch/csrc/ss2d.cu", "tramba_tpu/ops/fused_ss2d.py:1561"),
               "expand_ln": ("tramba_tpu_torch/csrc/expand.cu", "tramba_tpu/ops/fused_expand.py:59"),
               "final_head": ("tramba_tpu_torch/csrc/expand.cu",
                              "tramba_tpu/ops/fused_expand.py:165")}
    # the shape whose time the summary reports: the largest map of each kernel
    shown = {"ss2d_scan": "line 96px", "ss2d_merge": "line 96px", "expand_ln": "f2 48px",
             "final_head": "96px"}
    summary = []
    for name, rows in checks.items():
        label, _, ms, plain_ms = next(r for r in rows if r[0].startswith(shown[name]))
        summary.append({"name": name, "route": "cuda", "source": sources[name][0],
                        "replaces": sources[name][1], "launches": launches[name],
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
