"""Parent/change timing on one CUDA card: each tree's own chip_smoke.py, in turns.

    python3 chip_ab.py [--logs DIR] TREE [TREE ...]

Each TREE is the root of a checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists, and ``.``). For each, in the order given (parent, change, change,
parent compares two trees on one card), this runs that tree's
``chip_smoke.py`` from its root, so each tree builds its own kernels and times
them with its own code, and reads the times it prints: ms per forward (phase
6) and per train step (phase 8) of every model, and the ms of K1
``ss2d_scan``, K8 ``ss2d_scan_bwd``, K2 ``ss2d_merge``, K3 ``expand_ln``, K4
``final_head``, K5 ``prologue``, K6 ``ln_mlp``, K7 ``ln_dwms_mlp``, K9
``ln_mlp_bwd``, K10 ``ln_dwms_mlp_bwd``, K11 ``ln_dwmlp``, K12 ``sra`` and K13
``window_attn`` at each shape phase 3 checks them,
beside the bound the run computed and, where the tree prints it, the time of
the kernel's matrix products alone as torch.matmul (``gemm``). Then tables of
the runs side by side, with the card's ``name, power.limit``. ``--logs DIR``
keeps each run's whole output. ``--ffn-bwd`` runs, instead of the whole
``chip_smoke.py``, only its phase 3 checks of K9 and K10 (``check_mlp_bwd`` at
every shape of the train steps), and ``--k5-k10`` only its checks of K5 (every
shape of Tramba-V's, -P's and -R's forwards, through ``check_bf16_only`` with
no K6 / K7 shapes) and of K10 (the DWMS shapes of ``check_mlp_bwd``), and
``--k3-k4`` only its checks of K3 and K4 (``check_ss2d_expand`` with no SS2D
shapes, at Tramba-V's, -P's and -R's shapes, fp32 and bf16, B2) followed by a
timing snippet that is the same code in every tree: each tree's
``fused_expand.expand_ln`` and ``final_head`` at Tramba-V's seven shapes at
B16 (the timed forward's batch), fp32 and bf16, with their plain versions, by
CUDA events (``chip_smoke.cuda_ms``), so that a tree can be listed several times in one
short call; ``--k11-k13`` likewise runs only its checks of K11 ``ln_dwmlp``, K12 ``sra`` and
K13 ``window_attn`` (``check_encoder_kernels``), then the same snippet in every tree: the
three at every shape of Tramba-P's and -S's encoders at B16, with their plain versions, and
both models' bf16 B16 forward (ms, and the device time by kernel group with each tree's
own groups); ``--k12-k14`` runs only its checks of K12 ``sra`` (``check_sra``, where the
tree has it) and K14 ``linear_scan`` (``check_linear_scan``), then the same code in every
tree: K12 at Tramba-P's shapes at B2 and B16 beside its plain version and PyTorch's own
chain (LN + cuBLAS + SDPA + cuBLAS), K14 at phase 3's shapes forward and reversed,
Tramba-P's bf16 B16 forward with its profile, and phase 10's parallel backends (the
full-width Tramba-V forward at B2 on each, in turns with the default route, and one fp32
train step of each dry-run phase). ``--train-times`` runs phase 8's measurements that
``chip_smoke.py`` makes of Tramba-V only: each other model's ``run_training`` in fp32 and bf16
(its checks, then ms per step, peak memory and the device time by kernel group), and
``--parallel-times`` phase 10 with its measurements (``run_parallel`` against phase 4's
Tramba-V heads: each backend's forward in turns with the default route and its profile, each
dry-run step's ms, peak memory and profile). ``--yardsticks`` times each tree's kernels in
turns with PyTorch's own chain for each one's function (``chip_smoke.yardsticks``: cuBLAS
with TF32 off, cuDNN, F.layer_norm, SDPA, autograd for the adjoints) at phase 3's shapes at
B2 and Tramba-V's at B16; ``--k1-proj`` times K1's projection launch at Tramba-V's 13 SS2D
shapes at B2 and B16 (its device time inside ``ss2d_scan`` by the profiler, alone where the
tree has ``ss2d_proj``, beside ``x.float() @ wx^T``, with K1's dbc against an fp64 product;
``chip_smoke.k1_proj_sweep``), then Tramba-V's, -R's and BaseUMamba's bf16 B16 forwards with
their profiles. Both run this checkout's ``chip_smoke.py`` functions, loaded by path, on each
tree's own kernels, and tabulate the runs side by side. Every run prints its wall seconds, and the
seconds of each phase where the tree prints them (``phase seconds:``, else from the phases'
start times), with the host CPU. Exits with the first failing run's code.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

TIMES = (re.compile(r"^(?:Tramba-(\w)-TSOD|(BaseUMamba)-SOD) 384px (\w+ B\d+): ([\d.]+) "
                    r"ms/forward"),
         re.compile(r"^(?:Tramba-(\w)-TSOD|(BaseUMamba)-SOD) 384px (\w+ train) step (B\d+): "
                    r"([\d.]+) ms/step"))
# phase 3's line of a tabulated kernel: name, tag, shape, ..., kernel ms, plain
# ms, bound ms (bound by), and gemm ms where printed
KERNELS = re.compile(r"^(ss2d_scan(?:_bwd)?|ss2d_merge|expand_ln|final_head|prologue|ln_mlp|"
                     r"ln_dwms_mlp|ln_mlp_bwd|ln_dwms_mlp_bwd|ln_dwmlp|sra|window_attn|"
                     r"linear_scan)"
                     r"\s+((?:fp32|bf16)(?: train)?)\s+"
                     r"(\S.*?)\s+max_abs_err .* kernel ([\d.]+) ms plain ([\d.]+) ms "
                     r"bound ([\d.]+) ms \(\w+\)(?: gemm ([\d.]+) ms)?")


def times(stdout: str) -> dict:
    """{"V fp32 B1": ms, ..., "R bf16 train B4": ms} from a chip_smoke.py
    output (V, S, P, R: the Tramba model; BaseUMamba)."""
    out = {}
    for line in stdout.splitlines():
        if m := TIMES[0].match(line):
            out[f"{m[1] or m[2]} {m[3]}"] = float(m[4])
        elif m := TIMES[1].match(line):
            out[f"{m[1] or m[2]} {m[3]} {m[4]}"] = float(m[5])
    return out


def kernel_times(stdout: str) -> dict:
    """{(kernel, tag, shape): (ms, bound_ms, gemm_ms or nan, plain_ms)} of
    phase 3's K1, K8, K2, K3, K4, K5, K6, K7, K9 and K10 lines, and of the
    ``--k3-k4`` snippet's B16 lines (bound and gemm nan)."""
    out = {}
    for line in stdout.splitlines():
        if m := KERNELS.match(line):
            out[m[1], m[2], m[3]] = (float(m[4]), float(m[6]),
                                     float(m[7]) if m[7] else float("nan"), float(m[5]))
        elif m := B16.match(line):
            out[m[1], m[2], m[3]] = (float(m[4]), float("nan"), float("nan"),
                                     float(m[5]) if m[5] else float("nan"))
    return out


# the phase 3 checks of K9 and K10 alone, run in a tree's root (--ffn-bwd)
FFN_BWD = ("import torch, chip_smoke as cs\n"
           "torch.backends.cuda.matmul.allow_tf32 = False\n"
           "checks, gen = cs.Checks(), torch.Generator().manual_seed(0)\n"
           "for shapes in (cs.MLP_BWD_SHAPES, cs.MLP_BWD_SHAPES_P, cs.MLP_BWD_SHAPES_R):\n"
           "    cs.check_mlp_bwd(checks, torch.device('cuda'), gen, shapes)\n")
# the phase 3 checks of K5 and K10 alone (--k5-k10): the same calls in the
# parent's chip_smoke.py and in this one
K5_K10 = ("import torch, chip_smoke as cs\n"
          "torch.backends.cuda.matmul.allow_tf32 = False\n"
          "checks, gen, dev = cs.Checks(), torch.Generator().manual_seed(0), torch.device('cuda')\n"
          "for k5, bwd in ((cs.BF16_SHAPES, cs.MLP_BWD_SHAPES), (cs.BF16_SHAPES_P, "
          "cs.MLP_BWD_SHAPES_P), (cs.BF16_SHAPES_R, cs.MLP_BWD_SHAPES_R)):\n"
          "    cs.check_bf16_only(checks, dev, gen, dict(k5, ln_mlp=(), ln_dwms_mlp=()))\n"
          "    cs.check_mlp_bwd(checks, dev, gen, tuple(s for s in bwd if s[2]))\n")


# the phase 3 checks of K3 and K4 alone (--k3-k4), then the same B16 timing
# code in every tree: each tree's wrappers at Tramba-V's seven shapes
K3_K4 = ("import torch, chip_smoke as cs\n"
         "from tramba_tpu_torch.nn.init import init_weights\n"
         "from tramba_tpu_torch.nn.layers import FinalPatchExpandX4, _Expand\n"
         "from tramba_tpu_torch.ops import fused_expand as te\n"
         "torch.backends.cuda.matmul.allow_tf32 = False\n"
         "checks, gen, dev = cs.Checks(), torch.Generator().manual_seed(0), torch.device('cuda')\n"
         "for dt in (torch.float32, torch.bfloat16):\n"
         "    for shapes, c in ((cs.EXPAND_SHAPES, 128), (cs.EXPAND_SHAPES_P, 64), "
         "(cs.EXPAND_SHAPES_R, 256)):\n"
         "        cs.check_ss2d_expand(checks, dev, gen, dt, (), shapes, head_c=c)\n"
         "card, B = cs.card_line(), 16\n"
         "for dt in (torch.float32, torch.bfloat16):\n"
         "    for H, C, f in cs.EXPAND_SHAPES:\n"
         "        m = init_weights(_Expand(C, f), gen).to(dev)\n"
         "        args = (torch.randn(B, H, H, C, generator=gen).to(dev, dt), "
         "m.expand.weight.data.to(dt), m.norm.weight.data, m.norm.bias.data)\n"
         "        ms = cs.cuda_ms(lambda: te.expand_ln(*args), 20, warmup=2)\n"
         "        pms = cs.cuda_ms(lambda: te.expand_ln_ref(*args), 5, warmup=2)\n"
         "        print(f'b16 expand_ln {cs.NAMES[dt]} f{f} {H}px B{B} C{C}: {ms:.4f} ms, '\n"
         "              f'plain {pms:.4f} ms [{card}]')\n"
         "    m = init_weights(FinalPatchExpandX4(128), gen).to(dev)\n"
         "    args = (torch.randn(B, 96, 96, 128, generator=gen).to(dev, dt), "
         "m.expand.weight.data.to(dt), m.norm.weight.data, m.norm.bias.data, "
         "(torch.randn(128, generator=gen) * 0.1).to(dev), "
         "torch.randn(1, generator=gen).to(dev))\n"
         "    ms = cs.cuda_ms(lambda: te.final_head(*args), 20, warmup=2)\n"
         "    pms = cs.cuda_ms(lambda: te.final_head_ref(*args), 5, warmup=2)\n"
         "    print(f'b16 final_head {cs.NAMES[dt]} 96px B{B} C128: {ms:.4f} ms, '\n"
         "          f'plain {pms:.4f} ms [{card}]')\n")
# the phase 3 checks of K11, K12 and K13 alone (--k11-k13), then the same
# B16 code in every tree: each tree's wrappers at Tramba-P's and -S's encoder
# shapes, and the bf16 B16 forwards of both models with their profiles by
# kernel group (each tree's own groups)
K11_K13 = ("import time, torch, chip_smoke as cs\n"
           "from tramba_tpu_torch.models.registry import build\n"
           "from tramba_tpu_torch.models.swin import shift_attn_mask\n"
           "from tramba_tpu_torch.ops import fused_attn as ta, fused_mlp as tm\n"
           "torch.backends.cuda.matmul.allow_tf32 = False\n"
           "checks, gen, dev = cs.Checks(), torch.Generator().manual_seed(0), torch.device('cuda')\n"
           "cs.check_encoder_kernels(checks, dev, gen)\n"
           "card, B, bf = cs.card_line(), 16, torch.bfloat16\n"
           "def rnd(*shape, scale=1.0, shift=0.0):\n"
           "    return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)\n"
           "def timed(name, label, fn, plain):\n"
           "    ms = cs.cuda_ms(fn, 20, warmup=2)\n"
           "    pms = cs.cuda_ms(plain, 3, warmup=1)\n"
           "    print(f'b16 {name} bf16 {label}: {ms:.4f} ms, plain {pms:.4f} ms [{card}]', "
           "flush=True)\n"
           "for H, d, hid in cs.K11_SHAPES:\n"
           "    args = (rnd(B, H, H, d).to(bf), rnd(d, scale=0.1, shift=1.0), rnd(d, scale=0.1), "
           "rnd(hid, d, scale=d ** -0.5).to(bf), rnd(hid, scale=0.1), "
           "rnd(hid, 1, 3, 3, scale=1 / 3).to(bf), rnd(hid, scale=0.1), "
           "rnd(d, hid, scale=hid ** -0.5).to(bf), rnd(d, scale=0.1))\n"
           "    timed('ln_dwmlp', f'{H}px B{B} d{d} hid{hid}', lambda: tm.ln_dwmlp(*args), "
           "lambda: tm.ln_dwmlp_ref(*args))\n"
           "for H, C, nh in cs.K12_SHAPES:\n"
           "    args = (rnd(B, H * H, C, scale=2.0).to(bf), rnd(C, scale=0.1, shift=1.0), "
           "rnd(C, scale=0.1), rnd(C, C, scale=C ** -0.5).to(bf), rnd(C, scale=0.1), "
           "rnd(B, nh, 144, C // nh).to(bf), rnd(B, nh, 144, C // nh).to(bf), "
           "rnd(C, C, scale=C ** -0.5).to(bf), rnd(C, scale=0.1))\n"
           "    timed('sra', f'{H}px B{B} C{C} nh{nh}', lambda: ta.sra(*args, nh), "
           "lambda: ta.sra_ref(*args, nh))\n"
           "for H, C, nh in cs.K13_SHAPES:\n"
           "    for mask in (None, torch.from_numpy(shift_attn_mask(H, H, 12, 6)).to(dev)):\n"
           "        args = (rnd(B, H, H, C, scale=2.0).to(bf), rnd(C, scale=0.1, shift=1.0), "
           "rnd(C, scale=0.1), rnd(3 * C, C, scale=C ** -0.5).to(bf), rnd(3 * C, scale=0.1), "
           "rnd(nh, 144, 144), mask, rnd(C, C, scale=C ** -0.5).to(bf), rnd(C, scale=0.1))\n"
           "        label = f'{H}px B{B} C{C} nh{nh} ' + ('shifted' if mask is not None "
           "else 'unshifted')\n"
           "        timed('window_attn', label, lambda: ta.window_attn(*args, nh), "
           "lambda: ta.window_attn_ref(*args, nh))\n"
           "del args\n"
           "for method in ('Tramba-P-TSOD', 'Tramba-S-TSOD'):\n"
           "    model = build(method, 384, device=dev, seed=0, dtype=bf)\n"
           "    xb = torch.randn(B, 384, 384, 3, generator=gen).to(dev)\n"
           "    with torch.no_grad():\n"
           "        ms = cs.cuda_ms(lambda: model(xb), 5, warmup=2)\n"
           "        print(f'{method} 384px bf16 B{B}: {ms:.2f} ms/forward [{card}]', flush=True)\n"
           "        t0 = time.perf_counter()\n"
           "        for _ in range(3):\n"
           "            model(xb)\n"
           "        torch.cuda.synchronize()\n"
           "    cs.profile_breakdown(lambda: model(xb), (time.perf_counter() - t0) / 3 * 1e3, "
           "f'{method} bf16 B{B}')\n"
           "    del model, xb\n"
           "    torch.cuda.empty_cache()\n")
# the phase 3 checks of K12 and K14 alone (--k12-k14; a tree without
# ``check_sra`` checks K14 only), then the same code in every tree: each
# tree's ``sra`` at every shape of Tramba-P's encoder at B2 and B16 beside its
# plain version and PyTorch's own chain (:data:`SRA_LIB`), its
# ``linear_scan`` at every shape of phase 3, forward and reversed (100 calls:
# the short scans are bound by the host, whose time spreads), Tramba-P's
# bf16 B16 forward with its profile by kernel group (each tree's own groups),
# and phase 10's parallel backends on an NCCL world of one process: the
# full-width Tramba-V forward at B2 on each backend in turns with the default
# route (fp32, bf16), and one fp32 train step at B2 of each dry-run phase.
# The chain is the tree's ``chip_smoke.sra_lib`` where it has one, else this
# copy of it (a parent tree older than ``sra_lib``)
SRA_LIB = ("sra_lib = getattr(cs, 'sra_lib', None)\n"
           "if sra_lib is None:\n"
           "  def sra_lib(x, g, b, wq, bq, k, v, wp, bp, nh, eps=1e-6):\n"
           "    F = torch.nn.functional\n"
           "    B, N, C = x.shape\n"
           "    y = F.layer_norm(x, (C,), g.to(bf), b.to(bf), eps)\n"
           "    q = F.linear(y, wq, bq.to(bf)).reshape(B, N, nh, C // nh).transpose(1, 2)\n"
           "    o = F.scaled_dot_product_attention(q, k, v)\n"
           "    return F.linear(o.transpose(1, 2).reshape(B, N, C), wp, bp.to(bf))\n")
K12_K14 = ("import tempfile, time, torch, chip_smoke as cs\n"
           "import torch.distributed as dist\n"
           "from tramba_tpu_torch import dryrun\n"
           "from tramba_tpu_torch.models.registry import build\n"
           "from tramba_tpu_torch.ops import fused_attn as ta, selective_scan as ts\n"
           "from tramba_tpu_torch.parallel.mesh import make_grid\n"
           "from tramba_tpu_torch.parallel.seq_scan import use_sequence_group\n"
           "from tramba_tpu_torch.parallel.tp import use_tensor_group\n"
           "torch.backends.cuda.matmul.allow_tf32 = False\n"
           "torch.backends.cudnn.allow_tf32 = False\n"
           "checks, gen, dev = cs.Checks(), torch.Generator().manual_seed(0), torch.device('cuda')\n"
           "if hasattr(cs, 'check_sra'):\n"
           "    cs.check_sra(checks, dev, gen)\n"
           "cs.check_linear_scan(checks, dev, gen)\n"
           "card, bf = cs.card_line(), torch.bfloat16\n"
           "def rnd(*shape, scale=1.0, shift=0.0):\n"
           "    return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)\n"
           + SRA_LIB +
           "for B in (2, 16):\n"
           "    for H, C, nh in cs.K12_SHAPES:\n"
           "        args = (rnd(B, H * H, C, scale=2.0).to(bf), rnd(C, scale=0.1, shift=1.0), "
           "rnd(C, scale=0.1), rnd(C, C, scale=C ** -0.5).to(bf), rnd(C, scale=0.1), "
           "rnd(B, nh, 144, C // nh).to(bf), rnd(B, nh, 144, C // nh).to(bf), "
           "rnd(C, C, scale=C ** -0.5).to(bf), rnd(C, scale=0.1))\n"
           "        ms = cs.cuda_ms(lambda: ta.sra(*args, nh), 20, warmup=2)\n"
           "        pms = cs.cuda_ms(lambda: ta.sra_ref(*args, nh), 3, warmup=1)\n"
           "        lms = cs.cuda_ms(lambda: sra_lib(*args, nh), 20, warmup=2)\n"
           "        print(f'time sra bf16 {H}px B{B} C{C} nh{nh}: {ms:.4f} ms, plain {pms:.4f} ms, '\n"
           "              f'lib {lms:.4f} ms [{card}]', flush=True)\n"
           "del args\n"
           "for label, R, L, C in cs.LINEAR_SCAN_SHAPES:\n"
           "    a, b = cs.scan_inputs(gen, R, L, C, dev)\n"
           "    for rev in (False, True):\n"
           "        ms = cs.cuda_ms(lambda: ts.linear_scan(a, b, rev), 100, warmup=5)\n"
           "        print(f'time linear_scan fp32 {label} B4 {\"rev\" if rev else \"fwd\"}: '\n"
           "              f'{ms:.4f} ms [{card}]', flush=True)\n"
           "    del a, b\n"
           "model = build('Tramba-P-TSOD', 384, device=dev, seed=0, dtype=bf)\n"
           "xb = torch.randn(16, 384, 384, 3, generator=gen).to(dev)\n"
           "with torch.no_grad():\n"
           "    ms = cs.cuda_ms(lambda: model(xb), 5, warmup=2)\n"
           "    print(f'Tramba-P-TSOD 384px bf16 B16: {ms:.2f} ms/forward [{card}]', flush=True)\n"
           "    t0 = time.perf_counter()\n"
           "    for _ in range(3):\n"
           "        model(xb)\n"
           "    torch.cuda.synchronize()\n"
           "cs.profile_breakdown(lambda: model(xb), (time.perf_counter() - t0) / 3 * 1e3, "
           "'Tramba-P-TSOD bf16 B16')\n"
           "del model, xb\n"
           "torch.cuda.empty_cache()\n"
           "x2 = torch.randn(2, 384, 384, 3, generator=gen).to(dev)\n"
           "with tempfile.TemporaryDirectory() as tmp:\n"
           "    dist.init_process_group('nccl', init_method=f'file://{tmp}/rv', world_size=1, "
           "rank=0)\n"
           "    grid = make_grid(1, 1)\n"
           "    with torch.no_grad(), use_tensor_group(grid.model), use_sequence_group(grid.seq):\n"
           "        for dt in (torch.float32, bf):\n"
           "            default = build('Tramba-V-TSOD', 384, device=dev, seed=0, dtype=dt)\n"
           "            for backend in cs.BACKENDS:\n"
           "                m = build('Tramba-V-TSOD', 384, device=dev, seed=None, dtype=dt, "
           "ssm_backend=backend)\n"
           "                m.load_state_dict(default.state_dict())\n"
           "                ms = [cs.cuda_ms(lambda: f(x2), 3) for f in (default, m, m, default)]\n"
           "                print(f'Tramba-V-TSOD 384px {cs.NAMES[dt]} B2 forward: {backend} '\n"
           "                      f'{ms[1]:.2f} / {ms[2]:.2f} ms, default route {ms[0]:.2f} / '\n"
           "                      f'{ms[3]:.2f} ms [{card}]', flush=True)\n"
           "                del m\n"
           "            del default\n"
           "            torch.cuda.empty_cache()\n"
           "    def on_step(name, model, step):\n"
           "        step()\n"
           "        ms = cs.cuda_ms(step, reps=3)\n"
           "        print(f'dry-run phase {name}: fp32 train step B2 {ms:.2f} ms/step [{card}]', "
           "flush=True)\n"
           "    dryrun.run_phases(dev, img_size=384, batch=2, min_l=4096, model_kw={}, "
           "on_step=on_step)\n"
           "    dist.destroy_process_group()\n")
# phase 8's measurements of the models other than Tramba-V (--train-times): each
# tree's run_training, which times and profiles by default
TRAIN_TIMES = ("import torch, chip_smoke as cs\n"
               "torch.backends.cuda.matmul.allow_tf32 = False\n"
               "torch.backends.cudnn.allow_tf32 = False\n"
               "dev, card = torch.device('cuda'), cs.card_line()\n"
               "for method in cs.TRAINED:\n"
               "    if method in getattr(cs, 'TRAIN_TIMED', ()):\n"
               "        continue\n"
               "    for dt in (torch.float32, torch.bfloat16):\n"
               "        cs.run_training(dev, card, dt, method)\n"
               "        torch.cuda.empty_cache()\n"
               "print(f'host [{cs.host_cpu()}]')\n")
# phase 10 with its measurements (--parallel-times): phase 4's Tramba-V
# forwards for the default route's heads and the CPU's bf16 noise, then each
# tree's run_parallel, which times and profiles by default
PARALLEL_TIMES = ("import torch, chip_smoke as cs\n"
                  "torch.backends.cuda.matmul.allow_tf32 = False\n"
                  "torch.backends.cudnn.allow_tf32 = False\n"
                  "dev, card, fp, bf = torch.device('cuda'), cs.card_line(), torch.float32, "
                  "torch.bfloat16\n"
                  "x = torch.randn(2, 384, 384, 3, generator=torch.Generator().manual_seed(1))\n"
                  "heads, cpu = {}, {}\n"
                  "for dt in (fp, bf):\n"
                  "    _, model, outs, cpu[dt] = cs.run_model(dev, dt, x, cpu.get(fp))\n"
                  "    heads[dt] = [h.clone() for h in outs]\n"
                  "    del model, outs\n"
                  "noise = [(b - f).abs().mean().item() for b, f in zip(cpu[bf], cpu[fp])]\n"
                  "cs.run_parallel(dev, card, x, heads, noise)\n"
                  "print(f'host [{cs.host_cpu()}]')\n")
# the code of --yardsticks and --k1-proj: this checkout's chip_smoke.py, loaded
# by its path (@HERE@), drives each tree's own kernels (the tree's package is
# imported from its root), so a parent older than these functions is timed by
# the same code as the change
_HERE_SMOKE = ("import importlib.util, time, torch\n"
               "spec = importlib.util.spec_from_file_location('here_smoke', @HERE@)\n"
               "hs = importlib.util.module_from_spec(spec)\n"
               "spec.loader.exec_module(hs)\n"
               "torch.backends.cuda.matmul.allow_tf32 = False\n"
               "torch.backends.cudnn.allow_tf32 = False\n"
               "dev, gen, card = torch.device('cuda'), torch.Generator().manual_seed(0), "
               "hs.card_line()\n")
# every kernel beside PyTorch's own chain for its function (--yardsticks)
YARDSTICKS = _HERE_SMOKE + ("hs.yardsticks(dev, gen, card)\n"
                            "print(f'host [{hs.host_cpu()}]')\n")
# K1's projection at Tramba-V's SS2D shapes (--k1-proj), then Tramba-V's, -R's
# and BaseUMamba's bf16 B16 forwards with their profiles (each tree's groups)
K1_PROJ = _HERE_SMOKE + ("import chip_smoke as cs\n"
                         "from tramba_tpu_torch.models.registry import build\n"
                         "hs.k1_proj_sweep(dev, gen, card)\n"
                         "for method in ('Tramba-V-TSOD', 'Tramba-R-TSOD', 'BaseUMamba-SOD'):\n"
                         "    model = build(method, 384, device=dev, seed=0, dtype=torch.bfloat16)\n"
                         "    xb = torch.randn(16, 384, 384, 3, generator=gen).to(dev)\n"
                         "    with torch.no_grad():\n"
                         "        ms = cs.cuda_ms(lambda: model(xb), 5, warmup=2)\n"
                         "        print(f'{method} 384px bf16 B16: {ms:.2f} ms/forward [{card}]', "
                         "flush=True)\n"
                         "        t0 = time.perf_counter()\n"
                         "        for _ in range(3):\n"
                         "            model(xb)\n"
                         "        torch.cuda.synchronize()\n"
                         "    cs.profile_breakdown(lambda: model(xb), (time.perf_counter() - t0) "
                         "/ 3 * 1e3, f'{method} bf16 B16')\n"
                         "    del model, xb\n"
                         "    torch.cuda.empty_cache()\n"
                         "print(f'host [{hs.host_cpu()}]')\n")
# each narrow mode: its flag, the code it runs in each tree's root, its help
MODES = {"--ffn-bwd": (FFN_BWD, "run only phase 3's K9 / K10 checks of each tree"),
         "--k5-k10": (K5_K10, "run only phase 3's K5 / K10 checks of each tree"),
         "--k3-k4": (K3_K4, "run only phase 3's K3 / K4 checks of each tree, and time both at "
                            "Tramba-V's shapes at B16"),
         "--k11-k13": (K11_K13, "run only phase 3's K11-K13 checks of each tree, time them at "
                                "B16, and time and profile Tramba-P's and -S's bf16 B16 "
                                "forwards"),
         "--k12-k14": (K12_K14, "run only phase 3's K12 / K14 checks of each tree, time them at "
                                "B2 and B16, time and profile Tramba-P's bf16 B16 forward and "
                                "time phase 10's parallel backends"),
         "--yardsticks": (YARDSTICKS, "time each tree's kernels in turns with PyTorch's own "
                                      "chain for each one's function, at phase 3's shapes at "
                                      "B2 and Tramba-V's at B16"),
         "--k1-proj": (K1_PROJ, "time K1's projection of each tree at Tramba-V's SS2D shapes "
                                "(B2, B16) beside x.float() @ wx^T with its error against fp64, "
                                "then Tramba-V's, -R's and BaseUMamba's bf16 B16 forwards with "
                                "their profiles"),
         "--train-times": (TRAIN_TIMES, "run phase 8's steps of every model but Tramba-V with "
                                        "their ms per step, peak memory and profiles"),
         "--parallel-times": (PARALLEL_TIMES, "run phase 10 with each backend's ms per forward "
                                              "and profile and each dry-run step's ms, peak "
                                              "memory and profile")}
# a phase's start ("== 8 train (at 501 s)"), the final tree's phase seconds,
# and the host CPU printed in brackets ("[... 8 CPUs]")
PHASE_START = re.compile(r"^== (.+) \(at (\d+) s\)$")
PHASE_SECONDS = re.compile(r"^phase seconds: (.*); total ([\d.]+) s")
HOST_CPU = re.compile(r"\[([^\]]* CPUs)\]")


def phase_times(stdout: str, wall: float) -> dict:
    """{phase name: seconds} of a chip_smoke.py run: from its ``phase seconds``
    line where it prints one, else from the phases' start times, the last
    phase ending at ``wall`` (the run's wall seconds, a few more than the
    script's own clock, which starts after its imports)."""
    starts = []
    for line in stdout.splitlines():
        if m := PHASE_SECONDS.match(line):
            return {name: float(sec) for name, sec in
                    (part.rsplit(" ", 1) for part in m[1].split("; "))}
        if m := PHASE_START.match(line):
            starts.append((m[1], float(m[2])))
    ends = [at for _, at in starts[1:]] + [wall]
    return {name: end - at for (name, at), end in zip(starts, ends)}


# a --yardsticks line: kernel, tag, shape, the kernel's two ms, the chain's two
YARD = re.compile(r"^yard (\S+) ((?:fp32|bf16)(?: train)?) (.*?): kernel ([\d.]+) / ([\d.]+) "
                  r"ms, lib ([\d.]+) / ([\d.]+) ms")
# a --k1-proj line: tag, shape, in-scan ms, alone ms (nan without ss2d_proj),
# lib ms, bound ms, dbc's error as a share of max |fp64|
K1PROJ = re.compile(r"^k1proj (fp32|bf16) (.*?): in-scan ([\d.]+) ms, alone ([\d.]+|nan) ms, "
                    r"lib ([\d.]+) ms, bound ([\d.]+) ms \(\w+\), dbc err/max\|fp64\| (\S+)")


def side_times(stdout: str) -> dict:
    """{("yard", kernel, tag, shape): (kernel ms, lib ms)}, each the mean of
    its two turns, and {("k1proj", tag, shape): (in-scan ms, alone ms, lib
    ms, bound ms, error share)} of a --yardsticks or --k1-proj run."""
    out = {}
    for line in stdout.splitlines():
        if m := YARD.match(line):
            out["yard", m[1], m[2], m[3]] = ((float(m[4]) + float(m[5])) / 2,
                                             (float(m[6]) + float(m[7])) / 2)
        elif m := K1PROJ.match(line):
            out["k1proj", m[1], m[2]] = tuple(float(v) for v in m.group(3, 4, 5, 6, 7))
    return out


# a line of the K3_K4, K11_K13 or K12_K14 snippet's timing: name, dtype, shape,
# ms, plain ms
B16 = re.compile(r"^(?:b16|time) (expand_ln|final_head|ln_dwmlp|sra|window_attn|linear_scan) "
                 r"(fp32|bf16) (.*?): ([\d.]+) ms(?:, plain ([\d.]+) ms)?")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logs", default="", help="directory for each run's whole output")
    short = ap.add_mutually_exclusive_group()
    for flag, (_, text) in MODES.items():
        short.add_argument(flag, action="store_true", help=text)
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.logs:
        os.makedirs(args.logs, exist_ok=True)
    mode = next((flag for flag in MODES if getattr(args, flag[2:].replace("-", "_"))), None)
    runs, phases = [], []
    for i, tree in enumerate(args.trees):
        root = os.path.abspath(tree)
        here = repr(os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
        cmd = (["-c", MODES[mode][0].replace("@HERE@", here)] if mode
               else [os.path.join(root, "chip_smoke.py")])
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, *cmd], cwd=root, capture_output=True, text=True,
                             timeout=1500)
        wall = time.perf_counter() - t0
        if args.logs:
            with open(os.path.join(args.logs, f"{i}_{os.path.basename(root)}.log"), "w") as f:
                f.write(res.stdout + "\n--- stderr\n" + res.stderr)
        if res.returncode != 0:
            print(f"{tree}: chip_smoke.py exited {res.returncode}\n{res.stdout[-2000:]}\n"
                  f"{res.stderr[-4000:]}", file=sys.stderr)
            return res.returncode
        runs.append((tree, times(res.stdout), kernel_times(res.stdout), side_times(res.stdout)))
        host = HOST_CPU.search(res.stdout)
        phases.append((tree, wall, phase_times(res.stdout, wall), host[1] if host else "?"))
        print(f"run {i} {tree}: {wall:.1f} s wall [{phases[-1][3]}]; {runs[-1][1]}, "
              f"{len(runs[-1][2])} kernel lines", flush=True)
    print(f"seconds per phase, runs in order [{card}]")
    for name in dict.fromkeys(n for _, _, p, _ in phases for n in p):
        print(f"{name:24s} " + "  ".join(f"{tree}: {p.get(name, float('nan')):.1f}"
                                         for tree, _, p, _ in phases))
    print(f"{'wall':24s} " + "  ".join(f"{tree}: {wall:.1f} [{host}]"
                                       for tree, wall, _, host in phases))
    print(f"ms per forward or step, runs in order [{card}]")
    for key in runs[0][1]:
        print(f"{key:14s} " + "  ".join(f"{tree}: {t.get(key, float('nan')):.2f}"
                                        for tree, t, _, _ in runs))
    print(f"kernels: ms per call (bound ms; gemm ms; plain ms), runs in order [{card}]")
    keys = list(dict.fromkeys(k for _, _, sc, _ in runs for k in sc))
    for key in keys:
        cells = []
        for tree, _, sc, _ in runs:
            ms, bound, gemm, plain = sc.get(key, (float("nan"),) * 4)
            cells.append(f"{tree}: {ms:.4f} ({bound:.4f}; {gemm:.4f}; {plain:.4f})")
        print(f"{' '.join(key):48s} " + "  ".join(cells))
    side = list(dict.fromkeys(k for *_, st in runs for k in st))
    if side:
        print(f"yardsticks: kernel ms / lib ms (lib / kernel); K1's projection: in-scan ms, "
              f"alone ms, lib ms, bound ms, error share; runs in order [{card}]")
    for key in side:
        cells = []
        for tree, *_, st in runs:
            v = st.get(key)
            if v is None:
                cells.append(f"{tree}: -")
            elif key[0] == "yard":
                cells.append(f"{tree}: {v[0]:.4f} / {v[1]:.4f} ({v[1] / v[0]:.2f})")
            else:
                cells.append(f"{tree}: {v[0]:.4f}, {v[1]:.4f}, {v[2]:.4f}, {v[3]:.4f}, "
                             f"{v[4]:.2e}")
        print(f"{' '.join(key):56s} " + "  ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
