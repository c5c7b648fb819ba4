"""The plain reference: what it imports, and that it computes what the
program's plain CPU route computes at tiny widths (forward, loss, steps)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from tsodbench import weights
from tsodbench.reference import model as ref
from tsodbench.reference import orders
from tsodbench.reference import scan
from tsodbench.reference import train as ref_train
from tsodbench.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_reference_imports_neither_jax_nor_the_program():
    code = ("import sys, json, os; import tsodbench.reference.model as m, "
            "tsodbench.reference.train, tsodbench.counts, tsodbench.weights; "
            "d = os.path.dirname(m.__file__); "
            "[m.part(k, f[:-3]) for k in ('encoders', 'decoders') "
            "for f in os.listdir(os.path.join(d, k)) if f.endswith('.py')]; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "optax", "tramba_tpu", "tramba_tpu_torch"}


def _program(model, dtype=torch.float32):
    from tsodbench import runner

    c = tiny.cell(model, tiny.DUMP, "tramba-v.dump-b16", str(dtype).split(".")[1])
    return runner.build(c, torch.device("cpu"))


@pytest.mark.parametrize("cfg_name", ["tramba-v-tsod.bf16", "tramba-s-tsod.bf16"])
def test_param_shapes_are_the_programs_at_full_size(cfg_name):
    """The reference's parameters are those of the program built from the
    configuration file's ``build`` overrides, name for name and shape for
    shape."""
    from tsodbench import harness, runner

    with open(os.path.join(ROOT, "tsodbench", "configs", cfg_name + ".json")) as f:
        cfg = json.load(f)
    model = runner.build(harness.Cell("full", 1, cfg, tiny.DUMP, {}, [], []),
                         torch.device("meta"))
    have = {n: tuple(p.shape) for n, p in model.state_dict().items()}
    want = {n: tuple(s) for n, s in ref.param_shapes(cfg["model"]).items()}
    assert have == want
    assert sum(torch.Size(s).numel() for s in want.values()) == cfg["parameters"]


@pytest.mark.parametrize("model", [tiny.V, tiny.S], ids=["V", "S"])
def test_forward_matches_the_programs_plain_route(model):
    prog = _program(model)
    P = weights.draw(ref.param_shapes(model), 3, "cpu")
    prog.load_state_dict(P, strict=True)
    x = torch.randn(2, 96, 96, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, want = prog(x), ref.forward(ref.Ctx(), P, model, x)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind,res,param", [("raster", 12, 0), ("line", 12, 0), ("line", 24, 0),
                                            ("window", 24, 8), ("dilation", 24, 4)])
def test_orders_are_the_programs(kind, res, param):
    from tramba_tpu_torch.ops.scan_orders import get_order

    assert (orders.order(kind, res, res, param) == get_order(kind, res, res, param).idx).all()


def test_scan_and_its_adjoint_match_a_step_loop():
    g = torch.Generator().manual_seed(1)
    a = torch.rand(2, 3, 37, 5, generator=g).requires_grad_(True)
    b = torch.randn(2, 3, 37, 5, generator=g).requires_grad_(True)
    h = scan.linear_scan(a, b)
    prev, hs = torch.zeros(2, 3, 5), []
    for t in range(37):
        prev = a[:, :, t] * prev + b[:, :, t]
        hs.append(prev)
    want = torch.stack(hs, dim=2)
    torch.testing.assert_close(h, want, rtol=1e-5, atol=1e-6)
    w = torch.randn(want.shape, generator=g)
    ga, gb = torch.autograd.grad((h * w).sum(), (a, b))
    wa, wb = torch.autograd.grad((want * w).sum(), (a, b))
    torch.testing.assert_close(ga, wa, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gb, wb, rtol=1e-5, atol=1e-5)


def test_training_steps_match_the_programs():
    """Two steps of the program's fp32 CPU route (``train_step``, the
    two-group Adam with a bf16 first moment, DropPath from a seeded
    generator) against the reference's."""
    from tramba_tpu_torch.nn.layers import set_drop_path_generator
    from tramba_tpu_torch.train import optim
    from tramba_tpu_torch.train.step import train_step

    from tsodbench import counts

    model_cfg = tiny.V
    prog = _program(model_cfg)
    P = weights.draw(ref.param_shapes(model_cfg), 4, "cpu")
    prog.load_state_dict(P, strict=True)
    opt = optim.make_optimizer(prog.named_parameters(), 1e-3, steps_per_epoch=100,
                               mu_dtype=torch.bfloat16)
    set_drop_path_generator(prog, torch.Generator().manual_seed(9))
    imgs = weights.images(4, 96, 1, "cpu", 2)
    gts = weights.masks(4, 96, 2, "cpu", 2)
    losses = [train_step(prog, opt, imgs[s], gts[s], torch.ones(4)).item() for s in range(2)]
    want = ref_train.run(model_cfg, P, [(imgs[s], gts[s]) for s in range(2)], 2,
                         counts.drop_rates(model_cfg), 9, 1e-3, 0.1, 2)
    assert len(counts.drop_rates(model_cfg)) > 0
    for a, b in zip(losses, want["loss"]):
        assert a == pytest.approx(b, rel=1e-4)
    for n, p in prog.named_parameters():
        d_prog = (p.detach() - P[n]).norm()
        d_ref = (want["params"][n] - P[n]).norm()
        assert d_prog.item() == pytest.approx(d_ref.item(), rel=2e-2, abs=1e-7), n
