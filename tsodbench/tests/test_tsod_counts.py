"""The work counts: FLOPs recounted at a reduced size, and the bounds by
hand at one shape."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from tsodbench import counts, weights
from tsodbench.reference import model as ref
from tsodbench.tests import tiny


@pytest.mark.parametrize("model", [tiny.V, tiny.S], ids=["V", "S"])
def test_forward_flops_recounted_over_the_reference(model):
    """The meta-device count equals FlopCounterMode over the reference on
    real CPU tensors, plus 9 per scanned state element of every SS2D."""
    P = weights.draw(ref.param_shapes(model), 1, "cpu")
    x = torch.randn(1, model["img_size"], model["img_size"], 3)
    calls = []
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.forward(ref.Ctx(calls=calls), P, model, x)
    products = sum(fc.get_flop_counts()["Global"].values())
    scans = sum(9 * c[1] * c[2] * c[3] * c[4] for c in calls if c[0] == "ss2d")
    got = counts.forward_flops(model)
    assert got == {"products": products, "scans": scans, "total": products + scans}


def test_forward_flops_agree_with_the_programs_count():
    """At a reduced Tramba-V the count equals the program's own
    ``analytic_model_flops`` over its plain CPU route."""
    from tramba_tpu_torch.utils.profiling import analytic_model_flops

    from tsodbench import runner

    c = tiny.cell(tiny.V, tiny.DUMP, "tramba-v.dump-b16", "float32")
    prog = runner.build(c, torch.device("cpu"))
    want = analytic_model_flops(prog, torch.randn(1, 96, 96, 3))
    got = counts.forward_flops(tiny.V)
    assert got["products"] == want["matmul_conv_flops"]
    assert got["scans"] == want["scan_handle_flops"]


def test_k1_bound_by_hand():
    # Tramba-V's 96 px Helix SS2D at B16: d_model 128, D 256, K 8, R 8
    B, K, L, D, dm = 16, 8, 9216, 256, 128
    n = B * K * L * D
    nbytes = 2 * B * L * D + 4 * K * L + 4 * (K * 10 * D + K * D * 8 + 3 * K * D) + 4 * n
    tensor = 2 * n * 10  # the x projection's 10 outputs, on the tensor cores
    simt = 2 * n * 8 + 12 * n  # the rank-8 dt projection and the step, fp32
    want = max(nbytes / 3.35e12, tensor / 989e12, simt / 67e12)
    got, by = counts.k1_bound(B, K, L, D, dm)
    assert got == pytest.approx(want, rel=1e-12)
    assert by == "bytes" and nbytes / 3.35e12 == pytest.approx(3.8326e-4, rel=1e-4)


def test_k1_bound_by_hand_at_24_px():
    # a 15-block stage-3 SS2D of Tramba-V at B16: d_model 512, D 1024, K 4, R 32;
    # bytes-bound once the x projection runs at the tensor cores' rate
    B, K, L, D, dm = 16, 4, 576, 1024, 512
    n = B * K * L * D
    nbytes = 2 * B * L * D + 4 * K * L + 4 * (K * 34 * D + K * D * 32 + 3 * K * D) + 4 * n
    t_bytes, t_tensor = nbytes / 3.35e12, 2 * n * 34 / 989e12
    t_simt = (2 * n * 32 + 12 * n) / 67e12
    got, by = counts.k1_bound(B, K, L, D, dm)
    assert got == pytest.approx(max(t_bytes, t_tensor, t_simt), rel=1e-12)
    assert by == "bytes" and t_bytes > t_simt > t_tensor


def test_k8_bound_by_hand():
    # the same SS2D's adjoint: the line order visits some pixels twice
    B, K, L, D, dm = 16, 8, 9216, 256, 128
    n = B * K * L * D
    slots = counts.slots("line", 96, 0)
    assert slots > 1 and counts.slots("raster", 96, 0) == 1
    nbytes = (3 * 2 * B * L * D + 4 * K * L * (1 + slots) + 4 * B * K * (L // 64) * D
              + 4 * B * L * K * 10 + 2 * 4 * (K * 10 * D + K * D * 8 + 3 * K * D))
    tensor, simt = 6 * n * 10, 6 * n * 8 + 30 * n
    got, _ = counts.k8_bound(B, K, L, D, dm, "line", 0)
    want = max(nbytes / 3.35e12, tensor / 989e12, simt / 67e12)
    assert got == pytest.approx(want, rel=1e-12)


def test_ss2d_calls_of_tramba_v():
    import json
    import os

    path = os.path.join(os.path.dirname(counts.__file__), "configs", "tramba-v-tsod.bf16.json")
    with open(path) as f:
        model = json.load(f)["model"]
    calls = counts.ss2d_calls(model, 16)
    # 21 encoder blocks (raster), 3 guides of 2 (window, dilation), 6 Helix blocks (line)
    kinds = [c[5] for c in calls]
    assert len(calls) == 33 and kinds.count("raster") == 21 and kinds.count("line") == 6
    assert kinds.count("window") == kinds.count("dilation") == 3
    assert all(c[0] == 16 and c[3] == 2 * c[4] for c in calls)
    assert math.isclose(sum(c[2] for c in calls if c[5] == "raster"),
                        2 * 9216 + 2 * 2304 + 15 * 576 + 2 * 144)
