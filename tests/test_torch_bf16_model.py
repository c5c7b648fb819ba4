"""The bf16 slice end to end: a tiny bf16 Tramba-V vs the JAX package.

Dims 64 (so d_inner 128 and the FFN hidden 256 pass the JAX kernels' shape
gates), depths 1, 64 px.  The JAX side is ``TrambaV(dtype=bfloat16,
ssm_backend="pallas")``: its Pallas kernels in interpret mode on the CPU,
composed XLA where its TPU gates send it.  The two round at other places
there (the 2 px raster SS2D, the unfused expands and head), so the heads are
held to a mean abs logit difference of 2e-2, against the bf16-vs-fp32 gap of
the JAX model itself (4e-3 to 1.1e-2 at this size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramba_tpu.compat.torch_weights import convert_tramba_v, state_dict_to_numpy
from tramba_tpu.models.tramba import TrambaV as JTrambaV
from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.ops import fused_mlp, fused_prologue

TINY = dict(dims=64, enc_depths=(1, 1, 1, 1), dec_depths=(1, 1, 1, 1))
IMG = 64
HEADS = [(2, 4, 4, 1), (2, 8, 8, 1), (2, 16, 16, 1), (2, 64, 64, 1)]
HEAD_MEAN_ABS_TOL = 2e-2
# sites per forward at TINY: SS2Ds = 4 encoder + 3 decoder + 6 guide;
# plain FFNs = 4 encoder + 3 guide; DWMS FFNs = 3 decoder
SITES = {"prologue": 13, "ln_mlp": 7, "ln_dwms_mlp": 3}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: under pytest-xdist, model-size torch ops
    stall on OpenMP barriers when the workers' threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_bf16():
    return build("Tramba-V-TSOD", IMG, device="cpu", seed=0, dtype=torch.bfloat16, **TINY)


def _image():
    return np.random.default_rng(0).normal(size=(2, IMG, IMG, 3)).astype(np.float32)


def test_tiny_bf16_trambav_matches_jax_pallas(tiny_bf16):
    params = convert_tramba_v(state_dict_to_numpy(tiny_bf16.state_dict()),
                              enc_depths=TINY["enc_depths"], dec_depths=TINY["dec_depths"])
    x = _image()
    jmodel = JTrambaV(img_size=IMG, dtype=jnp.bfloat16, ssm_backend="pallas", **TINY)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tiny_bf16(torch.from_numpy(x))
    assert [tuple(o.shape) for o in got] == [w.shape for w in want] == HEADS
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        g, w = g.float().numpy(), np.asarray(w).astype(np.float32)
        assert np.isfinite(g).all()
        diff = np.abs(g - w).mean()
        assert diff <= HEAD_MEAN_ABS_TOL, f"head {i}: mean abs {diff} (|logit| {np.abs(w).mean()})"


def test_bf16_model_keeps_fp32_parameters(tiny_bf16):
    """Parameters stay fp32, as flax keeps them: one state dict serves both
    dtypes, and the fp32 and bf16 builds from one seed hold the same weights."""
    assert all(p.dtype == torch.float32 for p in tiny_bf16.parameters())
    fp32 = build("Tramba-V-TSOD", IMG, device="cpu", seed=0, **TINY).state_dict()
    bf16 = tiny_bf16.state_dict()
    assert fp32.keys() == bf16.keys()
    assert all(torch.equal(fp32[k], bf16[k]) for k in fp32)


@pytest.mark.parametrize("dtype,factor", [(torch.bfloat16, 1), (torch.float32, 0)])
def test_new_wrappers_run_at_every_site_in_bf16_only(monkeypatch, dtype, factor):
    """In bf16 every SS2D prologue, plain FFN and DWMS FFN goes through its
    wrapper (K5, K6, K7); in fp32 none does."""
    calls = {name: 0 for name in SITES}

    def spy(module, name):
        fn = getattr(module, name)

        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)

    spy(fused_prologue, "prologue")
    spy(fused_mlp, "ln_mlp")
    spy(fused_mlp, "ln_dwms_mlp")
    model = build("Tramba-V-TSOD", IMG, device="cpu", seed=0, dtype=dtype, **TINY)
    with torch.no_grad():
        outs = model(torch.from_numpy(_image()))
    assert all(o.dtype == dtype for o in outs)
    assert calls == {name: factor * n for name, n in SITES.items()}


def test_build_refuses_other_dtypes():
    with pytest.raises(ValueError, match="compute dtype"):
        build("Tramba-V-TSOD", IMG, device="cpu", seed=0, dtype=torch.float16, **TINY)
