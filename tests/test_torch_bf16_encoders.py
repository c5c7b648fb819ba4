"""The Tramba-S / Tramba-P slice in bf16: the port's Swin and PVTv2
encoders and a tiny Tramba-S / Tramba-P against the JAX package's TPU
routing.

The JAX encoders' ``_fused_ok`` is patched to True in this test's view of
the modules, so that ``_sra_pallas``, ``_dwmlp_pallas`` and ``_wattn_pallas``
run in interpret mode where their gates hold, and the decoder runs with
``ssm_backend="pallas"``.  No JAX file changes.  Models, cut and weights as
in ``tests/test_torch_encoders.py``.  Tolerances: bf16 stage maps rtol/atol
2e-2 (both sides round at the same points, but sum in another order); heads
mean abs 2e-2 (the bf16 Tramba-V gate: the decoders round at other points in
their unfused parts; at this cut the two sides differ by about as much as
JAX's bf16 differs from the port's fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_encoders import CUT, HEADS, IMG, JTramba, _image, _jax_params, _tiny, jpvt, jswin

HEAD_MEAN_ABS_TOL_BF16 = 2e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: under pytest-xdist, model-size torch ops
    stall on OpenMP barriers when the workers' threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tpu_routing(monkeypatch):
    """The JAX encoders take their TPU routing (fused kernels in interpret mode)."""
    for mod in (jpvt, jswin):
        monkeypatch.setattr(mod, "_fused_ok", lambda force=False: True)


@pytest.mark.parametrize("enc", ["swin", "pvt"])
def test_encoder_bf16_matches_jax_tpu_routing(enc, tpu_routing):
    """The bf16 encoders alone, JAX's fused kernels in interpret mode: every
    skip map within rtol/atol 2e-2."""
    model = _tiny(enc, torch.bfloat16)
    params = _jax_params(model.state_dict(), enc)["params"]["encoder"]
    cfg = CUT[enc]
    x = _image(1)
    if enc == "swin":
        jenc = jswin.SwinEncoder(img_size=IMG, dtype=jnp.bfloat16, **cfg)
    else:
        jenc = jpvt.PVTv2Encoder(dtype=jnp.bfloat16, **cfg)
    want = jax.jit(jenc.apply)({"params": params}, x)
    with torch.no_grad():
        got = model.encoder(torch.from_numpy(x).to(torch.bfloat16))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w).astype(np.float32),
                                   rtol=2e-2, atol=2e-2, err_msg=f"{enc} map {i}")


@pytest.mark.parametrize("enc", ["swin", "pvt"])
def test_tiny_model_bf16_matches_jax_tpu_routing(enc, tpu_routing):
    model = _tiny(enc, torch.bfloat16)
    x = _image(2)
    jmodel = JTramba(enc, tuple(CUT[enc].items()), dtype=jnp.bfloat16, ssm_backend="pallas")
    want = jax.jit(jmodel.apply)(_jax_params(model.state_dict(), enc), x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert [tuple(o.shape) for o in got] == [w.shape for w in want] == HEADS
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        g, w = g.float().numpy(), np.asarray(w).astype(np.float32)
        diff = np.abs(g - w).mean()
        assert np.isfinite(g).all()
        assert diff <= HEAD_MEAN_ABS_TOL_BF16, f"{enc} head {i}: mean abs {diff}"
