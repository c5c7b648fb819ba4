"""Tramba-S / Tramba-P training and the encoder grafts in fp32: a tiny
Tramba-S / -P's loss and every gradient against ``jax.value_and_grad``, and
the Swin-B / PVTv2-b4 grafts from state dicts under the upstream key names.

Models, cut and weights as in ``tests/test_torch_encoders.py`` (64 px, the
decoder at depth 1); the JAX side is that file's ``JTramba`` (TrambaEnc's
assembly at the cut configuration).  Eval mode on the port's side and
``deterministic=True`` on JAX's: no stochastic depth, as the Tramba-V test
(``tests/test_torch_train.py``).  The gradients of the fused encoder parts
run through the plain versions (fp32 takes no kernel), JAX's through its
composed encoders.  Tolerances: the loss rtol 1e-5, each parameter's
gradient ||port - jax|| <= 1e-4 ||jax||.  The graft checkpoints are built
here under the reference key names (no download).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_encoders import CUT, DEC, IMG, METHOD, JTramba, _jax_params, _tiny
from tramba_tpu.train import loss as jloss
from tramba_tpu_torch.compat.jax_weights import params_from_jax
from tramba_tpu_torch.compat.torch_weights import (graft_pvt_encoder, graft_swin_encoder,
                                                   upstream_encoder_state_dict)
from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.train import loss as tloss
from tramba_tpu_torch.train.loop import init_model


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: under pytest-xdist, model-size torch ops
    stall on OpenMP barriers when the workers' threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return (a - b).norm().item() / max(b.norm().item(), 1e-30)


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    return x, (rng.random((2, IMG, IMG, 1)) > 0.7).astype(np.float32)


@pytest.mark.parametrize("enc", ["swin", "pvt"])
def test_tiny_model_loss_and_grads_match_jax(enc):
    model = _tiny(enc, torch.float32)
    params = _jax_params(model.state_dict(), enc)
    x, gt = _batch(1)
    jmodel = JTramba(enc, tuple(CUT[enc].items()))

    def f(p):
        return jloss.deep_supervision_loss(jmodel.apply(p, jnp.asarray(x)), jnp.asarray(gt))

    want_loss, want_grads = jax.jit(jax.value_and_grad(f))(params)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    model.eval()
    loss = tloss.deep_supervision_loss(model(torch.from_numpy(x)), torch.from_numpy(gt))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = dict(model.named_parameters())
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        rel = _rel(g, w)
        assert rel <= 1e-4, f"{enc} {name}: relative grad error {rel}"


@pytest.mark.parametrize("enc", ["swin", "pvt"])
def test_init_model_grafts_the_upstream_encoder(enc, tmp_path):
    """The encoder of an upstream checkpoint lands on the port's names and
    nothing else moves; a checkpoint of another width is fatal unless
    --allow_random_init."""
    src = build(METHOD[enc], IMG, seed=3, enc_config=CUT[enc], dec_depths=DEC)
    torch.save(upstream_encoder_state_dict(src), tmp_path / "enc.pth")
    model = _tiny(enc, torch.float32)
    dec_before = model.state_dict()["decoder.seg_layers.0.weight"].clone()
    args = type("A", (), dict(pretrained_path=str(tmp_path / "enc.pth"),
                              allow_random_init=False, method=METHOD[enc]))()
    init_model(args, model)
    got = model.state_dict()
    for k, v in src.state_dict().items():
        if k.startswith("encoder."):
            assert torch.equal(got[k], v), k
    assert torch.equal(got["decoder.seg_layers.0.weight"], dec_before)
    wide = {"swin": dict(CUT["swin"], embed_dim=96),
            "pvt": dict(CUT["pvt"], embed_dims=(64, 64, 128, 192))}[enc]
    other = build(METHOD[enc], IMG, seed=0, enc_config=wide, dec_depths=DEC)
    with pytest.raises(RuntimeError, match="allow_random_init"):
        init_model(args, other)
    args.allow_random_init = True
    init_model(args, other)


@pytest.mark.parametrize("enc", ["swin", "pvt"])
def test_grafts_are_strict(enc):
    """A missing encoder weight raises KeyError, an unknown leftover key
    ValueError; what the grafts drop (classifier, stage-4 blocks, buffers)
    never reaches the result."""
    model = _tiny(enc, torch.float32)
    ckpt = upstream_encoder_state_dict(model)
    sd = ckpt.get("model", ckpt)
    graft, depths = ((graft_swin_encoder, (2, 2, 2, 0)) if enc == "swin"
                     else (graft_pvt_encoder, (1, 1, 1, 1)))
    out = graft(sd, depths)
    want = {k: v for k, v in model.state_dict().items() if k.startswith("encoder.")}
    assert out.keys() == want.keys()
    assert all(torch.equal(out[k], want[k]) for k in want)
    gone = next(k for k in sd if k.endswith("norm1.weight"))
    with pytest.raises(KeyError, match="lacks 1 encoder weights"):
        graft({k: v for k, v in sd.items() if k != gone}, depths)
    with pytest.raises(ValueError, match="unconsumed"):
        graft({**sd, "block9.0.mlp.fc3.weight": torch.zeros(2)}, depths)
