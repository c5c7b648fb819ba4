"""Port modules vs their flax counterparts, on the same weights.

Each port module is initialised from a seed; its state dict goes through the
JAX package's numpy-only converter (compat/torch_weights.py) to the flax
parameter tree, so these tests also hold the port's parameter names and
layouts to the reference's.  The flax modules run their composed CPU path.
fp32; rtol 1e-4, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramba_tpu.compat import torch_weights as tw
from tramba_tpu.nn.blocks import MultiScaleDecoderBlock as JMSBlock
from tramba_tpu.nn.blocks import VSSBlock as JVSSBlock
from tramba_tpu.nn.freq import FreqBlock as JFreqBlock
from tramba_tpu.nn.ssm import SS2D as JSS2D
from tramba_tpu_torch.nn.blocks import MultiScaleDecoderBlock, VSSBlock
from tramba_tpu_torch.nn.freq import FreqBlock
from tramba_tpu_torch.nn.init import init_weights
from tramba_tpu_torch.nn.ssm import SS2D

TOL = dict(rtol=1e-4, atol=1e-5)


def _flax_params(module: torch.nn.Module, convert, *args):
    sd = tw.state_dict_to_numpy({f"m.{k}": v for k, v in module.state_dict().items()})
    tracked = tw._TrackedSD(sd)
    params = convert(tracked, "m", *args)
    tw.check_consumed(tracked, strict=True)  # every port parameter has a flax home
    return {"params": params}


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind,K,param,with_ln", [
    ("raster", 4, 0, True), ("line", 8, 0, True), ("window", 4, 4, False),
    ("dilation", 4, 4, False)])
def test_ss2d(kind, K, param, with_ln):
    d = 16
    m = init_weights(SS2D(d, k_group=K, scan_kind=kind, scan_param=param),
                     torch.Generator().manual_seed(K + param)).eval()
    variables = _flax_params(m, tw._ss2d, K)
    x = _x((2, 8, 8, d), seed=1)
    ln = (_x((d,), 2) * 0.1 + 1, _x((d,), 3) * 0.1) if with_ln else None
    flax_m = JSS2D(d_model=d, k_group=K, scan_kind=kind, scan_param=param)
    want = jax.jit(lambda v, a, n: flax_m.apply(v, a, ln=n))(
        variables, jnp.asarray(x), None if ln is None else tuple(map(jnp.asarray, ln)))
    with torch.no_grad():
        got = m(torch.from_numpy(x), ln=None if ln is None else tuple(map(torch.from_numpy, ln)))
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("port_cls,flax_cls,convert", [
    (VSSBlock, JVSSBlock, tw._vss_block),
    (MultiScaleDecoderBlock, JMSBlock, tw._ms_decoder_block)])
def test_blocks(port_cls, flax_cls, convert):
    d = 16
    m = init_weights(port_cls(d), torch.Generator().manual_seed(7)).eval()
    variables = _flax_params(m, convert)
    x = _x((2, 8, 8, d), seed=4)
    want = jax.jit(flax_cls(hidden_dim=d).apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("H,window", [(8, 4), (12, 4)])
def test_freq_block(H, window):
    d = 16
    m = init_weights(FreqBlock(d, window, 4), torch.Generator().manual_seed(H)).eval()
    variables = _flax_params(m, tw._freq_block)
    x = _x((1, H, H, d), seed=5)
    want = jax.jit(JFreqBlock(dim=d, window=window, dilation=4).apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    _close(got, want)


def test_dct_quadrants_match():
    from tramba_tpu.ops.dct import dct2d_quadrants as jdct
    from tramba_tpu_torch.ops.dct import dct2d_quadrants as tdct

    x = _x((2, 8, 12, 5), seed=6)
    for got, want in zip(tdct(torch.from_numpy(x)), jax.jit(jdct)(jnp.asarray(x))):
        assert tuple(got.shape) == want.shape == (2, 4, 6, 5)
        _close(got, want)


def test_init_is_seeded():
    a = init_weights(VSSBlock(16), torch.Generator().manual_seed(3)).state_dict()
    b = init_weights(VSSBlock(16), torch.Generator().manual_seed(3)).state_dict()
    c = init_weights(VSSBlock(16), torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["op.x_proj_weight"], c["op.x_proj_weight"])
