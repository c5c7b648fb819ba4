"""Plain versions of kernels K3 (expand_ln) and K4 (final_head) vs the JAX package.

JAX side: the Pallas kernels in interpret mode on the CPU (fused_expand2,
fused_final_head) and their composed oracles.  fp32; rtol 1e-4, atol 1e-5.
Weights go to the port in torch.nn.Linear layout (the JAX kernels transposed).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramba_tpu.nn.layers import pixel_shuffle as jax_pixel_shuffle
from tramba_tpu.ops import fused_expand as je
from tramba_tpu_torch.ops import fused_expand as te

TOL = dict(rtol=1e-4, atol=1e-5)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _expand_inputs(B, H, W, C, factor, seed):
    rng = np.random.default_rng(seed)
    co = factor * C // 4
    return (rng.normal(size=(B, H, W, C)).astype(np.float32),
            (rng.normal(size=(C, factor * C)) * 0.2).astype(np.float32),
            (rng.normal(size=(co,)) * 0.1 + 1).astype(np.float32),
            (rng.normal(size=(co,)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("factor", [2, 4])
@pytest.mark.parametrize("shape", [(2, 6, 8, 16), (1, 4, 4, 32)])
def test_expand_ln_ref_vs_jax(factor, shape):
    x, w, s, b = _expand_inputs(*shape, factor, seed=factor)
    got = te.expand_ln_ref(*_t(x, w.T, s, b))
    args = [jnp.asarray(a) for a in (x, w, s, b)]
    for want in (je.fused_expand2(*args), je.composed_expand2(*args)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pixel_shuffle_channel_order():
    x = np.arange(2 * 3 * 4 * 16, dtype=np.float32).reshape(2, 3, 4, 16)
    for p in (2, 4):
        want = np.asarray(jax_pixel_shuffle(jnp.asarray(x), p))
        assert np.array_equal(te.pixel_shuffle(torch.from_numpy(x), p).numpy(), want)


@pytest.mark.parametrize("C,seed", [(128, 3), (32, 7)])
def test_final_head_ref_vs_jax(C, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.normal(size=s) * 0.2).astype(np.float32)
    x, w1, s, b, wh, bh = r(2, 8, 8, C), r(C, 16 * C), r(C) + 1.0, r(C), r(C), r(1)
    got = te.final_head_ref(*_t(x, w1.T, s, b, wh, bh))
    args = [jnp.asarray(a) for a in (x, w1, s, b, wh, bh)]
    for want in (je.fused_final_head(*args), je.composed_final_head(*args)):
        assert got.shape == want.shape == (2, 8, 8, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrappers_take_plain_version_on_cpu():
    x, w, s, b = _t(*_expand_inputs(1, 4, 4, 8, 2, seed=0))
    assert torch.equal(te.expand_ln(x, w.T.contiguous(), s, b),
                       te.expand_ln_ref(x, w.T.contiguous(), s, b))
    assert te.expand_ln.launches == 0 and te.final_head.launches == 0
