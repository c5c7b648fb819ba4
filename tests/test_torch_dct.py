"""The port's DCT helpers (``tramba_tpu_torch/ops/dct.py``) against the JAX
package's (``tramba_tpu/ops/dct.py``) and scipy.

On the CPU, fp32, inputs seeded with numpy: each helper equals JAX's at
rtol / atol 1e-5 at ``tests/test_dct.py``'s shapes, ``dct2d`` equals
``scipy.fft.dctn(norm="ortho")`` at 1e-4, both inverses undo their
transforms, and ``split_high_low(dct2d(x))`` is ``dct2d_quadrants(x)`` bit
for bit, as in JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft
import torch

from tramba_tpu.ops import dct as jdct
from tramba_tpu_torch.ops import dct as tdct

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(8, 8), (12, 16), (24, 24)]  # tests/test_dct.py's maps


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port(fn, x, *args):
    out = fn(torch.from_numpy(x), *args)
    return [o.numpy() for o in out] if isinstance(out, tuple) else out.numpy()


def _jax(fn, x, *args):
    out = fn(jnp.asarray(x), *args)
    return [np.asarray(o) for o in out] if isinstance(out, tuple) else np.asarray(out)


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("name", ["dct2d", "idct2d", "dct2d_quadrants"])
def test_full_map_helpers_equal_jax(name, H, W):
    x = _x((2, H, W, 3), 0)
    got, want = _port(getattr(tdct, name), x), _jax(getattr(jdct, name), x)
    for g, w in zip(*(o if isinstance(o, list) else [o] for o in (got, want))):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("H,W", SHAPES)
def test_split_high_low_equals_jax(H, W):
    x = _x((2, H, W, 3), 1)
    for g, w in zip(_port(tdct.split_high_low, x), _jax(jdct.split_high_low, x)):
        assert g.shape == w.shape == (2, H // 2, W // 2, 3)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["block_dct2d", "block_idct2d"])
@pytest.mark.parametrize("shape,block", [((1, 16, 24, 2), 8), ((2, 12, 12, 3), 4)])
def test_block_helpers_equal_jax(name, shape, block):
    x = _x(shape, 2)
    got = _port(getattr(tdct, name), x, block)
    np.testing.assert_allclose(got, _jax(getattr(jdct, name), x, block), **TOL)


@pytest.mark.parametrize("H,W", SHAPES)
def test_dct2d_matches_scipy(H, W):
    x = _x((2, H, W, 3), 3)
    want = scipy.fft.dctn(x.astype(np.float64), type=2, norm="ortho", axes=(1, 2))
    np.testing.assert_allclose(_port(tdct.dct2d, x), want, rtol=1e-4, atol=1e-4)


def test_round_trips():
    x = torch.from_numpy(_x((1, 16, 24, 4), 4))
    torch.testing.assert_close(tdct.idct2d(tdct.dct2d(x)), x, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(tdct.block_idct2d(tdct.block_dct2d(x, 8), 8), x,
                               rtol=1e-4, atol=1e-5)


def test_split_of_dct2d_is_dct2d_quadrants():
    x = torch.from_numpy(_x((2, 12, 12, 5), 5))
    for a, b in zip(tdct.split_high_low(tdct.dct2d(x)), tdct.dct2d_quadrants(x)):
        assert torch.equal(a, b)


def test_helpers_keep_dtype_and_refuse_ragged_blocks():
    x = torch.from_numpy(_x((1, 8, 8, 2), 6)).bfloat16()
    assert tdct.dct2d(x).dtype == tdct.block_dct2d(x).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="multiples"):
        tdct.block_dct2d(torch.zeros(1, 12, 8, 1))
