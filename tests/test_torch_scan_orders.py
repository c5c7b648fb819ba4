"""Port scan orders vs the JAX package's: gather and inverse tables byte-equal."""

import numpy as np
import pytest

from tramba_tpu.ops import scan_orders as jso
from tramba_tpu_torch.ops import scan_orders as tso

SQUARE = (4, 8, 12, 16)
# the orders that take any H x W map (besides raster and dilation)
ANY_MAP = ("hilbert", "diagonal", "diagonal8", "ab1", "ab2")


def _cases():
    for n in SQUARE:
        yield "raster", n, n, 0
        yield "line", n, n, 0
        yield "dilation", n, n, 4
        for w in (2, 4):
            if n % w == 0:
                yield "window", n, n, w
        for kind in ANY_MAP + ("line4", "spiral", "spiral8"):
            yield kind, n, n, 0
    # non-square maps where the JAX package allows them
    for H, W in ((4, 8), (12, 16), (16, 12)):
        yield "raster", H, W, 0
        yield "dilation", H, W, 4
        for kind in ANY_MAP:
            yield kind, H, W, 0


@pytest.mark.parametrize("kind,H,W,param", list(_cases()))
def test_tables_byte_equal(kind, H, W, param):
    want = jso.get_order(kind, H, W, param)
    got = tso.get_order(kind, H, W, param)
    for a, b in ((got.idx, want.idx), (got.inv, want.inv)):
        assert a.dtype == b.dtype == np.int32
        assert a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert got.max_mult == want.max_mult
    assert got.is_permutation == want.is_permutation


@pytest.mark.parametrize("gen,args", [
    ("raster_tables", (8, 12)), ("line_tables", (12, 12)), ("dilation_tables", (8, 8, 2)),
    ("window_tables", (12, 12, 3)), ("spiral_tables", (7, 7)), ("spiral_tables", (12, 12)),
    ("hilbert_tables", (12, 12)), ("hilbert_tables", (6, 10)), ("hilbert_tables", (16, 9)),
    ("diagonal_tables", (8, 12)), ("diagonal_tables", (12, 12)), ("ab_tables", (8, 12, 1)),
    ("ab_tables", (8, 12, 2)),
])
def test_generators_byte_equal(gen, args):
    assert getattr(tso, gen)(*args).tobytes() == getattr(jso, gen)(*args).tobytes()


def test_line_orders_revisit_and_miss():
    """Helix lines visit some pixels several times and miss others; the
    inverse table pads with L, so a merge gives missed pixels 0."""
    o = tso.get_order("line", 12, 12)
    L = 144
    assert o.K == 8 and o.max_mult > 1 and not o.is_permutation
    visits = np.stack([np.bincount(o.idx[k], minlength=L) for k in range(4, 8)])
    assert (visits == 0).any() and (visits > 1).any()
    assert ((o.inv[4:] < L).sum(axis=1) == visits).all()


def test_square_only_orders_and_unported_kind_raise():
    """line, line4 and window index a flat map as ``p0 * H + p1``, and the
    spirals transpose it as ``j * W + i`` (square maps only): the port
    refuses H != W, where the JAX window table misses pixels (4x8) or
    overruns the map (16x12), and so does its counter-clockwise spiral
    (16x12: 148 of 192 pixels; 4x8: past the map).  An unknown kind raises
    ValueError, as JAX's ``get_order`` does."""
    for kind, param in (("line", 0), ("line4", 0), ("window", 4), ("spiral", 0),
                        ("spiral8", 0)):
        for H, W in ((8, 12), (12, 8)):
            with pytest.raises(ValueError, match="square"):
                tso.get_order(kind, H, W, param)
    assert len(np.unique(jso.window_tables(4, 8, 4)[0])) < 32
    assert len(np.unique(jso.spiral_tables(16, 12)[1])) == 148
    assert jso.spiral_tables(4, 8)[1].max() >= 32
    for get in (jso.get_order, tso.get_order):
        with pytest.raises(ValueError, match="unknown scan order kind"):
            get("zigzag", 8, 8)
