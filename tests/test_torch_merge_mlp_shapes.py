"""K2 ``ss2d_merge`` and K6 ``ln_mlp`` at the shapes their Hopper kernels take.

* ``ln_mlp_ref`` against ``_mlp_pallas`` (``tramba_tpu/ops/fused_mlp.py:130``)
  in interpret mode at the widths the main path adds to
  ``tests/test_torch_bf16_ops.py``'s one shape: d 64 (Tramba-P's 96 px
  guide), d 320 (its 24 px guide) and 144 rows (a 12 px map at batch 1).
  Tolerances as there: bf16 rtol / atol 1e-2 (about one bf16 ulp at the
  output: the two sides sum in other orders), fp32 rtol 1e-4, atol 1e-5.
* ``ss2d_merge_ref`` / ``ss2d_merge_train_ref`` against JAX's merge path on
  the TPU route's train forward, ``cross_merge`` then ``_ln_gelu_proj``
  (``fused_ss2d.py:478``), at Tramba-P's 24 px widths (dm 320, D 640) with
  the line order's multi-slot inverse table (12 slots at 24 px), in fp32
  (rtol / atol 1e-4: a 640-term LayerNorm and product summed in another
  order).
* Without a launch: every (K, slots, D, dm) of an SS2D and every (M, d,
  hid) of an FFN that Tramba-V, -S, -P and -R build at full width, and the
  tiny models the tests build, pass the wrappers' shape checks
  (``check_merge_shape``, ``check_ln_mlp_shape``), so no shape the JAX
  package runs raises on the card; and shapes the kernels do not take
  raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramba_tpu.ops import fused_mlp as jm
from tramba_tpu.ops import fused_ss2d as jf
from tramba_tpu.ops.scan_orders import cross_merge
from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.nn.layers import Mlp
from tramba_tpu_torch.nn.ssm import SS2D
from tramba_tpu_torch.ops import fused_mlp as tm
from tramba_tpu_torch.ops import fused_ss2d as tf
from tramba_tpu_torch.ops.scan_orders import order_tables

TOL = {"bf16": dict(rtol=1e-2, atol=1e-2), "fp32": dict(rtol=1e-4, atol=1e-5)}
JDT = {"bf16": jnp.bfloat16, "fp32": jnp.float32}
TDT = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _r(rng, *shape, scale=0.2, shift=0.0):
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _t(a, dt="fp32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dt])


@pytest.mark.parametrize("dt", ["bf16", "fp32"])
@pytest.mark.parametrize("B,L,d", [(2, 96, 64), (1, 144, 320), (1, 144, 128)],
                         ids=["96px-guide-d64", "24px-guide-d320", "12px-B1-144rows"])
def test_ln_mlp_ref_vs_pallas_shapes(dt, B, L, d):
    rng = np.random.default_rng(d + L)
    hid = 4 * d
    x = _r(rng, B, L, d, scale=1.0)
    s, b = _r(rng, d, scale=0.1, shift=1.0), _r(rng, d, scale=0.1)
    w1, b1 = _r(rng, d, hid, scale=d ** -0.5), _r(rng, hid, scale=0.1)
    w2, b2 = _r(rng, hid, d, scale=hid ** -0.5), _r(rng, d, scale=0.1)
    want = jm._mlp_pallas(jnp.asarray(x).astype(JDT[dt]),
                          *map(jnp.asarray, (s, b, w1, b1, w2, b2)), interpret=True)
    got = tm.ln_mlp_ref(_t(x, dt), _t(s), _t(b), _t(w1.T, dt), _t(b1), _t(w2.T, dt), _t(b2))
    assert got.dtype == TDT[dt] and tuple(got.shape) == want.shape
    torch.testing.assert_close(got.float(), torch.from_numpy(np.array(want, np.float32)),
                               **TOL[dt])


@pytest.mark.parametrize("train", [False, True], ids=["inference", "train"])
def test_merge_ref_vs_jax_line_tables(train):
    """K2's plain versions on Tramba-P's 24 px line SS2D (K 8, 12 slots)."""
    H, D, dm, B = 24, 640, 320, 1
    L = H * H
    rng = np.random.default_rng(7)
    ys = _r(rng, B, 8, L, D, scale=1.0)
    scale, bias = _r(rng, D, scale=0.1, shift=1.0), _r(rng, D, scale=0.1)
    w_out = _r(rng, D, dm, scale=D ** -0.5)  # JAX layout (D, dm)
    y = cross_merge(jnp.asarray(ys), "line", H, H)
    want = jf._ln_gelu_proj(y, jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(w_out),
                            jnp.float32)
    _, inv = order_tables("line", H, H, 0, "cpu")
    assert inv.shape[1] == 12  # the multi-slot table: some pixels lie on 12 lines
    args = (_t(ys), inv, _t(scale), _t(bias), _t(w_out.T))
    if train:
        got, y_sum = tf.ss2d_merge_train_ref(*args)
        torch.testing.assert_close(y_sum, torch.from_numpy(np.array(y)), rtol=1e-5, atol=1e-5)
    else:
        got = tf.ss2d_merge_ref(*args)
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), rtol=1e-4, atol=1e-4)


# the models as the port builds them at full width (384 px) and as the
# tests cut them
FULL = ["Tramba-V-TSOD", "Tramba-S-TSOD", "Tramba-P-TSOD", "Tramba-R-TSOD"]
TINY = {
    "V dims 16": ("Tramba-V-TSOD", 64, dict(dims=16, enc_depths=(1, 1, 1, 1),
                                            dec_depths=(1, 1, 1, 1))),
    "V dims 64": ("Tramba-V-TSOD", 64, dict(dims=64, enc_depths=(1, 1, 1, 1),
                                            dec_depths=(1, 1, 1, 1))),
    "S cut": ("Tramba-S-TSOD", 64, dict(enc_config=dict(embed_dim=64, depths=(2, 2, 2, 2),
                                                        num_heads=(2, 4, 8, 16), window=4),
                                        dec_depths=(1, 1, 1, 1))),
    "P cut": ("Tramba-P-TSOD", 64, dict(enc_config=dict(embed_dims=(64, 64, 128, 128),
                                                        num_heads=(1, 2, 2, 4),
                                                        mlp_ratios=(2, 2, 2, 2),
                                                        depths=(1, 1, 1, 1),
                                                        sr_ratios=(4, 2, 1, 1)),
                                        dec_depths=(1, 1, 1, 1))),
    "R cut": ("Tramba-R-TSOD", 64, dict(enc_config={"layers": (1, 1, 1, 1)},
                                        dec_depths=(1, 1, 1), dec_drop_path=0.0)),
}


def _model_shapes(method, img, overrides):
    """({(K, slots, D, dm)}, {(M, d, hid)}) of every SS2D and FFN of the
    model, on every map its stages run (img / 4 down to img / 32) that the
    SS2D's order tiles (a window order tiles only its own map), at batch 1
    and 16: the shapes K2 and K6 would get on the card."""
    with torch.device("meta"):
        model = build(method, img, device="meta", seed=None, dtype=torch.bfloat16, **overrides)
    maps = [img >> s for s in (2, 3, 4, 5)]
    merges, mlps = set(), set()
    for m in model.modules():
        if isinstance(m, SS2D):
            tiled = 0
            for H in maps:
                try:
                    _, inv = order_tables(m.scan_kind, H, H, m.scan_param, "cpu")
                except ValueError:  # e.g. window 16 on a 24 px map: never run there
                    continue
                tiled += 1
                merges.add((m.k_group, inv.shape[1], m.d_inner, m.d_model))
            assert tiled, (m.scan_kind, m.scan_param)
        elif isinstance(m, Mlp):
            mlps.update((B * H * H, m.fc1.in_features, m.fc1.out_features)
                        for H in maps for B in (1, 16))
    return merges, mlps


@pytest.mark.parametrize("case", FULL + list(TINY))
def test_model_shapes_pass_the_kernel_checks(case):
    method, img, overrides = TINY.get(case, (case, 384, {}))
    merges, mlps = _model_shapes(method, img, overrides)
    assert merges and (mlps or method == "Tramba-R-TSOD" and overrides)
    for K, slots, D, dm in merges:
        for dt in (torch.float32, torch.bfloat16):
            tf.check_merge_shape(K, slots, D, dm, dt)
    for M, d, hid in mlps:
        tm.check_ln_mlp_shape(M, d, hid)
    if not overrides:  # the full-width widths the kernels were sized for
        assert max(D for _, _, D, _ in merges) <= 2048
        assert {K for K, *_ in merges} <= {4, 8} and max(s for _, s, _, _ in merges) >= 6


@pytest.mark.parametrize("K,slots,D,dm,dt,what", [
    (3, 1, 256, 128, torch.float32, "K=3"), (8, 1, 4096, 128, torch.float32, "D=4096"),
    (4, 1, 100, 64, torch.bfloat16, "D=100"), (4, 0, 256, 128, torch.float32, "slots")])
def test_merge_check_refuses(K, slots, D, dm, dt, what):
    with pytest.raises(ValueError, match="ss2d_merge"):
        tf.check_merge_shape(K, slots, D, dm, dt)


@pytest.mark.parametrize("M,d,hid", [(10, 2048, 8192), (10, 40, 160), (10, 64, 72), (0, 64, 256)])
def test_ln_mlp_check_refuses(M, d, hid):
    with pytest.raises(ValueError, match="ln_mlp"):
        tm.check_ln_mlp_shape(M, d, hid)
