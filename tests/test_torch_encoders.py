"""The Tramba-S / Tramba-P slice end to end in fp32: a tiny Tramba-S /
Tramba-P against the JAX package with the weights carried across by the
converters; the converters' round trip; checkpoints, registry and dump.
The bf16 comparisons are in ``tests/test_torch_bf16_encoders.py``.

The JAX side is built from its own ``SwinEncoder`` / ``PVTv2Encoder`` and
``TrambaDecoder`` with ``TrambaEnc``'s skip assembly (``TrambaEnc`` fixes
the full-size configurations).

The cut: 64 px images; Swin with embed 64, heads (2, 4, 8, 16), window 4
(stage 1 shifted and masked at 16 px, stage 3 a single 4 x 4 window);
PVTv2 with widths (64, 64, 128, 128), heads (1, 2, 2, 4), FFN ratio 2,
sr (4, 2, 1, 1), so that stages 1-3 run the fused attention and stages 1-2
the fused FFN, while stage 4 (2 px) and the FFN of stage 3 run composed,
as PVTv2-b4's stage 4 does at 384 px.  Tolerance: fp32 atol 1e-4 on the
heads' logits (as Tramba-V's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import tramba_tpu.models.pvt as jpvt
import tramba_tpu.models.swin as jswin
from tramba_tpu.compat.torch_weights import (convert_pvt_encoder, convert_swin_encoder,
                                             convert_tramba_decoder, convert_tramba_enc,
                                             state_dict_to_numpy)
from tramba_tpu.models.tramba import TrambaDecoder as JDecoder
from tramba_tpu_torch.compat.jax_weights import params_from_jax
from tramba_tpu_torch.models.registry import build

IMG = 64
HEADS = [(2, 4, 4, 1), (2, 8, 8, 1), (2, 16, 16, 1), (2, 64, 64, 1)]
DEC = (1, 1, 1, 1)
CUT = {
    "swin": dict(embed_dim=64, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16), window=4),
    "pvt": dict(embed_dims=(64, 64, 128, 128), num_heads=(1, 2, 2, 4), mlp_ratios=(2, 2, 2, 2),
                depths=(1, 1, 1, 1), sr_ratios=(4, 2, 1, 1)),
}
METHOD = {"swin": "Tramba-S-TSOD", "pvt": "Tramba-P-TSOD"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: under pytest-xdist, model-size torch ops
    stall on OpenMP barriers when the workers' threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JTramba(fnn.Module):
    """TrambaEnc's assembly (tramba_tpu/models/tramba.py:219-253) at a cut
    configuration."""

    enc_type: str
    cfg: tuple
    dtype: jnp.dtype = jnp.float32
    ssm_backend: str = None

    @fnn.compact
    def __call__(self, x):
        cfg = dict(self.cfg)
        if self.enc_type == "swin":
            skips = [x] + jswin.SwinEncoder(img_size=IMG, dtype=self.dtype, **cfg,
                                            name="encoder")(x)
            features = [cfg["embed_dim"] * 2 ** i for i in range(4)]
        else:
            skips = [x] + jpvt.PVTv2Encoder(dtype=self.dtype, **cfg, name="encoder")(x)[::-1]
            features = list(cfg["embed_dims"])
        return JDecoder(features_per_stage=features, depths=DEC, img_size=IMG,
                        ssm_backend=self.ssm_backend, dtype=self.dtype, name="decoder")(skips)


def _jax_params(sd, enc):
    sd = state_dict_to_numpy(sd)
    depths = CUT[enc]["depths"]
    conv = convert_swin_encoder if enc == "swin" else convert_pvt_encoder
    return {"params": {"encoder": conv(sd, "encoder.", depths),
                       "decoder": convert_tramba_decoder(sd, "decoder.", 4, DEC)}}


def _image(seed=0):
    return np.random.default_rng(seed).normal(size=(2, IMG, IMG, 3)).astype(np.float32)


def _tiny(enc, dtype):
    return build(METHOD[enc], IMG, device="cpu", seed=0, dtype=dtype, enc_config=CUT[enc], dec_depths=DEC)


@pytest.mark.parametrize("enc", ["swin", "pvt"])
def test_tiny_model_fp32_matches_jax(enc):
    """All four heads of the same weights and image, fp32: the port's plain
    path vs the JAX composed path, atol 1e-4 on the logits."""
    model = _tiny(enc, torch.float32)
    x = _image()
    want = jax.jit(JTramba(enc, tuple(CUT[enc].items())).apply)(_jax_params(model.state_dict(),
                                                                            enc), x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert [tuple(o.shape) for o in got] == [w.shape for w in want] == HEADS
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=f"{enc} head {i}")


# ---- weights, checkpoints, registry, dump -----------------------------------


@pytest.mark.parametrize("enc", ["swin", "pvt"])
def test_weights_round_trip_and_strict_load(enc):
    """The JAX converters applied to params_from_jax(p) give p back leaf for
    leaf, for a tree shaped like the flax model's own init; the state dict
    loads strictly into the port's model."""
    shapes = jax.eval_shape(JTramba(enc, tuple(CUT[enc].items())).init, jax.random.key(0),
                            jnp.zeros((1, IMG, IMG, 3)))
    rng = np.random.default_rng(3)
    p = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), shapes)
    sd = params_from_jax(p)
    back = _jax_params(sd, enc)
    want = dict(jax.tree_util.tree_leaves_with_path(p))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k
    model = build(METHOD[enc], IMG, device="cpu", seed=None, enc_config=CUT[enc], dec_depths=DEC)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("enc", ["swin", "pvt"])
def test_full_width_state_dict_round_trips_through_convert_tramba_enc(enc):
    """At full width (no forward): the port's state dict carries exactly the
    reference keys that convert_tramba_enc reads (its strict leftover check
    passes), and params_from_jax inverts it leaf for leaf.  The model is
    built without the seeded draws (``seed=None``) and each parameter filled
    with distinct values by position, which any transposed or swapped leaf
    would change."""
    model = build(METHOD[enc], 384, device="cpu", seed=None)
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.copy_(torch.arange(p.numel(), dtype=torch.float32).view_as(p) * 1e-6 + i)
    sd = model.state_dict()
    p = convert_tramba_enc(state_dict_to_numpy(sd), enc)
    back = params_from_jax(p)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    assert jax.tree_util.tree_all(jax.tree.map(np.array_equal, convert_tramba_enc(back, enc), p))


def test_load_checkpoint_drops_what_the_converter_ignores(tmp_path):
    """A reference Tramba-S state dict loads strictly after dropping only the
    weightless buffers and the never-run stage-4 Swin blocks; any other
    leftover key fails the strict load."""
    from tramba_tpu_torch.train.checkpoint import load_checkpoint

    tiny = _tiny("swin", torch.float32)
    sd = dict(tiny.state_dict())
    sd["encoder.layers.0.blocks.1.attn_mask"] = torch.zeros(16, 16, 16)
    sd["encoder.layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(16, 16)
    sd["encoder.layers.3.blocks.0.mlp.fc1.weight"] = torch.zeros(4, 4)
    torch.save(sd, tmp_path / "ref.pth")
    model = build("Tramba-S-TSOD", IMG, device="cpu", seed=None, enc_config=CUT["swin"], dec_depths=DEC)
    load_checkpoint(model, str(tmp_path / "ref.pth"))
    assert all(torch.equal(model.state_dict()[k], v) for k, v in tiny.state_dict().items())
    torch.save({**sd, "encoder.norm.weight": torch.zeros(4)}, tmp_path / "extra.pth")
    with pytest.raises(RuntimeError, match="encoder.norm.weight"):
        load_checkpoint(model, str(tmp_path / "extra.pth"))
    pvt = build("Tramba-P-TSOD", IMG, device="cpu", seed=None, enc_config=CUT["pvt"], dec_depths=DEC)
    torch.save({**_tiny("pvt", torch.float32).state_dict(),
                "encoder.layers.3.blocks.0.mlp.fc1.weight": torch.zeros(4)}, tmp_path / "p.pth")
    with pytest.raises(RuntimeError, match="layers.3.blocks"):
        load_checkpoint(pvt, str(tmp_path / "p.pth"))


@pytest.mark.parametrize("method", ["Tramba-S-TSOD", "Tramba-S-SOD", "Tramba-P-TSOD",
                                    "Tramba-P-SOD"])
def test_registry_builds_the_encoder_variants(method):
    """Every Tramba-S / -P method builds; fp32 and bf16 builds from one seed
    hold the same fp32 parameters (one state dict serves both)."""
    from tramba_tpu_torch.models.registry import METHODS

    enc = "swin" if "-S-" in method else "pvt"
    assert method in METHODS
    fp32 = build(method, IMG, device="cpu", seed=0, enc_config=CUT[enc], dec_depths=DEC)
    bf16 = build(method, IMG, device="cpu", seed=0, dtype=torch.bfloat16, enc_config=CUT[enc],
                 dec_depths=DEC)
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    a, b = fp32.state_dict(), bf16.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("enc", ["swin", "pvt"])
def test_seeded_init_draws_the_encoders_own_parameters(enc):
    """``init_weights`` leaves the encoders' own draws to their modules'
    ``reset_own_parameters``: each ``LecunConv2d`` flax's lecun normal
    (truncated at 2 sigma, std fan_in^-1/2; bias 0), each Swin bias table a
    truncated normal of std 0.02 (within +-0.04).  Std within 25%."""
    from tramba_tpu_torch.models.swin import WindowAttention
    from tramba_tpu_torch.nn.layers import LecunConv2d

    model = build(METHOD[enc], IMG, device="cpu", seed=0, enc_config=CUT[enc], dec_depths=DEC)
    convs = [m for m in model.modules() if isinstance(m, LecunConv2d)]
    tables = [m.relative_position_bias_table.detach() for m in model.modules()
              if isinstance(m, WindowAttention)]
    assert convs and bool(tables) == (enc == "swin")
    for m in convs:
        w, std = m.weight.detach(), m.weight[0].numel() ** -0.5
        assert w.abs().max() <= 2 * std / 0.87962566103423978 * (1 + 1e-6)
        assert 0.75 * std <= w.std() <= 1.25 * std
        assert m.bias is None or not m.bias.any()
    for t in tables:
        # a truncated normal at +-2 sigma keeps 0.88 of its sigma
        assert t.abs().max() <= 0.04 and 0.75 * 0.0176 <= t.std() <= 1.25 * 0.0176


@pytest.mark.parametrize("enc", ["swin", "pvt"])
def test_dump_writes_maps_of_the_encoder_variants(enc, tmp_path):
    """The dump CLI's path (eval/dump.py) for Tramba-S / -P, on the CPU at
    the cut size: one map per image at its original size."""
    from PIL import Image

    from tramba_tpu_torch.eval.dump import dump_saliency_maps

    rng = np.random.default_rng(0)
    for sub in ("image", "mask"):
        (tmp_path / "data" / "Test" / sub).mkdir(parents=True)
    for i, (w, h) in enumerate(((50, 44), (33, 61))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "RGB").save(
            tmp_path / "data" / "Test" / "image" / f"i{i}.png")
        Image.fromarray((rng.random((h, w)) > 0.5).astype(np.uint8) * 255, "L").save(
            tmp_path / "data" / "Test" / "mask" / f"i{i}.png")
    n = dump_saliency_maps(_tiny(enc, torch.bfloat16), str(tmp_path / "data"),
                           str(tmp_path / "out"), img_size=IMG, batch_size=2)
    assert n == 2
    for i, size in enumerate(((50, 44), (33, 61))):
        with Image.open(tmp_path / "out" / f"i{i}.png") as im:
            assert im.size == size and im.mode == "L"


@pytest.mark.slow
@pytest.mark.parametrize("enc,img", [("swin", 192), ("pvt", 128)])
def test_full_width_model_matches_jax_trambaenc(enc, img):
    """JAX's own full-width TrambaEnc (fp32, composed) against the port's
    full-width Tramba-S / -P with the same weights, on a small image (Swin-B's
    12 px windows need a map of 48 px at stage 1): heads at atol 1e-4."""
    from tramba_tpu.models.tramba import TrambaEnc as JTrambaEnc

    model = build(METHOD[enc], img, device="cpu", seed=0)
    p = convert_tramba_enc(state_dict_to_numpy(model.state_dict()), enc)
    x = np.random.default_rng(4).normal(size=(1, img, img, 3)).astype(np.float32)
    want = jax.jit(JTrambaEnc(enc_type=enc, img_size=img).apply)(p, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert [tuple(o.shape) for o in got] == [w.shape for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=f"{enc} head {i}")
