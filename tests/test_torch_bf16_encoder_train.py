"""bf16 training of Tramba-S against the JAX package, and the checks that
``tests/test_torch_bf16_pvt_train.py`` (Tramba-P) and
``tests/test_torch_bf16_resnet_train.py`` (Tramba-R) share: a tiny model's
loss and every gradient (and Tramba-R's updated running statistics) against
``jax.value_and_grad`` of the same model in bf16.  One model per file: JAX
traces and compiles each bf16 model with its Pallas kernels in interpret
mode for 1-2 minutes, and the files run side by side under pytest-xdist.

JAX's bf16 step is compiled in a thread while its fp32 step and the port's
run here (``overlapped``): the compile, most of that step's time, lets go of
the interpreter.

The cuts and JAX modules are those of ``tests/test_torch_encoders.py``
(Tramba-S / -P, with the JAX encoders' TPU routing: ``_fused_ok`` patched to
True in this test's view of the modules, so that ``_wattn_pallas``,
``_sra_pallas`` and ``_dwmlp_pallas`` run in interpret mode under their
custom VJPs) and ``tests/test_torch_resnet.py`` (Tramba-R, ``train()`` /
``deterministic=False``, drop path 0); the decoders run with
``ssm_backend="pallas"``.  The gate is Queue 3 #7's, set by JAX alone: per
parameter ||port - jax|| <= max(2e-2, 1.25 x sqrt(2) x JAX's own
bf16-vs-fp32 gap of that parameter) x ||jax||, the same rule for the loss
(``tests/test_torch_bf16_train.py`` says why).  The port's gradients of
K11-K13's parts are their plain versions' VJPs, JAX's ``jax.vjp`` of the
composed oracles.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_encoders import CUT, IMG, JTramba, _jax_params, _tiny, jpvt, jswin
from tramba_tpu.train import loss as jloss
from tramba_tpu_torch.compat.jax_weights import params_from_jax
from tramba_tpu_torch.train import loss as tloss

GATE, NOISE_FACTOR = 2e-2, 1.25 * 2 ** 0.5


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


def gate(got_loss, got, jax_bf16, jax_fp32):
    """Queue 3 #7's gate on the loss and on every entry of ``got`` (a dict
    of tensors under the port's names); prints each entry's rel / limit."""
    (want_loss, want), (fp32_loss, fp32) = jax_bf16, jax_fp32
    loss_tol = max(GATE, NOISE_FACTOR * abs(want_loss - fp32_loss) / abs(fp32_loss))
    assert abs(got_loss - want_loss) <= loss_tol * abs(want_loss), (got_loss, want_loss)
    rows = []
    for name, g in got.items():
        tol = max(GATE, NOISE_FACTOR * _rel(want[name], fp32[name]))
        rel = _rel(g, want[name])
        rows.append((rel / tol, name, rel, tol))
    rows.sort(reverse=True)
    print("rel/tol  rel norm  limit  entry")
    for ratio, name, rel, tol in rows[:15]:
        print(f"{ratio:.3f}  {rel:.3e}  {tol:.3e}  {name}")
    assert rows[0][0] <= 1.0, f"worst (rel/tol, name, rel, tol): {rows[:5]}"


def np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def overlapped(bf16_step, fp32_step, params, port_step):
    """(``bf16_step(params)``, ``fp32_step(params)``, ``port_step()``) for
    two jitted JAX functions and the port's step: the bf16 step is traced
    here and compiled in a thread while the other two run."""
    lowered = bf16_step.lower(params)
    with ThreadPoolExecutor(1) as pool:
        compiled = pool.submit(lowered.compile)
        fp32, port = fp32_step(params), port_step()
        return compiled.result()(params), fp32, port


def check_encoder_variant(enc, monkeypatch):
    """Tramba-S / -P, eval mode / deterministic=True."""
    for mod in (jpvt, jswin):
        monkeypatch.setattr(mod, "_fused_ok", lambda force=False: True)
    model = _tiny(enc, torch.bfloat16)
    params = _jax_params(model.state_dict(), enc)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    gt = (rng.random((2, IMG, IMG, 1)) > 0.7).astype(np.float32)

    def step(jmodel):
        def f(p):
            return jloss.deep_supervision_loss(jmodel.apply(p, jnp.asarray(x)), jnp.asarray(gt))

        return jax.jit(jax.value_and_grad(f))

    def port_step():
        model.eval()
        loss = tloss.deep_supervision_loss(model(torch.from_numpy(x)), torch.from_numpy(gt))
        loss.backward()
        return loss.item()

    cfg = tuple(CUT[enc].items())
    want, fp32, loss = overlapped(step(JTramba(enc, cfg, dtype=jnp.bfloat16, ssm_backend="pallas")),
                                  step(JTramba(enc, cfg)), params, port_step)
    want, fp32 = ((float(v), params_from_jax(np32(g))) for v, g in (want, fp32))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert got.keys() == want[1].keys()
    assert all(g is not None and g.dtype == torch.float32 for g in got.values())
    gate(loss, got, want, fp32)


def test_tiny_bf16_swin_loss_and_grads_match_jax(monkeypatch):
    check_encoder_variant("swin", monkeypatch)
