"""bf16 training of Tramba-R against the JAX package: a tiny Tramba-R's
loss, every gradient and the updated running statistics against
``jax.value_and_grad`` of the same model in bf16 (``deterministic=False``,
a mutable ``batch_stats``, drop path 0; the cut of
``tests/test_torch_resnet.py``), at Queue 3 #7's gate
(``tests/test_torch_bf16_encoder_train.py``).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_bf16_encoder_train import gate, np32, overlapped
from test_torch_resnet import JTrambaR, batch, jax_variables, randomise_batchnorms, tiny
from tramba_tpu.train import loss as jloss
from tramba_tpu_torch.compat.jax_weights import params_from_jax
from tramba_tpu_torch.train import loss as tloss


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: under pytest-xdist, model-size torch ops
    stall on OpenMP barriers when the workers' threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tiny_bf16_tramba_r_training_matches_jax():
    """Tramba-R, train() / deterministic=False with a mutable batch_stats:
    the loss, the gradients and the updated running statistics (flax
    computes the statistics in fp32 from the bf16 activations, as the
    port's BatchNorm does).  Stage 4's parameters get no gradient."""
    model = randomise_batchnorms(tiny(torch.bfloat16))
    variables = jax_variables(model.state_dict())
    x, gt = batch(3)

    def step(jmodel):
        def f(p):
            outs, new = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                     jnp.asarray(x), deterministic=False, mutable=["batch_stats"])
            return jloss.deep_supervision_loss(outs, jnp.asarray(gt)), new

        return jax.jit(jax.value_and_grad(f, has_aux=True))

    def port_step():
        model.train()
        loss = tloss.deep_supervision_loss(model(torch.from_numpy(x)), torch.from_numpy(gt))
        loss.backward()
        return loss.item()

    want, fp32, loss = overlapped(step(JTrambaR(dtype=jnp.bfloat16, ssm_backend="pallas")),
                                  step(JTrambaR()), variables["params"], port_step)
    want, fp32 = ((float(v), params_from_jax({"params": np32(g),
                                              "batch_stats": np32(new["batch_stats"])}))
                  for (v, new), g in (want, fp32))
    got = {n: p.grad for n, p in model.named_parameters() if not n.startswith("encoder.layer4.")}
    assert all(p.grad is None for n, p in model.named_parameters()
               if n.startswith("encoder.layer4."))
    got.update({n: b for n, b in model.named_buffers()})
    assert all(g is not None for g in got.values())
    gate(loss, got, want, fp32)
