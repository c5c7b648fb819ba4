"""bf16 training of Tramba-P against the JAX package: a tiny Tramba-P's
loss and every gradient against ``jax.value_and_grad`` of the same model in
bf16, with JAX's PVTv2 TPU routing (``_sra_pallas`` and ``_dwmlp_pallas`` in
interpret mode under their custom VJPs) and Queue 3 #7's gate
(``tests/test_torch_bf16_encoder_train.py``).
"""

import pytest
import torch

from test_torch_bf16_encoder_train import check_encoder_variant


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test: under pytest-xdist, model-size torch ops
    stall on OpenMP barriers when the workers' threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tiny_bf16_pvt_loss_and_grads_match_jax(monkeypatch):
    check_encoder_variant("pvt", monkeypatch)
