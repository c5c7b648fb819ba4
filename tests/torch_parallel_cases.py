"""What each process of a gloo world runs for ``test_torch_parallel.py``.

The test module imports JAX; the processes it starts import this module by
name instead, which needs only torch and the port.  Every function runs in
one rank of a world that ``parallel.distributed.spawn`` set up and returns
what the test compares, as CPU tensors.
"""

import functools
import os

import torch
import torch.distributed as dist

from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.nn.ssm import SS2D
from tramba_tpu_torch.ops.selective_scan import linear_scan
from tramba_tpu_torch.parallel.mesh import batch_slice, make_grid
from tramba_tpu_torch.parallel.seq_scan import sequence_parallel_linear_scan, use_sequence_group
from tramba_tpu_torch.parallel.tp import use_tensor_group
from tramba_tpu_torch.train.loss import deep_supervision_loss

# a two-stage Tramba-V (JAX's tests/test_parallel.py cuts it so): raster
# encoder, line decoder, window and dilation guides at 8 x 8 and 4 x 4 maps
TINY = dict(dims=8, enc_depths=(1, 1), dec_depths=(1, 1))
IMG = 32
MIN_L = 64  # the hybrid's least sequence-parallel L: the 8 x 8 stage
# a tiny Tramba-R (tests/test_torch_resnet.py's cut): BatchNorms, and a
# stage 4 whose output feeds no head
TINY_R = dict(enc_config={"layers": (1, 1, 1, 1)}, dec_depths=(1, 1, 1), dec_drop_path=0.0)
IMG_R = 64


def seq_scan(a, b, g):
    """The sequence-parallel scan over the whole world, and its gradients
    for the cotangent g; and the K14 wrapper's launches (none on the CPU)."""
    seq = make_grid(1, dist.get_world_size()).seq
    a, b = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    h = sequence_parallel_linear_scan(a, b, seq)
    h.backward(g)
    return h.detach(), a.grad, b.grad, linear_scan.launches


def tp_ss2d(cases):
    """Each case (SS2D keywords, state dict, x, ln, g) on the tensor-parallel
    route over the whole world: the output and the gradients of x and of
    every parameter."""
    model = make_grid(dist.get_world_size(), 1).model
    out = []
    for kw, sd, x, ln, g in cases:
        m = SS2D(backend="tensor_parallel", **kw)
        m.load_state_dict(sd)
        x = x.clone().requires_grad_(True)
        with use_tensor_group(model):
            y = m(x, ln=ln)
        y.backward(g)
        out.append((y.detach(), x.grad, {n: p.grad for n, p in m.named_parameters()}))
    return out


def tiny_model(backend, sd, x, gt, grid_shape):
    """A tiny Tramba-V on ``backend`` over a (data, model, seq) grid of
    ``grid_shape`` (model, seq): its four heads on this rank's slice of the
    batch, and one backward of the deep-supervision loss through DDP over
    the data group.  Returns the heads, the global mean loss and every
    parameter's gradient."""
    grid = make_grid(*grid_shape)
    model = build("Tramba-V-TSOD", IMG, seed=None, ssm_backend=backend, **TINY).eval()
    model.load_state_dict(sd)
    ddp = torch.nn.parallel.DistributedDataParallel(model, process_group=grid.data.group)
    xs, gs = batch_slice(x, grid.data), batch_slice(gt, grid.data)
    with use_tensor_group(grid.model), use_sequence_group(grid.seq, MIN_L):
        heads = ddp(xs)
        loss = deep_supervision_loss(heads, gs)
        loss.backward()
    total = loss.detach().clone()
    dist.all_reduce(total, group=grid.data.group)
    return ([h.detach() for h in heads], total.item() / grid.data.size,
            {n: p.grad for n, p in model.named_parameters()})


def resnet_steps(x, gt, sd):
    """Two ``train()`` steps of a tiny Tramba-R through DDP over the whole
    world, each rank on its slice of the batch: the global mean losses of
    both, and every parameter's gradient after the first.  ``sd`` holds
    numpy arrays."""
    data = make_grid().data
    model = build("Tramba-R-TSOD", IMG_R, seed=None, **TINY_R).train()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    ddp = torch.nn.parallel.DistributedDataParallel(model, process_group=data.group)
    xs, gs = batch_slice(x, data), batch_slice(gt, data)
    losses = []
    for step in range(2):
        loss = deep_supervision_loss(ddp(xs), gs)
        loss.backward()
        if step == 0:
            grads = {n: None if p.grad is None else p.grad.clone()
                     for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        total = loss.detach().clone()
        dist.all_reduce(total, group=data.group)
        losses.append(total.item() / data.size)
    return losses, grads


def run_cli(rank, world, init, flags, out):
    """One process of ``python -m tramba_tpu_torch.run`` as the JAX
    package's launch protocol starts it (``TRAMBA_NUM_PROCESSES``,
    ``TRAMBA_PROCESS_ID``, ``--init_method``), the model cut to TINY without
    stochastic depth; rank 0 saves the trained weights to ``out``."""
    from tramba_tpu_torch import run
    from tramba_tpu_torch.train import loop

    torch.set_num_threads(1)
    os.environ.update(TRAMBA_NUM_PROCESSES=str(world), TRAMBA_PROCESS_ID=str(rank))
    loop.build = functools.partial(build, enc_drop_path=0.0, dec_drop_path=0.0, **TINY)
    model, _ = run.main(flags + ["--init_method", init], device="cpu")
    if rank == 0:
        torch.save(model.state_dict(), out)


def run_all(seq_args, tp_cases, model_cfgs, model_args, resnet_args=None):
    """Everything one world size checks, in one world: the scan, the
    tensor-parallel SS2Ds, each (name, backend, grid shape) of
    ``model_cfgs`` on the tiny model and, given ``resnet_args``, the tiny
    Tramba-R's data-parallel steps."""
    return dict(seq=seq_scan(*seq_args), tp=tp_ss2d(tp_cases),
                models={name: tiny_model(backend, *model_args, shape)
                        for name, backend, shape in model_cfgs},
                resnet=resnet_args and resnet_steps(*resnet_args))
