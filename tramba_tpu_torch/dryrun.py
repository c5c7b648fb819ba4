"""Multi-process dry run: one training step in each parallel layout.

    python -m tramba_tpu_torch.dryrun --n N [--device cpu]

Port of ``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:23-164``).
It starts N processes (gloo on the CPU; on the card one process per card,
NCCL) and runs one training step of a tiny Tramba-V (64 px, dims 16, depths
1) in each of four process grids, the same shapes as JAX's meshes:

1. dp: data parallel over all N (the default SS2D route);
2. dp x tp: ``ssm_backend="tensor_parallel"``, model axis 2 where N is even;
3. dp x sp: ``ssm_backend="seq_parallel"``, sequence axis 2 where N is even;
4. dp x tp x sp: ``ssm_backend="hybrid_tp_sp"``, model 2 where N is even and
   sequence 2 where 4 divides N; SS2Ds with L >= 256 (the 16 x 16 stage)
   take the sequence-parallel scan, the rest the tensor-parallel core.

The global batch is N images, one per process, each phase starting from the
previous phase's updated weights.  Each step must give a finite loss and one
optimizer update; rank 0 prints a line per phase.
"""

from __future__ import annotations

import argparse
import contextlib
from typing import List, Optional

import torch
import torch.distributed as dist

from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.parallel.distributed import spawn
from tramba_tpu_torch.parallel.mesh import batch_slice, broadcast_parameters, make_grid
from tramba_tpu_torch.parallel.seq_scan import use_sequence_group
from tramba_tpu_torch.parallel.tp import use_tensor_group
from tramba_tpu_torch.train.optim import make_optimizer
from tramba_tpu_torch.train.step import train_step

__all__ = ["PHASES", "phase_grids", "run_phases", "main"]

TINY = dict(dims=16, enc_depths=(1, 1, 1, 1), dec_depths=(1, 1, 1, 1))
# (name, SS2D backend) of each phase, in order
PHASES = (("dp", None), ("dp x tp", "tensor_parallel"), ("dp x sp", "seq_parallel"),
          ("dp x tp x sp", "hybrid_tp_sp"))


def phase_grids(world: int) -> List[tuple]:
    """(model, seq) axis sizes of each phase at ``world`` processes (the data
    axis takes the rest), as ``dryrun_multichip`` shapes its meshes."""
    two = 2 if world % 2 == 0 else 1
    return [(1, 1), (two, 1), (1, two), (two, 2 if world % 4 == 0 else 1)]


def run_phases(device, img_size: int = 64, batch: Optional[int] = None, min_l: int = 256,
               model_kw=None, on_step=None) -> List[dict]:
    """The four phases in this process, one rank of the ambient world, in
    fp32.
    ``batch``: the global batch (default one image per process); ``model_kw``
    cuts Tramba-V (default :data:`TINY`); ``min_l``: the hybrid phase's
    least sequence-parallel L.  ``on_step(name, model, step)`` runs after
    each phase's step (a caller's check or timing of the same step).  Returns per
    phase its name, grid and global mean loss."""
    world = dist.get_world_size()
    batch = batch or world
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    model_kw = TINY if model_kw is None else model_kw
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(batch, img_size, img_size, 3, generator=gen).to(device)
    gts = torch.zeros(batch, img_size, img_size, 1, device=device)
    state = build("Tramba-V-TSOD", img_size, device="cpu", seed=0, **model_kw).state_dict()
    out = []
    for (name, backend), (n_model, n_seq) in zip(PHASES, phase_grids(world)):
        grid = make_grid(n_model, n_seq)
        model = build("Tramba-V-TSOD", img_size, device=device, seed=None, ssm_backend=backend,
                      **model_kw)
        model.load_state_dict(state)
        broadcast_parameters(model)  # one replica across the whole grid, not only the data group
        opt = make_optimizer(model.named_parameters(), 1e-4, [60], [0.2], 10)
        ddp = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None,
            process_group=grid.data.group)
        x, g = batch_slice(images, grid.data), batch_slice(gts, grid.data)
        with contextlib.ExitStack() as ctx:
            if backend is not None:
                ctx.enter_context(use_tensor_group(grid.model))
                ctx.enter_context(use_sequence_group(grid.seq, min_l))

            def step():
                return train_step(ddp, opt, x, g)

            loss = step()
            if on_step is not None:
                on_step(name, model, step)
        dist.all_reduce(loss, group=grid.data.group)
        loss = loss.item() / grid.data.size
        if not torch.isfinite(torch.tensor(loss)) or any(c < 1 for c in opt.count.values()):
            raise AssertionError(f"{name}: loss {loss}, optimizer steps {opt.count}")
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        out.append(dict(name=name, data=grid.data.size, model=grid.model.size,
                        seq=grid.seq.size, loss=loss))
    return out


def _worker(device: str) -> List[dict]:
    return run_phases(torch.device(device))


def main(argv=None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=None,
                   help="processes (default: one per visible card; 2 on the CPU)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.device == "cuda":
        cards = torch.cuda.device_count()
        n = args.n or cards
        if not 1 <= n <= cards:
            raise SystemExit(f"--n {n}: one process per card, and {cards} cards are visible "
                             "(--device cpu runs gloo processes instead)")
    else:
        n = args.n or 2
    phases = spawn(_worker, n, args.device, args.device)[0]
    for r in phases:
        print(f"dryrun({n}, {args.device}): {r['name']} ok (data {r['data']}, model "
              f"{r['model']}, seq {r['seq']}), loss={r['loss']:.4f}", flush=True)
    return phases


if __name__ == "__main__":
    main()
