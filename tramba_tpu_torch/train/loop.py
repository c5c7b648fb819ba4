"""Training orchestration: ``training(args)`` and its parts.

Port of ``tramba_tpu/train/loop.py``: seeding, model build, the
pretrained-encoder graft, data loading, then ``fit`` -- per-epoch step decay,
train steps, in-loop eval from epoch ``see`` with the full SOD metric suite,
text and TensorBoard records, best-MAE weights and the rolling resume dict.
Data loading and the metrics are the port's copies of the JAX package's
numpy-only modules (``data/pipeline.py``, ``eval/metrics.py``).

Data parallelism (``:148-160``, ``:243-269``, ``:322``) engages by itself
when ``torch.distributed`` holds more than one process (``run.py`` sets it up,
``parallel/distributed.py``): the model is wrapped in DDP over the data
group, ``--batch_size`` stays the global batch and each process loads its
slice of it (the loader drops a ragged last batch, so every slice is full
and DDP's mean of the per-process mean losses is the global mean), and rank
0 alone evaluates and writes the record, TensorBoard, best-MAE and resume
files, from the unwrapped module.  JAX runs one process over all of a host's
chips and falls back to one device where the batch does not divide; torch
runs one process per card and raises there instead.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tramba_tpu_torch.compat.torch_weights import (graft_pvt_encoder, graft_resnet_encoder,
                                                   graft_swin_encoder, graft_vmamba_encoder)
from tramba_tpu_torch.data.pipeline import BatchLoader, SODDataset
from tramba_tpu_torch.eval.metrics import SODMetrics
from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.nn.layers import set_drop_path_generator
from tramba_tpu_torch.parallel.mesh import Axis, make_grid
from tramba_tpu_torch.train import checkpoint as ckpt
from tramba_tpu_torch.train.optim import fast_forward_schedule, make_optimizer, step_decay_schedule
from tramba_tpu_torch.train.step import eval_step, train_step

__all__ = ["training", "fit", "evaluate_in_loop", "init_model", "record", "SEED"]

SEED = 1026  # train.py's seed: numpy, the DropPath generator, the loader's shuffle


def _graft_encoder(model: torch.nn.Module, sd) -> None:
    """A released encoder checkpoint -> the encoder's weights under the
    port's (the reference's) names, by the model's encoder
    (``tramba_tpu/train/loop.py:60-85``): VMamba for Tramba-V, Swin-B for
    Tramba-S, PVTv2-b4 for Tramba-P, torchvision's ResNet-50 with its running
    statistics for Tramba-R.  Every grafted entry must exist in the model
    with the same shape."""
    for key in ("model", "state_dict"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
    if hasattr(model, "vssm_encoder"):
        graft = graft_vmamba_encoder(sd, [len(s.blocks) for s in model.vssm_encoder.layers])
    else:
        enc = model.encoder
        if model.enc_type == "swin":  # stages 1-3 are built; the graft drops stage 4's blocks
            graft = graft_swin_encoder(sd, [len(s.blocks) for s in enc.layers] + [0])
        elif model.enc_type == "pvt":
            graft = graft_pvt_encoder(sd, [len(getattr(enc, f"block{i}"))
                                           for i in range(1, enc.n_stages + 1)])
        else:
            graft = graft_resnet_encoder(sd, [len(getattr(enc, f"layer{i}"))
                                              for i in range(1, enc.n_stages + 1)])
    have = model.state_dict()
    for name, value in graft.items():
        if name not in have:
            raise KeyError(f"pretrained graft: no target parameter {name}")
        if have[name].shape != value.shape:
            raise ValueError(f"pretrained graft: shape mismatch at {name}: model "
                             f"{tuple(have[name].shape)} vs checkpoint {tuple(value.shape)}")
    model.load_state_dict(graft, strict=False)


def init_model(args, model: torch.nn.Module) -> torch.nn.Module:
    """Graft the method's pretrained encoder when ``args.pretrained_path`` is
    set.  A checkpoint that does not load is a hard error unless
    ``--allow_random_init`` (``tramba_tpu/train/loop.py:88-118``)."""
    pre = getattr(args, "pretrained_path", None)
    if not pre:
        return model
    try:
        _graft_encoder(model, torch.load(pre, map_location="cpu", weights_only=True))
        print(f"Loaded pretrained encoder for {args.method} from {pre}")
    except Exception as e:
        if not getattr(args, "allow_random_init", False):
            raise RuntimeError(
                f"failed to load pretrained encoder from {pre} for {args.method}: {e}; "
                "pass --allow_random_init to train from scratch anyway") from e
        print(f"WARNING: could not load pretrained encoder ({e}); using random init")
    return model


def evaluate_in_loop(model: torch.nn.Module, data_root: str, img_size: int, device,
                     batch_size: int = 8, sets=("Test",)) -> dict:
    """In-loop eval at network resolution (train.py:102-151): the per-image
    metrics run on a thread pool while the next batch runs on the device."""
    ds = SODDataset(data_root, list(sets), img_size, mode="test")
    loader = BatchLoader(ds, batch_size=batch_size, shuffle=False)
    metrics = SODMetrics()
    futs = []
    with ThreadPoolExecutor(int(os.environ.get("TRAMBA_EVAL_WORKERS", "8"))) as ex:
        for batch in loader:
            preds = eval_step(model, torch.from_numpy(batch["image"]).to(device)).cpu().numpy()
            for i in range(preds.shape[0]):
                futs.append(ex.submit(SODMetrics.compute_one, preds[i, :, :, 0],
                                      batch["gt"][i, :, :, 0]))
        for f in futs:
            metrics.append(f.result())
    return metrics.results()


def _is_lead() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def fit(args, model: torch.nn.Module, train_loader, device, tb_writer=None,
        data: Optional[Axis] = None):
    """Train ``args.train_epochs`` epochs; returns the optimizer.  ``data``:
    the data axis of the process grid; above one process the steps run
    through DDP over its group, the rest on ``model`` itself."""
    steps_per_epoch = max(1, len(train_loader))
    decay_epochs = list(map(int, str(args.decay_epochs).split("-")))
    decay_factors = list(map(float, str(args.decay_factors).split("-")))
    opt = make_optimizer(model.named_parameters(), args.lr, decay_epochs, decay_factors,
                         steps_per_epoch,
                         mu_dtype=getattr(torch, getattr(args, "mu_dtype", "bfloat16")))
    lr_sched = step_decay_schedule(args.lr, decay_epochs, decay_factors, steps_per_epoch)
    lead = _is_lead()

    save_dir = os.path.join(args.save_model, args.method)
    os.makedirs(save_dir, exist_ok=True)
    resume_path = os.path.join(save_dir, f"{args.method}_resume.pth")
    start_epoch = 0
    if getattr(args, "resume", None):
        if args.resume == "last":
            start_epoch = ckpt.load_resume(resume_path, model, opt)
        else:
            # weights only: fresh Adam moments, the schedule fast-forwarded to
            # the resumed epoch (tramba_tpu/train/loop.py:189-202)
            ckpt.load_checkpoint(model, args.resume)
            start_epoch = ckpt.epoch_from_filename(args.resume)
            fast_forward_schedule(opt, start_epoch * steps_per_epoch)
        print(f"Resumed; starting from epoch {start_epoch + 1}")

    stepped = model
    if data is not None and data.size > 1:
        stepped = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None,
            process_group=data.group)

    best_mae = args.best_MAE
    for epoch in range(start_epoch, args.train_epochs):
        t0 = time.time()
        total = torch.zeros((), device=device)
        n_steps = 0
        for batch in train_loader:
            images = torch.from_numpy(batch["image"]).to(device, non_blocking=True)
            gts = torch.from_numpy(batch["gt"]).to(device, non_blocking=True)
            total += train_step(stepped, opt, images, gts)
            n_steps += 1
        if stepped is not model:  # the global mean of the processes' mean losses
            dist.all_reduce(total, group=data.group)
            total /= data.size
        loss = total.item() / max(1, n_steps)  # one host fetch per epoch
        lr = float(lr_sched(epoch * steps_per_epoch))  # the LR this epoch trained at
        if lead:
            print(f"Epoch [{epoch + 1:03d}/{args.train_epochs:03d}] loss {loss:.4f} "
                  f"lr {lr:.2e} ({time.time() - t0:.1f}s)", flush=True)

        if epoch + 1 >= args.see and lead:
            results = evaluate_in_loop(model, args.evaluation_root, args.img_size, device)
            record(args, tb_writer, results, epoch, args.train_epochs, loss, lr)
            if best_mae is None or results["MAE"] < best_mae:
                best_mae = results["MAE"]
                ckpt.save_params(ckpt.best_mae_path(save_dir, args.method, best_mae, epoch), model)
        if (epoch + 1) % 5 == 0 and lead:  # the rolling resume dict (tramba_tpu/train/loop.py:259)
            ckpt.save_resume(resume_path, model, opt, epoch)
        if stepped is not model:  # the others wait for rank 0's eval and files
            dist.barrier()
    return opt


def record(args, tb_writer, results: dict, epoch: int, epochs: int, loss: float, lr: float):
    """Append-only text record + TensorBoard scalars (train.py:154-209)."""
    os.makedirs(args.save_model, exist_ok=True)
    path = os.path.join(args.save_model, f"Record_{args.method}.txt")
    with open(path, "a") as f:
        if epoch == 0 or not os.path.getsize(path):
            f.write("\n" + str(datetime.datetime.now()) + "\nStart record.\n")
            json.dump({k: str(v) for k, v in vars(args).items()}, f, indent=4)
            f.write(f"\nCurrent lr: {lr}\n")
        f.write(
            f"Epoch:{epoch + 1}||train_loss{loss}; "
            f"Smeasure:{results['Smeasure']:.4f}; wFmeasure:{results['wFmeasure']:.4f}; "
            f"MAE:{results['MAE']:.4f}; fnr:{results['fnr']:.4f}||"
            f"adpEm:{results['adpEm']:.4f}; meanEm:{results['meanEm']:.4f}; "
            f"maxEm:{results['maxEm']:.4f}; adpFm:{results['adpFm']:.4f}; "
            f"meanFm:{results['meanFm']:.4f}; maxFm:{results['maxFm']:.4f}\n"
        )
        if epoch + 1 == epochs:
            f.write(str(datetime.datetime.now()) + "\nEnd Training Record.\n")
    if tb_writer is not None:
        tb_writer.add_scalar("lr", lr, epoch + 1)
        for key in ("MAE", "adpFm", "meanFm", "maxFm", "adpEm", "meanEm", "maxEm",
                    "wFmeasure", "Smeasure"):
            tb_writer.add_scalar(key, results[key], epoch + 1)
    print(" | ".join(f"{k}:{results[k]:.4f}" for k in
                     ("MAE", "Smeasure", "wFmeasure", "adpEm", "meanEm", "maxEm",
                      "adpFm", "meanFm", "maxFm")), flush=True)


def training(args, device="cuda"):
    """Entry point (train.py:283-297): seed, build, graft, load data, fit on
    ``device``: the CUDA card (kernels), or the CPU when the caller asks for
    it (plain versions).  ``--dtype`` sets the compute dtype; parameters
    stay fp32.  With more than one process in ``torch.distributed``, data
    parallel over all of them (one card each).  Returns the model (never the
    DDP wrapper) and the optimizer."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tramba_tpu_torch training runs on a CUDA device; none is available "
                           "(pass device='cpu' to train on the CPU with the plain versions)")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    data = make_grid().data
    if args.batch_size % data.size:
        raise ValueError(f"--batch_size {args.batch_size} is the global batch and must divide "
                         f"over the {data.size} data-parallel processes")
    np.random.seed(SEED)
    tb_writer = None
    if getattr(args, "tf_log_path", None) and _is_lead():
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb_writer = SummaryWriter(os.path.join(args.tf_log_path, args.method))
        except Exception:
            pass
    print(f"Starting train..... Model:{args.method}", flush=True)
    model = init_model(args, build(args.method, args.img_size, seed=0,
                                   dtype=getattr(torch, getattr(args, "dtype", "float32"))))
    model = model.to(device)
    set_drop_path_generator(model, torch.Generator(device=device).manual_seed(SEED + data.rank))
    ds = SODDataset(args.data_root, ["Train"], args.img_size, mode="train")
    loader = BatchLoader(ds, batch_size=args.batch_size, shuffle=True, seed=SEED, num_threads=8,
                         drop_last=False, shard_rank=data.rank, shard_count=data.size)
    try:
        return model, fit(args, model, loader, device, tb_writer, data)
    finally:
        if tb_writer is not None:
            tb_writer.close()
