"""Training CLI of the port: ``python -m tramba_tpu_torch.run``.

Port of ``run.py`` with its flags.  Trains on one CUDA card and raises
when there is none; a caller may ask for the CPU (``main(argv,
device="cpu")``, the plain versions of the kernels).  ``--dtype float32``
keeps TF32 off in matmuls and cuDNN convolutions, the counterpart of
``jax_default_matmul_precision=highest``; ``--dtype bfloat16`` computes in
bf16 with fp32 parameters (kernels K5-K7 and K9-K10, bf16 K1/K2/K8).
``--parallel`` and ``--init_method`` are accepted and ignored (one device).
"""

from __future__ import annotations

import argparse
import os

import torch

from tramba_tpu_torch.train.loop import training

# per-method pretrained encoder checkpoints (run.py:11-19): only Tramba-V is ported
_PRETRAINED = {"V": "vssm_base_0229_ckpt_epoch_237.pth"}


def resolve_pretrained(args) -> None:
    """'auto' -> the method's released encoder checkpoint under
    --pretrained_model; a missing default file degrades to a loud warning
    (an explicit --pretrained_path that fails to load is fatal instead)."""
    if args.pretrained_path != "auto":
        return
    path = os.path.join(args.pretrained_model, _PRETRAINED[args.method.split("-")[1]])
    if os.path.exists(path):
        args.pretrained_path = path
    else:
        print(f"WARNING: default pretrained encoder {path} not found; "
              "training will start from a RANDOM encoder (pass --pretrained_path "
              "to point at the checkpoint)")
        args.pretrained_path = None
        args.allow_random_init = True


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--init_method", default="tcp://127.0.0.1:33115", type=str,
                   help="accepted for compatibility; ignored (one device)")
    p.add_argument("--parallel", action="store_true",
                   help="accepted for compatibility; ignored (one device)")
    p.add_argument("--data_root", default="./TSOD10K/", type=str, help="data path")
    p.add_argument("--train_dataset", default="", type=str)
    p.add_argument("--evaluation_root", default="./TSOD10K/", type=str)
    p.add_argument("--evaluation_dataset", default="", type=str)
    p.add_argument("--img_size", default=384, type=int)
    p.add_argument("--pretrained_model", default="./pretrained_model/", type=str)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--save_model", default="./results", type=str)
    p.add_argument("--tf_log_path", default="./tf-logs", type=str)
    p.add_argument("--pretrained_path", default="auto", type=str,
                   help="encoder checkpoint; 'auto' picks the method's released file")
    p.add_argument("--allow_random_init", action="store_true",
                   help="tolerate a failing pretrained-encoder load (default: fatal)")
    p.add_argument("--resume", default=None, type=str)
    p.add_argument("--see", default=40, type=int)
    p.add_argument("--train_epochs", default=80, type=int)
    p.add_argument("--decay_epochs", default="60", type=str)
    p.add_argument("--decay_factors", default="0.2", type=str)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--method", default=None, type=str)
    p.add_argument("--best_MAE", default=None, type=float)
    p.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                   help="compute dtype; parameters stay fp32")
    p.add_argument("--mu_dtype", default="bfloat16", type=str,
                   help="Adam first-moment storage dtype (float32 = reference-exact)")
    return p


def main(argv=None, device="cuda"):
    args = parser().parse_args(argv)
    if args.method is None:
        raise SystemExit("--method is required (e.g. Tramba-V-TSOD)")
    if args.parallel:
        print(f"note: --parallel and --init_method {args.init_method} are ignored; "
              "the port trains on one device")
    resolve_pretrained(args)

    print("\nArguments:")
    print("=" * 40)
    for arg in vars(args):
        print(f"{arg: <20}: {getattr(args, arg)}")
    print("=" * 40, flush=True)

    # fp32 at "highest", as run.py:93: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return training(args, device=device)


if __name__ == "__main__":
    main()
