"""TSOD saliency-map dump on the card: ``python -m tramba_tpu_torch.dump``.

Port of ``test_TSOD.py``, with its flags.  Builds the model on CUDA in fp32
with TF32 off (matmuls and cuDNN convolutions both), or with
``--dtype bfloat16`` in bf16 (the forward ``bench.py`` times), loads each
reference ``.pth`` given with ``--ckpt`` (strict; parameters stay fp32 in
both dtypes), writes one uint8 PNG per test image of ``<data_root>/Test`` to
``<save_root>/<method>/TSOD`` at the image's original size, and with
``--measure_fps`` runs the 200-iteration FPS loop.  Without ``--ckpt`` the
weights are drawn from seed 0.  Requires CUDA.
"""

from __future__ import annotations

import argparse
import os

import torch

from tramba_tpu_torch.eval.dump import dump_saliency_maps
from tramba_tpu_torch.models.registry import build
from tramba_tpu_torch.train.checkpoint import load_checkpoint
from tramba_tpu_torch.utils.profiling import measure_inference_speed


def card_device(entry: str) -> torch.device:
    """The CUDA device for the entry point ``entry``, with TF32 off in
    matmuls and cuDNN convolutions (fp32 at "highest", as test_TSOD.py:15);
    raises where there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{entry} runs on a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def load_model(method: str, img_size: int, device, ckpt=None, dtype: str = "float32"):
    """``method`` in eval mode on ``device`` computing in ``dtype``, with the
    reference ``.pth`` ``ckpt`` loaded (strict), or seed-0 weights without
    one."""
    print(ckpt or "no checkpoint: random weights from seed 0", flush=True)
    model = build(method, img_size, device=device, seed=None if ckpt else 0,
                  dtype=getattr(torch, dtype))
    if ckpt:
        load_checkpoint(model, ckpt)
    return model.to(device).eval()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--img_size", default=384, type=int)
    parser.add_argument("--method", default="Tramba-V-TSOD", type=str)
    parser.add_argument("--data_root", default="./TSOD10K/", type=str)
    parser.add_argument("--ckpt", nargs="*", default=[], help="reference .pth checkpoint(s)")
    parser.add_argument("--save_root", default="./results", type=str)
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--measure_fps", action="store_true",
                        help="run the 200-iteration FPS loop (test_TSOD.py:71-108)")
    parser.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                        help="compute dtype (bfloat16: kernels K5-K7 and bf16 K1-K4)")
    args = parser.parse_args(argv)

    device = card_device("tramba_tpu_torch.dump")
    for ckpt in args.ckpt or [None]:
        model = load_model(args.method, args.img_size, device, ckpt, args.dtype)
        save_path = os.path.join(args.save_root, args.method, "TSOD")
        n = dump_saliency_maps(model, args.data_root, save_path, img_size=args.img_size,
                               batch_size=args.batch_size, device=device)
        print(f"wrote {n} maps to {save_path}", flush=True)
        if args.measure_fps:
            x = torch.zeros(1, args.img_size, args.img_size, 3, device=device)
            measure_inference_speed(lambda a: model(a)[-1], (x,), batch=1)


if __name__ == "__main__":
    main()
