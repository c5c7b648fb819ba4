"""Per-dataset SOD saliency-map dump on the card: ``python -m tramba_tpu_torch.dump_sod``.

Port of ``test_SOD.py``, with its flags and ``--dtype`` as the TSOD dump has
it.  ``--datasets name=root ...``: each root holds ``Test/image`` and
``Test/mask`` (a bare name is its own root).  Every dataset's maps go to the
one folder ``<image_save_path>/<method>/SOD`` (test_SOD.py:28), where
``python -m tramba_tpu_torch.evaluate_sod`` reads them back, at each
image's original size.  ``--resume`` is a reference ``.pth`` (strict);
without it the weights are drawn from seed 0.  Builds the model on CUDA in
fp32 with TF32 off, or in bf16 with ``--dtype bfloat16``.  Requires CUDA.

    python -m tramba_tpu_torch.dump_sod --method BaseUMamba-SOD \
        --resume BaseUMamba.pth --datasets DUTS-TE=./DUTS ECSSD=./ECSSD
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Mapping

import torch

from tramba_tpu_torch.dump import card_device, load_model
from tramba_tpu_torch.eval.dump import dump_saliency_maps

__all__ = ["main", "parse_datasets", "dump_datasets"]


def parse_datasets(specs) -> Dict[str, str]:
    """``name=root`` specs -> {name: root}; a spec without ``=`` names its
    own root."""
    datasets = {}
    for spec in specs:
        name, _, root = spec.partition("=")
        datasets[name] = root or name
    return datasets


def dump_datasets(model: torch.nn.Module, datasets: Mapping[str, str], image_save_path: str,
                  method: str, img_size: int = 384, batch_size: int = 8,
                  device=None) -> Dict[str, int]:
    """Dumps the test split of every dataset to
    ``<image_save_path>/<method>/SOD``; returns the maps written per dataset."""
    save_path = os.path.join(image_save_path, method, "SOD")
    written = {}
    for name, root in datasets.items():
        print(name, flush=True)
        written[name] = dump_saliency_maps(model, root, save_path, img_size=img_size,
                                           batch_size=batch_size, device=device)
        print(f"wrote {written[name]} maps to {save_path}", flush=True)
    return written


def main(argv=None) -> Dict[str, int]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--method", default="Tramba-V-SOD", type=str)
    parser.add_argument("--resume", default="", type=str, help="reference .pth checkpoint")
    parser.add_argument("--image_save_path", default="./results", type=str)
    parser.add_argument("--img_size", default=384, type=int)
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--datasets", nargs="+", default=["SOD=./DUTS"],
                        help="name=root pairs; each root holds Test/image + Test/mask")
    parser.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                        help="compute dtype (bfloat16: kernels K5-K7 and bf16 K1-K4)")
    args = parser.parse_args(argv)

    device = card_device("tramba_tpu_torch.dump_sod")
    model = load_model(args.method, args.img_size, device, args.resume or None, args.dtype)
    return dump_datasets(model, parse_datasets(args.datasets), args.image_save_path,
                         args.method, args.img_size, args.batch_size, device)


if __name__ == "__main__":
    main()
