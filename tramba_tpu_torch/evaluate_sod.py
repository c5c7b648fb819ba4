"""Offline SOD scoring of dumped maps: ``python -m tramba_tpu_torch.evaluate_sod``.

Port of ``Evaluation/evaluate_SOD.py``, with its flags: for each model of
``--models`` and each ``name=gt_root`` of ``--test_datasets`` (a bare name
takes ``--gt_root``) it scores the maps of ``<dataset_path>/<model>/SOD``,
the one folder every dataset's maps share (``tramba_tpu_torch.dump_sod``),
against that dataset's masks: only the maps whose file name is among the
masks count.  It prints the results row and writes the PR curves to
``<dataset_path>/<model>/precision.npy`` and ``recall.npy``; the models in
parallel processes.  numpy only: it runs on any machine.

    python -m tramba_tpu_torch.evaluate_sod --dataset_path ./results \
        --models BaseUMamba-SOD --test_datasets DUTS-TE=./DUTS/Test/mask
"""

from __future__ import annotations

import argparse
import os

from tramba_tpu_torch.eval.dump import evaluate_maps, format_results_row
from tramba_tpu_torch.evaluate_tsod import run_models

__all__ = ["main", "evaluate_model"]


def evaluate_model(args, model):
    results_list = []
    for spec in args.test_datasets:
        dataset, _, gt_root = spec.partition("=")
        salmap_root = os.path.join(args.dataset_path, model, "SOD")
        r = evaluate_maps(salmap_root, gt_root or args.gt_root,
                          save_pr_dir=os.path.join(args.dataset_path, model))
        print(format_results_row(model, dataset, r), flush=True)
        results_list.append({"model": model, "dataset": dataset, **r})
    return results_list


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset_path", default="./results", type=str)
    parser.add_argument("--gt_root", default="./DUTS/Test/mask/", type=str)
    parser.add_argument("--models", nargs="+", default=["Tramba-V-SOD"])
    parser.add_argument("--test_datasets", nargs="+", default=["DUTS-TE=./DUTS/Test/mask"])
    parser.add_argument("--workers", default=24, type=int)
    return run_models(parser.parse_args(argv), evaluate_model)


if __name__ == "__main__":
    main()
