"""Offline TSOD scoring of dumped maps: ``python -m tramba_tpu_torch.evaluate_tsod``.

Port of ``Evaluation/evaluate_TSOD.py``, with its flags: for each model of
``--models`` and each dataset of ``--test_datasets`` it scores the maps of
``<dataset_path>/<model>/<dataset>`` against the masks of ``--gt_root``,
prints the results row and the weighted F-measure and FNR, and writes the PR
curves to ``<dataset_path>/<model>/precision.npy`` and ``recall.npy``;
the models in parallel processes.  numpy only: it runs on any machine.

    python -m tramba_tpu_torch.evaluate_tsod --dataset_path ./results \
        --gt_root ./TSOD10K/Test/mask/ --models Tramba-V-TSOD
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os

from tramba_tpu_torch.eval.dump import evaluate_maps, format_results_row

__all__ = ["main", "evaluate_model", "run_models"]


def evaluate_model(args, model):
    results_list = []
    for dataset in args.test_datasets:
        salmap_root = os.path.join(args.dataset_path, model, dataset)
        print(salmap_root, flush=True)
        r = evaluate_maps(salmap_root, args.gt_root,
                          save_pr_dir=os.path.join(args.dataset_path, model))
        print(format_results_row(model, dataset, r), flush=True)
        print(f"Wmeasure_r: {round(r['wFmeasure'], 4)}  fnr_r: {round(r['fnr'], 4)}", flush=True)
        results_list.append({"model": model, "dataset": dataset, **r})
    return results_list


def run_models(args, evaluate) -> list:
    """``evaluate(args, model)`` for every model of ``args.models``, at most
    ``args.workers`` processes at once; their result lists in turn."""
    workers = max(1, min(args.workers, len(args.models)))
    with concurrent.futures.ProcessPoolExecutor(max_workers=workers) as ex:
        futures = [ex.submit(evaluate, args, m) for m in args.models]
        return [r for f in concurrent.futures.as_completed(futures) for r in f.result()]


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset_path", default="./results", type=str)
    parser.add_argument("--gt_root", default="./TSOD10K/Test/mask/", type=str)
    parser.add_argument("--models", nargs="+", default=["Tramba-V-TSOD"])
    parser.add_argument("--test_datasets", nargs="+", default=["TSOD"])
    parser.add_argument("--workers", default=24, type=int)
    return run_models(parser.parse_args(argv), evaluate_model)


if __name__ == "__main__":
    main()
