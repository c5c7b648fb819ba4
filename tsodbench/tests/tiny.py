"""Tiny configurations and cells for the CPU tests: the published layer
kinds at small widths and depths, the program on its plain versions."""

import time

import torch

from tsodbench import harness

V = dict(encoder="vssm", decoder="tramba", img_size=96, dims=16, enc_depths=[1, 1, 2, 1],
         dec_depths=[1, 1, 1, 1], enc_drop_path=0.6, dec_drop_path=0.2)
S = dict(encoder="swin", decoder="tramba", img_size=96, dims=16, enc_depths=[2, 2, 2, 2],
         num_heads=[2, 2, 4, 4], window=6, dec_depths=[1, 1, 1, 1], enc_drop_path=0.1,
         dec_drop_path=0.2)
# the program's method and build overrides of each tiny model, as a
# configuration file gives them
PROGRAM = {
    "vssm": ("Tramba-V-TSOD", dict(dims=16, enc_depths=[1, 1, 2, 1], dec_depths=[1, 1, 1, 1],
                                   enc_drop_path=0.6, dec_drop_path=0.2)),
    "swin": ("Tramba-S-TSOD", dict(enc_config=dict(embed_dim=16, depths=[2, 2, 2, 2],
                                                   num_heads=[2, 2, 4, 4], window=6,
                                                   drop_path_rate=0.1),
                                   dec_depths=[1, 1, 1, 1], dec_drop_path=0.2)),
}
DUMP = dict(driver="dump", batch=4, pool=3, warmup=1, check_batches=2, ref_rows=2)
TRAIN = dict(driver="train", batch=4, pool=4, check_steps=3, warmup_steps=1, lr=1e-4,
             encoder_lr_scale=0.1, mu_dtype="bfloat16", decay_epochs=[60], decay_factors=[0.2],
             steps_per_epoch=100, ref_rows=2)


def cell(model: dict, traffic: dict, limits_of: str, dtype: str = "bfloat16") -> harness.Cell:
    """A tiny cell held to the limits of the benchmark's cell ``limits_of``."""
    limits = harness.resolve(limits_of).limits
    method, build = PROGRAM[model["encoder"]]
    cfg = {"method": method, "dtype": dtype, "model": model, "build": build}
    return harness.Cell("tiny", 1, cfg, traffic, limits, [], [])


def run(c: harness.Cell, seed: int = 5):
    return harness.driver(c.traffic["driver"]).run(c, seed, 0.2, False, torch.device("cpu"),
                                                   time.perf_counter())
