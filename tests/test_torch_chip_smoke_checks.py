"""What ``chip_smoke.py`` checks on the card, read on the CPU without one.

Phase 3 walks ``chip_smoke.PHASE3``; ``chip_smoke.phase3_rows()`` gives,
from its shape tables alone, the (kernel, tag, shape) rows that walk adds,
and on the card the script fails unless the rows it checked are exactly
these.  Here: every kernel of the summary line (``SOURCES``) keeps its
shown shape (``SHOWN``) in each dtype tag it had when the measurements left
the script, no row is checked twice, and the measurements that left
phases 8 and 10 run from named ``chip_ab.py`` modes.
"""

import collections

import pytest
import torch

import chip_ab
import chip_smoke

# (kernel, tag) of every entry of the kernels line
TAGS = {"ss2d_scan": ("fp32", "bf16", "fp32 train", "bf16 train"),
        "ss2d_merge": ("fp32", "bf16", "fp32 train", "bf16 train"),
        "ss2d_scan_bwd": ("fp32 train", "bf16 train"),
        "expand_ln": ("fp32", "bf16"), "final_head": ("fp32", "bf16"),
        "prologue": ("bf16",), "ln_mlp": ("bf16",), "ln_dwms_mlp": ("bf16",),
        "ln_mlp_bwd": ("bf16 train",), "ln_dwms_mlp_bwd": ("bf16 train",),
        "ln_dwmlp": ("bf16",), "sra": ("bf16",), "window_attn": ("bf16",),
        "linear_scan": ("fp32",)}
ENTRIES = [(name, tag) for name, tags in TAGS.items() for tag in tags]


@pytest.fixture(scope="module")
def rows():
    return chip_smoke.phase3_rows()


def test_every_kernel_has_a_source_and_a_shown_shape():
    assert set(chip_smoke.SOURCES) == set(chip_smoke.SHOWN) == set(TAGS)
    assert {w.__name__ for w in chip_smoke.wrappers()} == set(TAGS)


@pytest.mark.parametrize("name,tag", ENTRIES)
def test_phase3_keeps_each_entry_at_its_shown_shape(rows, name, tag):
    """The summary line reports each (kernel, tag) at the first row whose
    label starts with ``SHOWN[name]``: phase 3 must check one."""
    assert any(n == name and t == tag and label.startswith(chip_smoke.SHOWN[name])
               for n, t, label in rows)


def test_phase3_entries_are_the_kernels_line(rows):
    assert {(n, t) for n, t, _ in rows} == set(ENTRIES)


def test_phase3_checks_no_row_twice(rows):
    twice = [row for row, n in collections.Counter(rows).items() if n > 1]
    assert not twice and len(rows) == 468


def test_phase3_rows_follow_the_shape_tables(rows):
    """Every SS2D shape of Tramba-V, -P and -R runs K1 / K2 in both dtypes
    and K1 / K2 / K8's train variants in both; every FFN shape K9 or K10;
    every K14 shape forward and reversed."""
    have = set(rows)
    for shapes in (chip_smoke.SS2D_SHAPES, chip_smoke.SS2D_SHAPES_P, chip_smoke.SS2D_SHAPES_R):
        for dt in ("fp32", "bf16"):
            for kind, H, d_model, param in shapes:
                label = chip_smoke.ss2d_label(kind, H, d_model, param, 2)
                assert {("ss2d_scan", dt, label), ("ss2d_merge", dt, label),
                        ("ss2d_scan", f"{dt} train", label), ("ss2d_merge", f"{dt} train", label),
                        ("ss2d_scan_bwd", f"{dt} train", label)} <= have
    for shapes in (chip_smoke.MLP_BWD_SHAPES, chip_smoke.MLP_BWD_SHAPES_P,
                   chip_smoke.MLP_BWD_SHAPES_R):
        for H, d, dwms in shapes:
            name = "ln_dwms_mlp_bwd" if dwms else "ln_mlp_bwd"
            assert (name, "bf16 train", f"{H}px B2 d{d} hid{4 * d}") in have
    for label, R, L, C in (*chip_smoke.LINEAR_SCAN_SHAPES, chip_smoke.LINEAR_SCAN_RAGGED):
        for d in ("fwd", "rev"):
            assert ("linear_scan", "fp32", f"{label} B4 {d} ({R}, {L}, {C})") in have


def test_ss2d_label_is_ss2d_case_label():
    """The planned label of an SS2D shape is the one ``ss2d_case`` prints."""
    gen = torch.Generator().manual_seed(0)
    for kind, H, d_model, param in (("line", 12, 32, 0), ("window", 12, 16, 4)):
        label = chip_smoke.ss2d_case("cpu", gen, torch.float32, kind, H, d_model, param, 2)[-1]
        assert label == chip_smoke.ss2d_label(kind, H, d_model, param, 2)


@pytest.mark.parametrize("flag,called", [("--train-times", "cs.run_training("),
                                         ("--parallel-times", "cs.run_parallel(")])
def test_moved_measurements_have_chip_ab_modes(flag, called, capsys):
    """Phase 8's timing and profiles of the models other than Tramba-V, and
    phase 10's, run from these modes of ``chip_ab.py``, through the same
    functions with their measurements on (the default)."""
    code = chip_ab.MODES[flag][0]
    compile(code, flag, "exec")
    assert called in code and "measure" not in code
    with pytest.raises(SystemExit):
        chip_ab.main([flag, "--help"])
    assert flag in capsys.readouterr().out


def test_measurements_are_on_by_default_and_off_in_the_script():
    import inspect

    for fn in (chip_smoke.run_training, chip_smoke.run_parallel):
        assert inspect.signature(fn).parameters["measure"].default is True
    assert chip_smoke.TRAIN_TIMED == ("Tramba-V-TSOD",)
    assert set(chip_smoke.TRAIN_TIMED) < set(chip_smoke.TRAINED)
