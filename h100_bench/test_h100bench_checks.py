"""The check that decides ``correct``: planted faults make it false, each
control differs from the program where the check can see it, and on the
card every cell is correct and every control is not, at the cell's size
and limits.

On the CPU the cells run tiny (``tiny``), the program in float32 so its
sound readings are rounding alone, against the cells' own limits.
"""

import pytest
import torch

from h100_bench import calibrate, faults, harness
from h100_bench.test_h100bench_reference import tiny

WORKLOADS = ["iisan-base.uncached-train", "fft-base.train-b32",
             "iisan-base.serve-topk-4m"]
CONTROLS = [(w, c["name"]) for w in WORKLOADS for c in calibrate.controls(w)]


def _control(workload, name):
    return next(c for c in calibrate.controls(workload) if c["name"] == name)


def _planted(workload):
    _, _, _, traffic, _ = harness.cell_files(workload)
    if traffic["runner"] == "train":
        return {name: {"step": f} for name, f in faults.TRAIN.items()}
    calls = faults.serve_calls(traffic["k"], traffic["history_max"])
    return {name: {"call": f} for name, f in calls.items()}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_planted_faults_are_not_correct(workload):
    """A whole run with the timed path broken underneath: the step that
    leaves the state unchanged, half of the batch left out, an answer
    altered where it is produced; each makes ``correct`` false, and the
    same run unbroken is correct."""
    over = tiny(workload)
    sound = harness.run_cell(workload, 2 ** 32 + 9, 0.3, False, device="cpu",
                             overrides=over)
    assert sound["correct"], sound["check"]
    for name, hooks in _planted(workload).items():
        line = harness.run_cell(workload, 2 ** 32 + 9, 0.3, False, device="cpu",
                                overrides=over, hooks=hooks)
        assert not line["correct"], (name, line["check"])


@pytest.mark.parametrize("workload,control", CONTROLS)
def test_control_reads_above_the_program(workload, control):
    """Each control (the program's lower-precision path, on both towers or
    the image tower alone, or the reference in a lower precision in its
    place) reads at least three times the program on one compared number,
    at a size a test run holds."""
    seed, over = 2 ** 31 + 3, tiny(workload)
    line = harness.run_cell(workload, seed, 0.2, False, device="cpu", overrides=over)
    sound = {k: v[0] for k, v in line["check"].items()}
    got = calibrate.control_check(workload, _control(workload, control), seed, 0.2,
                                  device="cpu", overrides=over)
    assert any(got[k] >= 3 * sound[k] and got[k] > 0 for k in sound), (sound, got)


def test_int8_image_tower_leaves_the_text_tower():
    """The image-tower control moves the image tower's products alone."""
    workload = "iisan-base.uncached-train"
    seen = {}

    def keep(tr, weights):
        calibrate.int8_image_tower(tr, weights)
        seen["kinds"] = {n: type(m).__name__ for n, m in tr.model.named_modules()
                         if n.startswith(("image_tower.vit.", "text_tower.bert."))
                         and n.endswith(".intermediate")}

    line = harness.run_cell(workload, 2 ** 31 + 19, 0.2, False, device="cpu",
                            overrides=tiny(workload), hooks={"program": keep})
    assert {k for n, k in seen["kinds"].items() if n.startswith("image")} == {"Int8Dense"}
    assert {k for n, k in seen["kinds"].items() if n.startswith("text")} == {"TorchLinear"}
    assert line["check"]["frozen_change"][0] == 0.0
    assert not line["correct"] and line["check"]["dense_gap"][0] > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("workload,control", CONTROLS)
def test_control_is_not_correct_on_the_card(workload, control):
    """Each control, at the cell's own size, through the cell's own limits
    (``harness.check_line``), comes out as not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _, _, _, _, limits = harness.cell_files(workload)
    got = calibrate.control_check(workload, _control(workload, control), 2 ** 31 + 91, 2.0)
    check = harness.check_line(got, limits)
    assert not all(c["ok"] for c in check.values()), check


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_is_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    line = harness.run_cell(workload, 2 ** 31 + 77, 2.0, False)
    assert line["correct"], line["check"]
