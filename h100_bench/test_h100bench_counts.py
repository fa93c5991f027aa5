"""The yardstick's arithmetic against the numbers the repository's kernel
table holds, and the model FLOPs of a step."""

import pytest

from h100_bench import counts, harness

CONFIG = harness.load_json(harness.HERE / "configs" / "iisan-base.json")


def test_attention_bounds():
    # PERF.md's bounds of #5 at the IISAN step's ViT shape and #6 at FFT's
    assert counts.mha_bound(704, 197, 768, 12, False, False) == pytest.approx(
        (0.2544e0, "bytes"), rel=1e-3)
    assert counts.mha_bound(352, 197, 768, 12, False, True) == pytest.approx(
        (0.2226e0, "bytes"), rel=1e-3)


def test_tower_flops_per_item():
    vit = counts.tower_forward_flops(CONFIG["image_tower"], 1)
    bert = counts.tower_forward_flops(CONFIG["text_tower"], 1)
    assert vit / 1e9 == pytest.approx(35.13, rel=1e-3)
    assert bert / 1e9 == pytest.approx(5.129, rel=1e-3)


def test_step_flops():
    fft = dict(CONFIG, method="fft")
    iisan = counts.train_step_flops(CONFIG, 64)
    full = counts.train_step_flops(fft, 32)
    assert iisan / 1e12 == pytest.approx(28.4, rel=5e-3)
    assert full / 1e12 == pytest.approx(42.6, rel=5e-3)
    # frozen towers count once, trained ones three times
    towers = 352 * (counts.tower_forward_flops(CONFIG["image_tower"], 1)
                    + counts.tower_forward_flops(CONFIG["text_tower"], 1))
    assert full > 3 * towers and full - 3 * towers < 0.01 * full


def test_dense_bound_trained_is_three_passes():
    f1, ms1 = counts.tower_dense(CONFIG["image_tower"], 32, False)
    f3, ms3 = counts.tower_dense(CONFIG["image_tower"], 32, True)
    assert f3 == 3 * f1 and ms3 == pytest.approx(3 * ms1, rel=0.05)
