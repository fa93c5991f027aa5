"""Model FLOP utilisation of a training step: the step's model FLOPs,
counted from the configuration's shapes (``counts.train_step_flops``),
over the window's time a step and one H100's bf16 dense peak."""

from h100_bench import counts

LAYER = "step: train/uncached.py UncachedTrainer.train_step"
MOVES = "train_users_per_s"


def read(ctx):
    if ctx["kind"] != "train":
        return None
    flops = counts.train_step_flops(ctx["config"], ctx["users"])
    return 100.0 * flops / (ctx["step_s"] * counts.PEAK_BF16_FLOPS)
