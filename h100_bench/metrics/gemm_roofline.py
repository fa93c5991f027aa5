"""The towers' dense products against the GEMM kernels' time: the bound
of every tower dense layer at the step's shapes (forward, and both
gradients where the towers train; bf16 operands read and results written
once, at 989 TFLOP/s or 3.35 TB/s, whichever binds), over the device time
of the kernels ``trace.family`` calls "gemm", a step.  H100 SXM at its
700 W limit."""

from h100_bench import counts
from h100_bench import trace as tracing

LAYER = "tower dense layers: TorchLinear / cuBLAS"
MOVES = "train_users_per_s"


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "train" or tr is None:
        return None
    gemm_s = tr.seconds_where(lambda n: tracing.family(n) == "gemm") / tr.steps
    if gemm_s <= 0:
        return None
    c = ctx["config"]
    items = ctx["users"] * (c["max_seq_len"] + 1)
    trained = c["method"] != "iisan"
    ms = sum(counts.tower_dense(c[t], items, trained)[1]
             for t in ("text_tower", "image_tower"))
    return 100.0 * ms * 1e-3 / gemm_s
