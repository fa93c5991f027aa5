"""Device ms a step in operations that are neither matrix products
(cuBLAS and the port's GEMM kernels) nor the port's own kernels nor Adam
(``trace.family`` "other"): the towers' elementwise work, casts, norms
and gathers, named by patterns in ``trace.py``."""

from h100_bench import trace as tracing

LAYER = "towers: models/bert.py, vit.py, towers.py, modules.py"
MOVES = "train_users_per_s"


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "train" or tr is None or tr.busy_s <= 0:
        return None
    return 1e3 * tr.seconds_where(lambda n: tracing.family(n) == "other") / tr.steps
