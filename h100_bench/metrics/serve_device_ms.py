"""Device-busy ms a ``Recommender.top_k`` call: the union of the device's
operations in the traced window over the calls traced."""

LAYER = "serving: serve.py Recommender.top_k"
MOVES = "serve_users_per_s"


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "serve" or tr is None or tr.busy_s <= 0:
        return None
    return 1e3 * tr.busy_s / tr.steps
