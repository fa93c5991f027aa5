"""Share of the traced window in which no operation ran on the device
(profiler trace, a few calls after the window)."""

LAYER = "device"
MOVES = "serve_users_per_s"


def read(ctx):
    trace = ctx["trace"]
    if ctx["kind"] != "serve" or trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
