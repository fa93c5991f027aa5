"""The tower attention forward (#5) against its bound: the sum over a
step's launches of ``counts.mha_bound`` (q, k, v read and o
written once in bf16, the title mask's key bias read once; the
forward's two products; bytes at 3.35 TB/s or operations at
989 TFLOP/s, whichever binds: bytes at these shapes), over the device
time of the kernels named ``mha_fwd``.  H100 SXM at its 700 W limit."""

from h100_bench import counts

LAYER = "tower attention: ops/fused_attention.py"
MOVES = "train_users_per_s"


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "train" or tr is None:
        return None
    kernel_s = tr.seconds_where(lambda n: "mha_fwd" in n) / tr.steps
    if kernel_s <= 0:
        return None
    c = ctx["config"]
    items = ctx["users"] * (c["max_seq_len"] + 1)
    ms = 0.0
    for key, bias in (("text_tower", True), ("image_tower", False)):
        tower = c[key]
        ms += tower["num_hidden_layers"] * counts.mha_bound(
            items, counts.tower_tokens(tower), tower["hidden_size"],
            tower["num_attention_heads"], bias, False)[0]
    return 100.0 * ms * 1e-3 / kernel_s
