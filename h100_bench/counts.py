"""Operations and bytes of the measured work, counted from shapes.

The yardstick of the roofline and MFU metrics.  Nothing here reads what a
kernel reports about itself, so a count stays the same whatever
implements the work.  A count is the products of the function computed,
two operations a multiply-add.

- ``mha``, ``encoder``: the arithmetic of the port's ``utils/flops.py``
  (tower attention; the SASRec user encoder), copied so that the program
  cannot move the yardstick.
- ``bound``, ``mha_bound``: the least time one H100 could take, the larger
  of bytes over the HBM rate and operations over the peak, as the bounds
  of the repository's chip smoke test take them: every input read once,
  every output written once.
- ``tower_dense``, ``train_step_flops``: the dense products of the BERT
  and ViT towers and the model FLOPs of one training step.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (data sheet, dense): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def mha(B: int, T: int, D: int, H: int, bwd: bool = False) -> int:
    """Attention over B sequences of T tokens, width D, H heads: the
    forward's two products (Q K^T, P V), the backward's five."""
    return (10 if bwd else 4) * B * H * T * T * (D // H)


def encoder(B: int, L: int, D: int, F: int, n_layers: int,
            bwd: bool = False) -> int:
    """The SASRec user encoder's forward over B sequences of L items, width
    D, FFN width F: per block four projections, two attention products and
    the FFN; the backward is three times the forward."""
    fwd = B * n_layers * (8 * L * D * D + 4 * L * L * D + 4 * L * D * F)
    return 3 * fwd if bwd else fwd


def bound(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS):
    """(ms, "bytes" or "operations"): the least time to move ``nbytes``
    through HBM and do ``flops`` operations at ``peak``."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mha_bound(B: int, T: int, D: int, H: int, bias: bool, bwd: bool,
              itemsize: int = 2):
    """The attention kernels' bound at one shape: q, k, v (and g) read and
    o (or gq, gk, gv) written once, the key bias read once; the forward's
    two products or the backward's five."""
    tensors = 7 if bwd else 4
    nbytes = tensors * B * T * D * itemsize + (B * T * 4 if bias else 0)
    return bound(nbytes, mha(B, T, D, H, bwd))


def dense(M: int, K: int, N: int, itemsize: int = 2):
    """(flops, bytes) of an (M, K) x (K, N) product: both operands read
    and the result written once."""
    return 2 * M * K * N, (M * K + K * N + M * N) * itemsize


def tower_tokens(tower: dict) -> int:
    """Tokens a sequence holds: a title's words, or an image's patches and
    its CLS token."""
    if "patch_size" in tower:
        return (tower["image_size"] // tower["patch_size"]) ** 2 + 1
    return tower["title_tokens"]


def tower_layers(tower: dict):
    """(rows a sequence, K, N) of each dense layer of one tower: per layer
    q, k, v, the attention output, the intermediate and the output layer;
    a ViT's patch projection, over its patches, first."""
    D, F, T = tower["hidden_size"], tower["intermediate_size"], tower_tokens(tower)
    per_layer = [(T, D, D)] * 4 + [(T, D, F), (T, F, D)]
    layers = per_layer * tower["num_hidden_layers"]
    if "patch_size" in tower:
        layers = [(T - 1, tower["patch_size"] ** 2 * 3, D)] + layers
    return layers


def tower_dense(tower: dict, items: int, trained: bool):
    """(flops, bound ms) of the tower's dense products over ``items``
    sequences: the forward, and with ``trained`` both gradients of each
    product as well (dX = dY W^T, dW = X^T dY)."""
    flops, ms = 0, 0.0
    for rows, K, N in tower_layers(tower):
        M = items * rows
        passes = [dense(M, K, N)]
        if trained:
            passes += [dense(M, N, K), dense(K, M, N)]
        for f, b in passes:
            flops += f
            ms += bound(b, f)[0]
    return flops, ms


def tower_attention_flops(tower: dict, items: int) -> int:
    T = tower_tokens(tower)
    return mha(items, T, tower["hidden_size"], tower["num_attention_heads"]) \
        * tower["num_hidden_layers"]


def tower_forward_flops(tower: dict, items: int) -> int:
    return tower_dense(tower, items, False)[0] + tower_attention_flops(tower, items)


def san_forward_flops(cfg: dict, items: int) -> int:
    """The side adapter network: three cascades of K down and up
    projections, the six heads and the fusion layer."""
    san, D, E = cfg["san"], cfg["text_tower"]["hidden_size"], cfg["embedding_dim"]
    K, R = len(san["taps"]), san["down_size"]
    cascades = 3 * K * 2 * (2 * D * R)
    heads = 3 * 2 * D * D + 3 * 2 * D * E
    return items * (cascades + heads + 2 * 3 * E * E)


def head_forward_flops(cfg: dict, items: int) -> int:
    """The full fine-tuning heads: each tower's CLS to the embedding width,
    and the fusion layer over both."""
    D, E = cfg["text_tower"]["hidden_size"], cfg["embedding_dim"]
    return items * (2 * 2 * D * E + 2 * 2 * E * E)


def train_step_flops(cfg: dict, users: int) -> int:
    """Model FLOPs of one training step of ``users`` sequences of L+1
    items: frozen towers count their forward once, trained ones three
    times; the side network or the heads, the user encoder and the
    in-batch loss count forward and backward.  Nothing recomputed
    counts."""
    L, E = cfg["max_seq_len"], cfg["embedding_dim"]
    items = users * (L + 1)
    towers = (tower_forward_flops(cfg["text_tower"], items)
              + tower_forward_flops(cfg["image_tower"], items))
    if cfg["method"] == "iisan":
        rest = san_forward_flops(cfg, items)
        towers_factor = 1
    else:
        rest = head_forward_flops(cfg, items)
        towers_factor = 3
    ue = cfg["user_encoder"]
    rest += encoder(users, L, E, 4 * E, ue["blocks"])
    rest += 2 * users * L * items * E  # the in-batch logits
    return towers_factor * towers + 3 * rest
