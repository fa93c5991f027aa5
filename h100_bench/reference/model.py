"""The plain reference of the measured models, in float32 PyTorch.

It follows the published architectures as the configuration files state
them, with no kernel, cache or batching of the program's:

- BERT (post-LN; exact GELU; additive -1e9 key bias from the title mask)
  and ViT-B/16 (pre-LN; patches flattened channels-last (p, p, 3) and
  projected; final LayerNorm), each returning its hidden stack's CLS rows,
  embeddings first;
- IISAN's side adapter network: three cascades of bottleneck adapters
  over the towers' CLS taps (text and image gated by sigmoid(theta / 0.1)
  against the carry, the inter branch over the gate-mixed taps), two
  linear heads each, and the fusion layer;
- SASRec (post-LN, causal, learned positions) and the popularity-debiased
  in-batch cross-entropy.

Train-mode dropout follows the program's documented draws, so both sides
drop the same elements: hidden dropout keeps where ``torch.rand`` from the
trainer's generator is at least the rate; attention and user-encoder
dropout are Philox bits (``philox.py``) under a seed drawn from that
generator.  ``Dropout`` makes the draws in the program's order.

Every product goes through ``Precision.mm``: float32 with TF32 off, or, for
the check's control, both operands rounded to a lower precision first.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .philox import keep_mask

GATE_TEMPERATURE = 0.1
E4M3_MAX = 448.0


class Precision:
    """``mm`` in float32, or for a control in a lower precision: operands
    rounded to TF32's 10-bit mantissa (``"tf32"``, as the tensor cores take
    them), to bfloat16 (``"bf16"``), or to float8 e4m3 (``"fp8"``: each
    operand scaled by its absolute maximum to the format's range, rounded
    and scaled back), the product summed in float32 and the gradient passed
    through unrounded."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "tf32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return x
        if self.kind == "tf32":  # the 13 low mantissa bits rounded away
            bits = x.detach().float().contiguous().view(torch.int32)
            q = ((bits + 0x1000) & -0x2000).view(torch.float32).view(x.shape)
            return x + (q - x.detach())
        if self.kind == "bf16":
            return x + (x.detach().to(torch.bfloat16).float() - x.detach())
        scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x + (q - x.detach())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)


class Dropout:
    """The trainer's dropout draws, made again from its seed on its
    device: ``hidden`` is ``torch.rand`` of the activation's shape,
    ``kernel_seed`` one ``torch.randint`` below 2^31 - 1, in the order the
    program draws them."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def hidden(self, shape, rate: float) -> torch.Tensor:
        u = torch.rand(shape, generator=self.gen, device=self.gen.device)
        return u >= rate

    def kernel_seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.gen,
                                 device=self.gen.device))


def drop(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float):
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def layer_norm(x, W, name: str, eps: float):
    return F.layer_norm(x, x.shape[-1:], W[name + ".scale"], W[name + ".bias"], eps)


def linear(x, W, name: str, prec: Precision, bias: bool = True,
           probe: Optional["Probe"] = None):
    y = prec.mm(x.reshape(-1, x.shape[-1]), W[name + ".kernel"])
    if bias:
        y = y + W[name + ".bias"]
    y = y.reshape(*x.shape[:-1], y.shape[-1])
    if probe is not None:
        probe.put(name, x, y)
    return y


PROBED = ("attention.query", "attention.key", "attention.value", "attention_output",
          "intermediate", "output")


def probe_names(cfg: dict) -> Dict[str, str]:
    """Where the check reads the towers' arithmetic, name -> "dense" or
    "attention": every dense product of each tower's first and last layer,
    and the image tower's attention cores there (softmax(q k^T / sqrt(dh))
    v of the layer's own q, k, v).  The text tower's cores drop
    probabilities and are left out."""
    out: Dict[str, str] = {}
    for prefix, key in (("text_tower.bert", "text_tower"), ("image_tower.vit", "image_tower")):
        for i in sorted({0, cfg[key]["num_hidden_layers"] - 1}):
            out.update({f"{prefix}.layer_{i}.{n}": "dense" for n in PROBED})
            if key == "image_tower":
                out[f"{prefix}.layer_{i}.attention"] = "attention"
    return out


class Probe:
    """The (input, output) of each product or attention core named in
    ``names``, the first that passes."""

    def __init__(self, names):
        self.names, self.seen = set(names), {}

    def put(self, name: str, x: torch.Tensor, y: torch.Tensor) -> None:
        if name in self.names:
            self.seen.setdefault(name, (x.detach(), y.detach()))


@contextmanager
def exact():
    """float32 products with TF32 off, as the reference computes them."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


@torch.no_grad()
def probed_again(W, cfg: dict, name: str, kind: str, seen: dict) -> torch.Tensor:
    """The reference's float32 result at a probe, from the inputs ``seen``
    gives it there: a dense product of the probe's own input, or an
    attention core of the q, k, v the layer's projections gave."""
    dev = W[next(iter(W))].device
    with exact():
        if kind == "dense":
            return linear(seen[name][0].float().to(dev), W, name, Precision())
        q, k, v = (seen[f"{name}.{n}"][1].float().to(dev) for n in ("query", "key", "value"))
        return attention(q, k, v, cfg["image_tower"]["num_attention_heads"], Precision())


def attention(q, k, v, H: int, prec: Precision, bias=None, keep=None,
              rate: float = 0.0):
    """(B, T, D) q, k, v -> (B, T, D): softmax(q k^T / sqrt(dh) + bias),
    probabilities dropped by ``keep`` (B, H, T, T), times v."""
    B, T, D = q.shape

    def split(t):
        return t.reshape(B, T, H, D // H).transpose(1, 2)

    s = prec.mm(split(q), split(k).transpose(-1, -2)) / math.sqrt(D // H)
    if bias is not None:
        s = s + bias
    p = drop(torch.softmax(s, dim=-1), keep, rate)
    return prec.mm(p, split(v)).transpose(1, 2).reshape(B, T, D)


def tower_masks(drops: Optional[Dropout], tower: dict, n: int, device):
    """The draws of one train-mode BERT call over n titles: the embedding
    output's mask, the attention seed, then each layer's two hidden masks;
    and each layer's attention masks (n, H, T, T), Philox at site
    ``layer * H + head``.  None in eval mode or at rate 0."""
    rate = tower["hidden_dropout_prob"]
    if drops is None or rate == 0.0:
        return None
    T, H = tower["title_tokens"], tower["num_attention_heads"]
    shape = (n, T, tower["hidden_size"])
    emb = drops.hidden(shape, rate)
    seed = drops.kernel_seed()
    layers = [(drops.hidden(shape, rate), drops.hidden(shape, rate))
              for _ in range(tower["num_hidden_layers"])]
    rows = torch.arange(n, device=device)
    attn = [keep_mask(seed, range(i * H, (i + 1) * H), rows, (T, T), rate)
            for i in range(tower["num_hidden_layers"])]
    return {"emb": emb, "layers": layers, "attn": attn}


def bert(W, prefix: str, ids, mask, tower: dict, prec: Precision,
         masks=None, rows: slice = slice(None), probe: Optional[Probe] = None):
    """(last hidden (B, T, D), CLS rows of the hidden stack): ``masks`` from
    ``tower_masks`` over the whole batch, of which these are ``rows``;
    ``probe`` records the dense products it names."""
    H, eps = tower["num_attention_heads"], tower["layer_norm_eps"]
    rate = tower["hidden_dropout_prob"]
    T = ids.shape[1]
    x = (W[prefix + ".word_embeddings.embedding"][ids.long()]
         + W[prefix + ".position_embeddings"][:T]
         + W[prefix + ".token_type_embeddings"][0])
    x = layer_norm(x, W, prefix + ".embeddings_layernorm", eps)
    x = drop(x, masks["emb"][rows] if masks else None, rate)
    key_bias = ((1.0 - mask.float()) * -1e9)[:, None, None, :]
    hidden = [x[:, 0]]
    for i in range(tower["num_hidden_layers"]):
        p = f"{prefix}.layer_{i}"
        q, k, v = (linear(x, W, f"{p}.attention.{n}", prec, probe=probe)
                   for n in ("query", "key", "value"))
        keep = masks["attn"][i][rows] if masks else None
        a = linear(attention(q, k, v, H, prec, key_bias, keep, rate), W,
                   f"{p}.attention_output", prec, probe=probe)
        a = drop(a, masks["layers"][i][0][rows] if masks else None, rate)
        x = layer_norm(x + a, W, f"{p}.attention_layernorm", eps)
        h = linear(F.gelu(linear(x, W, f"{p}.intermediate", prec, probe=probe)), W,
                   f"{p}.output", prec, probe=probe)
        h = drop(h, masks["layers"][i][1][rows] if masks else None, rate)
        x = layer_norm(x + h, W, f"{p}.output_layernorm", eps)
        hidden.append(x[:, 0])
    return x, hidden


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> [-1, 1]."""
    return images_u8.float() * (2.0 / 255.0) - 1.0


def vit(W, prefix: str, images, tower: dict, prec: Precision,
        probe: Optional[Probe] = None):
    """(final-LN last hidden (B, T, D), CLS rows of the hidden stack);
    images (B, S, S, 3) normalised.  The ViT's dropout rate is 0.
    ``probe`` records the dense products and attention cores it names."""
    if tower["hidden_dropout_prob"] or tower["attention_probs_dropout_prob"]:
        raise ValueError("the reference ViT runs without dropout")
    H, eps, P = tower["num_attention_heads"], tower["layer_norm_eps"], tower["patch_size"]
    B, S = images.shape[0], images.shape[1]
    n = S // P
    patches = images.reshape(B, n, P, n, P, 3).permute(0, 1, 3, 2, 4, 5)
    x = linear(patches.reshape(B, n * n, P * P * 3), W,
               prefix + ".patch_projection", prec)
    cls = W[prefix + ".cls_token"].expand(B, 1, x.shape[-1])
    x = torch.cat([cls, x], 1) + W[prefix + ".position_embeddings"]
    hidden = [x[:, 0]]
    for i in range(tower["num_hidden_layers"]):
        p = f"{prefix}.layer_{i}"
        h = layer_norm(x, W, f"{p}.layernorm_before", eps)
        q, k, v = (linear(h, W, f"{p}.attention.{n}", prec, probe=probe)
                   for n in ("query", "key", "value"))
        a = attention(q, k, v, H, prec)
        if probe is not None:
            probe.put(f"{p}.attention", h, a)
        x = x + linear(a, W, f"{p}.attention_output", prec, probe=probe)
        h = layer_norm(x, W, f"{p}.layernorm_after", eps)
        x = x + linear(F.gelu(linear(h, W, f"{p}.intermediate", prec, probe=probe)), W,
                       f"{p}.output", prec, probe=probe)
        hidden.append(x[:, 0])
    return layer_norm(x, W, prefix + ".final_layernorm", eps), hidden


def _act(z, activation: str):
    return F.gelu(z) if activation == "GELU" else torch.relu(z)


def cascade(W, branch: str, taps, coef_a, coef_b, activation: str,
            prec: Precision):
    """c <- up(act(down(f))) + f with f = a_i tap_i + b_i c, from c = 0."""
    p = f"san.{branch}"
    c = torch.zeros_like(taps[:, 0])
    for i in range(taps.shape[1]):
        f = coef_a[i] * taps[:, i] + coef_b[i] * c
        z = prec.mm(f, W[p + "_wd"][i]) + W[p + "_bd"][i]
        c = prec.mm(_act(z, activation), W[p + "_wu"][i]) + W[p + "_bu"][i] + f
    return c


def side_network(W, cv_taps, text_taps, san: dict, prec: Precision):
    """(emb_cv, emb_text, emb_mm) of (N, K, D) taps."""
    act = san["activation"]
    g_t = torch.sigmoid(W["san.side_gate_params_text"] / GATE_TEMPERATURE)
    g_c = torch.sigmoid(W["san.side_gate_params_cv"] / GATE_TEMPERATURE)
    g_m = torch.sigmoid(W["san.side_gate_params_mm"] / GATE_TEMPERATURE)
    ones = torch.ones_like(g_m)
    c_text = cascade(W, "bert_adapter_list", text_taps, g_t, 1.0 - g_t, act, prec)
    c_cv = cascade(W, "cv_adapter_list", cv_taps, g_c, 1.0 - g_c, act, prec)
    mm_taps = g_m[None, :, None] * cv_taps + (1.0 - g_m[None, :, None]) * text_taps
    c_mm = cascade(W, "mm_adapter_list", mm_taps, ones, ones, act, prec)

    def head(c, first, second):
        return linear(linear(c, W, f"san.{first}", prec), W, f"san.{second}", prec)

    return (head(c_cv, "fc_cv", "cv_pre_fc"), head(c_text, "fc_bert", "bert_pre_fc"),
            head(c_mm, "fc_mm", "fc_mm_down"))


def encoder_sites(n_layers: int, n_heads: int):
    """The user encoder's dropout sites after the input's (site 0), block
    by block: one per head's probabilities, the attention output, the FFN
    output."""
    per = n_heads + 2
    return [([1 + i * per + h for h in range(n_heads)], 1 + i * per + n_heads,
             2 + i * per + n_heads) for i in range(n_layers)]


def user_encoder(W, x, log_mask, ue: dict, prec: Precision,
                 seed: Optional[int] = None):
    """SASRec over (B, L, E) item embeddings: LN(x + positions), dropout,
    then post-LN blocks under a causal mask that also hides padded keys.
    ``seed`` (train mode) gives the Philox dropout masks."""
    p = "user_encoder.transformer_encoder"
    B, L, E = x.shape
    H, eps, rate = ue["heads"], ue["layer_norm_eps"], ue["dropout"]
    train = seed is not None and rate > 0.0
    seq = torch.arange(B, device=x.device)

    def keep(sites, shape):
        return keep_mask(seed, sites, seq, shape, rate) if train else None

    x = layer_norm(x + W[p + ".position_embedding"][:L], W, p + ".layer_norm", eps)
    x = drop(x, keep([0], (L, E))[:, 0] if train else None, rate)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    ok = causal[None] & (log_mask != 0)[:, None, :]
    bias = torch.where(ok, 0.0, -1e9)[:, None]
    for i, (probs, attn_out, ffn_out) in enumerate(encoder_sites(ue["blocks"], H)):
        b = f"{p}.transformer_blocks_{i}"
        q, k, v = (linear(x, W, f"{b}.multi_head_attention.{n}", prec, bias=False)
                   for n in ("w_Q", "w_K", "w_V"))
        o = linear(attention(q, k, v, H, prec, bias, keep(probs, (L, L)), rate), W,
                   f"{b}.multi_head_attention.fc", prec, bias=False)
        o = drop(o, keep([attn_out], (L, E))[:, 0] if train else None, rate)
        x = layer_norm(x + o, W, f"{b}.multi_head_attention.layer_norm", eps)
        h = linear(torch.relu(linear(x, W, f"{b}.feed_forward.w_1", prec)), W,
                   f"{b}.feed_forward.w_2", prec)
        h = drop(h, keep([ffn_out], (L, E))[:, 0] if train else None, rate)
        x = layer_norm(x + h, W, f"{b}.feed_forward.layer_norm", eps)
    return x


def inbatch_loss(prec_vec, item_embs, item_ids, log_mask, pop_prob, prec: Precision):
    """Cross-entropy of each valid position's next item against every item
    of the batch, scores less log popularity; an item of the user's own
    sequence other than the target, and padded columns, are excluded."""
    bs, L, E = prec_vec.shape
    n = item_ids.shape[0] * (L + 1)
    flat = item_ids.reshape(-1).long()
    logits = prec.mm(prec_vec.reshape(bs * L, E), item_embs.T)
    logits = logits - torch.log(pop_prob[flat])[None, :]
    ext = torch.cat([log_mask, torch.ones_like(log_mask[:, :1])], 1).reshape(-1)
    member = (flat[None, None, :] == item_ids.long()[:, :, None]).any(1)
    targets = (torch.arange(bs, device=flat.device) * (L + 1))[:, None] \
        + torch.arange(1, L + 1, device=flat.device)[None, :]
    cols = torch.arange(n, device=flat.device)
    reject = member[:, None, :] & (cols[None, None, :] != targets[:, :, None])
    masked = ((ext == 0)[None, None, :] | reject).reshape(bs * L, n)
    logits = logits.masked_fill(masked, -1e4)
    ce = torch.logsumexp(logits, -1) - logits.gather(1, targets.reshape(-1, 1))[:, 0]
    w = log_mask.reshape(-1).float()
    return (ce * w).sum() / w.sum().clamp(min=1.0)


def sequence_loss(W, item_embs, item_ids, log_mask, pop_prob, cfg: dict,
                  prec: Precision, seed: Optional[int]):
    """The model's tail: (bs*(L+1), E) item embeddings -> SASRec over all
    but each user's last item -> (the in-batch loss, SASRec's output)."""
    L, E = cfg["max_seq_len"], cfg["embedding_dim"]
    x = item_embs.reshape(-1, L + 1, E)[:, :-1]
    out = user_encoder(W, x, log_mask, cfg["user_encoder"], prec, seed)
    return inbatch_loss(out, item_embs, item_ids, log_mask, pop_prob, prec), out


def fuse(W, parts: List[torch.Tensor], prec: Precision):
    return linear(torch.cat(parts, -1), W, "fuse.com_dense", prec)


def as_params(weights: Dict[str, torch.Tensor], trainable) -> Dict[str, torch.Tensor]:
    """float32 copies of ``weights``, the ``trainable`` names as leaves
    that keep a gradient."""
    return {n: w.detach().float().clone().requires_grad_(trainable(n))
            for n, w in weights.items()}
