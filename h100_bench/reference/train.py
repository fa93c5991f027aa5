"""The reference training steps: loss, gradients and Adam, in float32.

``reference_steps`` takes the weights the benchmark made, the batches the
program was given and the seed of the trainer's dropout generator, and
trains the configuration's model for as many steps, returning what the
check compares: each step's loss, each leaf's gradient norm at the first
step, and each leaf's change over all the steps.

Frozen towers (IISAN) run without autograd in blocks of rows.  Trained
towers (full fine-tuning) run twice: a forward over the whole batch in
blocks without autograd gives the item embeddings, the loss's gradient
with respect to them comes from the tail, and each block's forward runs
again under autograd and takes that gradient back, so the towers'
gradients are summed block by block.  Dropout masks are drawn once for the
whole batch, in the program's order, before any block runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from . import model as M


def group_of(name: str) -> str:
    """The optimizer group of a leaf: the published IISAN code's name
    matching, quirks included (the image gate and ``fc_cv`` take the image
    tower's rate, ``fc_bert`` the text tower's)."""
    path = name.replace(".", "/")
    if "bert_adapter_list" in path:
        return "adapter_text"
    if "cv_adapter_list" in path or "mm_adapter_list" in path:
        return "adapter_cv"
    if "side_gate_params_cv" in path:
        return "image_tower"
    if "side_gate_params" in path:
        return "recsys"
    if "fc_bert" in path:
        return "text_tower"
    if "fc_cv" in path:
        return "image_tower"
    if path.startswith("text_tower/"):
        return "recsys" if path.startswith("text_tower/fc/") else "text_tower"
    if path.startswith("image_tower/"):
        return "recsys" if path.startswith("image_tower/classifier/") else "image_tower"
    return "recsys"


def trainable(cfg: dict):
    """Which leaves train: everything under full fine-tuning; IISAN's side
    network, user encoder, fusion layer and the towers' output heads."""
    if cfg["method"] != "iisan":
        return lambda name: True
    heads = ("san.", "user_encoder.", "fuse.", "image_tower.classifier.",
             "text_tower.fc.")
    return lambda name: name.startswith(heads)


class Adam:
    """Adam (beta1, beta2, eps) with a learning rate per group; a leaf
    without a gradient is left as it is."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: dict):
        self.params, self.lr = params, opt["lr"]
        self.b1, self.b2 = opt["betas"]
        self.eps, self.t = opt["eps"], 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items() if p.requires_grad}
        self.v = {n: torch.zeros_like(p) for n, p in params.items() if p.requires_grad}

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, m in self.m.items():
            p = self.params[n]
            if p.grad is None:
                continue
            m.mul_(self.b1).add_(p.grad, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(p.grad, p.grad, value=1 - self.b2)
            denom = (self.v[n].sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr[group_of(n)] / c1)
            p.grad = None


def _rows(n: int, block: int):
    return [slice(s, min(s + block, n)) for s in range(0, n, block)]


def _tower_outputs(W, cfg, images, tokens, masks, prec, block: int, grad_out=None,
                   probe: Optional[M.Probe] = None):
    """The towers over every item, block by block.  Returns, per block,
    (image hidden CLS rows, text hidden CLS rows, image final CLS, text last
    CLS); with ``grad_out`` (d emb_cv, d emb_text) each block's heads are
    back-propagated instead and nothing is returned.  ``probe`` records
    its products and cores over the first block."""
    text, image = cfg["text_tower"], cfg["image_tower"]
    nw = text["title_tokens"]
    out = []
    for rows in _rows(images.shape[0], block):
        first = probe if rows.start == 0 else None
        with torch.set_grad_enabled(grad_out is not None):
            last_v, hid_v = M.vit(W, "image_tower.vit", M.normalize(images[rows]),
                                  image, prec, first)
            last_t, hid_t = M.bert(W, "text_tower.bert", tokens[rows, :nw],
                                   tokens[rows, nw:2 * nw], text, prec, masks, rows, first)
            if grad_out is None:
                out.append((torch.stack(hid_v, 1), torch.stack(hid_t, 1),
                            last_v[:, 0], last_t[:, 0]))
                continue
            emb_cv = F.gelu(M.linear(last_v[:, 0], W, "image_tower.classifier", prec))
            emb_text = F.gelu(M.linear(last_t[:, 0], W, "text_tower.fc", prec))
            torch.autograd.backward([emb_cv, emb_text],
                                    [grad_out[0][rows], grad_out[1][rows]])
    return out


def _step_loss(W, cfg, batch, pop_prob, drops, prec, block: int):
    """One training step: (its loss, the towers' outputs, SASRec's output,
    the probes' inputs and outputs over the first block, ``M.probe_names``),
    its gradients left on the leaves.  The towers' outputs are the side network's CLS
    taps (IISAN) or the heads' embeddings (full fine-tuning), image
    first."""
    ids, images, tokens, log_mask = batch
    ids, log_mask = ids.long(), log_mask.float()
    masks = M.tower_masks(drops, cfg["text_tower"], images.shape[0], images.device)
    ue_seed = drops.kernel_seed() if cfg["user_encoder"]["dropout"] > 0 else None
    probe = M.Probe(M.probe_names(cfg))
    with torch.no_grad():
        parts = _tower_outputs(W, cfg, images, tokens, masks, prec, block, probe=probe)
    taps = cfg["san"]["taps"] if cfg["method"] == "iisan" else None
    if taps is not None:
        cv = torch.cat([p[0] for p in parts])[:, taps]
        tx = torch.cat([p[1] for p in parts])[:, taps]
        item_embs = M.fuse(W, list(M.side_network(W, cv, tx, cfg["san"], prec)), prec)
        loss, out = M.sequence_loss(W, item_embs, ids, log_mask, pop_prob, cfg, prec,
                                    ue_seed)
        loss.backward()
        return loss.detach(), (cv, tx), out.detach(), probe.seen
    final_v = torch.cat([p[2] for p in parts])
    last_t = torch.cat([p[3] for p in parts])
    with torch.no_grad():
        cv0 = F.gelu(M.linear(final_v, W, "image_tower.classifier", prec))
        tx0 = F.gelu(M.linear(last_t, W, "text_tower.fc", prec))
    emb_cv, emb_text = cv0.requires_grad_(), tx0.requires_grad_()
    item_embs = M.fuse(W, [emb_cv, emb_text], prec)
    loss, out = M.sequence_loss(W, item_embs, ids, log_mask, pop_prob, cfg, prec, ue_seed)
    loss.backward()
    _tower_outputs(W, cfg, images, tokens, masks, prec, block,
                   grad_out=(emb_cv.grad, emb_text.grad))
    return loss.detach(), (cv0.detach(), tx0.detach()), out.detach(), probe.seen


def reference_steps(cfg: dict, weights: Dict[str, torch.Tensor],
                    batches: List[tuple], pop_prob: torch.Tensor,
                    dropout_seed: int, precision: str = "fp32",
                    block: int = 64) -> dict:
    """Train ``len(batches)`` steps from ``weights``; returns ``losses``,
    ``grad_norms`` (leaf -> norm of its first gradient) and
    ``change_norms`` (leaf -> norm of its change after the last step), the
    norms over the trained leaves only, and the first step's ``towers``
    and ``encoder`` outputs and ``probes``, the inputs and outputs of the
    products and cores ``M.probe_names`` lists over the first ``block``
    items (``_step_loss``)."""
    with M.exact():
        prec = M.Precision(precision)
        W = M.as_params(weights, trainable(cfg))
        W0 = {n: p.detach().clone() for n, p in W.items() if p.requires_grad}
        opt = Adam(W, cfg["optimizer"])
        drops = M.Dropout(dropout_seed, pop_prob.device)
        losses, grad_norms, first = [], {}, None
        for i, batch in enumerate(batches):
            loss, towers, encoder, probes = _step_loss(W, cfg, batch, pop_prob, drops,
                                                      prec, block)
            losses.append(float(loss))
            if i == 0:
                grad_norms = {n: float(W[n].grad.norm()) for n in W0
                              if W[n].grad is not None}
                first = {"towers": towers, "encoder": encoder, "probes": probes}
            opt.step()
        change = {n: float((W[n].detach() - W0[n]).norm()) for n in grad_norms}
        return {"losses": losses, "grad_norms": grad_norms, "change_norms": change, **first}
