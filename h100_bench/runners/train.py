"""Training traffic: ``UncachedTrainer.train_step`` back to back.

Set-up makes the corpus, the title table and the image catalogue (on the
device) and the weights from the seed, builds the trainer, loads the
weights into it, and drives its first ``check_steps`` steps through the
timed call on the first batches of the seeded order, reading each step's
loss, the first step's gradient per leaf (from Adam's first moment) and
each leaf's change after the last of them; ``warmup_steps`` more follow.
The window then runs steps on the next batches with no synchronisation
until ``seconds`` have passed, and one at the end: users trained over the
whole window, drain included.  A traced run profiles ``traced_steps`` more
steps after the window.  Then the program is freed and the reference
trains the same steps from the same weights on the same batches.

Each batch's images and titles are gathered on the device from the
catalogue by the batch's item ids and handed to ``train_step`` as the
trainer's own epoch loop hands them over.
"""

from __future__ import annotations

import gc
from contextlib import contextmanager, nullcontext
import statistics
import sys
import time

import torch

from h100_bench import data
from h100_bench import trace as tracing
from h100_bench.harness import worst
from h100_bench.reference import model as M
from h100_bench.reference.train import reference_steps, trainable
from h100_bench.weights import make_weights, weight_spec


def program_config(cell):
    """The port's ``IISANConfig`` for the cell: the configuration's widths
    and rates, its published flags, the traffic's batch, the run's seed."""
    from iisan_tpu_torch.config import IISANConfig

    c, t = cell.config, cell.traffic
    text, image, ue = c["text_tower"], c["image_tower"], c["user_encoder"]
    for tower in (text, image):
        if tower["num_attention_heads"] != tower["hidden_size"] // 64:
            raise ValueError("the port's towers take heads of width 64")
    rates = {text["hidden_dropout_prob"], image["hidden_dropout_prob"]}
    if (text["hidden_dropout_prob"], image["hidden_dropout_prob"]) == (0.1, 0.0):
        tower_dropout = -1.0  # the port's default: BERT 0.1, ViT 0
    elif len(rates) == 1:
        tower_dropout = rates.pop()
    else:
        raise ValueError("tower dropout rates the port cannot set")
    lr = c["optimizer"]["lr"]
    kw = dict(c["program"], pipeline="uncached", batch_size=t["batch_users"],
              embedding_dim=c["embedding_dim"], max_seq_len=c["max_seq_len"],
              min_seq_len=c["corpus"]["min_seq_len"],
              word_embedding_dim=text["hidden_size"],
              text_layers=text["num_hidden_layers"],
              image_embedding_dim=image["hidden_size"],
              image_layers=image["num_hidden_layers"], CV_resize=image["image_size"],
              num_words_title=text["title_tokens"], num_attention_heads=ue["heads"],
              transformer_block=ue["blocks"], drop_rate=ue["dropout"],
              tower_dropout=tower_dropout, compute_dtype=c["compute_dtype"],
              lr=lr["recsys"], adapter_bert_lr=lr["adapter_text"],
              adapter_cv_lr=lr["adapter_cv"], fine_tune_lr_image=lr["image_tower"],
              fine_tune_lr_text=lr["text_tower"], seed=cell.seed, num_workers=1)
    if "san" in c:  # the port reads hidden row 0 and row i + 1 of each listed i
        taps = c["san"]["taps"]
        if taps[0] != 0:
            raise ValueError("the port's side network always reads hidden row 0")
        listed = ",".join(str(i - 1) for i in taps[1:])
        kw.update(bert_adapter_down_size=c["san"]["down_size"],
                  cv_adapter_down_size=c["san"]["down_size"],
                  side_adapter_bert_list=listed, side_adapter_vit_list=listed)
    return IISANConfig(**kw)


def _tree(weights, prefix: str) -> dict:
    """The JAX-layout tree under ``prefix`` of dotted names, as numpy."""
    tree: dict = {}
    for name, w in weights.items():
        if not name.startswith(prefix + "."):
            continue
        node = tree
        parts = name[len(prefix) + 1:].split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = w.detach().cpu().numpy()
    return tree


def build_trainer(cell, corpus, titles, weights):
    """The trainer with the benchmark's weights in it.  Towers whose layers
    the program stores otherwise (``tower_quant="int8"``) take them as
    float trees, which the trainer converts."""
    from iisan_tpu_torch.train.uncached import UncachedTrainer

    cfg = program_config(cell)
    tower_params = None
    if getattr(cfg, "tower_quant", "none") != "none":
        tower_params = {k.replace(".", "/"): _tree(weights, k)
                        for k in ("text_tower.bert", "image_tower.vit")}
    tr = UncachedTrainer(cfg, corpus, titles, None, tower_params=tower_params,
                         device=cell.device)
    params = dict(tr.model.named_parameters())
    extra = set(params) - set(weights)
    if tower_params is None and extra:
        raise ValueError(f"program parameters the benchmark does not make: {sorted(extra)[:5]}")
    with torch.no_grad():
        for name, w in weights.items():
            if name in params:
                params[name].copy_(w)
            elif tower_params is None:
                raise ValueError(f"the program has no parameter {name}")
    return tr


@contextmanager
def capture(model, method: str, probes, rows: int):
    """The first call's outputs, as the program hands them on, copied to
    the host: the towers' (the side network's inputs, IISAN's CLS taps, or
    the fusion layer's, the heads' embeddings; image first), the user
    encoder's, and under ``probes`` the input and output of each module
    ``reference.model.probe_names`` lists that the program has, over the
    first ``rows`` items; yields the dict they are put in."""
    seen: dict = {"probes": {}}
    stage = model.san if method == "iisan" else model.fuse
    names = dict(model.named_modules())

    def host(t):
        return t.detach().cpu()

    def towers(module, args):
        seen.setdefault("towers", tuple(host(a) for a in args[:2]))

    def encoder(module, args, out):
        seen.setdefault("encoder", host(out))

    def probe(name):
        def hook(module, args, out):
            seen["probes"].setdefault(name, (host(args[0][:rows]), host(out[:rows])))
        return hook

    hooks = [stage.register_forward_pre_hook(towers),
             model.user_encoder.register_forward_hook(encoder)]
    hooks += [names[n].register_forward_hook(probe(n)) for n in probes if n in names]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def _adam_grad_norms(tr) -> dict:
    """Each leaf's first gradient, as Adam's first moment after one step
    holds it: m / (1 - beta1)."""
    names = {p: n for n, p in tr.model.named_parameters()}
    keys, norms = [], []
    for group in tr.optimizer.param_groups:
        for p in group["params"]:
            st = tr.optimizer.state.get(p, {})
            if "exp_avg" in st:
                keys.append(names[p])
                norms.append(st["exp_avg"].float().norm() / (1 - group["betas"][0]))
    return dict(zip(keys, torch.stack(norms).cpu().tolist())) if norms else {}


def _change_norms(tr, weights) -> dict:
    params = dict(tr.model.named_parameters())
    keys = [n for n in weights if n in params]
    norms = torch.stack([(params[n].detach().float() - weights[n]).norm() for n in keys])
    return dict(zip(keys, norms.cpu().tolist()))


def output_gap(got, want) -> float:
    """||got - want|| / ||want|| of one output (float32).  Rows that the
    program left out count as zeros; any other difference of shape reads
    infinite."""
    got = got.detach().float().to(want.device)
    if got.shape[1:] != want.shape[1:] or got.shape[0] > want.shape[0]:
        return float("inf")
    missing = want[got.shape[0]:].norm() ** 2
    return float(((got - want[:got.shape[0]]).norm() ** 2 + missing).sqrt() / want.norm())


def compare(prog: dict, ref: dict, cfg: dict, weights) -> dict:
    """The check's numbers: the relative gap of the first step's tower
    outputs (the wider of the two towers) and of its user-encoder output;
    the widest relative gap of the probed dense products
    (``probe_gaps``) and of the probed attention cores;
    the widest relative loss gap over the steps;
    per leaf, the gap between the program's and the reference's norms of
    the first gradient and of the change, each over the larger of the
    reference's norm and the median leaf's, widest leaf; and the largest
    change of a leaf the configuration freezes (exactly 0 when sound).
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of the change."""
    loss_gap = worst(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    gr = ref["grad_norms"]
    med = statistics.median(gr.values())
    grad_gap = worst(abs(prog["grad_norms"].get(n, 0.0) - g) / max(g, med)
                   for n, g in gr.items())
    kept = [n for n, g in gr.items() if g >= 1e-3 * med]
    cr = ref["change_norms"]
    med_c = statistics.median(cr[n] for n in kept)
    change_gap = worst(abs(prog["change_norms"].get(n, 0.0) - cr[n]) / max(cr[n], med_c)
                     for n in kept)
    train = trainable(cfg)
    frozen = [v for n, v in prog["change_norms"].items() if not train(n)]
    gaps = probe_gaps(prog["probes"], weights, cfg)
    return {"tower_gap": worst(output_gap(p, r) for p, r in zip(prog["towers"], ref["towers"])),
            "dense_gap": worst(g for _, kind, g in gaps if kind == "dense"),
            "attn_gap": worst(g for _, kind, g in gaps if kind == "attention"),
            "encoder_gap": output_gap(prog["encoder"], ref["encoder"]),
            "loss_gap": loss_gap, "grad_norm_gap": grad_gap,
            "change_norm_gap": change_gap, "frozen_change": worst(frozen)}


def probe_gaps(seen: dict, weights, cfg: dict) -> list:
    """(name, kind, gap) at each probe of ``reference.model.probe_names``:
    the program's output there against the reference's float32 result of
    the program's own input (each product and core is judged alone, its
    input by the probes and outputs before it); infinite where the program
    has no such module."""
    out = []
    for name, kind in M.probe_names(cfg).items():
        try:
            want = M.probed_again(weights, cfg, name, kind, seen)
        except KeyError:
            out.append((name, kind, float("inf")))
            continue
        out.append((name, kind, output_gap(seen[name][1], want)))
    return out


def probe_detail(seen: dict, weights, cfg: dict, n: int = 6) -> str:
    """The ``n`` widest probe gaps, for the log."""
    gaps = sorted(probe_gaps(seen, weights, cfg), key=lambda g: -g[2])[:n]
    return ", ".join(f"{name.replace('_tower.', '.')} {g:.3g}" for name, _, g in gaps)


def tower_detail(prog: dict, ref: dict) -> str:
    """The towers' output gaps for the log: image then text, row by row
    of the taps where the outputs are taps."""
    parts = []
    for name, p, r in zip(("image", "text"), prog["towers"], ref["towers"]):
        if p.shape != r.shape:
            parts.append(f"{name} shape {tuple(p.shape)}")
        elif r.dim() == 3:
            parts.append(f"{name} " + " ".join(
                f"{output_gap(p[:, k], r[:, k]):.3g}" for k in range(r.shape[1])))
        else:
            parts.append(f"{name} {output_gap(p, r):.3g}")
    return "; ".join(parts)


def widest_leaves(prog: dict, ref: dict, key: str, n: int = 3) -> str:
    """The ``n`` leaves whose ``key`` norms differ most, for the log."""
    r = ref[key]
    med = statistics.median(r.values())
    gaps = sorted(((abs(prog[key].get(k, 0.0) - v) / max(v, med), k) for k, v in r.items()),
                  reverse=True)[:n]
    return ", ".join(f"{k} {g:.3g}" for g, k in gaps)


def quiet_gc() -> None:
    """Collect once and freeze what set-up left, so the collector's full
    passes in the window scan only what the window makes, as in a process
    that has run for a while."""
    gc.collect()
    gc.freeze()


def cuda_ready(device) -> float:
    """Start the device's context, so its cost shows as a phase; the time."""
    if torch.device(device).type == "cuda":
        torch.zeros(1, device=device)
    return time.perf_counter()


def log_phases(t_start: float, phases: dict) -> None:
    """One line on standard error: the seconds of each set-up phase."""
    last, parts = t_start, []
    for name, t in phases.items():
        parts.append(f"{name} {t - last:.3f} s")
        last = t
    print("h100_bench: set-up " + ", ".join(parts), file=sys.stderr)


class Inputs:
    """The run's inputs made from the seed: the corpus and title table on
    the host, and on the device the image catalogue, the titles, the
    sequences, their masks, the popularity and the batch order.
    ``nbytes`` is what they take on the device."""

    def __init__(self, cell):
        c, t, dev = cell.config, cell.traffic, cell.device
        corp = c["corpus"]
        self.corpus = data.synthetic_corpus(
            corp["users"], corp["items"], c["max_seq_len"], corp["min_seq_len"],
            data.stream_seed(cell.seed, "corpus"))
        self.corpus.n_users = corp["users"]
        self.titles = data.synthetic_token_table(
            corp["items"], c["text_tower"]["title_tokens"],
            data.stream_seed(cell.seed, "titles"), corp["title_vocab"])
        cuda = dev != "cpu"
        base = torch.cuda.memory_allocated(dev) if cuda else 0
        self.images = data.image_catalogue(corp["items"], c["image_tower"]["image_size"],
                                           cell.seed, dev)
        self.titles_d = torch.as_tensor(self.titles, device=dev)
        self.seqs_d = torch.as_tensor(self.corpus.train_seqs, device=dev)
        self.mask_d = torch.as_tensor(self.corpus.train_log_mask, device=dev)
        self.pop_d = torch.as_tensor(self.corpus.pop_prob, device=dev)
        self.order = torch.as_tensor(data.epoch_order(
            corp["users"], t["batch_users"], t["order_steps"], cell.seed), device=dev)
        self.nbytes = (torch.cuda.memory_allocated(dev) - base) if cuda else 0

    def batch(self, i: int):
        """Step i's (ids, uint8 images, title rows, log mask), gathered on
        the device."""
        users = self.order[i % len(self.order)]
        ids = self.seqs_d[users]
        flat = ids.reshape(-1).long()
        return ids, self.images[flat], self.titles_d[flat], self.mask_d[users]


def run(cell) -> dict:
    c, t, dev = cell.config, cell.traffic, cell.device
    cuda = dev != "cpu"
    bs = t["batch_users"]
    phases = {"imports and CUDA": cuda_ready(dev)}
    inputs = Inputs(cell)
    batch, corpus, titles = inputs.batch, inputs.corpus, inputs.titles
    inputs_bytes, pop_d = inputs.nbytes, inputs.pop_d

    phases["inputs"] = time.perf_counter()
    spec = weight_spec(c)
    weights = make_weights(spec, cell.seed, dev)
    phases["weights"] = time.perf_counter()
    tr = build_trainer(cell, corpus, titles, weights)
    if "program" in cell.hooks:
        cell.hooks["program"](tr, weights)
    phases["trainer"] = time.perf_counter()
    step = cell.hooks.get("step", lambda trainer, b: trainer.train_step(*b))

    prog = {"losses": []}
    for i in range(t["check_steps"]):
        with (capture(tr.model, c["method"], M.probe_names(c), t["reference_block"])
              if i == 0 else nullcontext()) as seen:
            prog["losses"].append(float(step(tr, batch(i))))
        if i == 0:
            prog["grad_norms"] = _adam_grad_norms(tr)
            prog.update(seen)
    prog["change_norms"] = _change_norms(tr, weights)
    phases["check steps"] = time.perf_counter()
    del weights
    nxt = t["check_steps"]
    for _ in range(t["warmup_steps"]):
        step(tr, batch(nxt))
        nxt += 1
    if cuda:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    quiet_gc()
    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start
    phases["warm-up"] = t0
    log_phases(cell.t_start, phases)
    steps = 0
    while time.perf_counter() - t0 < cell.seconds:
        step(tr, batch(nxt))
        nxt += 1
        steps += 1
    if cuda:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    traced = None
    if cell.trace:
        traced = tracing.profile(lambda i: step(tr, batch(nxt + i)), t["traced_steps"], dev)
    del tr
    gc.collect()
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1,
              "memory_peak_bytes": int(max(setup_peak, window_peak)) if cuda else 0}
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    weights = make_weights(spec, cell.seed, dev)
    ref = reference_steps(c, weights, [batch(i) for i in range(t["check_steps"])], pop_d,
                          dropout_seed=cell.seed, block=t["reference_block"])
    check = compare(prog, ref, c, weights)
    print(f"h100_bench: reference {time.perf_counter() - t_ref:.3f} s; window "
          f"{steps} steps in {window_s:.3f} s; losses program {prog['losses']} "
          f"reference {ref['losses']}; widest gradient leaves "
          f"{widest_leaves(prog, ref, 'grad_norms')}; widest change leaves "
          f"{widest_leaves(prog, ref, 'change_norms')}; tower gaps "
          f"{tower_detail(prog, ref)}; probes {probe_detail(prog['probes'], weights, c)}",
          file=sys.stderr)
    end_to_end = {"train_users_per_s": steps * bs / window_s,
                  "train_peak_mem_gib": (window_peak - inputs_bytes) / 2 ** 30,
                  "setup_s": setup_s}
    context = {"kind": "train", "trace": traced, "config": c, "users": bs,
               "step_s": window_s / steps}
    return {"end_to_end": end_to_end, "check": check, "attempted": steps * bs,
            "failed": 0, "device": device, "context": context, "trace": traced}
