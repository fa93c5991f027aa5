"""The readings a cell's correctness limits are set from, on the chip.

    python3 h100_bench/calibrate.py --workload <name> [--seeds 12]
        [--controls 3] [--faults 3] [--first-seed N] [--seconds 1]

in one process: the cell run on ``--seeds`` seeds (the sound readings:
each compared number's largest is its lower reading), then each control
on ``--controls`` seeds and each planted fault (``faults.py``) on
``--faults`` seeds (their smallest readings are the upper ones).  The
controls are those the cell's limits file lists: the program with a
lower-precision path of its own switched on (``"program"``: configuration
``overrides``, or a ``plant`` of ``PLANTS`` applied to the built trainer),
or the reference computed in a lower precision in the program's place
(``"reference"``).  One JSON line per reading, and a summary line last.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def int8_image_tower(tr, weights) -> None:
    """The program's W8A8 layers (#10) in place of every dense layer of
    the image tower's encoder alone, quantised from the benchmark's float
    weights as ``tower_quant="int8"`` quantises both towers' at graft
    time."""
    import torch
    from iisan_tpu_torch.models.modules import TorchLinear
    from iisan_tpu_torch.ops.int8_linear import Int8Dense, quantize_kernel

    prefix = "image_tower.vit"
    vit = tr.model.get_submodule(prefix)
    for name, mod in list(vit.named_modules()):
        if type(mod) is not TorchLinear:
            continue
        w = f"{prefix}.{name}"
        k = weights[w + ".kernel"]
        q, scale = quantize_kernel(k.float().cpu().numpy())
        new = Int8Dense(k.shape[0], k.shape[1], mod.dtype, use_bias=mod.bias is not None,
                        device=k.device)
        with torch.no_grad():
            new.kernel_q.copy_(torch.from_numpy(q))
            new.kscale.copy_(torch.from_numpy(scale))
            if mod.bias is not None:
                new.bias.copy_(weights[w + ".bias"])
        new.requires_grad_(False)
        parent, _, leaf = name.rpartition(".")
        setattr(vit.get_submodule(parent), leaf, new)


PLANTS = {"int8_image_tower": int8_image_tower}


def reference_control(workload: str, seed: int, precision: str, device: str = "cuda",
                      overrides=None) -> dict:
    """The cell's compared numbers with the reference in ``precision`` in
    the program's place, judged against the float32 reference."""
    import torch

    from h100_bench import data, harness
    from h100_bench.runners import train
    from h100_bench.reference import serve as ref_serve
    from h100_bench.reference.train import reference_steps
    from h100_bench.weights import make_weights, serve_spec, weight_spec

    _, _, config, traffic, _ = harness.cell_files(workload, overrides)
    cell = harness.Cell(config, traffic, seed, 0.0, False, device, 0.0)
    t = traffic
    if t["runner"] == "train":
        inputs = train.Inputs(cell)
        batches = [inputs.batch(i) for i in range(t["check_steps"])]
        weights = make_weights(weight_spec(config), seed, device)
        steps = [reference_steps(config, weights, batches, inputs.pop_d, dropout_seed=seed,
                                 precision=p, block=t["reference_block"])
                 for p in (precision, "fp32")]
        print("h100_bench: control tower gaps " + train.tower_detail(*steps) + "; probes "
              + train.probe_detail(steps[0]["probes"], weights, config), file=sys.stderr)
        return train.compare(steps[0], steps[1], config, weights)
    weights = make_weights(serve_spec(config), seed, device)
    table = torch.randn((t["catalogue_rows"] + 1, config["embedding_dim"]),
                        generator=data.torch_generator(seed, "catalogue", device),
                        device=device)
    table[0] = 0.0
    requests = data.serve_requests(t["requests"], t["batch_users"], t["catalogue_rows"],
                                   t["history_min"], t["history_max"], seed)
    rank_gap = score_gap = 0.0
    blk = t["reference_block"]
    for r in range(t["check_requests"] + 1):
        for s in range(0, t["batch_users"], blk):
            users = requests[r][s:s + blk]
            low = ref_serve.score_users(weights, table, users, config, precision)
            top = torch.topk(low, t["k"], dim=1)
            ref = ref_serve.score_users(weights, table, users, config)
            g = ref_serve.judge(ref, top.indices.cpu().numpy(), top.values.cpu().numpy())
            rank_gap, score_gap = harness.worst([rank_gap, g[0]]), harness.worst([score_gap, g[1]])
    return {"rank_gap": rank_gap, "score_gap": score_gap}


def controls(workload: str) -> list:
    """The controls the cell's limits file lists."""
    from h100_bench import harness

    return harness.load_json(harness.HERE / "workloads" / f"{workload}.json")["controls"]


def control_check(workload: str, control: dict, seed: int, seconds: float,
                  device: str = "cuda", overrides=None) -> dict:
    """The compared numbers of one control on one seed, at the cell's
    size unless ``overrides`` shrink it."""
    from h100_bench import harness

    if control["kind"] == "reference":
        return reference_control(workload, seed, control["precision"], device, overrides)
    over = harness.merge(overrides or {}, control.get("overrides", {}))
    hooks = {"program": PLANTS[control["plant"]]} if "plant" in control else None
    line = harness.run_cell(workload, seed, seconds, False, device=device, overrides=over,
                            hooks=hooks, t_start=time.perf_counter())
    return {k: v[0] for k, v in line["check"].items()}


def readings(workload: str, n_seeds: int, n_controls: int, n_faults: int,
             first_seed: int, seconds: float, device: str = "cuda", overrides=None,
             out=print) -> dict:
    """Every reading, by kind ("sound", "control:<name>" for each control,
    each fault), each a list of the compared numbers of one seed; ``out``
    gets one JSON line per reading."""
    from h100_bench import faults, harness

    _, _, config, traffic, _ = harness.cell_files(workload, overrides)
    train = traffic["runner"] == "train"
    planted = faults.TRAIN if train else faults.serve_calls(traffic["k"],
                                                             traffic["history_max"])
    listed = controls(workload)
    found = {"sound": [], **{"control:" + c["name"]: [] for c in listed},
             **{f: [] for f in planted}}
    seeds = [first_seed + 7919 * i for i in range(max(n_seeds, n_controls, n_faults))]

    def record(kind, seed, check):
        found[kind].append(check)
        out(json.dumps({"kind": kind, "seed": seed, "check": check}))

    def cell(seed, hooks=None):
        line = harness.run_cell(workload, seed, seconds, False, device=device,
                                overrides=overrides, hooks=hooks,
                                t_start=time.perf_counter())
        return {k: v[0] for k, v in line["check"].items()}

    for seed in seeds[:n_seeds]:
        record("sound", seed, cell(seed))
    for control in listed:
        for seed in seeds[:n_controls]:
            record("control:" + control["name"], seed,
                   control_check(workload, control, seed, seconds, device, overrides))
    for name, fault in planted.items():
        for seed in seeds[:n_faults]:
            record(name, seed, cell(seed, hooks={"step" if train else "call": fault}))
    return found


def summary(found: dict) -> dict:
    """Per kind, each number's largest sound reading or smallest other."""
    return {kind: {k: (max if kind == "sound" else min)(c[k] for c in checks)
                   for k in checks[0]}
            for kind, checks in found.items() if checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_011)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    found = readings(args.workload, args.seeds, args.controls, args.faults,
                     args.first_seed, args.seconds, out=lambda s: print(s, flush=True))
    print(json.dumps({"summary": summary(found)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
