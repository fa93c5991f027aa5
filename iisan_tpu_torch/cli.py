"""Command line: the reference's and the JAX package's flags, on the port.

Port of ``iisan_tpu/cli.py``.  Every field of ``IISANConfig`` is a flag of
the same name, so a command written for the reference (``run.py`` and its
``parameters.py``) or for ``python -m iisan_tpu.cli`` runs here unchanged;
``--pipeline {cached,cached_asym,uncached}`` and ``--item_tower id`` pick
the pipeline.  One flag is added: ``--device`` (default the first CUDA
card; there is no fallback to the CPU, ``--device cpu`` asks for it).

``--mesh_shape`` and ``--dist_*`` lay the run over ranks: ``main`` starts
the process group (``parallel.distributed.initialize_runtime``) from
``--dist_coordinator`` / ``--dist_num_processes`` / ``--dist_process_id``,
or from ``torchrun``'s environment, before training, e.g.
``torchrun --nproc_per_node 2 -m iisan_tpu_torch.cli --mesh_shape data:2
...`` (NCCL on the cards, gloo with ``--device cpu``).

Flags whose field holds a bool or a string (``--remat_towers``,
``--fused_tower_attention``) read ``true`` / ``false`` as bools and keep
any other value (``mlp``, ``subblock``, ``subblock_v2``) as the string;
the JAX parser turns those into False.

    python -m iisan_tpu_torch.cli --pipeline cached \\
        --root_data_dir DATA --dataset Dataset/Scientific \\
        --stored_vector_path VECS --epoch 10 --ckpt_dir CKPT \\
        [--load_ckpt_name epoch-7] [--mode test] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from .config import IISANConfig

_TRUE, _FALSE = ("1", "true", "yes"), ("0", "false", "no")


def _parse_bool(v: str) -> bool:
    return v.lower() in _TRUE


def _parse_bool_or_str(v: str):
    """A bool where the value reads as one, else the string itself."""
    low = v.lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    return v


def build_parser() -> argparse.ArgumentParser:
    # allow_abbrev=False: parse_config looks for an explicit --compute_dtype
    # in argv, which a prefix abbreviation would hide
    p = argparse.ArgumentParser(description="iisan_tpu_torch trainer",
                                allow_abbrev=False)
    defaults = IISANConfig()
    skip = {"news_attributes", "k_adapter_bert_list"}
    for f in dataclasses.fields(IISANConfig):
        if f.name in skip:
            continue
        default = getattr(defaults, f.name)
        if f.type == "Any":
            p.add_argument(f"--{f.name}", type=_parse_bool_or_str,
                           default=default)
        elif isinstance(default, bool):
            p.add_argument(f"--{f.name}", type=_parse_bool, default=default)
        else:
            p.add_argument(f"--{f.name}", type=type(default), default=default)
    # string-list flags keep the reference's string form
    p.add_argument("--news_attributes", type=str, default="title")
    p.add_argument("--k_adapter_bert_list", type=str, default="0,11")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    return p


def parse_args(argv=None):
    """(config, device) of a command line."""
    from .train.pipelines import validate_config

    argv = list(sys.argv[1:] if argv is None else argv)
    args = vars(build_parser().parse_args(argv))
    device = args.pop("device")
    cfg = IISANConfig(**args)
    # --use_scale is the reference's AMP switch: 'half' is bf16
    # activations (the default), anything else fp32, unless --compute_dtype
    # was given
    explicit_dtype = any(a.startswith("--compute_dtype") for a in argv)
    if "half" not in cfg.use_scale and not explicit_dtype:
        cfg = cfg.replace(compute_dtype="float32")
    validate_config(cfg)
    return cfg.with_bert_dims(), device


def parse_config(argv=None) -> IISANConfig:
    return parse_args(argv)[0]


def main(argv=None) -> int:
    from .parallel.distributed import initialize_runtime, shutdown_runtime
    from .train.pipelines import run_from_config

    cfg, device = parse_args(argv)
    if "train" not in cfg.mode and "test" not in cfg.mode:
        raise SystemExit(f"unknown mode {cfg.mode}")
    initialize_runtime(
        coordinator_address=cfg.dist_coordinator or None,
        num_processes=cfg.dist_num_processes or None,
        process_id=cfg.dist_process_id if cfg.dist_process_id >= 0 else None,
        device=device)
    try:
        run_from_config(cfg, eval_only="train" not in cfg.mode, device=device)
    finally:
        shutdown_runtime()
    return 0


if __name__ == "__main__":
    sys.exit(main())
