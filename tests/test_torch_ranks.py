"""Worlds of ``torch.distributed`` ranks for the port's CPU tests.

The tests start a world as the launcher ``torchrun`` does: one process a
rank, each with ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
and ``MASTER_PORT`` in its environment, on gloo (``--device cpu``).  Every
world is joined with a timeout and killed past it, so a hung collective
fails one test; each rank's process group has a 120 s timeout too.

    python tests/test_torch_ranks.py CASE OUTDIR [ARGS_JSON]

runs ``CASES[CASE]`` on one rank and pickles its results to
``OUTDIR/rank<r>.pkl``, with the modules of the JAX package (or of JAX,
flax, optax, transformers) the process loaded, which must be none: this
module imports only the port.  ``cached_run`` / ``id_run`` /
``uncached_run`` train the small configurations the rank tests use; the
tests call them in their own process for the one-rank reference.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from iisan_tpu_torch.config import IISANConfig  # noqa: E402
from iisan_tpu_torch.data.synthetic import synthetic_corpus, synthetic_taps  # noqa: E402
from iisan_tpu_torch.utils.jax_params import load_jax_params  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "transformers")

# The cached / ID configuration: 64 users over 200 items, taps 32 wide, K=3,
# batch 16 (4 steps an epoch), fp32, dropout 0.
USERS, ITEMS, DIM, K = 64, 200, 32, 3
SMALL = dict(batch_size=16, epoch=2, embedding_dim=16,
             side_adapter_vit_list="1,3", side_adapter_bert_list="1,3",
             word_embedding_dim=DIM, image_embedding_dim=DIM,
             bert_adapter_down_size=8, cv_adapter_down_size=8, drop_rate=0.0,
             eval_batch_size=32, lr=1e-3, adapter_cv_lr=1e-3,
             adapter_bert_lr=1e-3, fine_tune_lr_image=1e-3,
             fine_tune_lr_text=1e-3, compute_dtype="float32")
# The uncached configuration: 8 users over 20 items, towers of 2 layers x
# 128, 32 x 32 images, sequences of 4, batch 4 (20 item rows a step).
U_ITEMS, U_WORDS, U_IMAGE = 20, 6, 32
USMALL = dict(batch_size=4, epoch=1, embedding_dim=16,
              side_adapter_vit_list="0,1", side_adapter_bert_list="0,1",
              word_embedding_dim=128, image_embedding_dim=128, text_layers=2,
              image_layers=2, CV_resize=U_IMAGE, num_words_title=U_WORDS,
              max_seq_len=4, compute_dtype="float32", bert_adapter_down_size=8,
              cv_adapter_down_size=8, eval_batch_size=8, lr=1e-3,
              adapter_cv_lr=1e-3, adapter_bert_lr=1e-3,
              fine_tune_lr_image=1e-3, fine_tune_lr_text=1e-3, num_workers=2,
              adapter_type="IISAN", adding_adapter_to="all",
              fine_tune_to="None", tower_dropout=0.0, drop_rate=0.0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
               WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO))
    env.pop("XLA_FLAGS", None)
    return env


def start(cmd, world: int, logdir: Path):
    """Start ``cmd`` once a rank; returns the processes (output to files
    under ``logdir``)."""
    port = free_port()
    logdir.mkdir(parents=True, exist_ok=True)
    procs = []
    for r in range(world):
        out = open(logdir / f"rank{r}.log", "w")
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=rank_env(r, world, port),
                                      stdout=out, stderr=subprocess.STDOUT))
        out.close()
    return procs


def join(procs, logdir: Path, timeout: float) -> None:
    """Wait for every rank; kill all and fail past ``timeout`` seconds or
    where a rank exits non-zero (its log's end in the message)."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(f"a world of {len(procs)} ranks did not finish "
                             f"in {timeout} s:\n" + tail(logdir, len(procs)))
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"ranks {bad} exited non-zero:\n"
                             + tail(logdir, len(procs)))


def tail(logdir: Path, world: int, n: int = 3000) -> str:
    return "\n".join(f"--- rank {r}\n" + (logdir / f"rank{r}.log").read_text()[-n:]
                     for r in range(world))


def run_world(case: str, world: int, outdir: Path, args=None,
              timeout: float = 150.0) -> list:
    """Run ``CASES[case]`` on a world of ``world`` gloo ranks; returns each
    rank's results.  Fails if a rank loaded a forbidden module."""
    outdir.mkdir(parents=True, exist_ok=True)
    procs = start([sys.executable, str(Path(__file__).resolve()), case,
                   str(outdir), json.dumps(args or {})], world, outdir)
    join(procs, outdir, timeout)
    out = []
    for r in range(world):
        with open(outdir / f"rank{r}.pkl", "rb") as f:
            res = pickle.load(f)
        assert res.pop("forbidden_modules") == [], f"rank {r} loaded JAX"
        out.append(res)
    return out


def assert_same_topk(got, want, tol=1e-5, atol=1e-6):
    """Top-K ids equal up to ties, scores within ``tol`` relative: an id
    may differ only at a position whose score ties (within tolerance) with
    the other answer's there."""
    (gi, gs), (wi, ws) = got, want
    np.testing.assert_allclose(gs, ws, rtol=tol, atol=atol)
    for row in range(len(gi)):
        for j in np.flatnonzero(gi[row] != wi[row]):
            tied = np.isclose(ws[row], ws[row, j], rtol=tol, atol=atol)
            assert gi[row, j] in wi[row][tied], (row, j, gi[row], wi[row])


# ---------------------------------------------------------------------------
# Training runs, one rank's or the one-process reference


def cached_run(mesh: str = "", quant: str = "none", epochs: int = 2,
               params=None, drop: float = 0.0, **over) -> dict:
    """The small cached configuration on ``mesh``: valid metrics before
    training, each epoch's per-step losses, ``san.fc_bert.kernel`` and the
    metrics after, and the trainer."""
    from iisan_tpu_torch.train.cached import CachedTrainer

    cfg = IISANConfig(**{**SMALL, "mesh_shape": mesh, "cache_quant": quant,
                         "drop_rate": drop, **over})
    corpus = synthetic_corpus(n_users=USERS, item_num=ITEMS, seed=3)
    tr = CachedTrainer(cfg, corpus, synthetic_taps(ITEMS, K, DIM, 1),
                       synthetic_taps(ITEMS, K, DIM, 2), device="cpu")
    if params is not None:
        load_jax_params(tr.model, params)
    return _train(tr, epochs)


def id_run(mesh: str = "", epochs: int = 2) -> dict:
    from iisan_tpu_torch.train.id_pipeline import IDTrainer

    cfg = IISANConfig(**{**SMALL, "mesh_shape": mesh, "item_tower": "id"})
    tr = IDTrainer(cfg, synthetic_corpus(n_users=USERS, item_num=ITEMS, seed=3),
                   device="cpu")
    return _train(tr, epochs, param="id_embedding.weight")


class CountingStore:
    """The port's synthetic images, counting the names decoded."""

    def __init__(self, resize: int):
        from iisan_tpu_torch.data.images import SyntheticImageStore

        self.store, self.names = SyntheticImageStore(resize), []
        self.resize = resize

    def get(self, name):
        self.names.append(name)
        return self.store.get(name)


def uncached_run(mesh: str = "", epochs: int = 1) -> dict:
    from iisan_tpu_torch.data.images import synthetic_token_table
    from iisan_tpu_torch.train.uncached import UncachedTrainer

    cfg = IISANConfig(**{**USMALL, "pipeline": "uncached", "mesh_shape": mesh})
    corpus = synthetic_corpus(n_users=8, item_num=U_ITEMS, max_seq_len=4, seed=0)
    store = CountingStore(U_IMAGE)
    tr = UncachedTrainer(cfg, corpus,
                         synthetic_token_table(U_ITEMS, U_WORDS, seed=0, vocab=500),
                         store, device="cpu")
    out = _train(tr, epochs, param="san.fc_bert.kernel", evaluate=False)
    out["decoded"] = len(store.names)
    out["rows_per_step"] = cfg.batch_size * (cfg.max_seq_len + 1)
    out["steps"] = len(out["losses"][0])
    return out


def _train(tr, epochs: int, param: str = "san.fc_bert.kernel",
           evaluate: bool = True) -> dict:
    out = {"trainer": tr, "losses": [], "means": []}
    if evaluate:
        out["eval0"] = tr.evaluate_split("valid")
    for e in range(1, epochs + 1):
        out["means"].append(tr.run_epoch(e))
        out["losses"].append(tr._last_step_losses.float().numpy().copy())
    out["param"] = tr.model.state_dict()[param].float().numpy().copy()
    if evaluate:
        out["eval"] = tr.evaluate_split("valid")
    return out


def _results(run: dict, *extra) -> dict:
    keep = ("losses", "means", "param", "eval0", "eval", "decoded",
            "rows_per_step", "steps") + extra
    return {k: run[k] for k in keep if k in run}


# ---------------------------------------------------------------------------
# Cases: each runs on every rank of the world and returns its results


def case_parallel(args, rank, world):
    """make_mesh groups, owned_rows / host_shard, the differentiable
    all-gather's gradient, the column gather and the gradient sum."""
    from iisan_tpu_torch.parallel import distributed as pd
    from iisan_tpu_torch.parallel.mesh import make_mesh

    out = {"meshes": {}}
    for spec in ("", f"data:{world}", f"model:{world}", f"data:{world},model:1",
                 f"data:1,model:{world}"):
        m = make_mesh(spec)
        probe = torch.tensor([float(rank)])
        sums = {}
        for a in m.axes:
            sums[a.name] = float(pd.all_reduce_sum(probe.clone(), a))
        out["meshes"][spec] = ([(a.name, a.size, a.index, a.ranks)
                                for a in m.axes], sums)
    data = make_mesh("").axis("data")
    out["owned"] = pd.owned_rows(12, data).tolist()
    out["owned_ragged"] = pd.owned_rows(world * 3 + 1, data).tolist()
    out["host_shard"] = pd.host_shard(11).tolist()
    g = torch.Generator().manual_seed(rank)
    x = torch.randn(3, 5, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(3 * world, 5, generator=torch.Generator().manual_seed(100 + rank),
                    dtype=torch.float64)
    y = pd.all_gather_rows(x, data)
    (y * w).sum().backward()
    out["x"], out["w"] = x.detach().numpy(), w.numpy()
    out["y"], out["grad"] = y.detach().numpy(), x.grad.numpy()
    out["columns"] = pd.all_gather_columns(
        torch.full((2, 3), float(rank)), data).numpy()
    lin = torch.nn.Linear(4, 2)
    pd.broadcast_(lin.state_dict().values())
    lin(torch.full((1, 4), float(rank + 1))).sum().backward()
    pd.all_reduce_grads(lin.parameters(), data)
    out["linear"] = {n: p.detach().numpy().copy() for n, p in lin.named_parameters()}
    out["linear_grads"] = {n: p.grad.numpy().copy() for n, p in lin.named_parameters()}
    return out


def case_ddp2(args, rank, world):
    """World 2: cached data:2 and model:2, sharded evaluation, the ID and
    uncached trainers at data:2, rank-0 checkpoints and resume, dropout
    draws, and data:2 from the JAX package's initial parameters."""
    from iisan_tpu_torch.utils import checkpoint as ckpt_lib
    from iisan_tpu_torch.train import loop

    out = {"data2": _results(cached_run("data:2")),
           "model2": _results(cached_run("model:2")),
           "id": _results(id_run("data:2")),
           "uncached": _results(uncached_run("data:2"))}
    run = cached_run("model:2", epochs=0)
    tr = run["trainer"]
    out["model2_cols"] = tuple(tr.cv_table.shape)
    with np.load(args["jax_params"]) as z:
        tree = {}
        for key in z.files:
            node = tree
            *path, leaf = key.split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = z[key]
    out["jax_init"] = _results(cached_run("data:2", params=tree, epochs=1))

    # checkpoints: rank 0 writes, with a barrier; every rank resumes
    writes = []
    save = ckpt_lib.save_checkpoint
    loop.ckpt_lib.save_checkpoint = lambda *a: writes.append(a[1]) or save(*a)
    ckpt = args["ckpt_dir"]
    straight = cached_run("data:2", epochs=0, drop=0.1, ckpt_dir=ckpt)["trainer"]
    straight.train(save_checkpoints=True)
    loop.ckpt_lib.save_checkpoint = save
    out["writes"] = writes
    resumed = cached_run("data:2", epochs=0, drop=0.1, ckpt_dir=ckpt)["trainer"]
    resumed.cfg = resumed.cfg.replace(epoch=1)
    start = resumed.resume("epoch-1")
    resumed.train(start_epoch=start)
    out["resumed_param"] = resumed.model.state_dict()[
        "san.fc_bert.kernel"].numpy().copy()
    out["straight_param"] = straight.model.state_dict()[
        "san.fc_bert.kernel"].numpy().copy()
    out["dropout"] = _dropout_draws(straight)
    return out


def case_ddp4(args, rank, world):
    """World 4: cached data:4, data:2 x model:2 with fp32 and int8 tables,
    and the dropout draws of data:2 x model:2."""
    out = {"data4": _results(cached_run("data:4"))}
    for quant in ("none", "int8"):
        run = cached_run("data:2,model:2", quant=quant)
        table = run["trainer"].cv_table
        out[quant] = _results(run)
        out[quant]["cols"] = tuple(table.shape)
        if quant == "int8":
            out[quant]["scale_shape"] = tuple(table.scale.shape)
    out["dropout"] = _dropout_draws(
        cached_run("data:2,model:2", epochs=0, drop=0.1)["trainer"])
    return out


def _dropout_draws(tr):
    """This rank's data index and the first draws of its dropout generator
    (a copy, so training is untouched)."""
    g = torch.Generator().manual_seed(0)
    g.set_state(tr.generator.get_state())
    return tr.data_axis.index, torch.rand(8, generator=g).numpy()


def case_serve(args, rank, world):
    """ShardedRecommender against Recommender.top_k on an artifact: fp32,
    bf16 and int8 tables, each request set (history below, on and above
    each shard) and k beyond a shard's rows."""
    from iisan_tpu_torch.serve import Recommender, ShardedRecommender

    rec = Recommender.load(args["artifact"], device="cpu")
    recs = {"float32": rec,
            "bfloat16": Recommender(rec.model, rec.fused_table.bfloat16(),
                                    rec.max_seq_len),
            "int8": rec.quantize_table()}
    out = {}
    for name, dense in recs.items():
        sharded = ShardedRecommender(dense)
        res = {"rows_local": sharded.rows_local, "offset": sharded.offset}
        for label, (seqs, k) in args["requests"].items():
            res[label] = (sharded.top_k(seqs, k), dense.top_k(seqs, k))
        out[name] = res
    return out


CASES = {"parallel": case_parallel, "ddp2": case_ddp2, "ddp4": case_ddp4,
         "serve": case_serve}


def main() -> int:
    from iisan_tpu_torch.parallel.distributed import (initialize_runtime,
                                                      shutdown_runtime)

    case, outdir = sys.argv[1], Path(sys.argv[2])
    args = json.loads(sys.argv[3]) if len(sys.argv) > 3 else {}
    torch.set_num_threads(1)
    initialize_runtime(device="cpu", timeout=timedelta(seconds=120))
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    try:
        res = CASES[case](args, rank, world)
    finally:
        shutdown_runtime()
    res["forbidden_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in FORBIDDEN or m == "iisan_tpu"
        or m.startswith("iisan_tpu."))
    with open(outdir / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
