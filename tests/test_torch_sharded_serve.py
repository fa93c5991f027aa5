"""``ShardedRecommender`` and ``--shard`` on worlds of gloo ranks against
``Recommender.top_k`` and the JAX package's ``ShardedRecommender``.

One fp32 artifact (a random user encoder, embedding 16, L=6, and a random
table of 41 rows: over 3 ranks 14 rows each, the last padded by one) is
served by worlds of 2 and 3 ranks (``tests/test_torch_ranks.py``) from its
fp32 table, the table in bf16 and ``quantize_table()``'s int8 one.  The
requests hold history ids below, in and above every shard, and ask for k
past a shard's rows (k = 25 and 20 against 21 and 14).  Each rank's ids
equal the dense Recommender's up to ties and its scores are within 1e-5
relative; the JAX ``ShardedRecommender`` on the conftest's 8 virtual
devices gives the same ids.  ``python -m iisan_tpu_torch.serve --shard``
at a world of 2 writes the one-process TSV's ids, and ``--shard --http``
at a world of 2 (rank 0 listens and broadcasts each request, rank 1
follows) answers as the one-process Recommender, then stops on an
interrupt to rank 0.
"""

import json
import signal
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from iisan_tpu import serve as jserve
from iisan_tpu_torch import serve
from iisan_tpu_torch.models.model import IISANRecModel
from test_torch_ranks import assert_same_topk, free_port, join, run_world, start, tail

ROWS, DIM, L = 41, 16, 6
REQUESTS = {
    "low": ([[1, 2, 3], [5, 1]], 5),
    "high": ([[40, 39, 38], [35, 36]], 5),
    "across": ([[1, 14, 15, 20, 27, 28, 29, 40], [13, 14, 27, 40, 7]], 10),
    "wide_k2": ([[2, 22, 33], [41 - 1, 1]], 25),
    "wide_k3": ([[2, 22, 33], [10, 11, 12, 13, 14, 15]], 20),
}


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    model = IISANRecModel(san=None, embedding_dim=DIM, max_seq_len=L,
                          num_attention_heads=2, transformer_block=2,
                          drop_rate=0.0, dtype=torch.float32, device="cpu",
                          generator=torch.Generator().manual_seed(3)).eval()
    table = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (ROWS, DIM)).astype(np.float32))
    path = tmp_path_factory.mktemp("shard") / "rec.npz"
    serve.Recommender(model, table, L).save(str(path))
    return path


@pytest.fixture(scope="module", params=[2, 3])
def world(request, artifact, tmp_path_factory):
    out = run_world("serve", request.param,
                    tmp_path_factory.mktemp(f"serve{request.param}"),
                    args={"artifact": str(artifact), "requests": REQUESTS})
    return request.param, out


@pytest.mark.parametrize("table", ["float32", "bfloat16", "int8"])
def test_sharded_matches_recommender(world, table):
    n, ranks = world
    per = -(-ROWS // n)
    for r, res in enumerate(ranks):
        got = res[table]
        assert got["rows_local"] == per and got["offset"] == r * per
        for label in REQUESTS:
            sharded, dense = got[label]
            assert sharded[0].shape == dense[0].shape
            tol = 1e-2 if table == "bfloat16" else 1e-5
            assert_same_topk(sharded, dense, tol=tol)
            hist = [set(s) for s in REQUESTS[label][0]]
            ids = sharded[0][np.isfinite(sharded[1])]
            assert ids.min() >= 1 and ids.max() < ROWS
            assert not any(set(row) & h for row, h in zip(sharded[0].tolist(), hist))
    for res in ranks[1:]:  # every rank answers the same
        for label in REQUESTS:
            np.testing.assert_array_equal(res[table][label][0][0],
                                          ranks[0][table][label][0][0])


def test_sharded_matches_the_jax_sharded_recommender(world, artifact):
    _, ranks = world
    jrec = jserve.Recommender.load(str(artifact))
    for table, rec in (("float32", jrec), ("int8", jrec.quantize_table())):
        jsh = jserve.ShardedRecommender(rec)
        for label, (seqs, k) in REQUESTS.items():
            ids, scores = jsh.top_k(seqs, k)
            assert_same_topk(ranks[0][table][label][0],
                             (np.asarray(ids), np.asarray(scores)))


def _write_input(path):
    seqs = [s for label in REQUESTS for s in REQUESTS[label][0]]
    path.write_text("".join(f"u{i}\t{' '.join(map(str, s))}\n"
                            for i, s in enumerate(seqs)))
    return seqs


def test_cli_shard_at_world_two(artifact, tmp_path):
    inp = tmp_path / "in.tsv"
    _write_input(inp)
    one, two = tmp_path / "one.tsv", tmp_path / "two.tsv"
    assert serve.main([str(artifact), "--input", str(inp), "--out", str(one),
                       "--k", "7", "--device", "cpu"]) == 0
    procs = start([sys.executable, "-m", "iisan_tpu_torch.serve", str(artifact),
                   "--shard", "--input", str(inp), "--out", str(two), "--k", "7",
                   "--batch", "4", "--device", "cpu"], 2, tmp_path / "logs")
    join(procs, tmp_path / "logs", 120)

    def parse(p):
        rows = [line.split("\t") for line in p.read_text().splitlines()]
        return ([r[0] for r in rows], np.array([list(map(int, r[1].split())) for r in rows]),
                np.array([list(map(float, r[2].split())) for r in rows]))

    (u1, i1, s1), (u2, i2, s2) = parse(one), parse(two)
    assert u1 == u2
    assert_same_topk((i2, s2), (i1, s1), tol=1e-4, atol=1e-5)


def _get(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_cli_shard_http_at_world_two(artifact, tmp_path):
    port = free_port()
    logs = tmp_path / "logs"
    procs = start([sys.executable, "-m", "iisan_tpu_torch.serve", str(artifact),
                   "--shard", "--http", f"127.0.0.1:{port}", "--device", "cpu"],
                  2, logs)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                health = _get(url + "/healthz")
                break
            except (urllib.error.URLError, ConnectionError):
                if time.monotonic() > deadline or any(p.poll() is not None
                                                      for p in procs):
                    raise AssertionError("the sharded server did not start:\n"
                                         + tail(logs, 2))
                time.sleep(0.5)
        assert health["catalog_items"] == ROWS - 1
        rec = serve.Recommender.load(str(artifact), device="cpu")
        for label, (seqs, k) in REQUESTS.items():
            if k >= ROWS - 1:
                continue
            body = _get(url + "/recommend", {"sequences": seqs, "k": k})
            ids, scores = rec.top_k(seqs, k)
            got = (np.array([[-1 if i is None else i for i in row]
                             for row in body["items"]]),
                   np.array([[-np.inf if s is None else s for s in row]
                             for row in body["scores"]]))
            assert_same_topk(got, (ids, scores))
    finally:
        procs[0].send_signal(signal.SIGINT)
    join(procs, logs, 60)
