"""Port parity of the serving slice: item tables, evaluation, top-K, the
.npz artifact in both directions, the HTTP server and the batch CLI.

JAX and the port share perturbed weights (test_torch_model.build_pair),
a synthetic corpus of 16 users over 49 items, and synthetic taps.

Tolerances: fp32 1e-5 on tables and scores (summation order only);
bf16 5e-2 on the bf16 table (cast chain).  HR@10 / nDCG@10 agree to
1e-6 (the ranks are equal; only the float mean may differ in its last
bit).  Top-K ids are equal except where two scores tie within the
tolerance.
"""

import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iisan_tpu import serve as jax_serve
from iisan_tpu.data.synthetic import synthetic_corpus
from iisan_tpu.eval import evaluate as jax_eval
from iisan_tpu_torch import serve
from iisan_tpu_torch.eval.evaluate import (compute_item_tables, evaluate,
                                           stack_eval_batches)
from test_torch_model import ITEMS, build_pair, make_config, make_taps

SEQS = [[1, 5, 9], [2, 2, 7, 12, 3], list(range(1, 14)), [49], [30, 31, 32]]


def _tables(dtype="float32"):
    cfg = make_config(dtype)
    jm, params, tm = build_pair(cfg)
    cv, text = make_taps()
    want = jax_eval.compute_item_tables(jm, params, jnp.asarray(cv),
                                        jnp.asarray(text), chunk=16)
    got = compute_item_tables(tm, torch.tensor(cv).to(getattr(torch, dtype)),
                              torch.tensor(text).to(getattr(torch, dtype)),
                              chunk=16)
    return cfg, jm, params, tm, want, got


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
def test_compute_item_tables_matches_jax(dtype, tol):
    _, _, _, _, want, got = _tables(dtype)
    assert got.shape == (ITEMS + 1, 16) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_stack_eval_batches_wrap_pads():
    (a,), n = stack_eval_batches((np.arange(5),), 4)
    assert n == 5 and a.shape == (2, 4)
    assert a.flatten().tolist() == [0, 1, 2, 3, 4, 4, 4, 4]


def test_evaluate_matches_jax():
    cfg, jm, params, tm, want_table, got_table = _tables()
    c = synthetic_corpus(n_users=16, item_num=ITEMS, seed=0)
    split = (c.valid_tokens, c.valid_log_mask, c.valid_target, c.valid_history)
    want = jax_eval.evaluate(jm, params, want_table, *split, batch_size=8)
    got = evaluate(tm, got_table, *split, batch_size=8)
    # the port's evaluate on the JAX table isolates the ranking step
    same = evaluate(tm, torch.tensor(np.asarray(want_table)), *split,
                    batch_size=8)
    for g in (got, same):
        np.testing.assert_allclose(g, want, atol=1e-6)
    assert 0.0 <= got[0] <= 1.0 and 0.0 <= got[1] <= got[0]


def _assert_topk_equal(got, want, tol=1e-5):
    (gi, gs), (wi, ws) = got, want
    np.testing.assert_allclose(gs, ws, rtol=tol, atol=tol)
    for row in range(len(gi)):
        for j in np.flatnonzero(gi[row] != wi[row]):
            # ids differ only where two scores tie within the tolerance
            assert abs(gs[row, j] - ws[row, j]) <= tol
            assert np.isclose(gs[row], gs[row, j], atol=tol).sum() > 1


def _recommenders():
    cfg, jm, params, tm, want_table, got_table = _tables()
    jrec = jax_serve.Recommender(jm, params, want_table, cfg.max_seq_len)
    return jrec, serve.Recommender(tm, got_table, cfg.max_seq_len)


def test_top_k_matches_jax():
    jrec, rec = _recommenders()
    for k, exclude in ((5, True), (10, False)):
        got = rec.top_k(SEQS, k=k, exclude_history=exclude)
        _assert_topk_equal(got, jrec.top_k(SEQS, k=k, exclude_history=exclude))
        assert got[0].shape == (len(SEQS), k) and (got[0] > 0).all()
    ids, _ = rec.top_k([list(range(1, 40))], k=10)
    assert set(ids[0]) <= set(range(40, ITEMS + 1))  # history excluded


def test_artifact_loads_in_both_directions(tmp_path):
    jrec, rec = _recommenders()
    want = jrec.top_k(SEQS, k=7)

    jax_path = str(tmp_path / "from_jax.npz")
    jrec.save(jax_path)
    _assert_topk_equal(serve.Recommender.load(jax_path, device="cpu").top_k(SEQS, k=7), want)

    port_path = str(tmp_path / "from_port.npz")
    rec.save(port_path)
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert sorted(a.files) == sorted(b.files)
    _assert_topk_equal(jax_serve.Recommender.load(port_path).top_k(SEQS, k=7),
                       rec.top_k(SEQS, k=7))
    reloaded = serve.Recommender.load(port_path, device="cpu")
    np.testing.assert_array_equal(reloaded.top_k(SEQS, k=7)[0],
                                  rec.top_k(SEQS, k=7)[0])


def test_serve_http_matches_top_k():
    _, rec = _recommenders()
    server = serve.serve_http(rec, "127.0.0.1", 0, max_batch=8)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.load(r)["catalog_items"] == ITEMS
        body = json.dumps({"sequences": SEQS, "k": 6}).encode()
        req = urllib.request.Request(url + "/recommend", data=body)
        with urllib.request.urlopen(req, timeout=30) as r:
            got = json.load(r)
        want_ids, want_scores = rec.top_k(SEQS, k=6)
        assert got["items"] == want_ids.tolist()
        np.testing.assert_allclose(got["scores"], want_scores, rtol=1e-5)
        bad = urllib.request.Request(
            url + "/recommend", data=json.dumps({"sequences": [[0]]}).encode())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=30)
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_main_batch_file(tmp_path):
    _, rec = _recommenders()
    artifact = str(tmp_path / "rec.npz")
    rec.save(artifact)
    inp, out = tmp_path / "seqs.tsv", tmp_path / "recs.tsv"
    inp.write_text("".join(f"U{i}\t{' '.join(map(str, s))}\n"
                           for i, s in enumerate(SEQS)))
    assert serve.main([artifact, "--input", str(inp), "--out", str(out),
                       "--k", "4", "--batch", "2", "--device", "cpu"]) == 0
    rows = out.read_text().splitlines()
    want_ids, _ = rec.top_k(SEQS, k=4)
    assert len(rows) == len(SEQS)
    for row, ids in zip(rows, want_ids):
        user, id_str, _ = row.split("\t")
        assert [int(t) for t in id_str.split()] == ids.tolist()
