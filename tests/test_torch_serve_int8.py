"""int8 serving (``Recommender.quantize_table``, the ``table_q`` /
``table_scale`` artifact, ``--quant int8 --save-as``) against the JAX
package's.

One fp32 artifact (a random user encoder of 2 blocks, embedding 16, L=10,
and a random table of 300 rows) is loaded by both packages.  The port's
int8 rows and scales equal the JAX package's bit for bit (both quantise
in fp32 with the same division and rounding); ids equal the JAX
package's ``quantize_table().top_k`` up to ties, scores within 1e-5
relative and 1e-6 absolute (the products' summation order).  The port
serves a JAX-written int8 artifact and the JAX package a port-written
one; the command line's ``--quant int8 --save-as`` writes the same
artifact as ``quantize_table().save``; HTTP over the int8 table answers
as the direct call.  The int8 Recommender holds no fp32 copy of its table
(its table bytes are q's and the scales'), and scoring in row chunks
gives the one-product scores exactly.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from iisan_tpu import serve as jserve
from iisan_tpu_torch import serve
from iisan_tpu_torch.models.model import IISANRecModel
from test_torch_ranks import assert_same_topk

ROWS, DIM, L = 300, 16, 10
SEQS = [[1, 5, 9], [2, 2, 7, 12, 3], list(range(100, 113)), [299], [30, 31, 32],
        [150, 3, 280, 12]]


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    model = IISANRecModel(san=None, embedding_dim=DIM, max_seq_len=L,
                          num_attention_heads=2, transformer_block=2,
                          drop_rate=0.0, dtype=torch.float32, device="cpu",
                          generator=torch.Generator().manual_seed(0)).eval()
    table = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (ROWS, DIM)).astype(np.float32))
    path = tmp_path_factory.mktemp("int8") / "rec.npz"
    serve.Recommender(model, table, L).save(str(path))
    return path


def _top(rec, k=10, **kw):
    return tuple(np.asarray(a) for a in rec.top_k(SEQS, k=k, **kw))


def test_quantized_table_equals_jax(artifact):
    got = serve.Recommender.load(str(artifact), device="cpu").quantize_table()
    want = jserve.Recommender.load(str(artifact)).quantize_table()
    assert got.quant and got.fused_table.q.dtype == torch.int8
    np.testing.assert_array_equal(got.fused_table.q.numpy(),
                                  np.asarray(want.fused_table.q))
    np.testing.assert_array_equal(got.fused_table.scale.numpy(),
                                  np.asarray(want.fused_table.scale))
    for k, exclude in ((10, True), (25, False)):
        assert_same_topk(_top(got, k, exclude_history=exclude),
                         _top(want, k, exclude_history=exclude))
    assert got.quantize_table() is got


def test_artifacts_cross_both_ways(artifact, tmp_path):
    jq = jserve.Recommender.load(str(artifact)).quantize_table()
    jpath = tmp_path / "jax_int8.npz"
    jq.save(str(jpath))
    port = serve.Recommender.load(str(jpath), device="cpu")
    assert port.quant
    assert_same_topk(_top(port), _top(jq))
    ppath = tmp_path / "port_int8.npz"
    port.save(str(ppath))
    with np.load(jpath) as a, np.load(ppath) as b:
        assert sorted(a.files) == sorted(b.files) and "fused_table" not in b.files
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    back = jserve.Recommender.load(str(ppath))
    assert_same_topk(_top(back), _top(port))


def test_cli_quant_save_as(artifact, tmp_path, capsys):
    out = tmp_path / "small.npz"
    assert serve.main([str(artifact), "--quant", "int8", "--save-as", str(out),
                       "--device", "cpu"]) == 0
    assert "quant=int8" in capsys.readouterr().out
    direct = tmp_path / "direct.npz"
    serve.Recommender.load(str(artifact), device="cpu").quantize_table().save(
        str(direct))
    with np.load(out) as a, np.load(direct) as b:
        for key in b.files:
            np.testing.assert_array_equal(a[key], b[key])
        assert a["table_q"].nbytes + a["table_scale"].nbytes < \
            ROWS * DIM * 4 // 2
    # the batch command line over the int8 artifact
    inp, recs = tmp_path / "in.tsv", tmp_path / "recs.tsv"
    inp.write_text("".join(f"u{i}\t{' '.join(map(str, s))}\n"
                           for i, s in enumerate(SEQS)))
    assert serve.main([str(out), "--input", str(inp), "--out", str(recs),
                       "--k", "5", "--device", "cpu"]) == 0
    rec = serve.Recommender.load(str(out), device="cpu")
    ids, _ = rec.top_k(SEQS, k=5)
    rows = [line.split("\t") for line in recs.read_text().splitlines()]
    assert [list(map(int, r[1].split())) for r in rows] == ids.tolist()


def test_http_over_the_int8_table(artifact):
    rec = serve.Recommender.load(str(artifact), device="cpu").quantize_table()
    server = serve.serve_http(rec, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["catalog_items"] == ROWS - 1
        req = urllib.request.Request(
            url + "/recommend", data=json.dumps({"sequences": SEQS, "k": 7}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            body = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    ids, scores = rec.top_k(SEQS, k=7)
    assert body["items"] == ids.tolist()
    np.testing.assert_allclose(body["scores"], scores, rtol=1e-6)


def test_int8_recommender_keeps_no_fp32_table(artifact, monkeypatch):
    dense = serve.Recommender.load(str(artifact), device="cpu")
    rec = dense.quantize_table()
    assert rec._table32 is None
    assert rec.table_bytes == ROWS * DIM + ROWS * 4
    assert dense.table_bytes == ROWS * DIM * 4  # fp32: the table is its copy
    whole = _top(rec, 20)
    monkeypatch.setattr(serve, "SCORE_CHUNK", 64)  # five chunks, the last ragged
    np.testing.assert_array_equal(_top(rec, 20)[0], whole[0])
    np.testing.assert_array_equal(_top(rec, 20)[1], whole[1])
    prec = torch.randn(3, DIM)
    t = rec.fused_table
    want = (prec @ t.q[:, 0, :].float().T) * t.scale[:, 0, 0][None, :]
    torch.testing.assert_close(serve._score_catalog(prec, t), want, rtol=0, atol=0)
