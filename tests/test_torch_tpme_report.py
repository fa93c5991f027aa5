"""The port's TPME report (``tools/tpme_single.py``, ``tools/tpme_report.py``)
against the JAX package's.

- Trainable parameters: for each of the six methods, the port's trainer
  built from ``tpme_single``'s config at a small width (towers of 2 layers
  x 128, as the uncached parity tests use; cached taps 128 wide) counts
  as many as the JAX package's trainer from the same config; the cached
  method at full width counts 4,113,877, ``TPME.json``'s.
- ``measure_cached`` and ``measure_uncached("lora")`` on the CPU at a tiny
  size give a record whose keys are the JAX record's (``TPME.json``) plus
  ``device`` and ``launches``.
- The report, with each method's process replaced by a stub that prints
  ``TPME.json``'s record of its method (or fails as told): its scores are
  the JAX ``tpme_scores`` of the same records; a process that runs out of
  device memory runs once more, in a new process, with ``--remat``, and
  no more; any other failure ends the report with 1 (no retry) unless
  ``--merge`` has an earlier record; ``--merge`` reads only the port's
  files; ``TPME.json`` and ``TPME_partial.json`` are never opened.
"""

import io
import json
import math
from pathlib import Path

import numpy as np
import pytest

from iisan_tpu.config import IISANConfig as JaxConfig
from iisan_tpu.train.cached import CachedTrainer as JaxCached
from iisan_tpu.train.uncached import UncachedTrainer as JaxUncached
from iisan_tpu.utils import tpme as jax_tpme
from iisan_tpu_torch.data.images import SyntheticImageStore
from iisan_tpu_torch.data.synthetic import synthetic_corpus, synthetic_taps
from iisan_tpu_torch.tools import tpme_report, tpme_single
from iisan_tpu_torch.train.cached import CachedTrainer
from iisan_tpu_torch.train.uncached import UncachedTrainer
from iisan_tpu_torch.utils.tpme import trainable_param_count

REPO = Path(__file__).resolve().parents[1]
TPME_JSON = json.loads((REPO / "TPME.json").read_text())
JAX_RECORDS = {r["label"]: r for r in TPME_JSON["records"]}

ITEMS, WORDS, IMAGE = 20, 6, 32
SMALL_TOWERS = dict(word_embedding_dim=128, image_embedding_dim=128,
                    text_layers=2, image_layers=2, CV_resize=IMAGE,
                    num_words_title=WORDS, max_seq_len=4,
                    compute_dtype="float32", side_adapter_vit_list="0,1",
                    side_adapter_bert_list="0,1", num_workers=2)
SMALL_CACHED = dict(word_embedding_dim=128, image_embedding_dim=128,
                    max_seq_len=4, compute_dtype="float32")


def _jax_config(cfg):
    fields = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    return JaxConfig(**{**fields, "mesh_shape": "data:1"})


def _cached_pair(**overrides):
    cfg = tpme_single.cached_config(**overrides)
    corpus = synthetic_corpus(n_users=8, item_num=ITEMS,
                              max_seq_len=cfg.max_seq_len, seed=0)
    taps = [synthetic_taps(ITEMS, len(cfg.san_image_taps()),
                           cfg.image_embedding_dim, seed=1),
            synthetic_taps(ITEMS, len(cfg.san_text_taps()),
                           cfg.word_embedding_dim, seed=2)]
    return (CachedTrainer(cfg, corpus, *taps, device="cpu"),
            lambda: JaxCached(_jax_config(cfg), corpus, *taps))


@pytest.mark.parametrize("method", tpme_single.METHODS)
def test_trainable_params_match_jax_at_a_small_width(method):
    if method == "iisan_cached":
        port, make_jax = _cached_pair(**SMALL_CACHED)
        jax_tr = make_jax()
    else:
        cfg = tpme_single.uncached_config(method, **SMALL_TOWERS)
        corpus = synthetic_corpus(n_users=8, item_num=ITEMS,
                                  max_seq_len=cfg.max_seq_len, seed=0)
        tokens = tpme_single.token_table(ITEMS, WORDS)
        store = SyntheticImageStore(IMAGE)
        port = UncachedTrainer(cfg, corpus, tokens, store, device="cpu")
        jax_tr = JaxUncached(_jax_config(cfg), corpus, tokens, store)
    n = trainable_param_count(port)
    assert n == jax_tpme.trainable_param_count(jax_tr)
    assert n > 0


def test_cached_trainable_params_at_full_width():
    port, _ = _cached_pair()
    assert trainable_param_count(port) == 4_113_877
    assert JAX_RECORDS["iisan_cached"]["trainable_params"] == 4_113_877


def test_token_table_is_the_jax_scripts():
    tokens = tpme_single.token_table(600, 30)
    rng = np.random.default_rng(0)  # scripts/tpme_single.py:115-118
    want = np.zeros((601, 60), np.int32)
    want[1:, :30] = rng.integers(1, 30000, size=(600, 30))
    want[1:, 30:] = 1
    np.testing.assert_array_equal(tokens, want)


def _check_record(rec, label):
    assert set(rec) == set(JAX_RECORDS[label]) | {"device", "launches"}
    assert rec["label"] == label and rec["device"] == "cpu"
    assert rec["memory_bytes"] is None  # no device memory reading on the CPU
    assert rec["trainable_params"] > 0
    assert set(rec["launches"]) >= {"user_encoder_fwd", "user_encoder_bwd",
                                    "mha_fwd", "mha_bwd"}
    for key, value in rec.items():
        if isinstance(value, float):
            assert math.isfinite(value) and value >= 0, key
    json.dumps(rec)


def test_measure_cached_record():
    rec = tpme_single.measure_cached(device="cpu", n_users=64, item_num=50,
                                     timed_epochs=2, word_embedding_dim=32,
                                     image_embedding_dim=32,
                                     compute_dtype="float32")
    _check_record(rec, "iisan_cached")
    assert rec["batch_size"] == 64


def test_measure_uncached_record():
    rec = tpme_single.measure_uncached("lora", device="cpu", n_users=8,
                                       item_num=ITEMS, bench_steps=1,
                                       **SMALL_TOWERS)
    _check_record(rec, "lora")
    assert rec["batch_size"] == 32 and rec["remat_towers"] is False
    assert rec["e2e_measured_users"] == 8 and rec["e2e_image_store"] == "synthetic"
    assert rec["epoch_seconds"] == pytest.approx(rec["step_seconds"] * 378)
    assert rec["epoch_seconds_e2e"] == pytest.approx(
        rec["e2e_measured_seconds"] * 12076 / 8)


# --- the report, each method's process a stub ---------------------------

STUB = r'''
import json, os, sys
method, flags = sys.argv[1], sys.argv[2:]
with open(os.environ["TPME_STUB_LOG"], "a") as f:
    f.write(json.dumps({"pid": os.getpid(), "argv": sys.argv[1:]}) + "\n")
mode = json.loads(os.environ.get("TPME_STUB_MODES", "{}")).get(method)
if mode == "oom" or (mode == "oom_always"):
    if mode == "oom_always" or "--remat" not in flags:
        print("torch.OutOfMemoryError: CUDA out of memory. Tried to allocate "
              "2.00 GiB", file=sys.stderr)
        sys.exit(1)
if mode == "fail":
    print("RuntimeError: something else broke", file=sys.stderr)
    sys.exit(1)
rec = dict(json.loads(os.environ["TPME_STUB_RECORDS"])[method])
rec["remat_towers"] = "--remat" in flags
rec["device"] = "stub"
print("a line of other output")
print(json.dumps(rec))
'''


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """The child command, its invocation log and a runner of the report
    from ``tmp_path`` (also the working directory)."""
    script = tmp_path / "stub_child.py"
    script.write_text(STUB)
    log = tmp_path / "calls.jsonl"
    monkeypatch.setenv("TPME_STUB_LOG", str(log))
    monkeypatch.setenv("TPME_STUB_RECORDS", json.dumps(JAX_RECORDS))
    monkeypatch.chdir(tmp_path)

    def run(*argv, modes=None):
        monkeypatch.setenv("TPME_STUB_MODES", json.dumps(modes or {}))
        log.write_text("")
        code = tpme_report.main(list(argv), child=(tpme_report.sys.executable,
                                                   str(script)))
        calls = [json.loads(line) for line in log.read_text().splitlines()]
        return code, calls

    return run


def _written(path):
    return json.loads(Path(path).read_text())


def test_report_scores_are_jax_tpme_scores(stub, tmp_path, capsys):
    code, calls = stub("--out", "out", "--users", "64", "--device", "cpu",
                       "--lmdb", "images.lmdb")
    assert code == 0
    assert [c["argv"][0] for c in calls] == list(tpme_single.METHODS)
    for c in calls:
        assert c["argv"][1:] == ["--users", "64", "--lmdb",
                                 str(tmp_path / "images.lmdb"), "--device", "cpu"]
    out = _written(tmp_path / "out" / "TPME_torch.json")
    assert set(out) == {"alpha", "records", "tpme"}
    assert out["alpha"] == list(jax_tpme.ALPHA)
    runs = [jax_tpme.RunRecord(r["label"], r["epoch_seconds"],
                               r["trainable_params"], r["memory_bytes"])
            for r in out["records"]]
    want = jax_tpme.tpme_scores(runs)
    assert out["tpme"].keys() == want.keys()
    for label, score in want.items():
        assert out["tpme"][label] == pytest.approx(score, rel=1e-12, abs=1e-15)
        assert out["tpme"][label] == pytest.approx(TPME_JSON["tpme"][label])
    partial = _written(tmp_path / "out" / "TPME_torch_partial.json")
    assert [r["label"] for r in partial] == list(tpme_single.METHODS)
    table = capsys.readouterr().out
    order = sorted(want, key=want.get)
    rows = [line.split()[0] for line in table.splitlines()
            if line.split() and line.split()[0] in want]
    assert rows[-len(order):] == order
    assert "device: stub" in table


def test_out_of_memory_retries_once_with_remat(stub, tmp_path, capsys):
    code, calls = stub("fft", "lora", modes={"fft": "oom"})
    assert code == 0
    assert [c["argv"] for c in calls] == [["fft"], ["fft", "--remat"], ["lora"]]
    assert calls[0]["pid"] != calls[1]["pid"]
    records = {r["label"]: r for r in _written("TPME_torch.json")["records"]}
    assert records["fft"]["remat_towers"] is True
    assert records["lora"]["remat_towers"] is False
    assert "fft" in capsys.readouterr().out

    code, calls = stub("fft", modes={"fft": "oom_always"})
    assert code == 1
    assert [c["argv"] for c in calls] == [["fft"], ["fft", "--remat"]]


def test_other_failures_end_the_report(stub, tmp_path):
    code, calls = stub("iisan_cached", "lora", "bitfit", modes={"lora": "fail"})
    assert code == 1
    assert [c["argv"] for c in calls] == [["iisan_cached"], ["lora"]]
    assert not (tmp_path / "TPME_torch.json").exists()
    assert [r["label"] for r in _written("TPME_torch_partial.json")] == ["iisan_cached"]


def test_merge_reads_only_the_ports_files(stub, tmp_path, monkeypatch):
    foreign = {"alpha": [0.45, 0.1, 0.45],
               "records": [dict(JAX_RECORDS[m], epoch_seconds=1e9)
                           for m in tpme_single.METHODS],
               "tpme": {}}
    for name in ("TPME.json", "TPME_partial.json"):
        (tmp_path / name).write_text(json.dumps(foreign))
    before = {name: ((tmp_path / name).read_bytes(),
                     (tmp_path / name).stat().st_mtime_ns)
              for name in ("TPME.json", "TPME_partial.json")}
    prior = [dict(JAX_RECORDS[m], epoch_seconds=100.0 + i)
             for i, m in enumerate(tpme_single.METHODS)]
    (tmp_path / "TPME_torch.json").write_text(json.dumps(
        {"alpha": [0.45, 0.1, 0.45], "records": prior, "tpme": {}}))
    (tmp_path / "TPME_torch_partial.json").write_text(json.dumps(
        [dict(JAX_RECORDS["lora"], epoch_seconds=7.0)]))

    opened = []
    real_open = io.open

    def spy(file, mode="r", *args, **kw):
        opened.append((Path(file).name if isinstance(file, (str, Path))
                       else file, mode))
        return real_open(file, mode, *args, **kw)

    monkeypatch.setattr(io, "open", spy)
    monkeypatch.setattr("builtins.open", spy)
    code, calls = stub("fft", "bitfit", "--merge", modes={"bitfit": "fail"})
    monkeypatch.undo()
    assert code == 0
    assert [c["argv"] for c in calls] == [["fft"], ["bitfit"]]
    records = {r["label"]: r for r in _written(tmp_path / "TPME_torch.json")["records"]}
    assert set(records) == set(tpme_single.METHODS)
    assert records["fft"]["epoch_seconds"] == JAX_RECORDS["fft"]["epoch_seconds"]
    assert records["fft"]["device"] == "stub"  # measured now
    assert records["lora"]["epoch_seconds"] == 7.0  # the partial file wins
    assert records["bitfit"]["epoch_seconds"] == 105.0  # kept after its failure
    assert records["iisan_cached"]["epoch_seconds"] == 100.0
    assert all(r["epoch_seconds"] != 1e9 for r in records.values())
    names = {name for name, _ in opened if isinstance(name, str)}
    assert "TPME_torch.json" in names
    assert not names & {"TPME.json", "TPME_partial.json"}
    for name, state in before.items():
        assert ((tmp_path / name).read_bytes(),
                (tmp_path / name).stat().st_mtime_ns) == state


def test_report_refuses_unknown_methods(stub):
    with pytest.raises(SystemExit):
        stub("qlora")
