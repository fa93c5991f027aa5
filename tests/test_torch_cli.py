"""The port's command line (``iisan_tpu_torch/cli.py``) against the JAX one.

- ``build_parser`` takes exactly the JAX parser's options, plus
  ``--device``;
- ``parse_config`` gives the JAX package's configuration, field by field,
  on tests/test_pipelines.py's reference command and on ``--use_scale
  None`` (fp32 activations), and with an explicit ``--compute_dtype``;
- the one intended difference: ``--remat_towers mlp`` and
  ``--fused_tower_attention subblock`` keep their strings (the JAX parser
  reads them as False), and true / false still read as bools;
- every ``validate_config`` refusal of tests/test_flag_semantics.py raises
  ``ValueError`` in both packages, and the port refuses meshes and
  multi-host settings;
- ``python -m iisan_tpu_torch.cli`` trains the ID pipeline on the CPU
  (``--device cpu``) from a TSV dataset, writes checkpoints and an
  artifact, resumes, and tests a checkpoint with ``--mode test``; without
  ``--device`` it asks for a CUDA card.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from iisan_tpu import cli as jcli
from iisan_tpu.config import IISANConfig as JaxConfig
from iisan_tpu.train import pipelines as jpipe
from iisan_tpu_torch import cli as tcli
from iisan_tpu_torch.config import IISANConfig
from iisan_tpu_torch.train import pipelines as tpipe

REPO = Path(__file__).resolve().parents[1]

REFERENCE_COMMAND = [
    "--mode", "train", "--item_tower", "modal", "--batch_size", "64",
    "--lr", "2e-4", "--embedding_dim", "64",
    "--side_adapter_vit_list", "1,3,5,7,9,11",
    "--side_adapter_bert_list", "1,3,5,7,9,11",
    "--fusion_method", "gated", "--modality", "intra_inter",
    "--stored_vector_path", "vectors", "--seed", "12345",
    "--adapter_cv_lr", "1e-4", "--bert_adapter_down_size", "64",
    "--remove_first", "None", "--adding_adapter_to", "all",
    "--fine_tune_to", "None", "--adapter_type", "IISAN",
    "--cached_text_model", "llama70b_GPTQ_embeddings",
    "--text_embedding_dim", "8192", "--text_layers", "80",
]


def options(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_parser_takes_the_jax_flags_and_device():
    ours, theirs = options(tcli.build_parser()), options(jcli.build_parser())
    assert ours == theirs | {"--device"}
    assert not tcli.build_parser().allow_abbrev


@pytest.mark.parametrize("argv", [
    REFERENCE_COMMAND,
    ["--use_scale", "None"],
    ["--use_scale", "None", "--compute_dtype", "bfloat16"],
    ["--bert_model_load", "bert_large_uncased", "--news_attributes",
     "title,abstract", "--k_adapter_bert_list", "1,5", "--use_pallas", "true",
     "--save_checkpoints", "False"],
])
def test_parse_config_gives_the_jax_config(argv):
    ours, theirs = tcli.parse_config(argv), jcli.parse_config(argv)
    for f in dataclasses.fields(JaxConfig):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.san_text_taps() == theirs.san_text_taps()


def test_bool_or_string_flags_keep_their_strings():
    cfg = tcli.parse_config(["--remat_towers", "mlp",
                             "--fused_tower_attention", "subblock"])
    assert cfg.remat_towers == "mlp"
    assert cfg.fused_tower_attention == "subblock"
    assert tcli.parse_config(["--fused_tower_attention", "subblock_v2"]
                             ).fused_tower_attention == "subblock_v2"
    # the JAX parser reads both as False (the port parses them as above)
    jax_cfg = jcli.parse_config(["--remat_towers", "mlp",
                                 "--fused_tower_attention", "subblock"])
    assert jax_cfg.remat_towers is False
    assert jax_cfg.fused_tower_attention is False
    for text, value in (("true", True), ("False", False), ("1", True)):
        cfg = tcli.parse_config(["--remat_towers", text,
                                 "--fused_tower_attention", text])
        assert cfg.remat_towers is value and cfg.fused_tower_attention is value


FLAG_CASE = dict(
    batch_size=8, epoch=1, embedding_dim=16, word_embedding_dim=32,
    image_embedding_dim=32, text_layers=2, image_layers=2, CV_resize=16,
    num_words_title=6, side_adapter_vit_list="0,1",
    side_adapter_bert_list="0,1", bert_adapter_down_size=8,
    cv_adapter_down_size=8, adapter_type="IISAN", adding_adapter_to="all",
    compute_dtype="float32", max_seq_len=4, min_seq_len=3)


@pytest.mark.parametrize("kw,match", [
    (dict(item_tower="bogus"), "item_tower"),
    (dict(adapter_type="houslby", is_serial="None"), "is_serial"),
    (dict(use_scale="fp64"), "use_scale"),
    (dict(fine_tune_to="bogus"), "fine_tune_to"),
    (dict(fine_tune_to="None", adapter_type="fft", adding_adapter_to="None"),
     "freezes"),
    (dict(CV_model_load="resnet50"), "CV_model_load"),
    (dict(cache_quant="int4"), "cache_quant"),
    (dict(cache_quant="int8", pipeline="uncached"), "cache_quant"),
    (dict(remat_towers="attention"), "remat_towers"),
    (dict(dropout_prng="bogus"), "dropout_prng"),
    (dict(dropout_prng="unsafe_rbg"), "dropout_prng"),
])
def test_validate_config_refuses_what_jax_refuses(kw, match):
    for pkg, config in ((jpipe, JaxConfig), (tpipe, IISANConfig)):
        with pytest.raises(ValueError, match=match):
            pkg.validate_config(config(**{**FLAG_CASE, **kw}))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(adapter_type="IISAN", is_serial="None"),
    dict(fine_tune_to="None", item_tower="id", adapter_type="fft",
         adding_adapter_to="None"),
    dict(CV_model_load="resnet50", item_tower="id"),
    dict(dropout_prng="rbg"),
    dict(cache_quant="int8"),
])
def test_validate_config_accepts_what_jax_accepts(kw):
    for pkg, config in ((jpipe, JaxConfig), (tpipe, IISANConfig)):
        pkg.validate_config(config(**{**FLAG_CASE, **kw}))
        assert tpipe.effective_pipeline(IISANConfig(**{**FLAG_CASE, **kw})) == \
            jpipe.effective_pipeline(JaxConfig(**{**FLAG_CASE, **kw}))


@pytest.mark.parametrize("kw, match", [
    (dict(mesh_shape="data:8"), "holds 8 ranks but the run has 1"),
    (dict(mesh_shape="data"), "each axis is 'name:size'"),
    (dict(dist_num_processes=2), "needs dist_coordinator"),
    (dict(dist_num_processes=2, dist_coordinator="localhost:1234",
          dist_process_id=2), "is not a rank of")])
def test_validate_config_refuses_meshes(kw, match):
    """Meshes are ported: what is refused is a mesh the run's world cannot
    hold (one process here) or a malformed one, and a multi-process run
    without its coordinator or with a rank outside it, where the JAX
    package's make_mesh / jax.distributed.initialize fail too."""
    with pytest.raises(ValueError, match=match):
        tpipe.validate_config(IISANConfig(**{**FLAG_CASE, **kw}))
    with pytest.raises(ValueError, match=match):
        tcli.parse_config([f"--{k}={v}" for k, v in kw.items()])


@pytest.mark.parametrize("kw", [
    dict(mesh_shape="data:1"), dict(mesh_shape="data:1,model:1"),
    dict(dist_coordinator="localhost:1234"), dict(dist_process_id=0)])
def test_validate_config_accepts_meshes_of_the_world(kw):
    tpipe.validate_config(IISANConfig(**{**FLAG_CASE, **kw}))
    cfg = tcli.parse_config([f"--{k}={v}" for k, v in kw.items()])
    assert all(getattr(cfg, k) == v for k, v in kw.items())


def write_dataset(root):
    rng = np.random.default_rng(0)
    with open(root / "items.tsv", "w") as f:
        for i in range(30):
            f.write(f"I{i:04d}\tTitle of item {i}\n")
    with open(root / "users.tsv", "w") as f:
        for u in range(15):
            seq = " ".join(f"I{int(x):04d}" for x in
                           rng.integers(0, 30, size=int(rng.integers(5, 12))))
            f.write(f"U{u}\t{seq}\n")


def run_cli(*args, device=("--device", "cpu")):
    proc = subprocess.run(
        [sys.executable, "-m", "iisan_tpu_torch.cli", *args, *device],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    return proc.returncode, proc.stderr


def test_module_entry_point_trains_resumes_and_tests(tmp_path):
    from iisan_tpu_torch.serve import Recommender
    from iisan_tpu_torch.utils.checkpoint import latest_checkpoint

    write_dataset(tmp_path)
    common = ["--item_tower", "id", "--root_data_dir", str(tmp_path),
              "--dataset", "", "--behaviors", "users.tsv", "--news",
              "items.tsv", "--batch_size", "8", "--embedding_dim", "16",
              "--eval_batch_size", "16", "--use_scale", "None",
              "--ckpt_dir", str(tmp_path / "ckpt"),
              "--log_dir", str(tmp_path / "logs")]
    rc, err = run_cli(*common, "--epoch", "2", "--export_recommender",
                      str(tmp_path / "rec.npz"))
    assert rc == 0, err
    latest = latest_checkpoint(str(tmp_path / "ckpt"))
    assert latest is not None
    assert (tmp_path / "ckpt" / latest / "state.pt").is_file()
    assert "kernel launches" in err and "test Hit10" in err
    rec = Recommender.load(str(tmp_path / "rec.npz"), device="cpu")
    ids, _ = rec.top_k([[1, 2, 3]], k=5)
    assert ids.shape == (1, 5)

    rc, err = run_cli(*common, "--epoch", "1", "--load_ckpt_name", latest)
    assert rc == 0, err
    saved = int(latest.split("-")[1])
    assert f"epoch {saved + 1} loss" in err

    rc, err = run_cli(*common, "--mode", "test", "--load_ckpt_name", latest)
    assert rc == 0, err
    assert "test_results" in err


def test_cli_asks_for_a_card_without_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    write_dataset(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--item_tower", "id", "--root_data_dir", str(tmp_path),
                   "--dataset", "", "--behaviors", "users.tsv",
                   "--log_dir", str(tmp_path / "logs")])
    assert os.listdir(tmp_path / "logs")
