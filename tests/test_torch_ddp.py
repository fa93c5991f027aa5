"""Training and evaluation on a mesh of gloo ranks against one process.

Worlds of 2 and 4 ranks (``tests/test_torch_ranks.py``, one launch each) train
the port's trainers on small configurations, dropout 0, fp32; the
references are the same trainers in this process without a mesh:

- cached: ``data:2``, ``data:4``, ``model:2``, ``data:2,model:2`` with an
  fp32 and an int8 table (``q`` split by feature columns, the scales
  whole), two epochs of four steps;
- uncached IISAN at ``data:2``: one epoch of two steps, each rank decoding
  only its users' images (at most half of a step's 20 item rows);
- the ID baseline at ``data:2``, two epochs.

Per-step losses within 1e-4 relative of world 1, ``san.fc_bert.kernel``
(the ID table) within 1e-4 relative and 1e-6 absolute, the same on every
rank; valid HR@10 / nDCG@10 of the sharded evaluation within 1e-5 relative
(before training, where the parameters are the reference's, and after).
The loss is the global batch's in-batch CE (``ops/losses.py``): each
rank's share over the global count of valid rows, its gradient summed
over the data axis.

Checkpoints: at ``data:2`` with dropout 0.1 only rank 0 writes, and every
rank resumes from the file: the resumed run ends bit-equal to the
uninterrupted one on each rank, each data rank with its own generator.
Dropout: the data ranks' generators draw different numbers; the model
ranks of one data rank draw the same.  And one check against the JAX
package: the port at ``data:2`` and the JAX ``CachedTrainer`` on a
``data:2`` mesh of two virtual CPU devices, from the same initial
parameters, give one epoch's step losses within 1e-4 relative.
"""

import jax
import numpy as np
import pytest

from iisan_tpu.config import IISANConfig as JaxConfig
from iisan_tpu.data.synthetic import synthetic_corpus as jax_corpus
from iisan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from iisan_tpu.train.cached import CachedTrainer as JaxTrainer
from iisan_tpu_torch.utils.jax_params import flatten_tree
from test_torch_ranks import (DIM, ITEMS, K, SMALL, USERS, cached_run, id_run,
                         run_world, synthetic_taps, uncached_run)

RTOL, ATOL, EVAL_RTOL = 1e-4, 1e-6, 1e-5


@pytest.fixture(scope="module")
def jax_data2(tmp_path_factory):
    """The JAX trainer on a data:2 mesh: its initial parameters (written
    for the ranks) and one epoch's step losses."""
    cfg = JaxConfig(**SMALL, fused_epoch_eval=False)
    corpus = jax_corpus(n_users=USERS, item_num=ITEMS, seed=3)
    jt = JaxTrainer(cfg, corpus, synthetic_taps(ITEMS, K, DIM, 1),
                    synthetic_taps(ITEMS, K, DIM, 2), mesh=jax_make_mesh("data:2"))
    path = tmp_path_factory.mktemp("jax") / "init.npz"
    init = jax.device_get(jt.params)
    np.savez(path, **flatten_tree(init, "/"))
    jt.run_epoch(1)
    return init, str(path), np.asarray(jt._last_step_losses)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, jax_data2):
    tmp = tmp_path_factory.mktemp("ddp2")
    return run_world("ddp2", 2, tmp / "out", args={
        "jax_params": jax_data2[1], "ckpt_dir": str(tmp / "ckpt")}, timeout=240)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world("ddp4", 4, tmp_path_factory.mktemp("ddp4"), timeout=240)


@pytest.fixture(scope="module")
def ref():
    """One process, no mesh."""
    return {"cached": cached_run(), "int8": cached_run(quant="int8"),
            "id": id_run(), "uncached": uncached_run()}


def _close(ranks, want):
    for got in ranks:
        assert len(got["losses"]) == len(want["losses"])
        for g, w in zip(got["losses"], want["losses"]):
            np.testing.assert_allclose(g, w, rtol=RTOL)
        np.testing.assert_allclose(got["means"], want["means"], rtol=RTOL)
        np.testing.assert_allclose(got["param"], want["param"], rtol=RTOL,
                                   atol=ATOL)
        for key in ("eval0", "eval"):
            if key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=EVAL_RTOL)
    for got in ranks[1:]:  # every rank holds the same model
        np.testing.assert_array_equal(got["param"], ranks[0]["param"])


@pytest.mark.parametrize("case", ["data2", "model2"])
def test_cached_world_of_two_matches_one_process(world2, ref, case):
    _close([r[case] for r in world2], ref["cached"])


def test_model_axis_splits_the_tap_columns(world2):
    assert all(r["model2_cols"] == (ITEMS + 1, K, DIM // 2) for r in world2)


def test_cached_data4_matches_one_process(world4, ref):
    _close([r["data4"] for r in world4], ref["cached"])


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_data_by_model_mesh_matches_one_process(world4, ref, quant):
    _close([r[quant] for r in world4], ref["int8" if quant == "int8" else "cached"])
    for r in world4:  # an int8 q takes the column split, its scales stay whole
        assert r[quant]["cols"] == (ITEMS + 1, K, DIM // 2)
        if quant == "int8":
            assert r[quant]["scale_shape"] == (ITEMS + 1, K, 1)


def test_uncached_data2_matches_one_process(world2, ref):
    _close([r["uncached"] for r in world2], ref["uncached"])
    want = ref["uncached"]
    for r in world2:
        got = r["uncached"]
        # each rank decodes only its users' rows (pads need no decode)
        assert got["decoded"] <= got["steps"] * got["rows_per_step"] // 2
    assert sum(r["uncached"]["decoded"] for r in world2) == want["decoded"]


def test_id_data2_matches_one_process(world2, ref):
    _close([r["id"] for r in world2], ref["id"])


def test_sharded_evaluation_matches_one_process(world2, world4, ref):
    want = ref["cached"]["eval0"]
    for r in [w["data2"] for w in world2] + [w["data4"] for w in world4]:
        np.testing.assert_allclose(r["eval0"], want, rtol=EVAL_RTOL)


def test_rank0_writes_checkpoints_and_every_rank_resumes(world2):
    a, b = world2
    assert a["writes"] == [1, 2] and b["writes"] == []
    for r in world2:
        np.testing.assert_array_equal(r["resumed_param"], r["straight_param"])
    np.testing.assert_array_equal(a["resumed_param"], b["resumed_param"])


def test_dropout_draws_differ_across_data_ranks(world2, world4):
    (i0, d0), (i1, d1) = (r["dropout"] for r in world2)
    assert (i0, i1) == (0, 1) and not np.array_equal(d0, d1)
    by_index = {}
    for r in world4:  # data:2,model:2: ranks 0, 1 are data 0; 2, 3 data 1
        index, draws = r["dropout"]
        by_index.setdefault(index, []).append(draws)
    assert sorted(by_index) == [0, 1]
    for draws in by_index.values():
        np.testing.assert_array_equal(draws[0], draws[1])
    assert not np.array_equal(by_index[0][0], by_index[1][0])


def test_data2_matches_the_jax_package_at_data2(world2, jax_data2):
    want = jax_data2[2]
    for r in world2:
        np.testing.assert_allclose(r["jax_init"]["losses"][0], want, rtol=RTOL)
