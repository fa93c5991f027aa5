"""The port's parallel layer (``iisan_tpu_torch/parallel``) against the JAX
package's ``iisan_tpu/parallel`` on the conftest's 8-device virtual CPU
mesh, and on a world of two gloo ranks (``tests/test_torch_ranks.py``).

The layout of ``make_mesh(spec)`` (each rank's coordinates and the ranks
along each of its axes) must be the JAX mesh's device layout, rank r for
device r; ``pad_to_multiple`` and ``host_shard`` the JAX functions; a data
axis's ``owned_rows`` the rows JAX's batch sharding puts on each device.
On the two ranks: the axis groups (an all-reduce along each axis sums the
ranks on it), the differentiable all-gather (forward the ranks' rows in
order, backward the sum over ranks of the gradients flowing into this
rank's rows, exactly in float64), the column gather, and the gradient sum
after a broadcast of the parameters.
"""

import jax
import numpy as np
import pytest
import torch

from iisan_tpu.parallel import distributed as jdist
from iisan_tpu.parallel import mesh as jmesh
from iisan_tpu_torch.parallel import distributed as tdist
from iisan_tpu_torch.parallel import mesh as tmesh
from test_torch_ranks import run_world

SPECS = ["", "data:8", "data:4,model:2", "data:2,model:4", "model:8",
         "data:2,model:2,replica:2"]


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_layout_matches_jax(spec):
    jm = jmesh.make_mesh(spec)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    order = [d.id for d in jax.devices()]
    assert sorted(order) == order  # device r is the JAX list's r-th
    for r in range(8):
        names, sizes, coords, lines = tmesh.mesh_layout(spec, 8, r)
        assert tuple(names) == jm.axis_names and tuple(sizes) == ids.shape
        assert ids[coords] == r
        for i in range(len(sizes)):
            at = list(coords)
            at[i] = slice(None)
            assert lines[i] == tuple(ids[tuple(at)].tolist())


@pytest.mark.parametrize("spec", ["data:3", "data:2,model:2", "data:x",
                                  "data", "data:2,data:4"])
def test_mesh_layout_refuses_what_cannot_hold_the_world(spec):
    with pytest.raises(ValueError):
        tmesh.mesh_layout(spec, 8, 0)


def test_pad_to_multiple_and_host_shard_match_jax():
    for n, m in [(0, 4), (1, 4), (7, 4), (8, 4), (41, 3), (5, 1)]:
        assert tmesh.pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)
    for n in (1, 7, 11, 16):
        for pc in (1, 2, 3, 8):
            for pi in range(pc):
                np.testing.assert_array_equal(tdist.host_shard(n, pi, pc),
                                              jdist.host_shard(n, pi, pc))
    np.testing.assert_array_equal(tdist.host_shard(5), np.arange(5))


@pytest.mark.parametrize("spec", ["data:8", "data:4,model:2"])
def test_owned_rows_match_jax_batch_sharding(spec):
    jm = jmesh.make_mesh(spec)
    n = 24
    index = jmesh.data_sharding(jm, 1).devices_indices_map((n,))
    for r in range(8):
        names, sizes, coords, lines = tmesh.mesh_layout(spec, 8, r)
        i = names.index("data")
        axis = tmesh.Axis("data", sizes[i], coords[i], lines[i], group="probe")
        want = np.arange(n)[index[jax.devices()[r]][0]]
        np.testing.assert_array_equal(tdist.owned_rows(n, axis), want)
    # a batch that does not divide the axis is replicated (the JAX
    # uncached trainer's fallback)
    axis = tmesh.Axis("data", 8, 3, tuple(range(8)), group="probe")
    np.testing.assert_array_equal(tdist.owned_rows(20, axis), np.arange(20))


def test_one_process_mesh_communicates_nothing():
    m = tmesh.make_mesh("data:1,model:1")
    assert m.world == 1 and m.shape == {"data": 1, "model": 1}
    axis = m.axis("data")
    assert axis.group is None and not axis.splits(16)
    assert m.axis("absent").size == 1
    x = torch.randn(3, 2)
    assert tdist.all_gather_rows(x, axis) is x
    assert tdist.all_gather_columns(x, axis) is x
    assert tdist.all_reduce_sum(x, axis) is x
    with pytest.raises(ValueError, match="holds 2 ranks but the world has 1"):
        tmesh.make_mesh("data:2")


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world("parallel", 2, tmp_path_factory.mktemp("parallel"))


def test_world_of_two_meshes(world2):
    for r, res in enumerate(world2):
        meshes = res["meshes"]
        assert meshes[""][0] == [("data", 2, r, (0, 1))]
        assert meshes["data:2,model:1"][0] == [("data", 2, r, (0, 1)),
                                               ("model", 1, 0, (r,))]
        assert meshes["data:1,model:2"][0] == [("data", 1, 0, (r,)),
                                               ("model", 2, r, (0, 1))]
        # an all-reduce of the rank along an axis sums the ranks on it
        assert meshes["data:2,model:1"][1] == {"data": 1.0, "model": float(r)}
        assert meshes["model:2"][1] == {"model": 1.0}
        assert res["owned"] == list(range(6 * r, 6 * r + 6))
        assert res["owned_ragged"] == list(range(7))
        assert res["host_shard"] == [list(range(6)), [6, 7, 8, 9, 10, 10]][r]


def test_differentiable_all_gather(world2):
    xs = [res["x"] for res in world2]
    for r, res in enumerate(world2):
        np.testing.assert_array_equal(res["y"], np.concatenate(xs))
        # d/dx_r of sum_q <y, w_q> = sum over ranks of w_q's rows of rank r
        want = sum(q["w"][3 * r:3 * r + 3] for q in world2)
        np.testing.assert_allclose(res["grad"], want, rtol=1e-12, atol=0)
        np.testing.assert_array_equal(res["columns"],
                                      np.array([[0.0] * 3 + [1.0] * 3] * 2))


def test_gradient_sum_after_broadcast(world2):
    a, b = world2
    for n in a["linear"]:
        np.testing.assert_array_equal(a["linear"][n], b["linear"][n])
        np.testing.assert_array_equal(a["linear_grads"][n], b["linear_grads"][n])
    # the inputs were 1 and 2 on the two ranks: the weight gradient sums them
    np.testing.assert_allclose(a["linear_grads"]["weight"], np.full((2, 4), 3.0))
    np.testing.assert_allclose(a["linear_grads"]["bias"], np.full(2, 2.0))
