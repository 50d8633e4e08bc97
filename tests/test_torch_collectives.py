"""The port's hierarchical cross-pod reduction
(``repro_torch.distributed.collectives``) on four gloo ranks on the CPU.

``hierarchical_psum`` on a (pod 2, data 2, model 1) mesh, by its three
steps (reduce-scatter in the pod, all-reduce across pods, all-gather in
the pod), and its fallback on a (data 4, model 1) mesh, one all-reduce,
must each give the flat sum of every rank's values exactly: the values
are integer-valued float32, whose sums are exact in any order; so must
the trainer's gradient reduction on the pod mesh.  The ranks run in
processes of their own (``tests/torch_mesh_workers.py``), one spawn for
the file.
"""

import numpy as np
import pytest

import torch_mesh_workers as W


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    W.spawn(W.collectives_worker, tmp)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(W.WORLD)]


def test_the_ranks_hold_different_values(ranks):
    assert not np.array_equal(ranks[0]["mine_w"], ranks[1]["mine_w"])


@pytest.mark.parametrize("mesh", ["pod", "flat"])
def test_hierarchical_psum_is_the_flat_sum(ranks, mesh):
    total = sum(r["mine_w"] for r in ranks)
    for r in ranks:
        np.testing.assert_array_equal(r["want_w"], total)
        np.testing.assert_array_equal(r[f"{mesh}_w"], r["want_w"])
        # 13 entries: not a multiple of the pod's two data ranks
        np.testing.assert_array_equal(r[f"{mesh}_odd"], r["want_odd"])


def test_hierarchical_grad_reduce_sums_the_shards_gradients(ranks):
    # rank r's gradient is arange(6) * (r + 1): the sum is arange(6) * 10
    for r in ranks:
        np.testing.assert_array_equal(r["grad"],
                                      np.arange(6, dtype=np.float32) * 10)


def test_the_trainers_reduction_over_pods(ranks):
    """``Trainer``'s gradient reduction on the (pod, data) mesh: a partial
    sum beside a replicated parameter goes through ``hierarchical_psum``
    and comes out replicated; a gradient already on its parameter's
    placements stays."""
    total = sum(r["mine_w"] for r in ranks)
    for r in ranks:
        assert str(r["trainer_p_placements"]) == \
            "(Replicate(), Replicate(), Replicate())"
        np.testing.assert_array_equal(r["trainer_p"], total)
    # the cut gradient: each data rank's two columns of its own values
    want = np.concatenate([ranks[0]["mine_w"][:, :2],
                           ranks[1]["mine_w"][:, :2]], axis=1)
    for r in ranks[:2]:
        np.testing.assert_array_equal(r["trainer_c"], want)
