"""Sharded checkpoints over ``torch.distributed.checkpoint``
(``pygcn_tpu_torch/train/checkpoint_dist.py``) on gloo ranks: the port's
side of JAX's ``tests/test_checkpoint_orbax.py``.

One group of 4 gloo ranks, started once for the file; the rank-side jobs
live in ``tests/torch_axes_ranks.py``. Restores are held bit for bit
(``assert_array_equal``): a checkpoint moves bytes, it computes nothing.
"""

import os

import numpy as np
import pytest
import torch

import torch_axes_ranks as jobs
from pygcn_tpu_torch.parallel import build_dist_plan, launcher
from pygcn_tpu_torch.graph.datasets import sbm_classification

torch.set_num_threads(1)

RANKS = 4
JOB_TIMEOUT_S = 180


@pytest.fixture(scope="module")
def ranks():
    with launcher.LocalRanks(RANKS, timeout_s=JOB_TIMEOUT_S) as r:
        yield r


@pytest.fixture(scope="module")
def elastic(ranks, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "elastic")
    return ranks.run(jobs.ckpt_elastic_job, path), path


def test_elastic_roundtrip_onto_a_smaller_mesh(elastic):
    """Saved row-sharded on 4 ranks (2 rows each), asynchronously; restored
    from ``ShardSpec``s onto a 2-rank mesh (4 rows each), still split by
    rows, bit for bit; the ranks outside the mesh restore nothing."""
    out, path = elastic
    full = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    for r in out[:2]:
        np.testing.assert_array_equal(r["w"], full[4 * r["rank"]:4 * r["rank"] + 4])
        assert r["w_shape"] == (8, 8)
        np.testing.assert_array_equal(r["b"], np.ones(3, np.float32))
        assert r["epoch"] == 7
    assert all("w" not in r for r in out[2:])
    # each rank wrote its own file: no gather to one rank
    assert sorted(f for f in os.listdir(path) if f.endswith(".distcp")) == [
        f"__{i}_0.distcp" for i in range(RANKS)]


def test_elastic_restore_onto_uneven_blocks(elastic):
    """The same leaf restored alone onto 3 ranks: ``torch.chunk``'s split,
    3, 3 and 2 rows, bit for bit."""
    out, _ = elastic
    full = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    for r, (lo, hi) in zip(out[:3], [(0, 3), (3, 6), (6, 8)]):
        np.testing.assert_array_equal(r["w3"], full[lo:hi])
    assert "w3" not in out[3]


def test_restore_from_the_concrete_tree(elastic):
    """``like`` the saved tree itself: each rank gets its own rows back, in
    the same placement."""
    out, _ = elastic
    full = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    for r in out:
        np.testing.assert_array_equal(r["same_w"], full[2 * r["rank"]:2 * r["rank"] + 2])
        assert r["same_placement"] == ("(Shard(dim=0),)", (8, 8))


@pytest.fixture(scope="module")
def whole(ranks, tmp_path_factory):
    return ranks.run(jobs.ckpt_whole_job, str(tmp_path_factory.mktemp("whole")))


def test_sync_save_restored_whole(whole):
    """A column-sharded leaf saved synchronously comes back whole with
    ``like=None`` on every rank, and a plain value with it."""
    full = np.arange(24.0, dtype=np.float32).reshape(3, 8)
    for r in whole:
        np.testing.assert_array_equal(r["w"], full)
        assert r["lr"] == 0.5


def test_async_save_is_there_after_wait_and_a_save_overwrites(whole):
    """An asynchronous save's files are all there once ``wait()`` returns,
    and a second save at the same path replaces it (Orbax's ``force``)."""
    for r in whole:
        assert r["files"] == [".metadata"] + [f"__{i}_0.distcp" for i in range(RANKS)]
        np.testing.assert_array_equal(r["again"], np.full(2, 2.0, np.float32))


def test_tp_model_and_adam_state_restore_bit_for_bit(ranks, tmp_path):
    """A ``TPDistGCN`` on graph × model 2×2 after two steps: its split and
    replicated parameters and Adam's state saved asynchronously, restored
    into a fresh model: equal bits, and the next steps take the same
    loss."""
    d = sbm_classification(n=160, n_classes=3, feat_dim=16, seed=1, train_per_class=10,
                           n_val=30, n_test=60, build_dense=False, build_bcsr=False,
                           build_ell=False, build_hybrid=False)
    plan = build_dist_plan(d.graph, 2)
    npad, n = plan.n_nodes_padded, d.graph.n_nodes
    x = np.zeros((npad, 16), np.float32)
    x[:n] = d.features
    labels = np.zeros(npad, np.int64)
    labels[:n] = d.labels
    mask = np.zeros(npad, np.float32)
    mask[d.idx_train] = 1.0
    out = ranks.run(jobs.ckpt_tp_job, str(tmp_path / "tp"), plan, x, labels, mask)
    for r in out:
        assert r["max_diff"] == 0.0
        assert r["r_loss"] == r["loss"] and np.isfinite(r["loss"])
