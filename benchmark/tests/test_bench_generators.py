"""The traffic generators: a mix's ``graph_seed`` fixes the graph, ``--seed``
the node data, and each repeats."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.generators import chung_lu, community

MIXES = {"clustered": community, "powerlaw": chung_lu}


def _mix(name, **kw):
    mix = harness.load_json(harness.HERE / "traffic" / f"{name}.json")
    return dict(mix, n_nodes=2000, **kw)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_graph_seed_fixes_the_structure(name):
    gen = MIXES[name]
    a, _ = gen.graph(_mix(name))
    b, _ = gen.graph(_mix(name))
    c, _ = gen.graph(_mix(name, graph_seed=1))
    assert a.nnz > 0 and (a != b).nnz == 0
    assert (a != c).nnz > 0
    assert not np.any(a.row == a.col)  # no self loops


@pytest.mark.parametrize("name", sorted(MIXES))
def test_seed_repeats_the_node_data(name):
    gen = MIXES[name]
    mix = _mix(name)
    _, aux = gen.graph(mix)
    one, two, other = (gen.node_data(mix, aux, 16, 5, s, "cpu") for s in (7, 7, 8))
    for field in ("x", "labels", "mask"):
        assert torch.equal(getattr(one, field), getattr(two, field))
    assert not torch.equal(one.x, other.x)
    assert one.x.shape == (2000, 16) and int(one.labels.max()) < 5
    # every seed trains on as many nodes
    assert float(one.mask.sum()) == float(other.mask.sum()) == max(5, int(2000 * mix["train_frac"]))


# the graphs at 2000 nodes, as the port's ``community_graph`` and
# ``chung_lu_graph`` drew them at graph seed 0 when the copies were frozen:
# (edges, sum of receivers, sum of senders, sum of weights)
FINGERPRINTS = {"clustered": (24139, 23836449, 23819706, 26277.0),
                "powerlaw": (22919, 22023892, 22055598, 26416.0)}


@pytest.mark.parametrize("name", sorted(MIXES))
def test_frozen_copy_draws_the_ports_graph(name):
    a, _ = MIXES[name].graph(_mix(name))
    assert (a.nnz, int(a.row.sum()), int(a.col.sum()), float(a.data.sum())) == FINGERPRINTS[name]


def test_large_seed():
    """Seeds past 32 signed bits, as the driver's are."""
    mix = _mix("powerlaw")
    data = chung_lu.node_data(mix, None, 4, 3, 2 * (2**31 + 12345), "cpu")
    assert torch.isfinite(data.x).all()
