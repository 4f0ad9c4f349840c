"""Full-graph training, as ``fullgraph`` runs it, on a graph loaded from the
dataset a user of a large graph saves once: the port's ordered operator in
its ``.npz`` format (``graph/datasets.save_npz_dataset``, the ``--npz`` route
of ``train_fullgraph``).

**The cache.** The first run in a checkout generates the mix's graph and
runs the port's host pipeline on it, ``symmetrize_max`` and
``sym_normalize``, ``locality_order(graph, "auto")`` and the reorder, as
``fullgraph.build_graph`` does; it writes the ordered operator through
``save_npz_dataset`` (``operator.npz``; no features: the run makes its own)
and beside it the generator's raw edges, its communities and the order
(``raw.npz``), in ``.bench_cache/datasets/<key>/``. The key is a hash of the
mix's parameters, so a mix that changes builds its own cache; nothing else
invalidates one, and a new checkout starts without. Written to a temporary
directory and renamed into place, so a run never reads half a cache. The
build's seconds by stage go to standard error.

**What a run pays** (``setup_s``; a checkout's first run pays the build on
top, once): ``load_npz_dataset`` and ``Graph.from_scipy`` at
``COLPANEL_MIN_NODES`` (the column panels above it; inside the
``layout_build`` span, as in ``fullgraph``, so ``layout_build_s`` reads it),
the upload, the model and Adam, and the warm-up. ``save_npz_dataset`` marks
the operator symmetric only where it is so bit for bit, and
``sym_normalize``'s float32 weights of an edge and its reverse can differ in
the last bit where the generator summed duplicate edges into a weight above
1: the load then builds the transpose layouts too, as it does for any user
of such a file. The reference follows the first steps on the blocked
adjacency of ``reference/blocked.py``, the raw edges' gathered rows being
too large for the card in one piece. Everything else is
``fullgraph.FullGraphRun``.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import shutil
import sys
import tempfile
import types

import numpy as np
import scipy.sparse as sp

from benchmark.drivers.fullgraph import Built, FullGraphRun, model_spec
from benchmark.harness import ROOT
from benchmark.reference import blocked

CACHE = ROOT / ".bench_cache" / "datasets"


def cache_dir(mix: dict):
    key = hashlib.sha256(json.dumps(mix, sort_keys=True).encode()).hexdigest()[:16]
    return CACHE / key


def build_cache(mix: dict, spans, path) -> None:
    """Generate the mix's graph, run the port's host pipeline on it and
    write the cache into ``path``; prints the seconds of each stage."""
    from pygcn_tpu_torch.graph.datasets import NodeClassificationData, save_npz_dataset
    from pygcn_tpu_torch.graph.graph import Graph
    from pygcn_tpu_torch.graph.transform import sym_normalize, symmetrize_max
    from pygcn_tpu_torch.parallel.partition import locality_order, reorder_graph

    gen = importlib.import_module(f"benchmark.generators.{mix['generator']}")
    with spans("cache.generate"):
        raw, aux = gen.graph(mix)
    with spans("cache.normalize"):
        a = sym_normalize(symmetrize_max(raw))
        bare = Graph.from_scipy(a, is_symmetric=True, build_dense=False, build_bcsr=False,
                                build_ell=False, build_hybrid=False, build_colpanel=False)
        del a
    with spans("cache.locality_order"):
        perm = locality_order(bare, "auto")
    with spans("cache.reorder"):
        ordered, _ = reorder_graph(bare, perm)
        del bare
    tmp = tempfile.mkdtemp(dir=path.parent, prefix=f".{path.name}.")
    with spans("cache.save"):
        n = ordered.n_nodes
        empty = np.zeros(0, np.int64)
        save_npz_dataset(os.path.join(tmp, "operator.npz"), NodeClassificationData(
            graph=ordered, features=np.zeros((n, 0), np.float32),
            labels=np.zeros(n, np.int32), idx_train=empty, idx_val=empty, idx_test=empty,
            n_classes=1))
        np.savez(os.path.join(tmp, "raw.npz"), row=raw.row, col=raw.col, data=raw.data,
                 communities=aux, perm=perm)
    try:
        os.rename(tmp, path)
    except OSError:  # another run of the same mix finished first
        shutil.rmtree(tmp, ignore_errors=True)
    print("cache build s " + json.dumps({k: v[-1] for k, v in spans.seconds.items()
                                         if k.startswith("cache.")}), file=sys.stderr)


def build_graph(config: dict, mix: dict, spans) -> Built:
    """The mix's graph from the cache (built first if missing): the raw
    edges, communities and order from ``raw.npz``, the port's graph through
    ``load_npz_dataset`` with ``Graph.from_scipy``'s layouts."""
    from pygcn_tpu_torch.graph.datasets import load_npz_dataset
    from pygcn_tpu_torch.graph.graph import COLPANEL_MIN_NODES

    path = cache_dir(mix)
    if not path.is_dir():
        path.parent.mkdir(parents=True, exist_ok=True)
        with spans("cache_build"):
            build_cache(mix, spans, path)
    with spans("load_raw"):
        with np.load(path / "raw.npz") as z:
            n = int(z["communities"].shape[0])
            raw = sp.coo_matrix((z["data"], (z["row"], z["col"])), shape=(n, n))
            aux, perm = z["communities"], z["perm"]
    with spans("layout_build"), spans("load_layouts"):
        data = load_npz_dataset(str(path / "operator.npz"), build_dense=False,
                                build_bcsr=False, hybrid_min_edges_per_tile=64,
                                colpanel_min_nodes=COLPANEL_MIN_NODES)
        fwd_kw = model_spec(config).layouts(data.graph)
    return Built(raw, aux, data.graph, perm, fwd_kw)


class SavedGraphRun(FullGraphRun):
    """:class:`FullGraphRun` on the saved graph, its reference blocked."""

    def __init__(self, config: dict, mix: dict, seed: int, device, spans,
                 built: Built | None = None):
        if built is None:
            built = build_graph(config, mix, spans)
        super().__init__(config, mix, seed, device, spans, built=built)
        # FullGraphRun.reference builds its adjacency by ``self.ref.adjacency``
        self.ref = types.SimpleNamespace(forward=self.ref.forward,
                                         adjacency=blocked.normalized)


Run = SavedGraphRun
