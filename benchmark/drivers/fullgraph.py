"""Full-graph training, epoch after epoch, as ``train_fullgraph --clustered``
runs it: one ``train_step`` with its loss read on the host, then one
evaluation forward with its argmax copied to the host (``eval_every`` 1).

Set-up hands the port the raw edge list of the mix's graph and runs the
port's host pipeline as a user pays it, with no cache: ``symmetrize_max``
and ``sym_normalize``, ``locality_order(graph, "auto")`` and the reorder,
``Graph.from_scipy`` at ``hybrid_min_edges_per_tile=64`` and, for the GAT,
its attention layouts. The features, labels, mask and weights are made on
the device from ``--seed`` and given to the port in its order. The first
``check_steps`` epochs are the warm-up and the steps the reference follows.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.compare import training_gaps
from benchmark.reference.training import follow
from benchmark.work import TileEdges


@dataclasses.dataclass
class Built:
    """The mix's graph: the raw adjacency in the generator's ids (host), the
    generator's extra output, and the port's graph, order and layouts."""

    raw: object  # scipy COO
    aux: object
    graph: object  # pygcn_tpu_torch Graph on the host
    perm: np.ndarray  # perm[port id] = generator id
    fwd_kw: dict


def model_spec(config: dict):
    return importlib.import_module(f"benchmark.models.{config['model']}")


def build_graph(config: dict, mix: dict, spans) -> Built:
    """Generate the mix's graph and run the port's host pipeline on it."""
    from pygcn_tpu_torch.graph.graph import COLPANEL_MIN_NODES, Graph
    from pygcn_tpu_torch.graph.transform import sym_normalize, symmetrize_max
    from pygcn_tpu_torch.parallel.partition import locality_order, reorder_graph

    gen = importlib.import_module(f"benchmark.generators.{mix['generator']}")
    spec = model_spec(config)
    with spans("generate"):
        raw, aux = gen.graph(mix)
    with spans("layout_build"):
        a = sym_normalize(symmetrize_max(raw))
        bare = Graph.from_scipy(a, is_symmetric=True, build_dense=False, build_bcsr=False,
                                build_ell=False, build_hybrid=False, build_colpanel=False)
        perm = locality_order(bare, "auto")
        ordered, _ = reorder_graph(bare, perm)
        kw = dict(is_symmetric=True, build_dense=False, build_bcsr=False,
                  hybrid_min_edges_per_tile=64, colpanel_min_nodes=COLPANEL_MIN_NODES)
        if spec.ATTENTION:
            big = ordered.n_nodes > COLPANEL_MIN_NODES
            kw.update(build_ell=not big, build_hybrid=not big, build_colpanel=big)
        graph = Graph.from_scipy(ordered.to_scipy(), **kw)
        fwd_kw = spec.layouts(graph)
    return Built(raw, aux, graph, perm, fwd_kw)


def make_leaves(leaves: list, seed: int, device) -> dict:
    """Each leaf uniform in ``[-bound, bound]``, drawn on ``device`` in one
    call from ``seed``'s weight stream."""
    gen = torch.Generator(device=device).manual_seed(2 * seed + 1)
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    u = torch.rand(sum(sizes), generator=gen, device=device).mul_(2).sub_(1)
    return {name: part.view(shape) * bound
            for (name, shape, bound), part in zip(leaves, u.split(sizes))}


class FullGraphRun:
    """One run: the port's model, optimizer and graph on ``device``.

    ``start`` runs the first epochs (warm-up and the reference's steps),
    ``window`` the measured epochs, ``profile`` a few more under the
    profiler, ``check`` frees the program and compares with the reference.
    """

    def __init__(self, config: dict, mix: dict, seed: int, device, spans,
                 built: Built | None = None):
        from pygcn_tpu_torch.train.optim import adam_l2

        self.config, self.mix, self.device, self.spans = config, mix, torch.device(device), spans
        self.spec = model_spec(config)
        self.ref = importlib.import_module(f"benchmark.reference.{config['model']}")
        self.built = build_graph(config, mix, spans) if built is None else built
        gen = importlib.import_module(f"benchmark.generators.{mix['generator']}")
        with spans("node_data"):
            data = gen.node_data(mix, self.built.aux, config["in_features"],
                                 config["out_channels"], 2 * seed, self.device)
            self.params0 = make_leaves(self.spec.leaves(config), seed, self.device)
        with spans("inputs"):
            perm = torch.as_tensor(self.built.perm, device=self.device)
            self.x, self.labels, self.mask = data.x[perm], data.labels[perm], data.mask[perm]
            self.inputs = {"x": data.x.cpu(), "labels": data.labels.cpu(),
                           "mask": data.mask.cpu()}
            del data
        with spans("upload"):
            self.graph = self.built.graph.to(self.device)
            self.fwd_kw = {k: v.to(self.device) if hasattr(v, "to") else v
                           for k, v in self.built.fwd_kw.items()}
        with spans("model"):
            model = self.spec.build(config, torch.Generator().manual_seed(seed))
            self.model = model.to(self.device)
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    p.copy_(self.params0[name])
            b1, b2 = config["adam_betas"]
            self.opt = adam_l2(self.model.parameters(), config["lr"], config["weight_decay"],
                               b1=b1, b2=b2, eps=config["adam_eps"])
        self.losses: list = []
        self.pred = None

    def start(self) -> None:
        """The first ``check_steps`` epochs: the warm-up, and the steps whose
        first output, losses, first gradient and parameter change the
        reference checks."""
        b1 = self.config["adam_betas"][0]
        first = []

        def keep_first(module, inputs, out):  # returns None: the output goes on unchanged
            if not first:
                first.append(out.detach().cpu())

        hook = self.model.register_forward_hook(keep_first)
        with self.spans("warmup"):
            for t in range(self.mix["check_steps"]):
                self.losses.append(self.epoch())
                if t == 0:  # the first gradient, as the optimizer holds it
                    hook.remove()
                    # the first step's log-probabilities, in the generator's ids
                    self.logp1 = first[0][torch.as_tensor(np.argsort(self.built.perm))]
                    self.grad1 = {}
                    for name, p in self.model.named_parameters():
                        m = self.opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                        self.grad1[name] = m.detach() / (1 - b1)
            self.params = {n: p.detach().clone() for n, p in self.model.named_parameters()}

    def epoch(self) -> float:
        """One training step and one evaluation forward; returns the loss."""
        from pygcn_tpu_torch.apps.train_fullgraph import train_step

        with record_function("bench.train_step"):
            loss = train_step(self.model, self.opt, self.x, self.labels, self.mask,
                              self.graph, **self.fwd_kw)
        with record_function("bench.loss_read"):
            loss_v = float(loss)
        with record_function("bench.eval_forward"), torch.no_grad():
            out = self.model(self.x, self.graph, **self.fwd_kw)
        with record_function("bench.argmax_copy"):
            self.pred = out.argmax(dim=1).cpu()
        return loss_v

    def window(self, seconds: float) -> dict:
        """Epochs until ``seconds`` have passed: how many, how long they took
        in all and each, and how many read a loss that was not finite."""
        steps = failed = 0
        times = []
        t0 = t = time.perf_counter()
        end = t0 + seconds
        while t < end:
            loss = self.epoch()
            steps += 1
            failed += not math.isfinite(loss)
            times.append(time.perf_counter() - t)
            t += times[-1]
        return {"steps": steps, "seconds": t - t0, "failed": failed, "step_s": times}

    def profile(self, prefix: str) -> dict:
        """``profile_steps`` more epochs under ``torch.profiler``, twice: the
        card's activity alone, its window timed on the host clock between
        two waits for an idle card (what the card did, and how long it
        stood idle); then host and card, inside a ``bench.profile_window``
        range (what the host did while the card stood idle; recording the
        host's operators slows the host, so this pass is read for that
        alone). Writes ``<prefix>.device.json`` (on a card) and
        ``<prefix>.host.json``."""
        from torch.profiler import ProfilerActivity, profile

        n = self.mix["profile_steps"]
        on_card = self.device.type == "cuda"
        out = {"steps": n, "device_trace": None, "window_s": None}
        if on_card:
            torch.cuda.synchronize(self.device)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    self.epoch()
                torch.cuda.synchronize(self.device)
                out["window_s"] = time.perf_counter() - t0
            out["device_trace"] = f"{prefix}.device.json"
            prof.export_chrome_trace(out["device_trace"])
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            with record_function("bench.profile_window"):
                for _ in range(n):
                    self.epoch()
                if on_card:
                    torch.cuda.synchronize(self.device)
        out["host_trace"] = f"{prefix}.host.json"
        prof.export_chrome_trace(out["host_trace"])
        return out

    def counts(self) -> dict:
        """The program's counts: nodes, edges and the edges on tiles."""
        hy = self.graph.hybrid
        return {"n_nodes": self.graph.n_nodes, "n_edges": self.graph.n_edges,
                "tile_edges": None if hy is None else hy.tile_edges}

    def tile_edges(self):
        """The edges the hybrid layout routed to tiles, as :class:`TileEdges`
        (None without tiles), read from the tiles' nonzeros."""
        hy = self.graph.hybrid
        if hy is None or hy.bcsr is None:
            return None
        b = hy.bcsr
        t, i, j = torch.nonzero(b.data, as_tuple=True)
        rows = b.block_rows.long()[t] * b.tm + i
        cols = b.block_cols.long()[t] * b.tk + j
        return TileEdges(int(t.numel()), int(torch.unique(cols).numel()),
                         int(torch.unique(rows).numel()))

    def readings(self) -> dict:
        return {"losses": self.losses[: self.mix["check_steps"]], "logp": self.logp1,
                "grad1": self.grad1, "params": self.params}

    def release(self) -> None:
        """Free the program's state on the device."""
        for name in ("model", "opt", "graph", "fwd_kw", "x", "labels", "mask", "pred"):
            setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float64, matmul=torch.matmul) -> dict:
        """The reference's first steps from the same leaves and inputs, on
        its own adjacency of the raw edges in the generator's ids, computed
        in ``dtype``. In float64 its own rounding lies far below the
        program's float32: a float32 reference sums a hub's thousands of
        terms in another order and reads, on some seeds, as far from float64
        as the TF32 control does (``PERF.md``)."""
        raw = self.built.raw
        adj = self.ref.adjacency(raw.row, raw.col, raw.data, raw.shape[0], self.device, dtype)
        x, mask = (self.inputs[k].to(self.device, dtype) for k in ("x", "mask"))
        labels = self.inputs["labels"].to(self.device)
        params0 = {k: v.to(dtype) for k, v in self.params0.items()}
        return follow(self.ref, self.config, params0, adj, x, labels, mask,
                      self.mix["check_steps"], matmul)

    def check(self) -> dict:
        """Free the program, run the reference and return the compared gaps."""
        prog = self.readings()
        self.release()
        return training_gaps(prog, self.reference(), self.params0)


Run = FullGraphRun
