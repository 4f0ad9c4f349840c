"""Export simulator output to dynalearn-format HDF5
(reference ``gt-generator/wrap-data.py``, G9).

The port's copy of ``pygcn_tpu/apps/export_dynalearn.py``: host-side NumPy
over the files ``apps/no_vac_baseline`` writes, with ``h5py`` imported only
when a file is written.

Four ``gen_code`` network layouts (reference ``wrap-data.py:110-171``):

- 0 — synthetic CBG homogeneous network (random permutation edges);
- 1 — CBG-POI bipartite network from the averaged visit matrix;
- 2 — the same truncated to 5000 edges (toy);
- 3 — random bipartite toy (52 nodes, p=0.4).

The HDF5 file holds ``timeseries`` (daily per-CBG cumulative cases),
``networks/{node_list, edge_list, node_attr/population, edge_attr/weight}``
(:184-197), and the dynalearn lag-window tensors ``inputs``/``targets``
(lag 5, :220-235) — stored directly in the file (the dynalearn package itself
is not a dependency).

Usage::

    python -m pygcn_tpu_torch.apps.export_dynalearn --gt_dir gt --gen_code 1
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_network(gen_code: int, cases: np.ndarray, avg_array: np.ndarray,
                  cbg_sizes: np.ndarray, rng: np.random.Generator):
    num_days, num_cbgs = cases.shape
    num_pois = avg_array.shape[0]
    num_nodes = num_pois + num_cbgs

    if gen_code == 0:
        num_nodes = num_cbgs
        node_list = np.arange(num_nodes)
        edge_list = np.stack(
            [rng.permutation(num_nodes), np.arange(num_nodes)], axis=1
        )
        edge_attr = np.zeros(len(edge_list), np.float32)
    elif gen_code in (1, 2):
        cases = np.concatenate([cases, np.zeros((num_days, num_pois))], axis=1)
        node_list = np.arange(num_nodes)
        poi_e, cbg_e = np.nonzero(avg_array)
        edge_list = np.stack([poi_e + num_cbgs, cbg_e], axis=1)
        if gen_code == 2:
            edge_list = edge_list[:5000]
        edge_attr = avg_array[edge_list[:, 0] - num_cbgs, edge_list[:, 1]].astype(np.float32)
    elif gen_code == 3:
        from networkx.algorithms import bipartite

        num_nodes, num_cbgs = 52, 20
        cases = cases[:, :num_nodes] if cases.shape[1] >= num_nodes else np.pad(
            cases, ((0, 0), (0, num_nodes - cases.shape[1]))
        )
        node_list = np.arange(num_nodes)
        g = bipartite.random_graph(num_cbgs, num_nodes - num_cbgs, 0.4, seed=int(rng.integers(1 << 31)))
        edges = np.asarray(list(g.edges()), np.int64)
        edge_list = edges
        ij = np.clip(edge_list, 0, np.array(avg_array.shape) - 1)
        edge_attr = avg_array[ij[:, 0] % avg_array.shape[0], ij[:, 1] % avg_array.shape[1]].astype(np.float32)
    else:
        raise ValueError(f"invalid gen_code {gen_code}")

    node_attr = np.concatenate(
        [np.asarray(cbg_sizes, np.float64)[: min(num_cbgs, len(cbg_sizes))],
         rng.random(max(num_nodes - num_cbgs, 0)) * 10]
    )[:num_nodes]
    return cases, node_list, edge_list, node_attr, edge_attr


def lag_window(cases: np.ndarray, lag: int = 5, lagstep: int = 1):
    """dynalearn StateData tensors (reference ``wrap-data.py:220-231``):
    inputs [T', N, states, lag], targets [T', N, states]."""
    num_days, num_nodes = cases.shape
    t_out = num_days - (lag - 1) * lagstep
    inputs = np.zeros((t_out, num_nodes, 1, lag))
    targets = np.zeros((t_out, num_nodes, 1))
    for t in range(t_out):
        x = cases[t : t + lag * lagstep : lagstep]
        inputs[t] = np.transpose(x.reshape(*x.shape, 1), (1, 2, 0))
        targets[t] = cases[t + lag * lagstep - 1].reshape(-1, 1)
    return inputs, targets


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--msa_name", default="SanFrancisco")
    ap.add_argument("--gen_code", type=int, default=1, choices=[0, 1, 2, 3])
    ap.add_argument("--num_seeds", type=int, default=60)
    ap.add_argument("--lag", type=int, default=5)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--gt_dir", required=True,
                    help="directory with no_vac_baseline outputs")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from pygcn_tpu_torch.apps.common import set_process_title

    set_process_title("export_dynalearn")

    import h5py

    cases = np.load(os.path.join(
        args.gt_dir, f"cases_cbg_no_vaccination_{args.msa_name}_{args.num_seeds}seeds.npy"
    ))
    avg_array = np.load(os.path.join(args.gt_dir, f"avg_array_{args.msa_name}.npy"))
    sizes_path = os.path.join(args.gt_dir, f"cbg_sizes_{args.msa_name}.npy")
    cbg_sizes = (np.load(sizes_path) if os.path.exists(sizes_path)
                 else np.ones(cases.shape[1]))

    rng = np.random.default_rng(args.seed)
    cases_out, node_list, edge_list, node_attr, edge_attr = build_network(
        args.gen_code, cases, avg_array, cbg_sizes, rng
    )
    inputs, targets = lag_window(cases_out, lag=args.lag)

    out = args.out or os.path.join(
        args.gt_dir, f"data_{args.msa_name}_gencode{args.gen_code}.h5"
    )
    with h5py.File(out, "w") as f:
        f.create_dataset("timeseries", data=cases_out)
        net = f.create_group("networks")
        net.create_dataset("node_list", data=node_list)
        net.create_dataset("edge_list", data=edge_list)
        net.create_group("node_attr").create_dataset("population", data=node_attr)
        net.create_group("edge_attr").create_dataset("weight", data=edge_attr)
        f.create_dataset("inputs", data=inputs)
        f.create_dataset("targets", data=targets)
    print("wrote", out, "timeseries", cases_out.shape, "edges", len(edge_list),
          "inputs", inputs.shape)
    return out


if __name__ == "__main__":
    main()
