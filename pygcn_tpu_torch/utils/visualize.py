"""Plot helpers (headless matplotlib → png): the port of
``pygcn_tpu/utils/visualize.py``. matplotlib is imported when a plot is
drawn, never when the module is imported.

Capability mirror of the reference's ``visualize`` histogram helper
(``pygcn/utils.py:416-420``) and the loss-curve plots in its baselines
(``pygcn/mlp_new.py:196-200``).
"""

from __future__ import annotations


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def visualize(data, bins, save_path) -> None:
    plt = _plt()
    fig = plt.figure()
    plt.hist(data, bins=bins)
    plt.savefig(save_path)
    plt.close(fig)
    print("Figure saved at: ", save_path)


def plot_curves(curves: dict, save_path, xlabel: str = "epoch", ylabel: str = "value") -> None:
    plt = _plt()
    fig = plt.figure()
    for label, ys in curves.items():
        plt.plot(ys, label=label)
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.legend()
    plt.savefig(save_path)
    plt.close(fig)
    print("Figure saved at: ", save_path)
