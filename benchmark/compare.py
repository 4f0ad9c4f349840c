"""The comparison that decides ``correct`` for a training cell.

The program's first steps are held against the reference's from the same
initial parameters and inputs. Four numbers, each a relative gap:

- ``logp_diff``: the norm of the difference of the first step's
  log-probabilities, every node's, over the reference's norm. A norm of
  the difference keeps rounding that is random element by element, as
  TF32's is, where a norm or a mean averages it out; and the forward pass
  is continuous, so this is steady from seed to seed where the gradients
  are not (below). It is the number the control fails;
- ``loss_gap``: ``|L_prog - L_ref| / |L_ref|`` of the first step's loss;
- ``grad_gap``: by the worst leaf, the gap between the norms of the first
  gradient (the program's as its optimizer holds it after one step), over
  the larger of that leaf's reference norm and the median leaf's;
- ``change_gap``: by the median leaf, the same gap for the norm of each
  leaf's change over the steps. Leaves whose reference gradient is under a
  thousandth of the median leaf's move by round-off alone and are left out.

The gradients are taken at a nonsmooth point where a ReLU's or a leaky
ReLU's input lies within float32 rounding of nought: the program and the
float64 reference may take the two sides, and that element's share of the
gradient differs by its whole slope. On a few seeds in a hundred such an
element moves ``grad_gap`` and ``change_gap`` by up to 1e-3 (``PERF.md``):
they catch the faults, and ``logp_diff`` holds the precision.

The later steps' losses and the worst leaf's change are not compared: a
parameter element whose gradient is round-off (a still leaf such as the
output layer's receiver attention vector, or single elements) moves under
Adam by a whole step of either sign, and the later steps carry that into
every leaf, on sound runs too (``PERF.md`` gives both readings).
"""

from __future__ import annotations

import math
import statistics

import torch

# a leaf whose reference gradient norm is below this share of the median
# leaf's moves under Adam by round-off alone
STILL_LEAF = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _gap(prog: dict, ref: dict) -> dict:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref}


def _finite(x: float, parts=()) -> float:
    """``x``, or infinity where it or any of its ``parts`` is not finite."""
    return x if all(map(math.isfinite, [x, *parts])) else math.inf


def training_gaps(prog: dict, ref: dict, params0: dict) -> dict:
    """``prog`` and ``ref`` each hold ``logp`` (``[nodes, classes]``, in the
    generator's ids), ``losses`` (list), ``grad1`` and ``params`` (leaf name
    to tensor, same names as ``params0``)."""
    logp_ref = ref["logp"]
    logp_diff = _norm(prog["logp"].to(logp_ref) - logp_ref) / _norm(logp_ref)
    loss_gap = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    g_ref = {k: _norm(g) for k, g in ref["grad1"].items()}
    g_prog = {k: _norm(prog["grad1"][k]) for k in ref["grad1"]}
    med = statistics.median(g_ref.values())
    moving = [k for k in g_ref if g_ref[k] >= STILL_LEAF * med]
    d_ref = {k: _norm(ref["params"][k] - params0[k]) for k in moving}
    d_prog = {k: _norm(prog["params"][k] - params0[k]) for k in moving}
    grads, changes = _gap(g_prog, g_ref).values(), _gap(d_prog, d_ref).values()
    return {"logp_diff": _finite(logp_diff),
            "loss_gap": _finite(loss_gap),
            "grad_gap": _finite(max(grads), grads),
            "change_gap": _finite(statistics.median(changes), changes)}
