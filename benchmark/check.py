"""The numbers that decide ``correct``: the program's first training steps
against the reference's, from one seed.

* ``loss_gap``: over the checked steps, the largest |L - L_ref| / |L_ref|
  of the step's loss;
* ``grad_gap``: over the leaves, the largest gap between the norm of the
  first gradient as the optimizer got it (clipped) and the reference's,
  over the larger of the reference leaf's norm and the median leaf's;
* ``change_gap``: the same of each leaf's change over the checked steps,
  over the leaves that the reference moves: a leaf whose first gradient is
  under a thousandth of the median leaf's moves under Adam by rounding
  alone and is left out.

The gap is one between norms, not the norm of a difference, so that a
leaf whose gradient is all but zero counts no more than the median leaf.
"""

from __future__ import annotations

import statistics
from typing import Dict

import torch

#: a leaf counts for the change when its first gradient is at least this
#: share of the median leaf's
MOVED_SHARE = 1e-3


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The three numbers of one seed, and where each was worst."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog["losses"], ref["losses"]))
    g_ref, g_prog = _norms(ref["grads"]), _norms(prog["grads"])
    moved = [v for v in g_ref.values() if v > 0]
    med_g = statistics.median(moved)
    grad = {k: abs(g_prog.get(k, 0.0) - g_ref[k]) / max(g_ref[k], med_g)
            for k in g_ref}
    counted = [k for k in g_ref if g_ref[k] >= MOVED_SHARE * med_g]
    c_ref, c_prog = _norms(ref["change"]), _norms(prog["change"])
    med_c = statistics.median(c_ref[k] for k in counted)
    change = {k: abs(c_prog.get(k, 0.0) - c_ref[k]) / max(c_ref[k], med_c)
              for k in counted}
    worst_g = max(grad, key=grad.get)
    worst_c = max(change, key=change.get)
    return {"loss_gap": loss_gap, "grad_gap": grad[worst_g],
            "change_gap": change[worst_c],
            "_where": {"grad_gap": worst_g, "change_gap": worst_c,
                       "losses": prog["losses"],
                       "ref_losses": ref["losses"],
                       "left_out": sorted(set(g_ref) - set(counted))}}
