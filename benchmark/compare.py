"""The comparisons that decide a run's ``correct``: what the timed path
produced against what the reference works out again.

Render cells: ``film_mismatch_share``, the share of the check pixels'
film values, over every pass of every image the window completed, that
differ from the reference's film after the same pass by more than
``FILM_TOL`` x (|reference| + 1e-3 x samples so far).  The program and the
reference run the same per-sample arithmetic, so a sound run differs only
where two triangles tie at the same t (the trees differ), and then in
whole samples of a few pixels.

Fit cells, by the worst leaf (a trainable column), each gap taken between
the program's norm and the reference's and measured against the larger of
the reference's norm of that leaf and of the median leaf:
  ``loss_gap``    the largest relative gap of a checked step's loss;
  ``grad_gap``    the step-1 gradient (the program's first call returns
                  its eager warm-up), the program's recovered from its
                  optimizer state;
  ``grad2_gap``   the step-2 gradient, the first the kept graph replays,
                  recovered the same way;
  ``change_gap``  the parameters' change over the checked steps, leaving
                  out leaves whose step-1 reference gradient is under
                  ``ZERO_GRAD`` of the median leaf's (Adam moves those by
                  round-off alone).
"""
from __future__ import annotations

import numpy as np
import torch

FILM_TOL = 1e-4
ZERO_GRAD = 1e-3


def film_mismatch(films, ref, chunk: int):
    """films: [(spp done, (K, 3) film at the check pixels)] per pass of
    the window; ref: (n_passes, K, 3) the reference's films after each
    pass.  -> (share of mismatched values, per-pass shares)."""
    bad = total = 0
    per_pass = []
    for spp_done, film in films:
        r = ref[spp_done // chunk - 1]
        off = np.abs(np.asarray(film, np.float64) - r) > FILM_TOL * (
            np.abs(r) + 1e-3 * spp_done)
        bad += int(off.sum())
        total += off.size
        per_pass.append(float(off.mean()))
    return bad / max(total, 1), per_pass


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.detach().double().cpu()))


def _worst_leaf(prog: dict, ref: dict, keys=None) -> float:
    keys = sorted(ref) if keys is None else keys
    ref_n = {k: _norm(ref[k]) for k in sorted(ref)}
    median = float(np.median(list(ref_n.values())))
    worst = 0.0
    for k in keys:
        scale = max(ref_n[k], median)
        if scale > 0.0:
            worst = max(worst, abs(_norm(prog[k]) - ref_n[k]) / scale)
    return worst


def fit_gaps(prog: dict, ref: dict) -> dict:
    """prog, ref: dict(losses, grads (of steps 1 and 2), params (after
    each checked step), start) -> {loss_gap, grad_gap, grad2_gap,
    change_gap} over the steps both ran."""
    n = len(ref["losses"])
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog["losses"][:n], ref["losses"]))
    grad_gap = _worst_leaf(prog["grads"][0], ref["grads"][0])
    grad2_gap = _worst_leaf(prog["grads"][1], ref["grads"][1])
    g_n = {k: _norm(g) for k, g in ref["grads"][0].items()}
    median = float(np.median(list(g_n.values())))
    moved = [k for k in sorted(g_n) if g_n[k] >= ZERO_GRAD * median]

    def change(side):
        return {k: side["params"][n - 1][k].double().cpu()
                - side["start"][k].double().cpu() for k in side["start"]}
    change_gap = _worst_leaf(change(prog), change(ref), moved)
    return dict(loss_gap=loss_gap, grad_gap=grad_gap, grad2_gap=grad2_gap,
                change_gap=change_gap)
