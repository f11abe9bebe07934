"""The comparison that decides ``correct``.

Training cells compare the program's first steps with the reference's
(``reference.train.adam_steps``) by these numbers:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first gradient's norm, leaf by leaf (the program's read
  from Adam's first moment after one step, m / (1 - beta1)), the worst
  leaf's gap of norms over the larger of that leaf's reference norm and
  the median leaf's;
* ``update_gap``: the same for the norm of each leaf's change over the
  steps, leaving out leaves whose reference gradient is under a thousandth
  of the median leaf's (Adam moves those by round-off alone);
* ``grad_med_gap``, ``update_med_gap``: the median leaf's gap in place of
  the worst leaf's, for a cell where one small leaf swings the worst from
  seed to seed.

Serving cells compare sampled answers with the reference's forward by
``pred_rms_err``: the root mean square of a served answer's gap from the
reference's, in the target's normalised units (divided by the target's
std); the worst sampled request. An absolute error: with random weights
the predictions' own size is mostly the decoder's seeded offset, which
carries no rounding, so a gap relative to it swings with the seed while
the absolute gap does not.

A cell compares the numbers its ``limits/<workload>.json`` names, each
against its limit; a number over its limit, or not finite, makes the run
not correct. A number a cell does not name is not compared; PERF.md
gives the readings each limit was set from.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np


def _leaf_gaps(p: Dict[str, float], r: Dict[str, float], keys) -> list:
    scale = float(np.median([r[k] for k in r]))
    return [abs(p[k] - r[k]) / max(r[k], scale, 1e-30) for k in keys]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    steps = len(ref["losses"])
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"][:steps], ref["losses"]))
    g_med = float(np.median(list(ref["grad1"].values())))
    moved = [k for k, g in ref["grad1"].items() if g >= 1e-3 * g_med]
    grad = _leaf_gaps(prog["grad1"], ref["grad1"], ref["grad1"])
    update = _leaf_gaps(prog["delta"], ref["delta"], moved)
    return {"loss_gap": loss_gap,
            "grad_gap": max(grad), "update_gap": max(update),
            "grad_med_gap": float(np.median(grad)),
            "update_med_gap": float(np.median(update))}


def pred_rms_err(served_norm: np.ndarray, ref_norm: np.ndarray) -> float:
    if served_norm.shape != ref_norm.shape:
        return math.inf
    gap = served_norm.astype(np.float64) - ref_norm.astype(np.float64)
    return float(np.sqrt(np.mean(np.square(gap))))


def judge(numbers: Dict[str, float],
          limits: Optional[Dict[str, float]]) -> Optional[bool]:
    """True when every number ``limits`` names is finite and within its
    limit; None without limits (a calibration run)."""
    if limits is None:
        return None
    missing = set(limits) - set(numbers)
    if missing:
        raise ValueError(f"no number for the limits {sorted(missing)}")
    return all(math.isfinite(numbers[k]) and numbers[k] <= v
               for k, v in limits.items())
