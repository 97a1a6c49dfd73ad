"""Fixture-invariant style-discrimination criterion for the quality gate.

The port's own copy of the JAX package's ``testing/quality.py`` (NumPy).
The capability under test is the reference's style transfer
(model/inference.py:74-110): a prediction conditioned on style s audio must
be closer to the style-s target than to every other style's target. The
criterion is normalized by the MEASURED fixture separation: for every
conditioning style ``s`` and every other target ``t``,

    margin(s, t) = confusion[s, t] - confusion[s, s]  >=  alpha * sep[s, t]

i.e. the model must turn at least an ``alpha`` fraction of each pair's
available target separation into prediction margin, so close fixture pairs
demand small margins and far pairs large ones. ``DEFAULT_ALPHA`` (0.25) is
the JAX package's calibration, kept so that the two gates apply one bar.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

DEFAULT_ALPHA = 0.25


def normalized_margins(confusion: Sequence[Sequence[float]],
                       separation: Sequence[Sequence[float]]) -> np.ndarray:
    """Per-pair normalized margins, diagonal = +inf (self-pairs are not
    constraints).

    ``confusion[s, t]``: L1 between the prediction conditioned on style s and
    the style-t target. ``separation[s, t]``: L1 between the style-s and
    style-t targets themselves (the fixtures' own distance).
    """
    m = np.asarray(confusion, np.float64)
    sep = np.asarray(separation, np.float64)
    if m.shape != sep.shape or m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"square matrices of equal shape required, got "
                         f"{m.shape} vs {sep.shape}")
    n = m.shape[0]
    out = np.full((n, n), np.inf)
    for s in range(n):
        for t in range(n):
            if s == t:
                continue
            if sep[s, t] <= 0:
                # zero-separation fixtures carry no discrimination signal;
                # an indistinguishable pair is a broken fixture, not a model
                # failure — surface it as -inf so the gate fails loudly
                out[s, t] = -np.inf
            else:
                out[s, t] = (m[s, t] - m[s, s]) / sep[s, t]
    return out


def discrimination_report(confusion, separation,
                          alpha: float = DEFAULT_ALPHA) -> Dict:
    """Evaluate the fixture-invariant criterion -> dict for the gate record.

    ``per_style[s]`` is True iff every other target t clears
    margin(s, t) >= alpha * sep[s, t] (which implies s is its row's argmin).
    """
    nm = normalized_margins(confusion, separation)
    n = nm.shape[0]
    per_style: List[bool] = []
    worst: List[float] = []
    for s in range(n):
        row = np.delete(nm[s], s)
        per_style.append(bool(np.all(row >= alpha)))
        worst.append(float(row.min()))
    return {
        "alpha": float(alpha),
        "normalized_margins": [[None if not np.isfinite(v) else round(float(v), 4)
                                for v in row] for row in nm],
        "per_style_discrimination": per_style,
        "per_style_min_normalized_margin": [round(w, 4) for w in worst],
        "min_normalized_margin": round(float(min(worst)), 4),
        "passed": bool(all(per_style)),
    }
