"""Detection of Lit Silicon — paper Algorithm 1 (LEADVALUEDETECT) plus the
straggler-wave / overlap-ratio analyses of §III (Figs 3, 4, 6, 7).

Lead value of device g on kernel k = (latest start among devices) - (g's
start): the straggler trends to 0, leaders accumulate lead until collectives
clamp them (equilibrium).  Aggregation: sum (area under the wave — default,
penalizes devices while in equilibrium), max, or last (paper Table II).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def lead_values(start: np.ndarray) -> np.ndarray:
    """Algorithm 1 lines 1-4.  start: (G, K) kernel-start timestamps.

    Returns lead_value: (G, K).  NaN starts (never-ran kernels, or readings
    a lossy telemetry sensor dropped) -> 0 lead; an all-NaN kernel column
    (no device reported it) is 0 lead everywhere rather than a warning —
    noisy sensor streams hit this case routinely.
    """
    t = np.asarray(start, float)
    finite = np.isfinite(t)
    t_max = np.where(finite, t, -np.inf).max(axis=0, keepdims=True)
    return np.where(finite & np.isfinite(t_max), t_max - t, 0.0)


def aggregate_lead(lead: np.ndarray, mode: str = "sum") -> np.ndarray:
    """Algorithm 1 lines 5-6 (plus the paper's max/last alternatives)."""
    if mode == "sum":
        return lead.sum(axis=1)
    if mode == "max":
        return lead.max(axis=1)
    if mode == "last":
        return lead[:, -1]
    raise ValueError(f"unknown aggregation {mode!r}")


def lead_value_detect(start: np.ndarray, mode: str = "sum") -> np.ndarray:
    """Full Algorithm 1: (G, K) starts -> (G,) aggregate lead vector."""
    return aggregate_lead(lead_values(start), mode)


def straggler_index(start: np.ndarray, mode: str = "sum") -> int:
    """The straggler has the smallest aggregate lead (~0: everyone waits)."""
    return int(np.argmin(lead_value_detect(start, mode)))


# --------------------------------------------------------------------------- #
# §III characterization statistics
# --------------------------------------------------------------------------- #
def overlap_spread(overlap_ratio: np.ndarray) -> np.ndarray:
    """(G, K) per-kernel overlap ratios -> (K,) max-min spread across GPUs."""
    return overlap_ratio.max(axis=0) - overlap_ratio.min(axis=0)


def classify_overlap(overlap_ratio: np.ndarray,
                     tol: float = 0.15) -> np.ndarray:
    """Split kernels into constant (C) vs varying (V) overlap sets (§IV-A).

    Returns bool (K,): True -> constant overlap (spread < tol across GPUs).
    """
    return overlap_spread(overlap_ratio) < tol


def pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = a - a.mean()
    b = b - b.mean()
    d = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / d) if d > 0 else 0.0


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    d = np.linalg.norm(a) * np.linalg.norm(b)
    return float(np.dot(a, b) / d) if d > 0 else 0.0


def overlap_duration_correlation(overlap_ratio: np.ndarray,
                                 dur: np.ndarray) -> Tuple[float, float]:
    """Fig 4: correlation between a kernel's overlap ratio and its duration
    across GPUs×samples.  Returns (pearson, cosine)."""
    o = overlap_ratio.ravel()
    d = dur.ravel()
    return pearson(o, d), cosine(o, d)
