"""Mitigation of Lit Silicon — paper Algorithms 2 (INCPOWERGPU) and
3 (ADJPOWERNODE), vectorized.

Algorithm 2 turns an aggregate lead vector into per-device power-cap
increases: proportional to the device's normalized lead within the sample
(line 5) and damped by the largest lead ever seen (line 6, 'global' scale) so
adjustments shrink as convergence approaches.  Algorithm 3 projects the
requested caps onto the node power cap and TDP by uniform shifts.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def inc_power_gpu(lead: np.ndarray, max_inc: float, global_max: float,
                  scale: str = "global") -> Tuple[np.ndarray, float]:
    """Algorithm 2.  lead: (G,) aggregate lead values.

    Returns (I (G,) cap increases, updated global_max).
    scale='local' always uses max_inc (paper Table II: faster, more variance).
    """
    lead = np.asarray(lead, float)
    max_lead = float(lead.max())
    min_lead = float(lead.min())
    global_max = max(global_max, max_lead)
    span = max_lead - min_lead
    if span <= 0:
        norm_lead = np.ones_like(lead)      # no differentiation this sample
    else:
        norm_lead = 1.0 - (lead - min_lead) / span
    damp = (max_lead / global_max) if (scale == "global"
                                       and global_max > 0) else 1.0
    return norm_lead * damp * max_inc, global_max


def adj_power_node(inc: np.ndarray, caps: np.ndarray, tdp: float,
                   node_cap: float) -> np.ndarray:
    """Algorithm 3: apply increases, then uniform-shift to satisfy the node
    cap (line 5-8) and TDP (line 9-11)."""
    caps = np.asarray(caps, float) + np.asarray(inc, float)
    G = caps.shape[0]
    node_power = float(caps.sum())
    gpu_delta_max = math.ceil((node_power - node_cap) / G)
    caps = caps - gpu_delta_max
    gpu_delta = max(0.0, float((caps - tdp).max()))
    caps = caps - gpu_delta
    return caps
