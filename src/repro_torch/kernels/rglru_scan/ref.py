"""Plain PyTorch version of K4 (the RG-LRU linear recurrence)."""

from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, over axis 1 of (B, S, W).

    A log-depth (Hillis-Steele) scan of the pairs (a, b) under
    (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2): ceil(log2 S) rounds of whole
    tensor ops, in float32.  Returns (h: (B, S, W), h_final: (B, W))."""
    a, h = a.float(), b.float()
    S, d = a.shape[1], 1
    while d < S:
        h = torch.cat([h[:, :d], a[:, d:] * h[:, :-d] + h[:, d:]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return h, h[:, -1]
