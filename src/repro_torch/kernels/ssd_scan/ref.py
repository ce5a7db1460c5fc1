"""Plain PyTorch version of K3 (the Mamba2 SSD chunked scan): the
reference's ``ssd_chunked``, the oracle the kernel is held against."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int, init_state=None):
    """Chunked SSD scan.

    x: (B, S, H, P), dt: (B, S, H), A: (H,), Bm/Cm: (B, S, N) (1 group).
    Returns (y, final_state) with y: (B, S, H, P) in x's dtype and state:
    (B, H, P, N) float32.  Sequences are zero-padded to a chunk multiple
    (dt = 0: decay 1, contribution 0, so the state passes through).  All
    math in float32.
    """
    Bsz, S0, H, Pd = x.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S0)
    pad = (-S0) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    S = S0 + pad
    nc = S // chunk
    f32 = torch.float32

    xc = x.reshape(Bsz, nc, chunk, H, Pd).to(f32)
    dtc = dt.reshape(Bsz, nc, chunk, H).to(f32)
    Bc = Bm.reshape(Bsz, nc, chunk, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, chunk, N).to(f32)

    dA_cs = torch.cumsum(dtc * A.to(f32), dim=2)              # (B,nc,cs,H)

    # intra-chunk: L[i, j] = exp(cs_i - cs_j) for i >= j, else 0.  The
    # exponent is masked *before* exp: for i < j it is positive and exp
    # would overflow to inf (and inf * 0 is NaN).
    diff = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]   # (B,nc,i,j,H)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    L = torch.where(tri[None, None, :, :, None], diff,
                    torch.tensor(float("-inf"), device=x.device)).exp()
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    xdt = xc * dtc[..., None]                                  # (B,nc,cs,H,P)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * L, xdt)

    # chunk states
    decay_last = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)        # (B,nc,cs,H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchpn", Bc, decay_last, xdt)

    # inter-chunk recurrence (sequential over nc)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                # (B,nc,H)
    st = (torch.zeros((Bsz, H, Pd, N), dtype=f32, device=x.device)
          if init_state is None else init_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                     # (B,nc,H,P,N)

    # off-diagonal contribution of the previous chunks' state
    y_off = torch.einsum("bcin,bcih,bchpn->bcihp", Cc, torch.exp(dA_cs),
                         prev_states)

    y = (y_diag + y_off).reshape(Bsz, S, H, Pd)[:, :S0]
    return y.to(x.dtype), st
