"""Plain PyTorch version of K3 (the Mamba2 SSD chunked scan): the
reference's ``ssd_chunked``, the oracle the kernel is held against; and
``ssd_chunked_split_ref``, a mirror of the bf16 kernel route's arithmetic
for the CPU tests (nothing on the serving path calls it)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

ROW_BLOCK = 64      # csrc/ssd_scan.cu: BR, the mma route's row block


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


def _split(v):
    """f32 ``v`` as hi + lo, both bf16 values: hi = bf16(v), lo =
    bf16(v - hi), together good to about 2**-16 of v."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def ssd_chunked_split_ref(x, dt, A, Bm, Cm, *, chunk: int):
    """The mma route of K3 (``csrc/ssd_scan.cu: ssd_scan_mma_kernel``) in
    plain PyTorch: each chunk in row blocks of ``ROW_BLOCK``; x, B and C as
    exact bf16 operands; the f32 operand of each product (the state at
    chunk entry, the gated scores M, the weighted x) split into hi + lo
    bf16 parts, each part's product summed in f32; the decay of blocks
    J < I factored as the kernel factors it.

    Same arguments as ``ssd_chunked``.  Returns (y, final_state), both
    float32: y is not cast to x's dtype, so a test can hold the route's
    arithmetic itself against the reference.
    """
    f32 = torch.float32
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    xb, Bb, Cb = (t.to(torch.bfloat16).to(f32) for t in (x, Bm, Cm))
    dt, A = dt.to(f32), A.to(f32)
    y = torch.zeros((Bsz, S, H, Pd), dtype=f32, device=x.device)
    st = torch.zeros((Bsz, H, Pd, N), dtype=f32, device=x.device)
    pos = torch.arange(chunk, device=x.device)
    for c0 in range(0, S, chunk):
        L = min(chunk, S - c0)
        d = dt[:, c0:c0 + L]                                   # (B, L, H)
        cs = torch.cumsum(d * A, dim=1)
        last = cs[:, -1]                                       # (B, H)
        X, Bc, Cc = xb[:, c0:c0 + L], Bb[:, c0:c0 + L], Cb[:, c0:c0 + L]
        sh, sl = _split(st)
        for i0 in range(0, L, ROW_BLOCK):
            i1 = min(i0 + ROW_BLOCK, L)
            Ci, csi, cs0 = Cc[:, i0:i1], cs[:, i0:i1], cs[:, i0]
            acc = (torch.einsum("bin,bhpn->bihp", Ci, sh)
                   + torch.einsum("bin,bhpn->bihp", Ci, sl)) \
                * torch.exp(cs0)[:, None, :, None]
            # blocks J < I: the decay as exp(cs_i - cs_i0) exp(cs_i0 - cs_j),
            # both <= 1, the row factor applied once after the sum
            for j0 in range(0, i0, ROW_BLOCK):
                colf = torch.exp(cs0[:, None] - cs[:, j0:j0 + ROW_BLOCK]) \
                    * d[:, j0:j0 + ROW_BLOCK]                      # (B, lj, H)
                s = torch.einsum("bin,bjn->bij", Ci, Bc[:, j0:j0 + ROW_BLOCK])
                mh, ml = _split(s[..., None] * colf[:, None])
                Xj = X[:, j0:j0 + ROW_BLOCK]
                acc = acc + torch.einsum("bijh,bjhp->bihp", mh, Xj) \
                    + torch.einsum("bijh,bjhp->bihp", ml, Xj)
            acc = acc * torch.exp(csi - cs0[:, None])[..., None]
            # the diagonal block: exp(cs_i - cs_j) where i >= j
            s = torch.einsum("bin,bjn->bij", Ci, Bc[:, i0:i1])
            keep = pos[:i1 - i0, None] >= pos[None, :i1 - i0]
            diff = csi[:, :, None, :] - csi[:, None, :, :]
            decay = torch.where(keep[None, :, :, None], diff,
                                torch.tensor(float("-inf"))).exp()
            mh, ml = _split(s[..., None] * decay * d[:, None, i0:i1])
            Xi = X[:, i0:i1]
            acc = acc + torch.einsum("bijh,bjhp->bihp", mh, Xi) \
                + torch.einsum("bijh,bjhp->bihp", ml, Xi)
            y[:, c0 + i0:c0 + i1] = acc
        wh, wl = _split((torch.exp(last[:, None] - cs) * d)[..., None] * X)
        st = st * torch.exp(last)[..., None, None] \
            + torch.einsum("bjhp,bjn->bhpn", wh, Bc) \
            + torch.einsum("bjhp,bjn->bhpn", wl, Bc)
    return y, st
