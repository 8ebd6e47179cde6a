"""Disparity constraint passes (counterpart of
`reconstruction_tpu/stereo/constraints.py`).

  * smoothness: 8-neighbour link/violation counting
  * ordering: the greedy crossing removal, one row a thread block (K6,
    `ops/constraints.py`; its plain version runs all rows together)
  * uniqueness: a plain gather of the target map, and the in-row kill
    cascade in closed form with two running maxima
  * masked median over the reference's 2-column x 3-row window
  * bound propagation: the reference's four directional sweeps as
    sequential recurrences, a column pass and a row pass (K7,
    `ops/constraints.py`; its plain version evaluates the reference's
    associative scans with `jax.lax.associative_scan`'s pairing tree)

The two deviations from the original C++ that the reference documents
(the SE link-count aliasing and the boundary clamp typo) are kept.
"""

from __future__ import annotations

from typing import Tuple

import torch

from reconstruction_tpu_torch.config import NOMATCH
from reconstruction_tpu_torch.ops import constraints as K67
from reconstruction_tpu_torch.stereo.margins import Margins, inner_box
from reconstruction_tpu_torch.stereo.ncc import shifted

_BIG = 1e9
_NM = float(NOMATCH)


def _nm(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_NM, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Smoothness
# ---------------------------------------------------------------------------

def smoothness_constraint(disp: torch.Tensor, m: Margins) -> torch.Tensor:
    """Kill pixels with no valid 8-neighbours, or with |d - d_q| > 1 to
    more than half of them (`CStereoMatching.cpp:370-448`)."""
    H, W = disp.shape
    box = inner_box(m, H, W)
    valid = (disp != NOMATCH) & box
    dmask = torch.where(valid, disp, _nm(disp))
    links = torch.zeros((H, W), dtype=torch.int32, device=disp.device)
    viol = torch.zeros_like(links)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = shifted(dmask, dy, dx)
            nb_valid = shifted(valid, dy, dx)
            links = links + nb_valid.to(torch.int32)
            viol = viol + (nb_valid & ((disp - nb).abs() > 1)).to(torch.int32)
    kill = box & ((links == 0) | (2 * viol > links))
    return torch.where(kill, _nm(disp), disp)


# ---------------------------------------------------------------------------
# Ordering
# ---------------------------------------------------------------------------

def ordering_constraint(disp: torch.Tensor, m: Margins) -> torch.Tensor:
    """Greedy epipolar-order enforcement (`CStereoMatching.cpp:310-368`):
    every row repeatedly deletes its point with the most crossings (the
    first such point on ties) until none cross.  K6 on the card
    (`ops/constraints.ordering`), its plain version on the CPU."""
    return K67.ordering(disp, m)


# ---------------------------------------------------------------------------
# Uniqueness
# ---------------------------------------------------------------------------

def _uniqueness_pass(p: torch.Tensor, q: torch.Tensor,
                     m_src: Margins, m_tgt: Margins) -> torch.Tensor:
    """One directional pass of `UniquenessContraint_`
    (`CStereoMatching.cpp:463-497`), including the in-row kill cascade."""
    H, W = p.shape
    dev = p.device
    box = inner_box(m_src, H, W)
    valid = (p != NOMATCH) & box
    x = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    base = torch.trunc(p + 0.5).to(torch.int32) + x - 1
    bL = torch.maximum(base, m_tgt.XL.to(torch.int32))
    bR = torch.minimum(bL + 2, m_tgt.XR.to(torch.int32))

    hit = torch.zeros((H, W), dtype=torch.bool, device=dev)
    qv = []
    for k in range(3):
        col = torch.clamp(bL + k, 0, W - 1).long()
        v = torch.gather(q, 1, col)
        qv.append(v)
        hit = hit | (((bL + k) <= bR) & valid & ((v + p).abs() < 2))

    q_mid = qv[1]
    c_east = (q_mid + shifted(p, 0, 1)).abs() >= 2       # original p[x+1]
    c_west_orig = (q_mid + shifted(p, 0, -1)).abs() >= 2
    # kill(x) = g(x) & (c_west_orig(x) | kill(x-1)), g = valid & ~hit & c_east:
    # x is killed iff some b = g & c_west_orig at j <= x starts a run of g
    # that reaches x, i.e. the last b comes after the last ~g.
    g = valid & ~hit & c_east
    b = g & c_west_orig
    idx = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(H, W)
    neg = torch.full_like(idx, -1)
    last_b = torch.cummax(torch.where(b, idx, neg), dim=1).values
    last_break = torch.cummax(torch.where(~g, idx, neg), dim=1).values
    kill = g & (last_b > last_break)
    return torch.where(kill, _nm(p), p)


def uniqueness_constraint(d0: torch.Tensor, d1: torch.Tensor,
                          m0: Margins, m1: Margins
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward, reverse (using the updated forward map), forward again
    (`CStereoMatching.cpp:450-461`)."""
    d0 = _uniqueness_pass(d0, d1, m0, m1)
    d1 = _uniqueness_pass(d1, d0, m1, m0)
    d0 = _uniqueness_pass(d0, d1, m0, m1)
    return d0, d1


# ---------------------------------------------------------------------------
# Median filter
# ---------------------------------------------------------------------------

def median_filter(disp: torch.Tensor, valid_mask: torch.Tensor, m: Margins,
                  iterations: int = 1) -> torch.Tensor:
    """Masked median with fill/kill rules (`CStereoMatching.cpp:763-815`)
    over the reference's window: columns x-1, x by rows y-1..y+1.  An
    even count takes the truncated mean of the middle two."""
    H, W = disp.shape
    box = inner_box(m, H, W)
    compute = valid_mask & box
    offsets = [(dy, dx) for dx in (-1, 0) for dy in (-1, 0, 1)]
    nm = _nm(disp)
    d = disp
    for _ in range(iterations):
        vals = torch.stack([shifted(d, dy, dx) for dy, dx in offsets])
        ok = vals != NOMATCH
        k = ok.sum(dim=0)
        svals = torch.sort(torch.where(ok, vals, torch.tensor(
            _BIG, dtype=torch.float32, device=d.device)), dim=0).values
        lo = torch.clamp((k - 1) // 2, 0, 5)
        hi = torch.clamp(k // 2, 0, 5)
        v_lo = torch.gather(svals, 0, lo[None]).squeeze(0)
        v_hi = torch.gather(svals, 0, hi[None]).squeeze(0)
        med = torch.trunc((v_lo + v_hi) / 2.0)
        out = torch.where(d != NOMATCH,
                          torch.where(k <= 2, nm, med),
                          torch.where(k >= 4, med, nm))
        d = torch.where(compute, out, nm)
    return d


# ---------------------------------------------------------------------------
# Bound propagation (SetBoundary_smooth)
# ---------------------------------------------------------------------------

def propagate_bounds(
    disp: torch.Tensor,
    valid_mask: torch.Tensor,
    m_src: Margins,
    m_tgt: Margins,
    max_step: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Admissible target-column intervals [BL, BR] for hole re-matching
    (`SetBoundary_smooth`, `CStereoMatching.cpp:817-942`): valid
    disparities seed the bounds; down, up, left->right and right->left
    sweeps relax them.  Absolute-column float32 maps, meaningful at
    mask-valid source pixels.  K7 on the card
    (`ops/constraints.propagate_bounds`), its plain version on the CPU."""
    return K67.propagate_bounds(disp, valid_mask, m_src, m_tgt, max_step)
