"""Disparity constraint passes (counterpart of
`reconstruction_tpu/stereo/constraints.py`).  Each runs a kernel of
`ops/constraints.py` on the card and its plain version on the CPU:

  * smoothness: 8-neighbour link/violation counting (K10; a thread a pixel)
  * ordering: the greedy crossing removal, one row a thread block (K6; its
    plain version runs all rows together)
  * uniqueness: forward, reverse, forward again in one launch, a block a
    row (K11; the plain version gathers the target map and evaluates the
    in-row kill cascade in closed form with two running maxima)
  * masked median over the reference's 2-column x 3-row window (K12; a
    sorting network a pixel, the plain version a stacked sort)
  * bound propagation: the reference's four directional sweeps as
    sequential recurrences, a column pass and a row pass (K7; its plain
    version evaluates the reference's associative scans with
    `jax.lax.associative_scan`'s pairing tree)

The two deviations from the original C++ that the reference documents
(the SE link-count aliasing and the boundary clamp typo) are kept.
"""

from __future__ import annotations

from typing import Tuple

import torch

from reconstruction_tpu_torch.ops import constraints as K67
from reconstruction_tpu_torch.stereo.margins import Margins


def smoothness_constraint(disp: torch.Tensor, m: Margins) -> torch.Tensor:
    """Kill pixels with no valid 8-neighbours, or with |d - d_q| > 1 to
    more than half of them (`CStereoMatching.cpp:370-448`).  K10 on the
    card (`ops/constraints.smoothness`), its plain version on the CPU."""
    return K67.smoothness(disp, m)


def ordering_constraint(disp: torch.Tensor, m: Margins) -> torch.Tensor:
    """Greedy epipolar-order enforcement (`CStereoMatching.cpp:310-368`):
    every row repeatedly deletes its point with the most crossings (the
    first such point on ties) until none cross.  K6 on the card
    (`ops/constraints.ordering`), its plain version on the CPU."""
    return K67.ordering(disp, m)


def uniqueness_constraint(d0: torch.Tensor, d1: torch.Tensor,
                          m0: Margins, m1: Margins
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward, reverse (using the updated forward map), forward again
    (`CStereoMatching.cpp:450-497`), each pass with its in-row kill
    cascade.  K11 on the card (`ops/constraints.uniqueness`), its plain
    version on the CPU."""
    return K67.uniqueness(d0, d1, m0, m1)


def median_filter(disp: torch.Tensor, valid_mask: torch.Tensor, m: Margins,
                  iterations: int = 1) -> torch.Tensor:
    """Masked median with fill/kill rules (`CStereoMatching.cpp:763-815`)
    over the reference's window: columns x-1, x by rows y-1..y+1.  An
    even count takes the truncated mean of the middle two.  K12 on the
    card (`ops/constraints.median`, a launch an iteration), its plain
    version on the CPU."""
    return K67.median(disp, valid_mask, m, iterations)


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
