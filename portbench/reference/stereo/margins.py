"""Mask bounding-box margins (counterpart of
`reconstruction_tpu/stereo/margins.py`).

Margins are 0-d int32 tensors on the mask's device, never Python ints, so
that no stage has to wait for the device to learn them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Margins(NamedTuple):
    """Valid-region bounding box, inclusive (reference `Boundary` struct)."""

    YL: torch.Tensor
    YR: torch.Tensor
    XL: torch.Tensor
    XR: torch.Tensor


def find_margin(valid: torch.Tensor, radius: int) -> Margins:
    """Bounding box of valid pixels in the interior band [radius, size-radius).

    For an empty mask the reference's degenerate values are returned
    (YL > YR), which downstream stages treat as "no valid region"."""
    H, W = valid.shape
    dev = valid.device
    band = torch.zeros_like(valid)
    band[radius:H - radius, radius:W - radius] = \
        valid[radius:H - radius, radius:W - radius]
    rows = band.any(dim=1)
    cols = band.any(dim=0)
    ridx = torch.arange(H, dtype=torch.int32, device=dev)
    cidx = torch.arange(W, dtype=torch.int32, device=dev)
    big = torch.tensor(1 << 30, dtype=torch.int32, device=dev)
    YL = torch.where(rows, ridx, big).min()
    YR = torch.where(rows, ridx, -big).max()
    XL = torch.where(cols, cidx, big).min()
    XR = torch.where(cols, cidx, -big).max()
    empty = ~rows.any()

    def deg(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    YL = torch.where(empty, deg(H - 1 - radius), YL)
    YR = torch.where(empty, deg(radius), YR)
    XL = torch.where(empty, deg(W - 1 - radius), XL)
    XR = torch.where(empty, deg(radius), XR)
    return Margins(YL=YL, YR=YR, XL=XL, XR=XR)


def inner_box(m: Margins, H: int, W: int, inset: int = 0) -> torch.Tensor:
    """(H, W) boolean: inside [YL+inset..YR-inset] x [XL+inset..XR-inset]."""
    dev = m.YL.device
    y = torch.arange(H, dtype=torch.int32, device=dev)[:, None]
    x = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    return ((y >= m.YL + inset) & (y <= m.YR - inset)
            & (x >= m.XL + inset) & (x <= m.XR - inset))
