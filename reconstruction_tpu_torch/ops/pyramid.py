"""K9 (one pyramid step on the card): the wrapper of `csrc/pyramid.cu`.

Its plain version is `core/pyramid.pyr_down` (the JAX package's
`core/pyramid.pyr_down`, rounded as XLA:CPU compiles it).  For CPU
tensors the wrapper returns the plain version's result; for a CUDA tensor
it launches K9 once a step on that device's current stream, and for a
mask pyramid the same launch also writes the levels rounded to the uint8
grid.  Any other device raises; there is no fallback.  K9's launches are
counted in ``pyr_down.launches``.

Exactness.  K9 evaluates each blurred value with the plain version's
operations in its order, one float32 multiply and four fmaf, each rounded
once as `utils/fp.fma32` rounds: the levels are bit-equal.  Where the
plain version raises (a side under 3, fewer than 2 dimensions), so does
the wrapper.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from reconstruction_tpu_torch.core import pyramid as plain
from reconstruction_tpu_torch.ops import _build
from reconstruction_tpu_torch.ops.ncc_sweep import _dispatch


def _k9(img: torch.Tensor, quantize: bool, quantize_input: bool
        ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(step, step rounded or None, ``img`` rounded or None) of a CUDA
    tensor, from one K9 launch."""
    if img.ndim < 2 or img.shape[0] < 3 or img.shape[1] < 3:
        raise IndexError(f"pyr_down: shape {tuple(img.shape)} has a side under 3 "
                         f"(the reflect-101 blur reads 2 pixels past each edge)")
    x = img.float().contiguous()
    H, W = x.shape[:2]
    C = x[0, 0].numel()
    out = x.new_empty(((H + 1) // 2, (W + 1) // 2, *x.shape[2:]))
    out_q = torch.empty_like(out) if quantize else None
    in_q = torch.empty_like(x) if quantize_input else None
    if C:
        with torch.cuda.device(x.device):
            _build.launch("rtt_pyr_down", x.data_ptr(), out.data_ptr(),
                          None if out_q is None else out_q.data_ptr(),
                          None if in_q is None else in_q.data_ptr(), H, W, C)
        pyr_down.launches += 1
    return out, out_q, in_q


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """One pyramid step: blur + 2x decimate, (H, W) or (H, W, C) to
    (ceil(H/2), ceil(W/2)[, C]) float32; K9 on a CUDA tensor."""
    if _dispatch(img):
        return plain.pyr_down(img)
    return _k9(img, False, False)[0]


def build_pyramid(img: torch.Tensor, levels: int, quantize: bool = False) -> List[torch.Tensor]:
    """Coarse->fine list of length ``levels``; ``img`` is the finest
    (`core/pyramid.build_pyramid`).  With ``quantize`` every level is
    returned rounded to the uint8 grid (`core/pyramid.quantize_u8`) while
    each step still reads the unrounded level.  On a CUDA tensor: one K9
    launch a step, the rounded levels written by the same launches."""
    if _dispatch(img):
        pyr = plain.build_pyramid(img, levels)
        return [plain.quantize_u8(p) for p in pyr] if quantize else pyr
    if levels < 2:
        return [plain.quantize_u8(img) if quantize else img]
    cur, cur_q, img_q = _k9(img, quantize, quantize)
    pyr = [cur_q if quantize else cur, img_q if quantize else img]
    for _ in range(levels - 2):
        cur, cur_q, _ = _k9(cur, quantize, False)
        pyr.insert(0, cur_q if quantize else cur)
    return pyr


pyr_down.launches = 0
