"""K8 (the rectify maps on the card): the wrapper of `csrc/rectify_map.cu`.

Its plain version is `core/remap.sampling_maps`, float64 NumPy on the host
(the JAX package's `core/remap.rectify_map` computes the same maps).  For
the CPU the wrapper returns the plain version's arrays as tensors; for a
CUDA device it allocates both maps there and launches K8 on that device's
current stream, with M_inv and K passed by value: no copy to the card, no
read-back.  Any other device raises; there is no fallback.  K8's launches
are counted in ``rectify_map.launches`` (one a view).

Exactness.  K8 repeats the plain version's float64 operations one for one
(IEEE multiply, add and divide, no contraction) and rounds to float32 as
NumPy does: the maps are bit-equal, NaN (xyw_2 and its numerator both 0)
by position.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from reconstruction_tpu_torch.core.remap import sampling_maps
from reconstruction_tpu_torch.ops import _build


def rectify_map(M_inv: np.ndarray, K: np.ndarray, out_size: Tuple[int, int],
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(map_x, map_y), float32 (height, width) tensors on ``device``: the
    source pixel of every rectified pixel, from M_inv = (A' R)^{-1}
    (`core/remap.rectify_inverse`) and the original intrinsics K, both
    host (3, 3) arrays; ``out_size`` is (width, height)."""
    device = torch.device(device)
    M = np.asarray(M_inv, np.float64)
    K = np.asarray(K, np.float64)
    if M.shape != (3, 3) or K.shape != (3, 3):
        raise ValueError(f"rectify_map: M_inv {M.shape} and K {K.shape}, expected (3, 3)")
    w, h = (int(s) for s in out_size)
    if device.type == "cpu":
        mx, my = sampling_maps(M, K, (w, h))
        return torch.from_numpy(mx), torch.from_numpy(my)
    if device.type != "cuda":
        raise RuntimeError(f"rectify_map: no kernel for device {device}")
    with torch.cuda.device(device):
        map_x = torch.empty((h, w), dtype=torch.float32, device=device)
        map_y = torch.empty((h, w), dtype=torch.float32, device=device)
        if h * w:
            k = (K[0, 0], K[0, 1], K[0, 2], K[1, 1], K[1, 2])
            _build.launch("rtt_rectify_map", map_x.data_ptr(), map_y.data_ptr(), h, w,
                          *map(float, M.ravel()), *map(float, k))
            rectify_map.launches += 1
    return map_x, map_y


rectify_map.launches = 0
