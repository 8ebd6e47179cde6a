"""K4 (the bundle adjustment's point-camera coupling contraction): the
wrapper of `csrc/ba_coupling.cu` beside its plain PyTorch version.

    W_t[e, c, m] = sum_o He[e, o, m] * [cam[o, m] == c]

The wrapper runs the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises.  It counts its launches in
``ba_coupling.launches``.  Both sum over o in ascending order and return
He's dtype, which in `ba_blocks` is the poses' dtype (the reference's XLA
contraction's contract); the kernel takes float32 only.
"""

from __future__ import annotations

import torch

from reconstruction_tpu_torch.ops import _build
from reconstruction_tpu_torch.ops.ncc_sweep import _dispatch, _require_cuda

MAX_OBS = 32   # the kernel keeps a point's O observations in registers


def ba_coupling_plain(He: torch.Tensor, cam: torch.Tensor,
                      num_cameras: int) -> torch.Tensor:
    """Plain PyTorch contraction, the kernel's serial order over o."""
    E, O, M = He.shape
    W = torch.empty((E, num_cameras, M), dtype=He.dtype, device=He.device)
    for c in range(num_cameras):
        mask = (cam == c).to(He.dtype)                  # (O, M)
        acc = mask[0] * He[:, 0]
        for o in range(1, O):
            acc = acc + mask[o] * He[:, o]
        W[:, c] = acc
    return W


def ba_coupling(He: torch.Tensor, cam: torch.Tensor,
                num_cameras: int) -> torch.Tensor:
    """K4 on CUDA tensors, the plain contraction on CPU tensors.

    He: (E, O, M) float32 (any float dtype on the CPU); cam: (O, M) int32,
    ids outside [0, C) (the -1 padding) contribute nothing.  Returns W_t
    (E, C, M) in He's dtype."""
    if _dispatch(He):
        return ba_coupling_plain(He, cam, num_cameras)
    E, O, M = He.shape
    if not 1 <= O <= MAX_OBS:
        raise ValueError(f"ba_coupling: {O} observations per point, the "
                         f"kernel takes 1..{MAX_OBS}")
    dev = _require_cuda("ba_coupling", [(He, torch.float32, (E, O, M)),
                                        (cam, torch.int32, (O, M))])
    Wt = torch.empty((E, num_cameras, M), dtype=torch.float32, device=dev)
    if M == 0:
        return Wt
    _build.launch("rtt_ba_coupling", He.data_ptr(), cam.data_ptr(),
                  Wt.data_ptr(), E, O, num_cameras, M)
    ba_coupling.launches += 1
    return Wt


ba_coupling.launches = 0
