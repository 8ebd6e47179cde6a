"""Bytes that the gather of a sharded stereo stage moves, counted from a
configuration's shapes, and the link they cross.

A pair's result (`stereo/pipeline.PairResult`) holds, at the finest
level's H x W: the disparity (float32), the cloud (xyz float32 x 3,
colours uint8 x 3, valid bool, one entry a pixel), both rectified views
(uint8 x 3), both pre-erosion and both eroded masks (uint8), the refine
drift (float32, 2 a level) and both views' margins (4 int32 each): 30
bytes a pixel and 8 a level and 32 more.  Whatever carries them (NCCL on
the card, or pickles through the host), these are the bytes each rank has
to receive: the pairs that the other ranks computed.

The link: NVLink 4 of an H100 SXM5, 900 GB/s both ways by NVIDIA's data
sheet, 450 GB/s into one card.  On the four-card host the benchmark runs
on, `nvidia-smi topo -m` printed "Failed to run topology matrix";
`nvidia-smi nvlink -s -i 0` lists 18 active links on cuda:0 at 26.562 GB/s
(478 GB/s, the links' signalling rate), and the host joins its four cards
all to all by NVLink, so a rank can take in the three others' blocks at
once over its own links.  The share is taken against the data sheet's
450 GB/s.
"""

from __future__ import annotations

from typing import List

PEAK_BYTES_PER_S = 450e9


def pair_bytes(config: dict) -> int:
    """The tensor bytes of one pair's result."""
    w, h = config["lowest_level_size"]
    levels = int(config["pyramid_levels"])
    hw = (w << (levels - 1)) * (h << (levels - 1))
    return 30 * hw + 8 * levels + 32


def owned_pairs(config: dict, rank: int) -> List[int]:
    """The pairs that ``rank`` of the configuration's pair axis computes:
    its contiguous block of ceil(pairs / ranks), the padding left out."""
    n, size = len(config["cam_pairs"]), int(config["mesh"]["pair"])
    per = -(-n // size)
    return list(range(rank * per, min(n, (rank + 1) * per)))


def received_bytes(config: dict, rank: int = 0) -> int:
    """The tensor bytes of the results that ``rank`` receives."""
    return (len(config["cam_pairs"]) - len(owned_pairs(config, rank))) * pair_bytes(config)


def sent_bytes(config: dict, rank: int = 0) -> int:
    """The tensor bytes of the results that ``rank`` sends."""
    return len(owned_pairs(config, rank)) * pair_bytes(config)
