"""Host-side image reading and writing (counterpart of
`reconstruction_tpu/io/images.py`, which replaces `cv::imread`,
`reconstruction/CStereoMatching.cpp:146,155`).

Images are float32 arrays in the reference's BGR channel order
(`CStereoMatching.cpp:728`), or (H, W) 8-bit gray.  Pillow reads and
writes them, as in the reference; it is imported at the call, and
without it a call raises ImportError naming the file.
"""

from __future__ import annotations

import numpy as np


def _pil(path: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: reading and writing images needs Pillow, "
                          "which is not installed") from e
    return Image


def check_writable(path: str) -> None:
    """Raise now, as `imwrite` would, if ``path`` cannot be written because
    Pillow is missing."""
    _pil(path)


def imread(path: str, grayscale: bool = False) -> np.ndarray:
    """Load an image as float32 (H, W, 3) BGR or (H, W) grayscale (8-bit
    "L"); the format comes from the file's contents."""
    img = _pil(path).open(path)
    if grayscale:
        return np.asarray(img.convert("L"), np.float32)
    arr = np.asarray(img.convert("RGB"), np.float32)
    return arr[..., ::-1].copy()  # BGR, like cv::imread


def imwrite(path: str, img: np.ndarray) -> None:
    """Write float or uint8 pixels (BGR order for colour), clipped to 0-255
    and truncated to uint8; the format follows the extension."""
    Image = _pil(path)
    arr = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    if arr.ndim == 3:
        arr = arr[..., ::-1]  # BGR -> RGB
    Image.fromarray(arr).save(path)
