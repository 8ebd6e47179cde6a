"""Host-side image writing (from `reconstruction_tpu/io/images.py`; PIL is
imported at the call).  Images are float32 arrays in the reference's BGR
channel order (`CStereoMatching.cpp:728`); reading comes with the run
configuration loader.
"""

from __future__ import annotations

import numpy as np


def imwrite(path: str, img: np.ndarray) -> None:
    from PIL import Image
    arr = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    if arr.ndim == 3:
        arr = arr[..., ::-1]  # BGR -> RGB
    Image.fromarray(arr).save(path)
