"""The first-frame transforms of the inference CLIs (the port's copy of
`crop_and_resize` and `image_to_tensor` in `dualforce_tpu/data/transforms.py`;
a test holds them equal). PIL is imported where an image is resized."""

from __future__ import annotations

import numpy as np


def crop_and_resize(image, height: int, width: int):
    """Aspect-preserving LANCZOS scale, then a center crop to height x width
    (a PIL image in, a PIL image out)."""
    from PIL import Image

    w, h = image.size
    scale = max(width / w, height / h)
    image = image.resize((round(w * scale), round(h * scale)), Image.Resampling.LANCZOS)
    w2, h2 = image.size
    left, top = (w2 - width) // 2, (h2 - height) // 2
    return image.crop((left, top, left + width, top + height))


def image_to_tensor(image) -> np.ndarray:
    """An RGB image -> float32 [H, W, 3] in [-1, 1]."""
    return np.asarray(image, np.float32) / 127.5 - 1.0
