"""Image transforms (the port's copy of `dualforce_tpu/data/transforms.py`; a
test holds them equal): the inference CLIs' first-frame `crop_and_resize`
and `image_to_tensor`, `Compose`, and the `TV*` transforms, torchvision's
semantics over PIL and numpy, which the reference registers by name for
dataset configs. `TRANSFORMS` (the `registry.TRANSFORMS` registry) names them
all; `Compose` builds a dict entry {"type": name, **kwargs} through it. The random ones draw from
`np.random.default_rng(seed)` in the JAX package's order. PIL is imported
where an image is made or resized."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from dualforce_tpu_torch.registry import TRANSFORMS

_BILINEAR = 2       # PIL's Image.Resampling.BILINEAR


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


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = [TRANSFORMS.build(t) if isinstance(t, dict) else t
                           for t in transforms]

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


def _size_pair(size):
    return (size, size) if isinstance(size, int) else tuple(size)


class TVResize:
    """int size: the shorter side to `size`, keeping the aspect; (h, w): exactly."""

    def __init__(self, size, interpolation=_BILINEAR):
        self.size = size
        self.interpolation = interpolation

    def __call__(self, img):
        if isinstance(self.size, int):
            w, h = img.size
            short, long = (w, h) if w <= h else (h, w)
            new_long = round(self.size * long / short)
            nw, nh = (self.size, new_long) if w <= h else (new_long, self.size)
            return img.resize((nw, nh), self.interpolation)
        h, w = _size_pair(self.size)
        return img.resize((w, h), self.interpolation)


class TVCenterCrop:
    def __init__(self, size):
        self.size = _size_pair(size)

    def __call__(self, img):
        from PIL import Image

        th, tw = self.size
        w, h = img.size
        if w < tw or h < th:  # torchvision zero-pads undersized inputs
            canvas = Image.new(img.mode, (max(w, tw), max(h, th)))
            canvas.paste(img, ((canvas.width - w) // 2, (canvas.height - h) // 2))
            img, (w, h) = canvas, canvas.size
        left, top = (w - tw) // 2, (h - th) // 2
        return img.crop((left, top, left + tw, top + th))


class TVRandomCrop:
    def __init__(self, size, seed=None):
        self.size = _size_pair(size)
        self.rng = np.random.default_rng(seed)

    def __call__(self, img):
        th, tw = self.size
        w, h = img.size
        if w < tw or h < th:
            raise ValueError(f"crop {self.size} larger than image {(h, w)}")
        left = int(self.rng.integers(0, w - tw + 1))
        top = int(self.rng.integers(0, h - th + 1))
        return img.crop((left, top, left + tw, top + th))


class _RandomFlip:
    _METHOD = 0

    def __init__(self, p: float = 0.5, seed=None):
        self.p = p
        self.rng = np.random.default_rng(seed)

    def __call__(self, img):
        return img.transpose(self._METHOD) if self.rng.random() < self.p else img


class TVRandomHorizontalFlip(_RandomFlip):
    _METHOD = 0     # PIL's Image.Transpose.FLIP_LEFT_RIGHT


class TVRandomVerticalFlip(_RandomFlip):
    _METHOD = 1     # PIL's Image.Transpose.FLIP_TOP_BOTTOM


class TVGrayscale:
    def __init__(self, num_output_channels: int = 1):
        self.n = num_output_channels

    def __call__(self, img):
        g = img.convert("L")
        return g.convert("RGB") if self.n == 3 else g


class TVPad:
    def __init__(self, padding, fill: int = 0):
        if isinstance(padding, int):
            padding = (padding,) * 4          # left, top, right, bottom
        elif len(padding) == 2:
            padding = (padding[0], padding[1]) * 2
        self.padding = tuple(padding)
        self.fill = fill

    def __call__(self, img):
        from PIL import Image

        l, t, r, b = self.padding
        canvas = Image.new(img.mode, (img.width + l + r, img.height + t + b), self.fill)
        canvas.paste(img, (l, t))
        return canvas


class TVToTensor:
    """PIL or uint8 HWC -> float32 CHW in [0, 1] (torchvision's layout)."""

    def __call__(self, img) -> np.ndarray:
        a = np.asarray(img, np.float32) / 255.0
        if a.ndim == 2:
            a = a[:, :, None]
        return np.ascontiguousarray(a.transpose(2, 0, 1))


class TVNormalize:
    """(x - mean) / std on channel-first float input (after TVToTensor)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean) / self.std


class TVLambda:
    def __init__(self, lambd: Callable):
        self.lambd = lambd

    def __call__(self, x):
        return self.lambd(x)


# the JAX package's TRANSFORMS registry's names
for _name, _fn in {
    "Compose": Compose, "CropAndResize": crop_and_resize, "TVResize": TVResize,
    "TVCenterCrop": TVCenterCrop, "TVRandomCrop": TVRandomCrop,
    "TVRandomHorizontalFlip": TVRandomHorizontalFlip,
    "TVRandomVerticalFlip": TVRandomVerticalFlip, "TVGrayscale": TVGrayscale,
    "TVPad": TVPad, "TVToTensor": TVToTensor, "TVNormalize": TVNormalize,
    "TVLambda": TVLambda,
}.items():
    TRANSFORMS.register_module(name=_name, module=_fn)
