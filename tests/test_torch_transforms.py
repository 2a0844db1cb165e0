"""The port's image transforms (`data/transforms.py`) against the JAX
package's (`dualforce_tpu/data/transforms.py`) on the same PIL images and
seeds: every `TV*` class, `Compose` built from name entries, and the name
table against the JAX package's `TRANSFORMS` registry. Exact: the same
pixels, arrays and random draws."""

import numpy as np
import pytest
from PIL import Image

from dualforce_tpu.data import transforms as jt
from dualforce_tpu.registry import TRANSFORMS as JAX_TRANSFORMS

from dualforce_tpu_torch.data import transforms as tt
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)


def _images():
    g = np.random.default_rng(0)
    return [Image.fromarray(g.integers(0, 256, (h, w, 3), np.uint8)) for h, w in
            ((37, 53), (64, 48), (20, 20))] + [
        Image.fromarray(g.integers(0, 256, (30, 41), np.uint8))]


def _same(a, b):
    if isinstance(a, Image.Image):
        assert isinstance(b, Image.Image) and a.mode == b.mode and a.size == b.size
        a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(a, b)


CASES = {
    "TVResize": [dict(size=24), dict(size=(17, 29)),
                 dict(size=31, interpolation=Image.Resampling.NEAREST)],
    "TVCenterCrop": [dict(size=16), dict(size=(40, 70))],
    "TVRandomCrop": [dict(size=12, seed=3), dict(size=(8, 15), seed=None)],
    "TVRandomHorizontalFlip": [dict(p=0.5, seed=1), dict(p=1.0, seed=2)],
    "TVRandomVerticalFlip": [dict(p=0.5, seed=4), dict(p=0.0)],
    "TVGrayscale": [dict(), dict(num_output_channels=3)],
    "TVPad": [dict(padding=3), dict(padding=(2, 5), fill=7), dict(padding=(1, 2, 3, 4))],
    "TVToTensor": [dict()],
    "CropAndResize": [dict(height=16, width=24)],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_transform_matches_jax(name):
    for kw in CASES[name]:
        if kw.get("seed", 0) is None:     # unseeded: draws differ by design; both run
            tt.TRANSFORMS[name](**kw)(_images()[0])
            continue
        if name == "CropAndResize":
            mine = lambda im, kw=kw: tt.TRANSFORMS[name](im, **kw)   # noqa: E731
            theirs = lambda im, kw=kw: JAX_TRANSFORMS.get(name)(im, **kw)   # noqa: E731
        else:
            mine, theirs = tt.TRANSFORMS[name](**kw), JAX_TRANSFORMS.get(name)(**kw)
        for im in _images() * 3:          # a random transform keeps drawing in order
            _same(mine(im), theirs(im))


def test_normalize_lambda_and_compose_match_jax():
    steps = [{"type": "TVResize", "size": 20}, {"type": "TVRandomCrop", "size": 16, "seed": 5},
             {"type": "TVRandomHorizontalFlip", "seed": 6}, {"type": "TVToTensor"},
             {"type": "TVNormalize", "mean": [0.5, 0.4, 0.3], "std": [0.2, 0.25, 0.3]}]
    mine = tt.Compose(steps + [tt.TVLambda(lambda x: x * 2)])
    theirs = jt.Compose(steps + [jt.TVLambda(lambda x: x * 2)])
    for im in _images()[:3] * 2:
        _same(mine(im), theirs(im))
    assert set(tt.TRANSFORMS) == set(JAX_TRANSFORMS.keys())
    with pytest.raises(KeyError):
        tt.Compose([{"type": "TVNoSuch"}])
