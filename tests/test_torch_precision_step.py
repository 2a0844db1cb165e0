"""One dual-tower step in the serving precision modes, the port against the
JAX package on the CPU in fp32, at the `__graft_entry__._flagship_mini()`
geometry (head_dim 128, 288 video and 50 audio tokens): ("sage", int8
towers) and ("fast", int4 towers).

The JAX side takes its kernels as on a TPU (`_flash_available` patched to
True, as `test_sage_dispatch` does; the Pallas kernels run in interpret
mode) and quantizes its towers with `quantize_tree_int8/int4`; the port's
towers are its own random modules (read into the JAX trees by the JAX
package's converters) quantized by `nn.quantize_modules`. The port's video
side takes the sage or cap-mode kernel's plain version 10 times (video
self, video text cross and a2v on each of 2 shared layers, video self and
text cross on each of 2 tail layers); the 50-query audio side takes plain
attention on both sides.

Both modes are held to relative L2 1e-3 on the video and audio outputs.
fp32 round-off alone (the two frameworks sum in different orders) stays
near 1e-6, and the cap mode and the int4 weights round nothing at run time
("fast", int4: 7e-6). The int8 towers, though, round every activation to a
level per token, and where round-off puts a value on the other side of a
rounding boundary the two sides differ by a whole level; each such flip
moves the next layer's inputs, which flip more levels. Left alone, the two
sides drift apart by 2.3-2.4e-3 (video) over four input seeds, the size of
the int8 noise itself, whatever the port gets right or wrong.

So the int8 linears of both sides quantize the same activations: the JAX
side hands out each activation it quantizes (`jax.debug.callback` in
`_linear_int8`), and the port's `nn.quantize_activations` quantizes, in
place of its own activation, the JAX activation nearest to it. Three checks
keep that honest:
- each of the port's activations lies within ACT_REL of its JAX
  counterpart (sound runs: 0.8-2.6e-4 over four seeds, from sage levels that
  round-off flips; the fault this test found, fp32 RoPE where JAX rotates
  in bf16 on the sage route, read 2.6e-3 in the audio tower and 5.9e-3 in
  the video tower);
- the port's own quantization of its activation differs from that of the
  JAX activation by at most one level per element (counted, printed);
- every int8 linear of one side has its counterpart on the other.
`nn.quantize_activations` itself is held bit-exact against `_linear_int8`
in `test_torch_quantize.py`. Outputs then agree to 7e-7 (video).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualforce_tpu import nn as jnn
from dualforce_tpu.diffusion.step import dual_tower_step as jax_dual_tower_step
from test_torch_models import _flagship_mini, _jax_config, _towers

from dualforce_tpu_torch import nn as tnn
from dualforce_tpu_torch.diffusion.step import dual_tower_step
from dualforce_tpu_torch.ops import flash_attention as tfa
from dualforce_tpu_torch.ops import sage_attention as tsa

REL = 1e-3
ACT_REL = 1e-3
KERNEL_CALLS = 2 * 3 + 2 * 2


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    """Compile the JAX reference with XLA's optimisation passes off (the same
    math, compiled faster at these sizes); restored for later files."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(scope="module")
def flagship_mini():
    cfg = _flagship_mini()
    jparams, mods = _towers(cfg)
    rng = np.random.default_rng(6)
    inputs = (rng.standard_normal((1, cfg.video_dit.in_dim, 2, 24, 24)).astype(np.float32),
              rng.standard_normal((1, cfg.audio_dit.in_dim, 50)).astype(np.float32),
              rng.standard_normal((1, 16, cfg.video_dit.text_dim)).astype(np.float32),
              np.array([750.0], np.float32), np.array([620.0], np.float32))
    return cfg, jparams, mods, inputs


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))


class _SharedActivations:
    """The JAX side's int8-linear activations, handed to the port's."""

    def __init__(self):
        self.jax = []           # fp32 activations, as `_linear_int8` quantizes them
        self.errs = []          # per port call: rel L2 to the nearest JAX activation
        self.level_flips = 0    # levels where the port's own quantization differs

    def record(self, jax_linear_int8):
        def linear(p, x):
            jax.debug.callback(lambda a: self.jax.append(np.array(a)),
                               x.astype(jnp.float32))
            return jax_linear_int8(p, x)
        return linear

    def replay(self, own_quantize):
        def quantize(x):
            mine = x.detach().numpy()
            cands = [a for a in self.jax if a.shape == mine.shape]
            assert cands, f"no JAX int8 activation of shape {mine.shape}"
            # nearest on every 61st element, then the full distance to it
            near = min(cands, key=lambda a: _rel(mine.reshape(-1)[::61], a.reshape(-1)[::61]))
            self.errs.append(_rel(mine, near))
            ai, scale = own_quantize(torch.from_numpy(near))
            diff = (ai.int() - own_quantize(x)[0].int()).abs()
            assert int(diff.max()) <= 1
            self.level_flips += int(diff.sum())
            return ai, scale
        return quantize


@pytest.mark.parametrize("impl,mode", [("sage", "int8"), ("fast", "int4")])
def test_quantized_step_matches_jax(flagship_mini, monkeypatch, impl, mode):
    cfg, jparams, mods, inputs = flagship_mini
    jcfg = _jax_config(cfg)
    jattn = importlib.import_module("dualforce_tpu.ops.attention")
    monkeypatch.setattr(jattn, "_flash_available", lambda: True)
    shared = _SharedActivations()
    monkeypatch.setattr(jnn, "_linear_int8", shared.record(jnn._linear_int8))
    qtree = jnn.quantize_tree_int8 if mode == "int8" else jnn.quantize_tree_int4
    want_v, want_a = jax.jit(lambda vp, ap, bp, *x: jax_dual_tower_step(
        qtree(vp), qtree(ap), qtree(bp), jcfg.video_dit, jcfg.audio_dit, jcfg.bridge, *x,
        video_fps=24.0, compute_dtype=jnp.float32, attn_impl=impl))(
        jparams["video_dit"], jparams["audio_dit"], jparams["bridge"], *inputs)

    calls = []
    if impl == "sage":
        plain = tsa.sage_fwd_plain
        monkeypatch.setattr(tsa, "sage_fwd_plain", lambda *a: calls.append(1) or plain(*a))
    else:
        plain = tfa.flash_attention_plain
        monkeypatch.setattr(tfa, "flash_attention_plain",
                            lambda *a, **kw: calls.append(kw["softmax_cap"]) or plain(*a, **kw))
    monkeypatch.setattr(tnn, "quantize_activations", shared.replay(tnn.quantize_activations))
    q = {name: tnn.quantize_modules(mods[name], mode)
         for name in ("video_dit", "audio_dit", "bridge")}
    with torch.no_grad():
        got_v, got_a = dual_tower_step(
            q["video_dit"], q["audio_dit"], q["bridge"], *map(torch.from_numpy, inputs),
            video_fps=24.0, compute_dtype=torch.float32, attn_impl=impl)
    assert len(calls) == KERNEL_CALLS
    if impl == "fast":
        assert set(calls) == {tfa.FAST_SOFTMAX_CAP}
    assert len(shared.errs) == len(shared.jax) == (76 if mode == "int8" else 0)
    worst = max(shared.errs, default=0.0)
    err_v, err_a = _rel(got_v.numpy(), want_v), _rel(got_a.numpy(), want_a)
    print(f"{impl}/{mode}: video rel L2 {err_v:.2e}, audio {err_a:.2e}; int8 activations "
          f"within {worst:.2e} of JAX's, {shared.level_flips} levels flipped")
    assert worst <= ACT_REL
    assert err_v <= REL and err_a <= REL
