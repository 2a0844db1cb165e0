"""`remat_save_attention` in the port against full remat and against the JAX
package's switch of the same name, on the CPU in fp32.

A tiny dual tower (two video layers, one audio layer: a shared layer and a
video-only tail, head_dim 48) takes every attention through flash
attention (`attn_impl="pallas"`: the port's plain versions here, JAX's
Pallas kernels in interpret mode) under remat. With the switch on, the
port's LoRA gradients must be bit-equal to full remat's, the same backward
on the same tensors, while the forward runs once per attention instead of
twice (counted by a wrapper around the forward). Against JAX with its
switch on, the shared layer alone (one video layer; the interpret-mode
kernels make each layer cost seconds to trace), 1e-4 relative on the loss
and 1e-3 relative (atol 1e-6) on the gradients, fp32 round-off through the
layers and their backward.
"""

import jax
import numpy as np
import pytest
import torch

from dualforce_tpu.ops.flash_attention import remat_save_attention as jax_remat_save
from test_torch_training import _jax_lora, _jax_params, _noise, _np, _t, _tables
from test_torch_training_loss import _check_grads, _encoded, _jax_config, _jax_loss_and_grads

from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import from_jax
from dualforce_tpu_torch.diffusion import training as ttr
from dualforce_tpu_torch.diffusion.flow_match import FlowMatchPairScheduler
from dualforce_tpu_torch.models.factory import init_pipeline_params
from dualforce_tpu_torch.ops import flash_attention as fa

# per step of this tower: the shared layer's 6 attentions (a2v, v2a, video
# self and text cross, audio self and text cross) and the tail layer's 2
ATTENTIONS = 8


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_unoptimised():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _tower(visual_layers: int):
    cfg = tiny_test_config(visual_layers=visual_layers, audio_layers=1)
    jcfg = _jax_config(cfg)
    mods = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=3,
                                with_vaes=False, with_text=False)
    jparams = _jax_params(mods, jcfg)
    enc = _encoded(cfg, (2, 8, 8), 21, 24, 8)
    jl = _jax_lora(jparams)
    return dict(cfg=cfg, jcfg=jcfg, mods=mods, jparams=jparams, enc=enc, jl=jl,
                lora=from_jax.lora(_np(jl), cfg), noise=_noise(enc, 9),
                tables=_tables(cfg, FlowMatchPairScheduler))


@pytest.fixture(scope="module")
def tower():
    """A shared layer and a video-only tail."""
    return _tower(2)


@pytest.fixture(scope="module")
def shared_layer():
    """The shared layer alone."""
    return _tower(1)


def _port_grads(tower, save: bool, tid: int = 120, remat: bool = True):
    prev = fa.remat_save_attention(save)
    try:
        return ttr.lora_grads(tower["lora"], tower["mods"], tower["cfg"], tower["tables"],
                              _t(tower["enc"]), None, 0, compute_dtype=torch.float32,
                              remat=remat, attn_impl="pallas",
                              noise_override=tower["noise"], timestep_id=tid, device="cpu")
    finally:
        fa.remat_save_attention(prev)


def test_switch_returns_previous_value():
    assert fa.remat_save_attention(True) is False
    assert fa.remat_save_attention(True) is True
    assert fa.remat_save_attention(False) is True
    assert fa.remat_save_attention(False) is False


def test_remat_save_grads_bit_equal_forward_once(tower, monkeypatch):
    """Full remat runs each attention's forward twice (the layer's forward,
    then its recompute); with the switch once; the gradients and the loss
    are bit-equal."""
    calls = []
    forward = fa._forward
    monkeypatch.setattr(fa, "_forward", lambda *a, **k: calls.append(1) or forward(*a, **k))
    runs = {}
    for save, remat in ((False, True), (True, True), (False, False)):
        calls.clear()
        runs[save, remat] = _port_grads(tower, save, remat=remat), len(calls)
    (full, n_full), (kept, n_kept), (_, n_plain) = (runs[False, True], runs[True, True],
                                                   runs[False, False])
    assert (n_plain, n_kept, n_full) == (ATTENTIONS, ATTENTIONS, 2 * ATTENTIONS)
    assert torch.equal(full[1]["loss"], kept[1]["loss"])
    assert all(torch.equal(a, b) for a, b in zip(full[0], kept[0]))
    assert any(torch.count_nonzero(g) for g in kept[0])


def test_remat_save_grads_match_jax(shared_layer):
    """The port with its switch on against `training_loss` traced with the
    JAX package's `remat_save_attention(True)`, both through flash
    attention under remat."""
    tower = shared_layer
    prev = jax_remat_save(True)
    try:
        tid, jloss, _, jgrads = _jax_loss_and_grads(
            tower["jl"], tower["jparams"], tower["jcfg"], tower["enc"], 0, tower["noise"],
            remat=True, attn_impl="pallas")
    finally:
        jax_remat_save(prev)
    grads, metrics = _port_grads(tower, True, tid=tid)
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=1e-4)
    _check_grads(tower["lora"], grads, jgrads, tower["cfg"])
