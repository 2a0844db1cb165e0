"""The port's reference-LoRA import (`convert/lora_import.py`) and LoRA merge
(`engine/lora.py`, with `scale`) against the JAX package's, on the CPU, and
the LoRA CLI's merge (`cli/inference_single_lora.load_merged`) on a tiny
checkpoint.

Both reference formats are built as `tests/test_lora_import.py` builds them
(the accelerate directory, with PEFT's `.default.` keys, and the
low-resource state dict). The port's LoRA must equal `convert.from_jax.lora`
of JAX's `convert_lora_state_dict`, with the same skipped keys and meta;
merged weights (scale != 1) must equal JAX's `merge_pipeline_lora` within
fp32 round-off (1e-6 relative: the rank-r product summed in another order).
"""

import numpy as np
import pytest
import torch

from dualforce_tpu.config import tiny_test_config as jax_tiny_config
from dualforce_tpu.convert import lora_import as jax_li
from dualforce_tpu.convert import torch_import
from dualforce_tpu.engine import lora as jax_lora

from dualforce_tpu_torch import nn as dnn
from dualforce_tpu_torch.cli import inference_single_lora as lora_cli
from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import from_jax
from dualforce_tpu_torch.convert import lora_import
from dualforce_tpu_torch.convert import load_checkpoint as lc
from dualforce_tpu_torch.engine import lora as lora_mod
from dualforce_tpu_torch.models.factory import init_pipeline_params

from test_lora_import import ALPHA, RANK, _fake_accelerate_sd
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

MERGE_REL_TOL = 1e-6
TOWERS = ("video_dit", "video_dit_2", "audio_dit", "bridge")


def _assert_lora_equal(got, want):
    assert set(got) == set(want)
    for mod in want:
        assert set(got[mod]) == set(want[mod]), mod
        for name, ab in want[mod].items():
            for part in ("a", "b"):
                assert torch.equal(got[mod][name][part], ab[part]), (mod, name, part)


def _low_resource_sd(cfg, rng):
    """Buffer-style keys (no `.weight`), numpy values, a key without the
    module prefix, a factor whose partner is missing, and keys to skip."""
    vdim, adim = cfg.video_dit.dim, cfg.audio_dit.dim

    def f(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {
        "video_dit.blocks.0.self_attn.v.lora_A": f(RANK, vdim),
        "video_dit.blocks.0.self_attn.v.lora_B": f(vdim, RANK),
        "blocks.1.cross_attn.k.lora_A": f(RANK, vdim),
        "blocks.1.cross_attn.k.lora_B": f(vdim, RANK),
        "video_to_audio_conditioners.1.inner.q.lora_A": f(RANK, adim),
        "video_to_audio_conditioners.1.inner.q.lora_B": f(adim, RANK),
        "audio_dit.blocks.1.self_attn.o.lora_A": f(RANK, adim),
        "video_dit.blocks.0.self_attn.v.weight": f(vdim, vdim),
        "video_dit.blocks.0.ffn.0.lora_A": f(RANK, vdim),
        "text_encoder.blocks.0.self_attn.q.lora_A": f(RANK, vdim),
    }


def test_low_resource_state_dict_matches_jax():
    cfg, jcfg = tiny_test_config(), jax_tiny_config()
    sd = _low_resource_sd(cfg, np.random.default_rng(1))
    got, skipped = lora_import.convert_lora_state_dict(sd, cfg)
    jtree, jskipped = jax_li.convert_lora_state_dict(sd, jcfg)
    _assert_lora_equal(got, from_jax.lora(jtree, cfg))
    assert skipped == jskipped
    assert skipped["non_lora"] and skipped["unmapped"]


@pytest.mark.parametrize("config", ["rank_alpha", "class_name_rank", "none", "bare_pt"])
def test_accelerate_format_matches_jax(tmp_path, config):
    cfg, jcfg = tiny_test_config(), jax_tiny_config()
    sd = _fake_accelerate_sd(jcfg, np.random.default_rng(0))
    d = tmp_path / "lora_ckpt"
    d.mkdir()
    torch.save(sd, d / "lora_weights.pt")
    if config == "rank_alpha":
        torch.save({"rank": RANK, "alpha": ALPHA, "target_modules": []}, d / "lora_config.pt")
    elif config == "class_name_rank":
        torch.save({"rank": "WanModel", "alpha": ALPHA}, d / "lora_config.pt")
    path = str(d / "lora_weights.pt") if config == "bare_pt" else str(d)
    got, meta = lora_import.load_reference_lora(path, cfg)
    jtree, jmeta = jax_li.load_reference_lora(path, jcfg)
    _assert_lora_equal(got, from_jax.lora(jtree, cfg))
    assert meta == jmeta and meta["rank"] == RANK
    assert meta["alpha"] == (ALPHA if config in ("rank_alpha", "class_name_rank") else 16.0)
    # the PEFT key and the bridge's stacked position
    assert "blocks.0.cross_attn.o.weight" in got["audio_dit"]
    assert "audio_to_video_conditioners.0.inner.k.weight" in got["bridge"]


def _towers_to_jax(modules, jcfg):
    sd = {name: {k: v.numpy() for k, v in modules[name].state_dict().items()}
          for name in TOWERS}
    return {
        "video_dit": torch_import.convert_video_dit(sd["video_dit"], jcfg.video_dit),
        "video_dit_2": torch_import.convert_video_dit(sd["video_dit_2"], jcfg.video_dit),
        "audio_dit": torch_import.convert_audio_dit(sd["audio_dit"], jcfg.audio_dit),
        "bridge": torch_import.convert_bridge(sd["bridge"], jcfg.bridge),
    }


def test_merge_with_scale_matches_jax():
    """`merge_pipeline_lora` and the in-place `merge_lora_into`
    with alpha 8 and scale 0.5 against JAX's on the same factors."""
    cfg, jcfg = tiny_test_config(), jax_tiny_config()
    modules = init_pipeline_params(cfg, device="cpu", dtype=torch.float32, seed=0,
                                   with_vaes=False, with_text=False)
    sd = _fake_accelerate_sd(jcfg, np.random.default_rng(0))
    sd.update({k.replace("video_dit.", "video_dit_2.", 1): v * 0.5 for k, v in sd.items()
               if k.startswith("video_dit.")})
    lora, _ = lora_import.convert_lora_state_dict(sd, cfg)
    jtree, _ = jax_li.convert_lora_state_dict(sd, jcfg)
    jmerged = jax_lora.merge_pipeline_lora(_towers_to_jax(modules, jcfg), jtree,
                                           alpha=ALPHA, scale=0.5)
    want = from_jax.state_dicts({k: jmerged[k] for k in TOWERS}, cfg)
    merged = lora_mod.merge_pipeline_lora(modules, lora, alpha=ALPHA, scale=0.5)
    for name, tree in lora.items():
        lora_mod.merge_lora_into(modules[name], tree, alpha=ALPHA, scale=0.5)
    changed = 0
    for name in TOWERS:
        for k, v in modules[name].state_dict().items():
            w = want[name][k]
            err = np.abs(v.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= MERGE_REL_TOL, (name, k, err)
            if k in merged.get(name, {}):
                assert torch.equal(merged[name][k], v), (name, k)
                changed += 1
    assert changed == sum(len(t) for t in lora.values())


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    cfg = tiny_test_config()
    root = tmp_path_factory.mktemp("lora_base")
    modules = init_pipeline_params(cfg, device="cpu", dtype=torch.bfloat16, seed=0)
    lc.save_pipeline_params(modules, cfg, str(root))
    return cfg, str(root)


@pytest.mark.parametrize("weight_dtype", ["bf16", "fp8"])
def test_lora_cli_merges_before_the_fp8_cast(tiny_ckpt, tmp_path, weight_dtype):
    """The LoRA CLI's modules: with an npz LoRA and --lora_alpha/--lora_scale,
    each targeted weight is the fp32 merge rounded once to bf16, and under
    fp8 the fp8 cast of that (`nn.to_fp8`); UMT5 stays bf16, as in the JAX
    CLI. With --offload cpu on the CPU the merge runs where it loads."""
    cfg, root = tiny_ckpt
    base = init_pipeline_params(cfg, device="cpu", dtype=torch.bfloat16, seed=0)
    lora = lora_mod.init_pipeline_lora(base, 4, torch.Generator().manual_seed(5))
    for tree in lora.values():
        for ab in tree.values():
            ab["b"] = torch.randn(ab["b"].shape) * 0.1
    lora_mod.save_lora(lora, str(tmp_path / "l.npz"), alpha=8.0, rank=4)
    args = lora_cli.parse_args(["--base_model", root, "--lora_path", str(tmp_path / "l.npz"),
                                "--lora_alpha", "6", "--lora_scale", "0.5", "--prompt", "x",
                                "--ref_path", "unused.png", "--device", "cpu",
                                "--offload", "cpu", "--weight_dtype", weight_dtype])
    loaded, meta = lora_cli.load_any_lora(args.lora_path, cfg)
    assert meta == {"alpha": 8.0, "rank": 4}
    modules, _ = lora_cli.load_merged(args, cfg, loaded, 6.0, torch.device("cpu"),
                                      torch.bfloat16)
    for name in TOWERS:
        for k, ab in lora[name].items():
            w = base[name].get_parameter(k).float()
            want = (w + (ab["a"].detach() @ ab["b"]).t() * (6.0 / 4 * 0.5)).bfloat16()
            if weight_dtype == "fp8":
                want = dnn.to_fp8(want.float())
            got = modules[name].get_parameter(k)
            assert got.dtype == want.dtype and torch.equal(got.view(torch.uint8),
                                                           want.view(torch.uint8)), (name, k)
    assert {p.dtype for p in modules["text_encoder"].parameters()} == {torch.bfloat16}
