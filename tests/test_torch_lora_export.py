"""The port's reference-format LoRA export (`convert/lora_export.py`) against
the JAX package's (`dualforce_tpu/convert/lora_export.py`), on the CPU.

The JAX LoRA tree is drawn by the JAX package (`init_pipeline_lora` over its
own tiny towers, b made nonzero, some layers zeroed as untrained) and
carried into the port by `convert.from_jax.lora`. Both exports must hold the
same keys with bit-equal values, in both styles; the port's export must read
back through the port's importer (`convert/lora_import.py`) to the LoRA it
came from, and the trainer's save must write it beside its npz.
"""

import jax
import numpy as np
import pytest
import torch

from dualforce_tpu.config import tiny_test_config as jax_tiny_config
from dualforce_tpu.convert import lora_export as jexport
from dualforce_tpu.engine import lora as jlora
from dualforce_tpu.models.factory import init_pipeline_params as jax_init

from dualforce_tpu_torch.config import tiny_test_config
from dualforce_tpu_torch.convert import from_jax, lora_export, lora_import
from dualforce_tpu_torch.engine import lora as lora_mod

CFG_KW = dict(visual_layers=3, audio_layers=2)
STYLES = ("accelerate", "low_resource")


@pytest.fixture(scope="module")
def loras():
    jcfg, cfg = jax_tiny_config(**CFG_KW), tiny_test_config(**CFG_KW)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg, with_vaes=False, with_text=False)
    tree = jlora.init_pipeline_lora(jax.random.PRNGKey(1), jparams, rank=4)
    rng = np.random.default_rng(0)
    out = {}
    for mod, paths in tree.items():
        out[mod] = {}
        for path, ab in paths.items():
            a = np.asarray(ab["a"]).copy()
            b = (0.01 * rng.standard_normal(np.shape(ab["b"]))).astype(np.float32)
            if path.endswith("q/kernel"):     # an untrained layer: both factors zero
                a[0] = 0.0
                b[0] = 0.0
            out[mod][path] = {"a": a, "b": b}
    return dict(jax=out, port=from_jax.lora(out, cfg), cfg=cfg, jcfg=jcfg)


@pytest.mark.parametrize("style", STYLES)
def test_export_matches_jax(loras, style):
    want = jexport.export_lora_state_dict(loras["jax"], loras["jcfg"], style=style)
    got = lora_export.export_lora_state_dict(loras["port"], style=style)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("dual_tower_bridge.video_to_audio_conditioners.") for k in got)
    assert not any(".blocks.0.self_attn.q." in k for k in got)      # the untrained layer
    suffix = ".weight" if style == "accelerate" else ""
    assert all(k.endswith((f".lora_A{suffix}", f".lora_B{suffix}")) for k in got)
    for key, arr in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)


@pytest.mark.parametrize("style", STYLES)
def test_saved_export_round_trips_through_import(loras, tmp_path, style):
    cfg, port = loras["cfg"], loras["port"]
    out = str(tmp_path / ("lora" if style == "accelerate" else "lora.pt"))
    path = lora_export.save_reference_lora(port, out, alpha=8.0, rank=4, style=style)
    want_path = jexport.save_reference_lora(loras["jax"], loras["jcfg"],
                                            str(tmp_path / "jax" / ("lora" if style ==
                                                "accelerate" else "lora.pt")),
                                            alpha=8.0, rank=4, style=style)
    got_sd, want_sd = torch.load(path), torch.load(want_path)
    assert sorted(got_sd) == sorted(want_sd)
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)
    if style == "accelerate":
        assert torch.load(str(tmp_path / "lora" / "lora_config.pt")) == \
            torch.load(str(tmp_path / "jax" / "lora" / "lora_config.pt")) == \
            {"rank": 4, "alpha": 8.0}
    back, meta = lora_import.load_reference_lora(out, cfg)
    assert meta["rank"] == 4
    assert meta["alpha"] == (8.0 if style == "accelerate" else 16.0)
    # the importer zero-fills the untrained layer: every factor comes back
    assert set(back) == set(port)
    for mod, tree in port.items():
        assert set(back[mod]) == set(tree), mod
        for name, ab in tree.items():
            for part in ("a", "b"):
                assert torch.equal(back[mod][name][part], ab[part].detach()), (mod, name)


def test_export_refuses_unknown_module_and_style(loras):
    with pytest.raises(ValueError):
        lora_export.export_lora_state_dict({"text_encoder": {}})
    with pytest.raises(ValueError):
        lora_export.export_lora_state_dict(loras["port"], style="peft")


def test_export_of_the_trainers_layout(loras):
    """The export of a LoRA on the trainer's device-side layout (leaves that
    require grad) equals that of the same factors detached."""
    live = {m: {n: {p: t.clone().requires_grad_() for p, t in ab.items()}
                for n, ab in tree.items()} for m, tree in loras["port"].items()}
    got = lora_export.export_lora_state_dict(live)
    want = lora_export.export_lora_state_dict(loras["port"])
    assert sorted(got) == sorted(want)
    assert all(not t.requires_grad and torch.equal(t, want[k]) for k, t in got.items())
    assert len(lora_mod.lora_parameters(live)) == 2 * sum(len(t) for t in live.values())
