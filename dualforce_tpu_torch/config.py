"""Model and pipeline configuration dataclasses.

A copy of the JAX package's configuration (its `config.py`): the same
fields, defaults, `mova_360p()` preset and `tiny_test_config()`, kept here so
that the port imports nothing of the JAX package. A test holds the two
copies equal field for field.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class VideoDiTConfig:
    """Wan-style video DiT (reference: mova/diffusion/models/wan_video_dit.py:333)."""

    dim: int = 5120
    in_dim: int = 36  # 16 noisy z + 4 mask + 16 first-frame condition
    ffn_dim: int = 13824
    out_dim: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    eps: float = 1e-6
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_heads: int = 40
    num_layers: int = 40
    rope_max_len: int = 1024

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


@dataclass(frozen=True)
class AudioDiTConfig:
    """Wan-style audio DiT (reference: mova/diffusion/models/wan_audio_dit.py:105)."""

    dim: int = 1536
    in_dim: int = 128  # DAC continuous latent dim
    ffn_dim: int = 8960
    out_dim: int = 128
    text_dim: int = 4096
    freq_dim: int = 256
    eps: float = 1e-6
    patch_size: int = 1
    num_heads: int = 12
    num_layers: int = 30
    vae_type: str = "dac"  # "dac" | "oobleck" (legacy tps-rescaled RoPE)
    rope_max_len: int = 16384

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


@dataclass(frozen=True)
class BridgeConfig:
    """Dual-tower conditional bridge (reference: mova/diffusion/models/interactionv2.py:357)."""

    visual_layers: int = 40
    audio_layers: int = 30
    visual_hidden_dim: int = 5120
    audio_hidden_dim: int = 1536
    audio_fps: float = 50.0  # DAC 48kHz / hop 960
    head_dim: int = 128
    interaction_strategy: str = "full"
    apply_cross_rope: bool = True
    apply_first_frame_bias_in_rope: bool = False
    trainable_condition_scale: bool = False
    pooled_adaln: bool = False
    eps: float = 1e-6
    rope_theta: float = 10000.0

    @property
    def min_layers(self) -> int:
        return min(self.visual_layers, self.audio_layers)

    def interaction_layers(self) -> List[int]:
        """Which shared layer indices interact (both a2v and v2a use the same set).

        Mirrors CrossModalInteractionController.get_interaction_layers
        (interactionv2.py:139-190).
        """
        m = self.min_layers
        s = self.interaction_strategy
        if s == "shallow_focus":
            return list(range(0, min(10, m // 3)))
        if s == "distributed":
            return list(range(0, m, 3))
        if s == "progressive":
            shallow = list(range(0, min(8, m)))
            return shallow + (list(range(8, m, 3)) if m > 8 else [])
        if s == "custom":
            return [i for i in [0, 2, 4, 6, 8, 12, 16, 20] if i < m]
        if s == "full":
            return list(range(0, m))
        raise ValueError(f"Unknown interaction strategy: {s}")


@dataclass(frozen=True)
class WanVAEConfig:
    """Wan 3D-causal video VAE (diffusers AutoencoderKLWan convention).

    z=16, spatial stride 8, temporal stride 4; latents normalized by
    per-channel mean/std from the checkpoint config.
    """

    base_dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temperal_downsample: Tuple[bool, ...] = (False, True, True)
    dropout: float = 0.0
    scale_factor_spatial: int = 8
    scale_factor_temporal: int = 4
    latents_mean: Tuple[float, ...] = (
        -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
        0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
    )
    latents_std: Tuple[float, ...] = (
        2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
        3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.916,
    )


@dataclass(frozen=True)
class DACVAEConfig:
    """DAC audio VAE, continuous (KL) mode as shipped by MOVA
    (reference: mova/diffusion/models/dac_vae.py:810; checkpoint values SURVEY.md §0.1).
    """

    encoder_dim: int = 128
    encoder_rates: Tuple[int, ...] = (2, 3, 4, 5, 8)
    decoder_dim: int = 2048
    decoder_rates: Tuple[int, ...] = (8, 5, 4, 3, 2)
    latent_dim: int = 128
    sample_rate: int = 48000
    continuous: bool = True
    # RVQ (discrete) mode, continuous=False (dac_vae.py:810-827 defaults)
    n_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8

    @property
    def hop_length(self) -> int:
        h = 1
        for r in self.encoder_rates:
            h *= r
        return h  # 960 for the shipped config


@dataclass(frozen=True)
class UMT5Config:
    """UMT5-xxl encoder (per-layer relative position bias)."""

    vocab_size: int = 256384
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


@dataclass(frozen=True)
class SchedulerConfig:
    """Flow-matching pair scheduler (reference: flow_match.py / flow_match_pair.py)."""

    num_inference_steps: int = 50
    num_train_timesteps: int = 1000
    shift: float = 5.0
    sigma_max: float = 1.0
    sigma_min: float = 0.003 / 1.002
    inverse_timesteps: bool = False
    extra_one_step: bool = True
    reverse_sigmas: bool = False
    exponential_shift: bool = False
    exponential_shift_mu: Optional[float] = None
    shift_terminal: Optional[float] = None


@dataclass(frozen=True)
class MOVAConfig:
    """Full dual-tower pipeline config (two video towers + audio tower + bridge)."""

    video_dit: VideoDiTConfig = field(default_factory=VideoDiTConfig)
    audio_dit: AudioDiTConfig = field(default_factory=AudioDiTConfig)
    bridge: BridgeConfig = field(default_factory=BridgeConfig)
    video_vae: WanVAEConfig = field(default_factory=WanVAEConfig)
    audio_vae: DACVAEConfig = field(default_factory=DACVAEConfig)
    text_encoder: UMT5Config = field(default_factory=UMT5Config)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    boundary_ratio: float = 0.9  # high->low-noise expert switch (pipeline_mova.py:406)
    audio_vae_type: str = "dac"
    two_video_towers: bool = True


def mova_360p() -> MOVAConfig:
    """Checkpoint-actual MOVA-360p configuration (SURVEY.md §0.1)."""
    return MOVAConfig()


def tiny_test_config(
    *,
    visual_layers: int = 2,
    audio_layers: int = 2,
    dim: int = 96,  # head_dim 48 -> valid 3-way RoPE split (16+16+16 halves)
    audio_dim: int = 48,
    num_heads: int = 2,
    audio_heads: int = 2,
    text_dim: int = 32,
    interaction_strategy: str = "full",
    apply_cross_rope: bool = True,
) -> MOVAConfig:
    """A tiny random-weight config exercising every interface (tests / dry runs)."""
    head_dim = dim // num_heads
    return MOVAConfig(
        video_dit=VideoDiTConfig(
            dim=dim, in_dim=36, ffn_dim=dim * 2, out_dim=16, text_dim=text_dim,
            freq_dim=32, patch_size=(1, 2, 2), num_heads=num_heads,
            num_layers=visual_layers, rope_max_len=64,
        ),
        audio_dit=AudioDiTConfig(
            dim=audio_dim, in_dim=8, ffn_dim=audio_dim * 2, out_dim=8,
            text_dim=text_dim, freq_dim=32, patch_size=1, num_heads=audio_heads,
            num_layers=audio_layers, rope_max_len=256,
        ),
        bridge=BridgeConfig(
            visual_layers=visual_layers, audio_layers=audio_layers,
            visual_hidden_dim=dim, audio_hidden_dim=audio_dim,
            head_dim=head_dim, interaction_strategy=interaction_strategy,
            apply_cross_rope=apply_cross_rope, audio_fps=50.0,
        ),
        video_vae=WanVAEConfig(base_dim=16, dim_mult=(1, 2, 2, 2)),
        audio_vae=DACVAEConfig(encoder_dim=16, decoder_dim=64, latent_dim=8),
        text_encoder=UMT5Config(vocab_size=512, d_model=text_dim, d_kv=16, d_ff=64,
                                num_layers=2, num_heads=2),
    )
