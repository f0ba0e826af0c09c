"""Model configurations.

The reference pins CLIP ViT-L/14 as its only model (vision tower via Burn
codegen from ``Xenova/clip-vit-large-patch14`` ONNX, ``clip/build.rs:9-11``;
text tower via embed_anything from ``openai/clip-vit-large-patch14``,
``server/src/clip.rs:37``). We make the model family a first-class config so
ViT-B variants, OpenCLIP bigG and SigLIP slot in behind one interface
(BASELINE.json config #5).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class TowerConfig:
    """One transformer tower (text or vision)."""

    hidden_size: int
    num_layers: int
    num_heads: int
    mlp_ratio: int = 4
    act: str = "quick_gelu"  # "quick_gelu" | "gelu" | "gelu_tanh"
    layernorm_eps: float = 1e-5
    mlp_size_override: Optional[int] = None  # e.g. OpenCLIP bigG's 8192

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads

    @property
    def mlp_size(self) -> int:
        return self.mlp_size_override or self.hidden_size * self.mlp_ratio


@dataclass(frozen=True)
class TextConfig(TowerConfig):
    vocab_size: int = 49408
    context_length: int = 77
    eos_token_id: int = 49407


@dataclass(frozen=True)
class VisionConfig(TowerConfig):
    image_size: int = 224
    patch_size: int = 14

    @property
    def grid(self) -> int:
        assert self.image_size % self.patch_size == 0
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        # +1 for the class token (CLIP-style). SigLIP has no class token.
        return self.grid * self.grid + (0 if self.no_class_token else 1)

    no_class_token: bool = False


@dataclass(frozen=True)
class CLIPConfig:
    """Dual-tower contrastive model config (CLIP / OpenCLIP / SigLIP)."""

    name: str
    text: TextConfig
    vision: VisionConfig
    projection_dim: int = 768
    logit_scale_init: float = 2.6592  # ln(1/0.07), HF CLIPConfig default
    # "clip": cls-token pooling + linear projections, learned logit scale.
    # "siglip": MAP-head pooling, no projections, logit scale + bias.
    arch: str = "clip"
    logit_bias_init: Optional[float] = None  # SigLIP only

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self) | {"_version": 1}, indent=2)

    @staticmethod
    def from_json(s: str) -> "CLIPConfig":
        d = json.loads(s)
        d.pop("_version", None)
        d["text"] = TextConfig(**d["text"])
        d["vision"] = VisionConfig(**d["vision"])
        return CLIPConfig(**d)


def clip_vit_l14() -> CLIPConfig:
    """openai/clip-vit-large-patch14 — the reference's model.

    Dims confirmed by the generated Burn module (ViT-L/14: 24L/1024h, 14px
    patches) and the 768-d store at ``server/src/clip.rs:124,141``.
    """
    return CLIPConfig(
        name="clip-vit-large-patch14",
        text=TextConfig(hidden_size=768, num_layers=12, num_heads=12),
        vision=VisionConfig(hidden_size=1024, num_layers=24, num_heads=16),
        projection_dim=768,
    )


def clip_vit_b32() -> CLIPConfig:
    return CLIPConfig(
        name="clip-vit-base-patch32",
        text=TextConfig(hidden_size=512, num_layers=12, num_heads=8),
        vision=VisionConfig(hidden_size=768, num_layers=12, num_heads=12, patch_size=32),
        projection_dim=512,
    )


def clip_vit_b16() -> CLIPConfig:
    return CLIPConfig(
        name="clip-vit-base-patch16",
        text=TextConfig(hidden_size=512, num_layers=12, num_heads=8),
        vision=VisionConfig(hidden_size=768, num_layers=12, num_heads=12, patch_size=16),
        projection_dim=512,
    )


def openclip_vit_h14() -> CLIPConfig:
    """laion/CLIP-ViT-H-14-laion2B-s32B-b79K (OpenCLIP H/14)."""
    return CLIPConfig(
        name="openclip-vit-H-14",
        text=TextConfig(hidden_size=1024, num_layers=24, num_heads=16, act="gelu"),
        vision=VisionConfig(
            hidden_size=1280, num_layers=32, num_heads=16, act="gelu", patch_size=14
        ),
        projection_dim=1024,
    )


def openclip_vit_bigg14() -> CLIPConfig:
    """laion/CLIP-ViT-bigG-14-laion2B-39B-b160k (BASELINE config #5 stretch)."""
    return CLIPConfig(
        name="openclip-vit-bigG-14",
        text=TextConfig(
            hidden_size=1280, num_layers=32, num_heads=20, act="gelu"
        ),
        vision=VisionConfig(
            hidden_size=1664,
            num_layers=48,
            num_heads=16,
            mlp_size_override=8192,  # bigG's MLP width is not a clean ratio
            act="gelu",
            patch_size=14,
        ),
        projection_dim=1280,
    )


def dfn5b_clip_vit_h14_378() -> CLIPConfig:
    """apple/DFN5B-CLIP-ViT-H-14-378 (OpenCLIP ``ViT-H-14-378-quickgelu``,
    pretrained tag ``dfn5b``): H/14's widths and depths with quick-GELU in
    both towers, at 378 px (27 x 27 patches + the class token = 730 vision
    tokens, past the 320 keys of the short attention kernels: the vision
    tower runs the long-key forward). The port's own preset: the JAX
    package has none at this resolution."""
    return CLIPConfig(
        name="dfn5b-clip-vit-h-14-378",
        text=TextConfig(hidden_size=1024, num_layers=24, num_heads=16, act="quick_gelu"),
        vision=VisionConfig(
            hidden_size=1280, num_layers=32, num_heads=16, act="quick_gelu", image_size=378, patch_size=14
        ),
        projection_dim=1024,
    )


def siglip_base_patch16_224() -> CLIPConfig:
    """google/siglip-base-patch16-224 (BASELINE config #5 stretch)."""
    return CLIPConfig(
        name="siglip-base-patch16-224",
        text=TextConfig(
            hidden_size=768,
            num_layers=12,
            num_heads=12,
            act="gelu_tanh",
            layernorm_eps=1e-6,
            vocab_size=32000,
            context_length=64,
            eos_token_id=1,
        ),
        vision=VisionConfig(
            hidden_size=768,
            num_layers=12,
            num_heads=12,
            act="gelu_tanh",
            layernorm_eps=1e-6,
            patch_size=16,
            no_class_token=True,
        ),
        projection_dim=768,
        arch="siglip",
        logit_scale_init=0.0,
        logit_bias_init=-10.0,
    )


def tiny_test_config() -> CLIPConfig:
    """A miniature CLIP for fast CPU tests (same topology, tiny dims)."""
    return CLIPConfig(
        name="clip-tiny-test",
        text=TextConfig(
            hidden_size=64, num_layers=2, num_heads=4, vocab_size=128,
            context_length=16, eos_token_id=127,
        ),
        vision=VisionConfig(
            hidden_size=96, num_layers=2, num_heads=4, image_size=28, patch_size=14
        ),
        projection_dim=32,
    )


PRESETS = {
    "clip-vit-large-patch14": clip_vit_l14,
    "clip-vit-base-patch32": clip_vit_b32,
    "clip-vit-base-patch16": clip_vit_b16,
    "openclip-vit-H-14": openclip_vit_h14,
    "openclip-vit-bigG-14": openclip_vit_bigg14,
    "dfn5b-clip-vit-h-14-378": dfn5b_clip_vit_h14_378,
    "siglip-base-patch16-224": siglip_base_patch16_224,
    "clip-tiny-test": tiny_test_config,
}


def get_config(name: str) -> CLIPConfig:
    try:
        return PRESETS[name]()
    except KeyError:
        raise ValueError(f"unknown model preset {name!r}; known: {sorted(PRESETS)}")
