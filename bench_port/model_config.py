"""A configuration file (``configs/<name>.json``) -> the model's sizes.

The file keeps the source's own keys (HuggingFace ``CLIPConfig``:
``text_config``, ``vision_config``, ``projection_dim``) and adds the preset
that the port serves them under, the deployment's flags and what was
assumed. ``model`` below is the one shape every part of the harness reads.
"""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> dict:
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def _tower(c: dict, vision: bool) -> dict:
    t = {
        "hidden_size": c["hidden_size"],
        "mlp_size": c["intermediate_size"],
        "num_layers": c["num_hidden_layers"],
        "num_heads": c["num_attention_heads"],
        "act": c["hidden_act"],
        "layernorm_eps": c["layer_norm_eps"],
    }
    if vision:
        t |= {"image_size": c["image_size"], "patch_size": c["patch_size"]}
    else:
        t |= {"vocab_size": c["vocab_size"], "context_length": c["max_position_embeddings"]}
    return t


def model(cfg: dict) -> dict:
    """The sizes of both towers under one set of names."""
    m = {
        "text": _tower(cfg["text_config"], False),
        "vision": _tower(cfg["vision_config"], True),
        "projection_dim": cfg["projection_dim"],
        "logit_scale_init": cfg["logit_scale_init_value"],
    }
    m["text"]["eos_token_id"] = cfg["tokenizer"]["eos_token_id"]
    return m


def checkpoint_config_json(cfg: dict) -> str:
    """The ``config`` metadata of the project's checkpoint file format
    (``image_search_tpu.v1``: the ``CLIPConfig`` dataclass as JSON)."""
    m = model(cfg)

    def tower(t, vision):
        out = {
            "hidden_size": t["hidden_size"], "num_layers": t["num_layers"], "num_heads": t["num_heads"],
            "mlp_ratio": 4, "act": t["act"], "layernorm_eps": t["layernorm_eps"],
            "mlp_size_override": None if t["mlp_size"] == 4 * t["hidden_size"] else t["mlp_size"],
        }
        if vision:
            return out | {"image_size": t["image_size"], "patch_size": t["patch_size"], "no_class_token": False}
        return out | {"vocab_size": t["vocab_size"], "context_length": t["context_length"],
                      "eos_token_id": t["eos_token_id"]}

    return json.dumps({
        "name": cfg["preset"], "text": tower(m["text"], False), "vision": tower(m["vision"], True),
        "projection_dim": m["projection_dim"], "logit_scale_init": m["logit_scale_init"], "arch": "clip",
        "logit_bias_init": None, "_version": 1,
    }, indent=2)


def check_against_preset(cfg: dict, program_cfg) -> None:
    """The preset the program serves must have this file's sizes."""
    m = model(cfg)
    for side, pc in (("text", program_cfg.text), ("vision", program_cfg.vision)):
        got = {"hidden_size": pc.hidden_size, "mlp_size": pc.mlp_size, "num_layers": pc.num_layers,
               "num_heads": pc.num_heads, "act": pc.act, "layernorm_eps": pc.layernorm_eps}
        for key, val in got.items():
            if m[side][key] != val:
                raise ValueError(f"preset {cfg['preset']} {side}.{key} = {val}, the configuration says {m[side][key]}")
    if program_cfg.projection_dim != m["projection_dim"]:
        raise ValueError(f"preset {cfg['preset']} projection_dim {program_cfg.projection_dim} != {m['projection_dim']}")
