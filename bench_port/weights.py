"""Seeded random CLIP weights, made on the device in one draw.

The harness makes the weights, so its plain reference never takes them from
the program: both sides get :func:`make` of the same seed. The keys are the
port's ``nn.Module`` state names (``[out, in]`` linear weights, the patch
embedding in (ph, pw, c) order), the distributions those of the project's
``init_params``, except that no leaf is drawn constant: a bias is N(0, 0.02)
and a LayerNorm scale 1 + N(0, 0.02), so a program that drops, swaps or
misorders a bias or a LayerNorm's affine parts answers differently from the
reference. :func:`write_checkpoint` writes them as the project's
checkpoint file (safetensors, ``image_search_tpu.v1``: ``/``-joined keys,
``[in, out]`` weights, blocks stacked ``[L, ...]``, F32), which is what
the fine-tune CLI reads.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

_BLOCK = (  # port name, checkpoint name, kind
    ("ln1.weight", "ln1_scale", "ones"), ("ln1.bias", "ln1_bias", "zeros"),
    ("qkv.weight", "qkv_w", "normal"), ("qkv.bias", "qkv_b", "zeros"),
    ("o.weight", "o_w", "normal"), ("o.bias", "o_b", "zeros"),
    ("ln2.weight", "ln2_scale", "ones"), ("ln2.bias", "ln2_bias", "zeros"),
    ("fc.weight", "fc_w", "normal"), ("fc.bias", "fc_b", "zeros"),
    ("proj.weight", "proj_w", "normal"), ("proj.bias", "proj_b", "zeros"),
)
_TOP = {  # port name -> checkpoint name
    "text.token_embedding": "text/token_embedding",
    "text.position_embedding": "text/position_embedding",
    "text.final_ln.weight": "text/final_ln_scale",
    "text.final_ln.bias": "text/final_ln_bias",
    "text.projection.weight": "text/projection",
    "vision.patch_embedding.weight": "vision/patch_embedding",
    "vision.class_embedding": "vision/class_embedding",
    "vision.position_embedding": "vision/position_embedding",
    "vision.pre_ln.weight": "vision/pre_ln_scale",
    "vision.pre_ln.bias": "vision/pre_ln_bias",
    "vision.post_ln.weight": "vision/post_ln_scale",
    "vision.post_ln.bias": "vision/post_ln_bias",
    "vision.projection.weight": "vision/projection",
    "logit_scale": "logit_scale",
}


def spec(m: dict) -> list:
    """[(key, shape, kind, scale)] in a fixed order."""
    t, v, p = m["text"], m["vision"], m["projection_dim"]
    patch = v["patch_size"] ** 2 * 3
    seq = (v["image_size"] // v["patch_size"]) ** 2 + 1
    out = [
        ("text.token_embedding", (t["vocab_size"], t["hidden_size"]), "normal", 0.02),
        ("text.position_embedding", (t["context_length"], t["hidden_size"]), "normal", 0.01),
        ("text.final_ln.weight", (t["hidden_size"],), "ones", 0.0),
        ("text.final_ln.bias", (t["hidden_size"],), "zeros", 0.0),
        ("text.projection.weight", (p, t["hidden_size"]), "normal", t["hidden_size"] ** -0.5),
        ("vision.patch_embedding.weight", (v["hidden_size"], patch), "normal", patch ** -0.5),
        ("vision.class_embedding", (v["hidden_size"],), "normal", 0.02),
        ("vision.position_embedding", (seq, v["hidden_size"]), "normal", 0.01),
        ("vision.pre_ln.weight", (v["hidden_size"],), "ones", 0.0),
        ("vision.pre_ln.bias", (v["hidden_size"],), "zeros", 0.0),
        ("vision.post_ln.weight", (v["hidden_size"],), "ones", 0.0),
        ("vision.post_ln.bias", (v["hidden_size"],), "zeros", 0.0),
        ("vision.projection.weight", (p, v["hidden_size"]), "normal", v["hidden_size"] ** -0.5),
    ]
    for tower, tc in (("text", t), ("vision", v)):
        d, mm = tc["hidden_size"], tc["mlp_size"]
        shapes = {"ln1.weight": (d,), "ln1.bias": (d,), "qkv.weight": (3 * d, d), "qkv.bias": (3 * d,),
                  "o.weight": (d, d), "o.bias": (d,), "ln2.weight": (d,), "ln2.bias": (d,),
                  "fc.weight": (mm, d), "fc.bias": (mm,), "proj.weight": (d, mm), "proj.bias": (d,)}
        scales = {"qkv.weight": d ** -0.5, "o.weight": d ** -0.5, "fc.weight": d ** -0.5, "proj.weight": mm ** -0.5}
        for i in range(tc["num_layers"]):
            for name, _, kind in _BLOCK:
                out.append((f"{tower}.blocks.{i}.{name}", shapes[name], kind, scales.get(name, 0.0)))
    return out


AFFINE_STD = 0.02  # the spread of a bias, and of a LayerNorm scale around 1


def make(m: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{state name: tensor} on ``device`` in ``dtype`` (``logit_scale`` in
    f32): every leaf cut from one draw of a generator on the device seeded
    with ``seed``, so a seed gives the same weights on any run."""
    leaves = spec(m)
    total = sum(int(np.prod(s)) for _, s, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for key, shape, kind, scale in leaves:
        n = int(np.prod(shape))
        z = draw[off : off + n].view(shape)
        off += n
        if kind == "normal":
            out[key] = (z * scale).to(dtype)
        else:
            out[key] = ((1.0 if kind == "ones" else 0.0) + AFFINE_STD * z).to(dtype)
    del draw
    out["logit_scale"] = torch.tensor(m["logit_scale_init"], dtype=torch.float32, device=device)
    return out


def checkpoint_arrays(m: dict, state: dict) -> dict:
    """Port-layout state -> {checkpoint key: host tensor}, ``[in, out]``
    weights, blocks stacked."""
    def host(t, transpose):
        t = t.detach()
        if transpose:
            t = t.transpose(-1, -2)
        return t.contiguous().cpu()

    flat = {}
    for port, ck in _TOP.items():
        flat[ck] = host(state[port], port.endswith(("projection.weight", "patch_embedding.weight")))
    for tower, tc in (("text", m["text"]), ("vision", m["vision"])):
        for name, ck, _ in _BLOCK:
            layers = [state[f"{tower}.blocks.{i}.{name}"] for i in range(tc["num_layers"])]
            flat[f"{tower}/blocks/{ck}"] = host(torch.stack(layers), name.endswith(".weight") and not name.startswith("ln"))
    return flat


def write_checkpoint(path: str, m: dict, state: dict, config_json: str) -> None:
    """The project's checkpoint file (F32 buffers in key order)."""
    flat = checkpoint_arrays(m, state)
    header = {"__metadata__": {"config": config_json, "format": "image_search_tpu.v1"}}
    bufs, offset = [], 0
    for key in sorted(flat):
        raw = flat[key].float().numpy().astype("<f4").tobytes()
        header[key] = {"dtype": "F32", "shape": list(flat[key].shape), "data_offsets": [offset, offset + len(raw)]}
        bufs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in bufs:
            f.write(raw)
