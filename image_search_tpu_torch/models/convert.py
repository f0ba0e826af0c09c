"""Weights for the port: the reference's checkpoint file, its parameter
pytree, and seeded random demo weights.

- :func:`load_checkpoint` reads, and :func:`save_checkpoint` writes, the file
  of ``image_search_tpu.models.convert.save_checkpoint`` (safetensors: an
  8-byte little-endian header length, a JSON header, raw little-endian
  buffers; ``/``-joined keys, stacked ``[L, ...]`` block tensors, the
  ``CLIPConfig`` JSON in the metadata) with json and numpy alone -- the
  ``safetensors`` package is not needed.
- :func:`params_from_jax` turns the reference's parameter pytree (numpy
  arrays) into the state of ``models.clip.CLIP``, and :func:`params_to_jax`
  turns a model back. This is the one place layouts change: the reference
  multiplies ``x @ w`` with ``w`` as ``[in, out]``; ``nn.Linear`` holds
  ``[out, in]``.
- :func:`init_params` makes the demo-mode random weights from a
  ``torch.Generator``, with the reference's distributions.
- :func:`params_from_hf_state_dict` turns a HuggingFace ``CLIPModel``
  state dict into the reference's parameter pytree, and
  :func:`params_from_hf_dir` reads one from a local HF directory
  (``model.safetensors``, or shards named by
  ``model.safetensors.index.json``; F32, F16 or BF16) with this module's own
  safetensors reader: no ``transformers``, no ``safetensors``.
  :func:`convert_hf_model` writes a checkpoint from a local directory or,
  through ``transformers`` imported then, from a hub id (``--from-hf``).
"""

from __future__ import annotations

import json
import os
import shutil
import struct
from typing import Any, Dict, Mapping

import numpy as np
import torch

from image_search_tpu_torch.config import CLIPConfig, get_config
from image_search_tpu_torch.models.clip import CLIP

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
    "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}
CHECKPOINT_FORMAT = "image_search_tpu.v1"


def read_safetensors(path: str):
    """-> (flat {key: numpy array}, metadata dict). bf16 tensors come back f32."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = memoryview(f.read())
    meta = header.pop("__metadata__", None) or {}
    flat = {}
    for key, info in header.items():
        lo, hi = info["data_offsets"]
        buf = data[lo:hi]
        if info["dtype"] == "BF16":
            bits = np.frombuffer(buf, "<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(buf, np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<"))
        flat[key] = arr.reshape(info["shape"]).astype(arr.dtype.newbyteorder("="))
    return flat, meta


def _unflatten(flat) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def write_safetensors(path: str, flat: Dict[str, np.ndarray], metadata: Dict[str, str]) -> None:
    """{key: numpy array} -> a safetensors file, buffers in key order. Every
    buffer is written C-contiguous: a transposed view would otherwise be
    written in its memory order (``image_search_tpu/models/convert.py:143``)."""
    header: dict = {"__metadata__": metadata}
    bufs, offset = [], 0
    for key in sorted(flat):
        arr = np.ascontiguousarray(flat[key])
        code = next(c for c, t in _ST_DTYPES.items() if np.dtype(t) == arr.dtype)
        raw = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[key] = {"dtype": code, "shape": list(arr.shape), "data_offsets": [offset, offset + len(raw)]}
        bufs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the format pads the header to 8 bytes
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in bufs:
            f.write(raw)


def save_checkpoint(path: str, params, cfg: CLIPConfig) -> None:
    """The reference's checkpoint file from reference-layout params (nested
    dicts of arrays, e.g. :func:`params_to_jax`)."""
    def flatten(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flatten(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v)

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_safetensors(
        path, dict(flatten(params)), {"config": cfg.to_json(), "format": CHECKPOINT_FORMAT}
    )


def load_checkpoint(path: str):
    """Returns (reference-layout params as nested numpy dicts, cfg)."""
    flat, meta = read_safetensors(path)
    return _unflatten(flat), CLIPConfig.from_json(meta["config"])


_TOP_KEYS = (  # reference path, port name, transposed
    ("text/token_embedding", "text.token_embedding", False),
    ("text/position_embedding", "text.position_embedding", False),
    ("text/final_ln_scale", "text.final_ln.weight", False),
    ("text/final_ln_bias", "text.final_ln.bias", False),
    ("text/projection", "text.projection.weight", True),
    # [p*p*C, D] in (ph, pw, c) order -> Linear [D, p*p*C], same order
    ("vision/patch_embedding", "vision.patch_embedding.weight", True),
    ("vision/class_embedding", "vision.class_embedding", False),
    ("vision/position_embedding", "vision.position_embedding", False),
    ("vision/pre_ln_scale", "vision.pre_ln.weight", False),
    ("vision/pre_ln_bias", "vision.pre_ln.bias", False),
    ("vision/post_ln_scale", "vision.post_ln.weight", False),
    ("vision/post_ln_bias", "vision.post_ln.bias", False),
    ("vision/projection", "vision.projection.weight", True),
    ("logit_scale", "logit_scale", False),
)
_BLOCK_KEYS = (  # reference name under <tower>/blocks, port name, transposed
    ("ln1_scale", "ln1.weight", False), ("ln1_bias", "ln1.bias", False),
    ("qkv_w", "qkv.weight", True), ("qkv_b", "qkv.bias", False),
    ("o_w", "o.weight", True), ("o_b", "o.bias", False),
    ("ln2_scale", "ln2.weight", False), ("ln2_bias", "ln2.bias", False),
    ("fc_w", "fc.weight", True), ("fc_b", "fc.bias", False),
    ("proj_w", "proj.weight", True), ("proj_b", "proj.bias", False),
)


def _towers(cfg: CLIPConfig):
    return (("text", cfg.text.num_layers), ("vision", cfg.vision.num_layers))


def params_from_jax(params, cfg: CLIPConfig) -> Dict[str, torch.Tensor]:
    """Reference parameter pytree (numpy leaves) -> ``CLIP`` state dict (f32)."""
    if cfg.arch != "clip":
        raise NotImplementedError(f"arch {cfg.arch!r}: only CLIP is ported so far")
    flat = {}
    for ref, port, tr in _TOP_KEYS:
        node = params
        for part in ref.split("/"):
            node = node[part]
        flat[port] = np.asarray(node).T if tr else node
    for tower, n in _towers(cfg):
        blocks = params[tower]["blocks"]
        for i in range(n):
            for ref, port, tr in _BLOCK_KEYS:
                a = np.asarray(blocks[ref][i])
                flat[f"{tower}.blocks.{i}.{port}"] = a.T if tr else a
    return {
        k: torch.from_numpy(np.array(a, np.float32, order="C"))
        for k, a in flat.items()
    }


def params_to_jax(model: CLIP):
    """``CLIP`` -> the reference's parameter pytree: nested dicts of f32
    C-contiguous numpy arrays, ``[in, out]`` weights, blocks stacked to
    ``[L, ...]`` (the inverse of :func:`params_from_jax`)."""
    sd = {k: t.detach().float().cpu().numpy() for k, t in model.state_dict().items()}
    c = lambda a, tr: np.ascontiguousarray(a.T if tr else a, np.float32)
    flat = {ref: c(sd[port], tr) for ref, port, tr in _TOP_KEYS}
    for tower, n in _towers(model.cfg):
        for ref, port, tr in _BLOCK_KEYS:
            flat[f"{tower}/blocks/{ref}"] = np.stack([c(sd[f"{tower}.blocks.{i}.{port}"], tr) for i in range(n)])
    return _unflatten(flat)


def build_model(
    cfg: CLIPConfig, state: Dict[str, torch.Tensor], device, dtype, trainable: bool = False
) -> CLIP:
    """A ``CLIP`` holding ``state`` on ``device`` in ``dtype`` (no default
    init). Frozen for serving; ``trainable=True`` leaves every parameter
    requiring grad, on a copy of ``state`` (training updates it in place)."""
    with torch.device("meta"):
        model = CLIP(cfg)
    state = {k: t.to(device=device, dtype=dtype, copy=trainable) for k, t in state.items()}
    model.load_state_dict(state, assign=True, strict=True)
    return model.train() if trainable else model.eval().requires_grad_(False)


def _tower_blocks(normal, prefix: str, tc) -> Dict[str, torch.Tensor]:
    D, M = tc.hidden_size, tc.mlp_size
    s = D**-0.5
    out = {}
    for i in range(tc.num_layers):
        p = f"{prefix}.blocks.{i}."
        out |= {
            p + "ln1.weight": ("ones", (D,)), p + "ln1.bias": ("zeros", (D,)),
            p + "qkv.weight": normal((3 * D, D), s), p + "qkv.bias": ("zeros", (3 * D,)),
            p + "o.weight": normal((D, D), s), p + "o.bias": ("zeros", (D,)),
            p + "ln2.weight": ("ones", (D,)), p + "ln2.bias": ("zeros", (D,)),
            p + "fc.weight": normal((M, D), s), p + "fc.bias": ("zeros", (M,)),
            p + "proj.weight": normal((D, M), M**-0.5), p + "proj.bias": ("zeros", (D,)),
        }
    return out


def init_params(cfg: CLIPConfig, generator: torch.Generator, device, dtype) -> Dict[str, torch.Tensor]:
    """Seeded random ``CLIP`` state with the reference's init distributions
    (``image_search_tpu/models/clip.py::init_params``). Torch and JAX draw
    different numbers from the same seed; tests that compare the packages
    pass the reference's weights through :func:`params_from_jax` instead."""
    if cfg.arch != "clip":
        raise NotImplementedError(f"arch {cfg.arch!r}: only CLIP is ported so far")
    tc, vc = cfg.text, cfg.vision
    P = cfg.projection_dim
    patch_dim = vc.patch_size * vc.patch_size * 3

    def normal(shape, scale):
        return ("normal", shape, scale)

    spec = {
        "text.token_embedding": normal((tc.vocab_size, tc.hidden_size), 0.02),
        "text.position_embedding": normal((tc.context_length, tc.hidden_size), 0.01),
        "text.final_ln.weight": ("ones", (tc.hidden_size,)),
        "text.final_ln.bias": ("zeros", (tc.hidden_size,)),
        "text.projection.weight": normal((P, tc.hidden_size), tc.hidden_size**-0.5),
        "vision.patch_embedding.weight": normal((vc.hidden_size, patch_dim), patch_dim**-0.5),
        "vision.class_embedding": normal((vc.hidden_size,), 0.02),
        "vision.position_embedding": normal((vc.seq_len, vc.hidden_size), 0.01),
        "vision.pre_ln.weight": ("ones", (vc.hidden_size,)),
        "vision.pre_ln.bias": ("zeros", (vc.hidden_size,)),
        "vision.post_ln.weight": ("ones", (vc.hidden_size,)),
        "vision.post_ln.bias": ("zeros", (vc.hidden_size,)),
        "vision.projection.weight": normal((P, vc.hidden_size), vc.hidden_size**-0.5),
    }
    spec |= _tower_blocks(normal, "text", tc)
    spec |= _tower_blocks(normal, "vision", vc)
    out = {}
    for key, (kind, shape, *scale) in spec.items():
        if kind == "normal":
            t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
            out[key] = (t * scale[0]).to(dtype)
        else:
            out[key] = (torch.ones if kind == "ones" else torch.zeros)(shape, device=device, dtype=dtype)
    out["logit_scale"] = torch.tensor(cfg.logit_scale_init, dtype=torch.float32, device=device)
    return out


# -- HuggingFace CLIPModel weights (the reference's models/convert.py:31-191) --


def _np(t) -> np.ndarray:
    """A torch tensor or numpy array -> f32 numpy."""
    if isinstance(t, np.ndarray):
        return np.asarray(t, np.float32)
    return t.detach().cpu().float().numpy()


def _stack_tower_blocks(sd: Mapping[str, Any], prefix: str, num_layers: int) -> dict:
    """HF per-layer weights -> stacked ``[L, ...]`` arrays, q/k/v fused into
    one ``[L, D, 3D]`` projection, ``[in, out]`` weights."""

    def lin(name):
        w = np.stack([_np(sd[f"{prefix}.layers.{i}.{name}.weight"]).T for i in range(num_layers)])
        b = np.stack([_np(sd[f"{prefix}.layers.{i}.{name}.bias"]) for i in range(num_layers)])
        return w, b

    def ln(name):
        s = np.stack([_np(sd[f"{prefix}.layers.{i}.{name}.weight"]) for i in range(num_layers)])
        b = np.stack([_np(sd[f"{prefix}.layers.{i}.{name}.bias"]) for i in range(num_layers)])
        return s, b

    (q_w, q_b), (k_w, k_b), (v_w, v_b) = (lin(f"self_attn.{n}_proj") for n in "qkv")
    o_w, o_b = lin("self_attn.out_proj")
    fc_w, fc_b = lin("mlp.fc1")
    pj_w, pj_b = lin("mlp.fc2")
    ln1_s, ln1_b = ln("layer_norm1")
    ln2_s, ln2_b = ln("layer_norm2")
    return {
        "ln1_scale": ln1_s, "ln1_bias": ln1_b,
        "qkv_w": np.concatenate([q_w, k_w, v_w], axis=2), "qkv_b": np.concatenate([q_b, k_b, v_b], axis=1),
        "o_w": o_w, "o_b": o_b,
        "ln2_scale": ln2_s, "ln2_bias": ln2_b,
        "fc_w": fc_w, "fc_b": fc_b,
        "proj_w": pj_w, "proj_b": pj_b,
    }


def params_from_hf_state_dict(sd: Mapping[str, Any], cfg: CLIPConfig) -> dict:
    """HF ``CLIPModel`` state dict (torch tensors or numpy arrays) -> the
    reference's parameter pytree (nested dicts of f32 numpy arrays), as
    ``image_search_tpu.models.convert.params_from_hf_state_dict`` builds it;
    :func:`params_from_jax` takes it on to a ``CLIP`` state."""
    if cfg.arch != "clip":
        raise NotImplementedError(f"arch {cfg.arch!r}: only CLIP is ported so far (ROADMAP A.10)")
    conv = _np(sd["vision_model.embeddings.patch_embedding.weight"])  # [D, C, p, p]
    text = {
        "token_embedding": _np(sd["text_model.embeddings.token_embedding.weight"]),
        "position_embedding": _np(sd["text_model.embeddings.position_embedding.weight"]),
        "blocks": _stack_tower_blocks(sd, "text_model.encoder", cfg.text.num_layers),
        "final_ln_scale": _np(sd["text_model.final_layer_norm.weight"]),
        "final_ln_bias": _np(sd["text_model.final_layer_norm.bias"]),
        "projection": _np(sd["text_projection.weight"]).T,
    }
    vision = {
        # [D, C, p, p] -> [p*p*C, D] in (ph, pw, c) order, as models.clip patchifies
        "patch_embedding": conv.transpose(2, 3, 1, 0).reshape(-1, conv.shape[0]),
        "class_embedding": _np(sd["vision_model.embeddings.class_embedding"]).reshape(-1),
        "position_embedding": _np(sd["vision_model.embeddings.position_embedding.weight"]),
        "pre_ln_scale": _np(sd["vision_model.pre_layrnorm.weight"]),  # sic: HF's spelling
        "pre_ln_bias": _np(sd["vision_model.pre_layrnorm.bias"]),
        "blocks": _stack_tower_blocks(sd, "vision_model.encoder", cfg.vision.num_layers),
        "post_ln_scale": _np(sd["vision_model.post_layernorm.weight"]),
        "post_ln_bias": _np(sd["vision_model.post_layernorm.bias"]),
        "projection": _np(sd["visual_projection.weight"]).T,
    }
    return {"text": text, "vision": vision, "logit_scale": _np(sd["logit_scale"]).reshape(())}


def _read_hf_dir(path: str) -> Dict[str, np.ndarray]:
    """The tensors of a local HF model directory: ``model.safetensors``, or
    every shard that ``model.safetensors.index.json`` names (the published
    H/14 and bigG directories are sharded)."""
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = ["model.safetensors"]
    flat: Dict[str, np.ndarray] = {}
    for name in files:
        flat.update(read_safetensors(os.path.join(path, name))[0])
    return flat


def params_from_hf_dir(path: str, cfg: CLIPConfig) -> dict:
    """A local HF model directory at configuration ``cfg`` -> the
    reference's parameter pytree."""
    return params_from_hf_state_dict(_read_hf_dir(path), cfg)


# the hub repos of the bundled presets (the reference's HF_REPOS)
HF_REPOS = {
    "clip-vit-large-patch14": "openai/clip-vit-large-patch14",
    "clip-vit-base-patch32": "openai/clip-vit-base-patch32",
    "clip-vit-base-patch16": "openai/clip-vit-base-patch16",
    "openclip-vit-H-14": "laion/CLIP-ViT-H-14-laion2B-s32B-b79K",
    "openclip-vit-bigG-14": "laion/CLIP-ViT-bigG-14-laion2B-39B-b160k",
    "siglip-base-patch16-224": "google/siglip-base-patch16-224",
}
TOKENIZER_FILES = ("vocab.json", "merges.txt")


def convert_hf_model(model_ref: str, out_path: str, preset: str | None = None,
                     tokenizer_out: str | None = None) -> CLIPConfig:
    """Convert a HF CLIP model, both towers, into one checkpoint at
    ``out_path`` (+ the BPE files into ``tokenizer_out``); returns its config.

    ``model_ref`` is a local HF directory (read here, nothing imported) or a
    hub id, fetched through ``transformers``, imported only then: offline, or
    without the package, a hub id raises, and the engine goes on without.
    The configuration is the preset named by ``preset`` (else by the last
    part of ``model_ref``)."""
    cfg = get_config((preset or model_ref).rstrip("/").split("/")[-1])
    if cfg.arch != "clip":
        raise NotImplementedError(f"arch {cfg.arch!r}: only CLIP is ported so far (ROADMAP A.10)")
    if os.path.isdir(model_ref):
        params = params_from_hf_dir(model_ref, cfg)
        if tokenizer_out and all(os.path.exists(os.path.join(model_ref, n)) for n in TOKENIZER_FILES):
            os.makedirs(tokenizer_out, exist_ok=True)
            for name in TOKENIZER_FILES:
                shutil.copyfile(os.path.join(model_ref, name), os.path.join(tokenizer_out, name))
    else:
        from transformers import AutoTokenizer, CLIPModel

        params = params_from_hf_state_dict(CLIPModel.from_pretrained(model_ref).state_dict(), cfg)
        if tokenizer_out:
            os.makedirs(tokenizer_out, exist_ok=True)
            AutoTokenizer.from_pretrained(model_ref, use_fast=False).save_vocabulary(tokenizer_out)
    save_checkpoint(out_path, params, cfg)
    return cfg
