"""Weights for the port: the reference's checkpoint file, its parameter
pytree, and seeded random demo weights.

- :func:`load_checkpoint` reads the file ``image_search_tpu.models.convert.
  save_checkpoint`` writes (safetensors: an 8-byte little-endian header
  length, a JSON header, raw little-endian buffers; ``/``-joined keys, stacked
  ``[L, ...]`` block tensors, the ``CLIPConfig`` JSON in the metadata) with
  json and numpy alone -- the ``safetensors`` package is not needed.
- :func:`params_from_jax` turns the reference's parameter pytree (numpy
  arrays) into the state of ``models.clip.CLIP``. This is the one place
  layouts change: the reference multiplies ``x @ w`` with ``w`` as
  ``[in, out]``; ``nn.Linear`` holds ``[out, in]``.
- :func:`init_params` makes the demo-mode random weights from a
  ``torch.Generator``, with the reference's distributions.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np
import torch

from image_search_tpu_torch.config import CLIPConfig
from image_search_tpu_torch.models.clip import CLIP

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
    "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}


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


def load_checkpoint(path: str):
    """Returns (reference-layout params as nested numpy dicts, cfg)."""
    flat, meta = read_safetensors(path)
    return _unflatten(flat), CLIPConfig.from_json(meta["config"])


def _blocks_from_jax(blocks, prefix: str, num_layers: int) -> Dict[str, np.ndarray]:
    out = {}
    for i in range(num_layers):
        p = f"{prefix}.blocks.{i}."
        g = lambda name: np.asarray(blocks[name][i])
        out |= {
            p + "ln1.weight": g("ln1_scale"), p + "ln1.bias": g("ln1_bias"),
            p + "qkv.weight": g("qkv_w").T, p + "qkv.bias": g("qkv_b"),
            p + "o.weight": g("o_w").T, p + "o.bias": g("o_b"),
            p + "ln2.weight": g("ln2_scale"), p + "ln2.bias": g("ln2_bias"),
            p + "fc.weight": g("fc_w").T, p + "fc.bias": g("fc_b"),
            p + "proj.weight": g("proj_w").T, p + "proj.bias": g("proj_b"),
        }
    return out


def params_from_jax(params, cfg: CLIPConfig) -> Dict[str, torch.Tensor]:
    """Reference parameter pytree (numpy leaves) -> ``CLIP`` state dict (f32)."""
    if cfg.arch != "clip":
        raise NotImplementedError(f"arch {cfg.arch!r}: only CLIP is ported so far")
    t, v = params["text"], params["vision"]
    flat = {
        "text.token_embedding": t["token_embedding"],
        "text.position_embedding": t["position_embedding"],
        "text.final_ln.weight": t["final_ln_scale"],
        "text.final_ln.bias": t["final_ln_bias"],
        "text.projection.weight": np.asarray(t["projection"]).T,
        # [p*p*C, D] in (ph, pw, c) order -> Linear [D, p*p*C], same order
        "vision.patch_embedding.weight": np.asarray(v["patch_embedding"]).T,
        "vision.class_embedding": v["class_embedding"],
        "vision.position_embedding": v["position_embedding"],
        "vision.pre_ln.weight": v["pre_ln_scale"],
        "vision.pre_ln.bias": v["pre_ln_bias"],
        "vision.post_ln.weight": v["post_ln_scale"],
        "vision.post_ln.bias": v["post_ln_bias"],
        "vision.projection.weight": np.asarray(v["projection"]).T,
        "logit_scale": params["logit_scale"],
    }
    flat |= _blocks_from_jax(t["blocks"], "text", cfg.text.num_layers)
    flat |= _blocks_from_jax(v["blocks"], "vision", cfg.vision.num_layers)
    return {
        k: torch.from_numpy(np.array(a, np.float32, order="C"))
        for k, a in flat.items()
    }


def build_model(cfg: CLIPConfig, state: Dict[str, torch.Tensor], device, dtype) -> CLIP:
    """A ``CLIP`` holding ``state`` on ``device`` in ``dtype`` (no default init)."""
    with torch.device("meta"):
        model = CLIP(cfg)
    state = {k: t.to(device=device, dtype=dtype) for k, t in state.items()}
    model.load_state_dict(state, assign=True, strict=True)
    return model.eval().requires_grad_(False)


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
