"""The plain reference of both configurations: CLIP in float32, plain torch.

Written from the published model (HuggingFace ``CLIPModel``, OpenCLIP's
``ViT-H-14``): pre-LN blocks, a fused qkv projection, attention as explicit
f32 matmuls and a softmax, quick-GELU or GELU, the class token pooled after
the vision tower's last layer, the first EOS token pooled after the text
tower's (causal) last layer, both projected without bias. It imports nothing
of the program; weights come from ``bench_port.weights`` under the port's
state names. TF32 is off for every matmul here (:func:`f32_exact`).

``lowp="fp8"`` is the control: every matmul's two operands rounded to
float8 e4m3 with one scale a tensor, the step below the bf16 the
configurations compute in. Departures from the published models: none in
the mathematics; the vision patch embedding takes the patch's pixels in
(row, column, channel) order, the order of the project's checkpoint format.
"""

from __future__ import annotations

import contextlib
import math
import zlib

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@contextlib.contextmanager
def f32_exact():
    """Full f32 matmuls for the block (no TF32), restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale (its largest magnitude at
    e4m3's largest finite value), back in f32. The rounding is the
    forward's only: the gradient passes through it unrounded, as a scaled
    fp8 training recipe keeps its gradients in a wider type."""
    d = x.detach()
    s = d.abs().amax().clamp(min=1e-30) / 448.0
    return x + ((d / s).to(torch.float8_e4m3fn).float() * s - d)


def hash_tokens(texts, vocab_size: int, context: int, eos_id: int) -> torch.Tensor:
    """The project's hash tokenizer (used when no BPE vocabulary is
    given): BOS, one id a lower-cased whitespace word (2 + crc32 mod
    (vocab - 4), stepped past BOS and EOS), EOS, then EOS to the context."""
    bos = (eos_id - 1) % vocab_size
    out = torch.full((len(texts), context), eos_id, dtype=torch.long)
    for i, text in enumerate(texts):
        ids = []
        for w in " ".join(text.split()).lower().split()[: context - 2]:
            t = 2 + zlib.crc32(w.encode("utf-8")) % (vocab_size - 4)
            if t in (bos, eos_id):
                t = (t + 1) % (vocab_size - 4) + 2
            ids.append(t)
        row = [bos] + ids + [eos_id]
        out[i, : len(row)] = torch.tensor(row)
    return out


class Clip:
    """Both towers over a state dict (any dtype; used as f32)."""

    def __init__(self, m: dict, state: dict, lowp: str | None = None):
        self.m = m
        self.w = {k: v.float() for k, v in state.items()}
        self.lowp = lowp

    def _mm(self, x, w, b=None):
        if self.lowp == "fp8":
            x, w = fp8(x), fp8(w)
        y = x @ w.t()
        return y if b is None else y + b

    def _act(self, x, kind):
        if kind == "quick_gelu":
            return x * torch.sigmoid(1.702 * x)
        if kind == "gelu":
            return F.gelu(x)
        raise ValueError(kind)

    def _ln(self, x, p, eps):
        return F.layer_norm(x, (x.shape[-1],), self.w[p + ".weight"], self.w[p + ".bias"], eps)

    def _block(self, x, p, tc, causal):
        w, H = self.w, tc["num_heads"]
        B, S, D = x.shape
        hd = D // H
        h = self._ln(x, p + "ln1", tc["layernorm_eps"])
        qkv = self._mm(h, w[p + "qkv.weight"], w[p + "qkv.bias"])
        q, k, v = (t.reshape(B, S, H, hd).transpose(1, 2) for t in qkv.split(D, dim=-1))
        if self.lowp == "fp8":
            q, k = fp8(q), fp8(k)
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        if causal:
            mask = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
            logits = logits.masked_fill(mask, float("-inf"))
        p_attn = torch.softmax(logits, dim=-1)
        if self.lowp == "fp8":
            p_attn, v = fp8(p_attn), fp8(v)
        a = (p_attn @ v).transpose(1, 2).reshape(B, S, D)
        x = x + self._mm(a, w[p + "o.weight"], w[p + "o.bias"])
        h = self._ln(x, p + "ln2", tc["layernorm_eps"])
        h = self._act(self._mm(h, w[p + "fc.weight"], w[p + "fc.bias"]), tc["act"])
        return x + self._mm(h, w[p + "proj.weight"], w[p + "proj.bias"])

    def _run(self, x, tower, tc, causal, remat):
        for i in range(tc["num_layers"]):
            p = f"{tower}.blocks.{i}."
            if remat:
                x = torch.utils.checkpoint.checkpoint(self._block, x, p, tc, causal, use_reentrant=False)
            else:
                x = self._block(x, p, tc, causal)
        return x

    def encode_image(self, pixels: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """Normalised pixels [B, H, W, 3] -> raw [B, projection_dim]."""
        vc, w = self.m["vision"], self.w
        P = vc["patch_size"]
        B, Hh, Ww, C = pixels.shape
        x = pixels.reshape(B, Hh // P, P, Ww // P, P, C).permute(0, 1, 3, 2, 4, 5).reshape(B, -1, P * P * C)
        x = self._mm(x, w["vision.patch_embedding.weight"])
        cls = w["vision.class_embedding"].reshape(1, 1, -1).expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1) + w["vision.position_embedding"]
        x = self._ln(x, "vision.pre_ln", vc["layernorm_eps"])
        x = self._run(x, "vision", vc, False, remat)
        pooled = self._ln(x[:, 0], "vision.post_ln", vc["layernorm_eps"])
        return self._mm(pooled, w["vision.projection.weight"])

    def encode_text(self, ids: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """Token ids [B, S] -> raw [B, projection_dim], pooled at the first EOS."""
        tc, w = self.m["text"], self.w
        B, S = ids.shape
        x = w["text.token_embedding"][ids] + w["text.position_embedding"][:S]
        x = self._run(x, "text", tc, True, remat)
        eos = torch.argmax((ids == tc["eos_token_id"]).int(), dim=-1)
        pooled = self._ln(x[torch.arange(B, device=x.device), eos], "text.final_ln", tc["layernorm_eps"])
        return self._mm(pooled, w["text.projection.weight"])


def preprocess(path: str, size: int, draft: int = 512) -> torch.Tensor:
    """A photo file -> normalised [size, size, 3] f32: PIL's decode (a JPEG
    at its DCT draft scale, the smallest that keeps both sides at least
    ``draft``), the shortest side resized to ``size`` by PIL's bicubic, the
    centre crop, CLIP's mean and standard deviation."""
    import numpy as np
    from PIL import Image

    with Image.open(path) as im:
        if im.format == "JPEG":
            im.draft("RGB", (draft, draft))
        im = im.convert("RGB")
        w, h = im.size
        short, long = min(w, h), max(w, h)
        new_long = int(size * long / short)
        nw, nh = (new_long, size) if w >= h else (size, new_long)
        im = im.resize((nw, nh), Image.BICUBIC)
        top, left = (nh - size) // 2, (nw - size) // 2
        arr = np.asarray(im, dtype=np.float32)[top : top + size, left : left + size] / 255.0
    mean, std = np.asarray(CLIP_MEAN, np.float32), np.asarray(CLIP_STD, np.float32)
    return torch.from_numpy((arr - mean) / std)
