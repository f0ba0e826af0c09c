"""CLIP dual-tower model as ``nn.Module``s.

Port of ``image_search_tpu/models/clip.py``. The math and the dtype policy
are the reference's: activations in the compute dtype, each weight cast to it
at its use (``F.linear(x, w.to(x.dtype), b.to(x.dtype))``), LayerNorm
statistics, softmax and attention accumulation in f32. Serving holds bf16
weights, so the casts are no-ops; training holds f32 master weights and
computes in bf16, as the reference's train step does.

- ``encode_image``: patchify as a matmul, class token, pre-LN, blocks
  ``0..L-2`` through the attention core (``ops.attention``: B1, B1p or B6
  forward by ``attention_route``, B5 backward), then the CLS-only last
  block (under ``ISX_CLS_LAST=0`` the full last block, then the CLS row),
  post-LN and the projection. Under ``ISX_VIT_SPAD`` the sequence is
  padded once after the pre-LN and stays padded through every block (pad
  keys masked by index, pad rows never read), as the reference's is.
- ``encode_text``: token + position embedding, blocks ``0..L-2`` causal
  through the core, then the EOS-only last block (pooled at the FIRST EOS
  token; under ``ISX_EOS_LAST=0`` the full last block, then that row), the
  final LN and the projection.
- ``remat=True`` (training) runs the full L-layer stacks instead, each block
  under ``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``
  over its scanned blocks does.

The CLS/EOS-only last blocks stay plain torch, as they are plain XLA in the
reference. Layouts differ from the reference's parameter pytree only in the
``nn.Linear`` convention (``weight`` is ``[out, in]``); ``models.convert``
maps one to the other.
"""

from __future__ import annotations

import functools
import os

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from image_search_tpu_torch.ops.attention import NEG_INF, AttentionCore, attention_route, split_regime

# remat policies (the reference's jax.checkpoint_policies names): "" recomputes
# everything; the default saves the outputs of matmuls without batch dims
# (aten.mm / aten.addmm: every projection) and recomputes the rest
REMAT_POLICIES = {
    "": None,
    "dots_with_no_batch_dims_saveable": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default),
}


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with f32 statistics, output cast back to x.dtype."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps)
    return y.to(x.dtype)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "quick_gelu":
        # HF CLIP's QuickGELUActivation: x * sigmoid(1.702 * x)
        return x * torch.sigmoid(1.702 * x)
    if kind == "gelu":
        return F.gelu(x, approximate="none")
    if kind == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {kind!r}")


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``lin`` applied in x's dtype: its weight is cast at the use."""
    b = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), b)


def _ln(d: int, eps: float) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=eps)


class Block(nn.Module):
    """Pre-LN transformer block (HF CLIPEncoderLayer)."""

    def __init__(self, tc):
        super().__init__()
        D, M = tc.hidden_size, tc.mlp_size
        self.heads = tc.num_heads
        self.act = tc.act
        self.ln1 = _ln(D, tc.layernorm_eps)
        self.qkv = nn.Linear(D, 3 * D)
        self.o = nn.Linear(D, D)
        self.ln2 = _ln(D, tc.layernorm_eps)
        self.fc = nn.Linear(D, M)
        self.proj = nn.Linear(M, D)

    def mlp(self, x):
        return _linear(_act(_linear(x, self.fc), self.act), self.proj)

    def attention(self, xn, causal: bool, s_real=None):
        """Self-attention over the LN'd input; q is pre-scaled by Hd^-0.5,
        so the core runs at sm_scale 1. One fused qkv projection: the core
        reads k and v as strided column blocks of it. The core is the
        reference's for this layer (``attention_route``); ``s_real`` marks a
        sequence padded end to end (rows >= s_real are padding)."""
        S, D = xn.shape[1:]
        Hd = D // self.heads
        qkv = _linear(xn, self.qkv)
        q = qkv[..., :D] * float(Hd**-0.5)
        route = attention_route(S, self.heads, causal, s_real)
        out = AttentionCore.apply(
            q, qkv[..., D : 2 * D], qkv[..., 2 * D :], self.heads, causal, 1.0, route, s_real
        )
        return _linear(out, self.o)

    def forward(self, x, causal: bool, s_real=None):
        x = x + self.attention(_layer_norm(x, self.ln1), causal, s_real)
        return x + self.mlp(_layer_norm(x, self.ln2))

    def _qkv_rows(self, xn_q, xn):
        """q for the selected rows [B, 1, D] (pre-scaled), k and v for all."""
        D = xn.shape[-1]
        Hd = D // self.heads
        w, b = self.qkv.weight.to(xn.dtype), self.qkv.bias.to(xn.dtype)
        q = F.linear(xn_q, w[:D], b[:D]) * float(Hd**-0.5)
        k = F.linear(xn, w[D : 2 * D], b[D : 2 * D])
        v = F.linear(xn, w[2 * D :], b[2 * D :])
        return q, k, v

    def _pooled_attention(self, q, k, v, col_mask=None):
        """Attention of one query row per batch element, the grouped kernel's
        dtype sequence: f32 logits, f32 softmax, p in the activation dtype,
        f32 PV accumulation."""
        B, S, D = k.shape
        H = self.heads
        Hd = D // H
        dtype = k.dtype
        logits = torch.einsum(
            "bqhd,bkhd->bhqk", q.reshape(B, 1, H, Hd).float(), k.reshape(B, S, H, Hd).float()
        )
        if col_mask is not None:
            logits = logits.masked_fill(~col_mask, NEG_INF)
        p = torch.softmax(logits, dim=-1).to(dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.reshape(B, S, H, Hd).float())
        return _linear(out.to(dtype).reshape(B, 1, D), self.o)

    def forward_cls(self, x, s_real=None):
        """Last block truncated to the CLS row -> [B, 1, D] (``_block_cls``):
        only x[:, 0] is read after the last layer, so its Q projection,
        attention rows 1.. and MLP rows 1.. are dead work. K/V still cover
        every token. A padded sequence is cut to its ``s_real`` rows first,
        as ``_attention_cls`` does."""
        if s_real is not None:
            x = x[:, :s_real]
        xn = _layer_norm(x, self.ln1)
        q, k, v = self._qkv_rows(xn[:, :1], xn)
        c = x[:, :1] + self._pooled_attention(q, k, v)
        return c + self.mlp(_layer_norm(c, self.ln2))

    def forward_eos(self, x, eos_pos):
        """Last text block truncated to each row's pooled (first-EOS)
        position -> [B, 1, D] (``_block_eos``); the causal mask of that row
        is the column mask ``col <= eos_pos[b]``."""
        B, S, _ = x.shape
        rows = torch.arange(B, device=x.device)
        xn = _layer_norm(x, self.ln1)
        q, k, v = self._qkv_rows(xn[rows, eos_pos][:, None], xn)
        col = torch.arange(S, device=x.device)
        mask = (col[None, :] <= eos_pos[:, None])[:, None, None, :]
        c = x[rows, eos_pos][:, None] + self._pooled_attention(q, k, v, mask)
        return c + self.mlp(_layer_norm(c, self.ln2))


class VisionTower(nn.Module):
    def __init__(self, vc, projection_dim: int):
        super().__init__()
        D = vc.hidden_size
        self.cfg = vc
        self.patch_embedding = nn.Linear(vc.patch_size * vc.patch_size * 3, D, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(D))
        self.position_embedding = nn.Parameter(torch.empty(vc.seq_len, D))
        self.pre_ln = _ln(D, vc.layernorm_eps)
        self.blocks = nn.ModuleList(Block(vc) for _ in range(vc.num_layers))
        self.post_ln = _ln(D, vc.layernorm_eps)
        self.projection = nn.Linear(D, projection_dim, bias=False)


class TextTower(nn.Module):
    def __init__(self, tc, projection_dim: int):
        super().__init__()
        D = tc.hidden_size
        self.cfg = tc
        self.token_embedding = nn.Parameter(torch.empty(tc.vocab_size, D))
        self.position_embedding = nn.Parameter(torch.empty(tc.context_length, D))
        self.blocks = nn.ModuleList(Block(tc) for _ in range(tc.num_layers))
        self.final_ln = _ln(D, tc.layernorm_eps)
        self.projection = nn.Linear(D, projection_dim, bias=False)


class CLIP(nn.Module):
    """Both towers of one checkpoint; ``cfg`` is the reference's CLIPConfig."""

    def __init__(self, cfg):
        super().__init__()
        if cfg.arch != "clip":
            raise NotImplementedError(f"arch {cfg.arch!r}: only CLIP is ported so far")
        self.cfg = cfg
        self.text = TextTower(cfg.text, cfg.projection_dim)
        self.vision = VisionTower(cfg.vision, cfg.projection_dim)
        self.logit_scale = nn.Parameter(torch.empty(()))

    @property
    def dtype(self) -> torch.dtype:
        return self.vision.patch_embedding.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.vision.patch_embedding.weight.device


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p*C] with (ph, pw, c) minor order."""
    B, H, W, C = pixels.shape
    gh, gw = H // patch, W // patch
    x = pixels.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)
    return (x.float() / torch.clamp(n, min=eps)).to(x.dtype)


def _encoder(x, blocks, causal: bool, remat_policy: str):
    """Every block of a tower (the training path), each under
    ``torch.utils.checkpoint`` with the named policy."""
    ops = REMAT_POLICIES[remat_policy]
    context_fn = checkpoint.noop_context_fn
    if ops is not None:
        context_fn = functools.partial(checkpoint.create_selective_checkpoint_contexts, list(ops))
    for blk in blocks:
        x = checkpoint.checkpoint(blk, x, causal, use_reentrant=False, context_fn=context_fn)
    return x


def _vit_spad(x: torch.Tensor):
    """(x, s_real): the pre-LN'd vision sequence zero-padded once to
    ``ISX_VIT_SPAD`` rows and its real row count S0, or (x, None) when the
    switch does not apply (``image_search_tpu/models/clip.py:498-516``).

    It pads when the switch asks for more rows than S0, S0 is in the split
    kernel's regime, and x is on the card (on the CPU only with
    ``ISX_VIT_SPAD_CPU=1``); an off-regime tower ignores the switch. The
    padded length must be (S0//128)*128 + 8, the split kernel's tail.
    Training (remat) never pads: the caller does not ask.
    """
    spad = int(os.environ.get("ISX_VIT_SPAD", "0") or 0)
    S0 = x.shape[1]
    on_device = x.device.type == "cuda" or os.environ.get("ISX_VIT_SPAD_CPU") == "1"
    if not (spad > S0 and on_device and split_regime(S0)):
        return x, None
    if spad != (S0 // 128) * 128 + 8:
        raise ValueError(
            f"ISX_VIT_SPAD={spad} invalid for S={S0}: need Sp == (S//128)*128 + 8 (the split kernel's tail)"
        )
    return F.pad(x, (0, 0, 0, spad - S0)), S0


def encode_image(
    model: CLIP, pixels: torch.Tensor, normalize: bool = False, compute_dtype=None,
    remat: bool = False, remat_policy: str = "",
) -> torch.Tensor:
    """Preprocessed pixels [B, H, W, 3] (NHWC, normalized) -> [B, proj_dim].
    ``compute_dtype`` defaults to the weights' dtype."""
    v = model.vision
    vc = v.cfg
    dtype = compute_dtype or model.dtype
    B = pixels.shape[0]
    x = _linear(patchify(pixels.to(dtype), vc.patch_size), v.patch_embedding)
    cls = v.class_embedding.to(dtype).reshape(1, 1, -1).expand(B, 1, -1)
    x = torch.cat([cls, x], dim=1) + v.position_embedding.to(dtype)
    x = _layer_norm(x, v.pre_ln)
    x, s_real = (x, None) if remat else _vit_spad(x)
    if remat:
        pooled = _encoder(x, v.blocks, False, remat_policy)[:, 0]
    elif vc.num_layers > 1 and os.environ.get("ISX_CLS_LAST", "1") == "1":
        for blk in v.blocks[:-1]:
            x = blk(x, False, s_real)
        pooled = v.blocks[-1].forward_cls(x, s_real)[:, 0]
    else:  # ISX_CLS_LAST=0: the full last block, then the CLS row
        for blk in v.blocks:
            x = blk(x, False, s_real)
        pooled = x[:, 0]
    pooled = _layer_norm(pooled, v.post_ln)
    emb = _linear(pooled, v.projection)
    return l2_normalize(emb) if normalize else emb


def encode_text(
    model: CLIP, input_ids: torch.Tensor, normalize: bool = False, compute_dtype=None,
    remat: bool = False, remat_policy: str = "",
) -> torch.Tensor:
    """Token ids [B, S] -> [B, proj_dim], pooled at the first EOS token.
    ``compute_dtype`` defaults to the weights' dtype."""
    t = model.text
    tc = t.cfg
    B, S = input_ids.shape
    x = (t.token_embedding[input_ids] + t.position_embedding[:S]).to(compute_dtype or model.dtype)
    # HF CLIP pools at the first EOS token (pad == EOS for CLIP's tokenizer);
    # torch.argmax returns the first maximal index
    eos_pos = torch.argmax((input_ids == tc.eos_token_id).to(torch.int32), dim=-1)
    rows = torch.arange(B, device=x.device)
    if remat:
        pooled = _encoder(x, t.blocks, True, remat_policy)[rows, eos_pos]
    elif tc.num_layers > 1 and os.environ.get("ISX_EOS_LAST", "1") == "1":
        for blk in t.blocks[:-1]:
            x = blk(x, causal=True)
        pooled = t.blocks[-1].forward_eos(x, eos_pos)[:, 0]
    else:  # ISX_EOS_LAST=0: the full last block, then the EOS row
        for blk in t.blocks:
            x = blk(x, causal=True)
        pooled = x[rows, eos_pos]
    pooled = _layer_norm(pooled, t.final_ln)
    emb = _linear(pooled, t.projection)
    return l2_normalize(emb) if normalize else emb


def forward(
    model: CLIP, input_ids: torch.Tensor, pixels: torch.Tensor, compute_dtype=None,
    remat: bool = False, remat_policy: str = "",
):
    """The contrastive forward: (image_emb, text_emb, logit_scale), the
    embeddings l2-normalized in the compute dtype, the scale exp(logit_scale)
    in f32 (``image_search_tpu/models/clip.py::forward``)."""
    img = encode_image(model, pixels, True, compute_dtype, remat, remat_policy)
    txt = encode_text(model, input_ids, True, compute_dtype, remat, remat_policy)
    return img, txt, torch.exp(model.logit_scale.float())
