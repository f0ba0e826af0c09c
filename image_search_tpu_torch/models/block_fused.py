"""Fused-block compositions of a transformer block: kernels B7 and B9 in
the vision forward.

The port of the three compositions of ``benchmarks/block_fused_e2e.py``
(``block_full_fused``, ``block_qkv_only``, ``block_mlp_only``), written over
the port's :class:`~image_search_tpu_torch.models.clip.Block` and its own
``nn.Linear`` and ``LayerNorm`` parameters, so the reference's weights come
across through ``models.convert.params_from_jax`` unchanged:

- ``block_full_fused``: LN1 fused into the qkv projection (B9), B7 on the
  packed qkv at sm_scale Hd^-0.5, the o projection, LN2 fused into the MLP's
  fc (B9), the activation and the output projection;
- ``block_qkv_only``: B9 for LN1 -> qkv, q scaled by Hd^-0.5, then B1p
  (``AttentionCore`` on the "packed" route at sm_scale 1, the reference's
  ``attention_core``); the shipped MLP;
- ``block_mlp_only``: the shipped ``Block.attention`` (its route by
  ``attention_route``), then the B9 MLP.

:func:`blocks_as` swaps ``Block.forward`` for one of them and restores it,
as the benchmark swaps the reference's ``_block``; the towers then run it on
blocks ``0..L-2`` while the CLS/EOS-only last block stays as it is. No flag,
environment variable or server option selects a composition: like the
reference, the port keeps them off every served path. They take no padded
sequence (``s_real``), as the reference's compositions take none.
"""

from __future__ import annotations

import contextlib

from image_search_tpu_torch.models.clip import Block, _act, _layer_norm, _linear
from image_search_tpu_torch.ops.attention import AttentionCore, AttentionQkvPackedCore
from image_search_tpu_torch.ops.ln_matmul import LnMatmulCore


def _no_padding(s_real) -> None:
    if s_real is not None:
        raise ValueError("the fused-block compositions take no padded sequence: unset ISX_VIT_SPAD")


def _ln_linear(x, ln, lin):
    """``lin(ln(x))`` through B9: x [B, S, D] -> [B, S, out] in x.dtype."""
    B, S, D = x.shape
    out = LnMatmulCore.apply(
        x.reshape(B * S, D), ln.weight, ln.bias, lin.weight.to(x.dtype), lin.bias.to(x.dtype), ln.eps
    )
    return out.reshape(B, S, -1)


def _fused_mlp(blk: Block, x):
    """LN2 fused into the MLP's fc (B9), then the activation and proj."""
    return _linear(_act(_ln_linear(x, blk.ln2, blk.fc), blk.act), blk.proj)


def block_full_fused(blk: Block, x, causal: bool, s_real=None):
    _no_padding(s_real)
    Hd = x.shape[-1] // blk.heads
    qkv = _ln_linear(x, blk.ln1, blk.qkv)
    attn = AttentionQkvPackedCore.apply(qkv, blk.heads, causal, float(Hd**-0.5))
    x = x + _linear(attn, blk.o)
    return x + _fused_mlp(blk, x)


def block_qkv_only(blk: Block, x, causal: bool, s_real=None):
    _no_padding(s_real)
    D = x.shape[-1]
    Hd = D // blk.heads
    qkv = _ln_linear(x, blk.ln1, blk.qkv)
    q = qkv[..., :D] * float(Hd**-0.5)
    out = AttentionCore.apply(q, qkv[..., D : 2 * D], qkv[..., 2 * D :], blk.heads, causal, 1.0, "packed")
    x = x + _linear(out, blk.o)
    return x + blk.mlp(_layer_norm(x, blk.ln2))


def block_mlp_only(blk: Block, x, causal: bool, s_real=None):
    _no_padding(s_real)
    x = x + blk.attention(_layer_norm(x, blk.ln1), causal)
    return x + _fused_mlp(blk, x)


COMPOSITIONS = {
    "fully fused": block_full_fused,
    "ln1->qkv only": block_qkv_only,
    "ln2->fc only": block_mlp_only,
}


@contextlib.contextmanager
def blocks_as(fn):
    """Every ``Block`` runs ``fn(blk, x, causal, s_real)`` as its forward
    inside the context; the shipped forward is restored on exit, also when
    the body raises."""
    shipped = Block.forward
    Block.forward = lambda self, x, causal, s_real=None: fn(self, x, causal, s_real)
    try:
        yield
    finally:
        Block.forward = shipped
