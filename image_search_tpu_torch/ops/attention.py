"""Multi-head attention core: kernels B1, B1p and B6 (forward) and B5
(backward), each with its plain PyTorch version, and the towers' choice
between them.

- ``fused_attention`` is the port of ``image_search_tpu/ops/attention.py::
  fused_attention_grouped`` (Pallas ``_attn_kernel_grouped``), the default
  route of every attention layer of both CLIP towers except the CLS/EOS-only
  last one. On a CUDA tensor it launches ``csrc/attention.cu``; on a CPU
  tensor it runs :func:`attention_reference`. It follows the grouped
  kernel's rounding points: f32 logits, f32 softmax statistics,
  probabilities cast to the activation dtype BEFORE the PV product, f32 PV
  accumulation, and the 1/sum factor applied to the accumulator.
- ``fused_attention_packed`` (B1p) is the port of ``fused_attention_packed``
  (Pallas ``_attn_kernel``): the same function with p normalised in f32
  before the bf16 cast (:func:`attention_packed_reference`).
- ``fused_attention_split`` and ``fused_attention_split_padded`` (B6) are
  the ports of the entry points of the same names (Pallas
  ``_attn_kernel_split``): B1p's rounding over one shared max and
  denominator, keys split at ``s_main = (S//128)*128`` into a main block and
  a tail whose PV sums are added in f32, and keys at or past ``s_real``
  masked (:func:`attention_split_reference`). Non-causal, S in
  :func:`split_regime` only.
- :func:`attention_route` picks one of those cores for a layer exactly as
  the reference's ``models/clip.py::_attention`` does, from ``ISX_ATTN_PIPE``
  (default 4), ``ISX_ATTN_SPLIT`` and whether the sequence is padded end to
  end (``ISX_VIT_SPAD``, see ``models/clip.py::encode_image``).
- ``fused_attention_bwd`` is the port of ``fused_attention_bwd`` (Pallas
  ``_attn_bwd_kernel``): dq, dk and dv from the output cotangent, with the
  probabilities recomputed in f32. On a CUDA tensor it launches
  ``csrc/attention_bwd.cu``; on a CPU tensor it runs
  :func:`attention_bwd_reference`.
- :class:`AttentionCore` joins a route's forward and B5 as one
  differentiable op, as the reference's ``attention_grouped_core``,
  ``attention_core`` and ``attention_split_core`` custom VJPs do. The padded
  route has no VJP in the reference and raises when a gradient is needed.
- ``fused_attention_qkv_packed`` (B7) is the port of the entry point of the
  same name (Pallas ``_attn_kernel_packed``): B1p's function over the three
  column blocks of one ``[B, S, 3D]`` qkv, q unscaled and ``sm_scale``
  applied to the f32 logits. It launches B1p's kernel on the three views.
  :class:`AttentionQkvPackedCore` is its VJP (``attention_qkv_packed_core``):
  B5 on the views, concatenated.
- ``fused_qkv_attention`` (B8) is the port of the entry point of the same
  name (Pallas ``_qkv_attn_kernel``): the qkv projection of the LN'd x and
  B7's attention in one kernel (``csrc/qkv_attention.cu``), so qkv never
  reaches device memory (:func:`qkv_attention_reference`). No tower calls
  it, as in the reference.

There is no other route: a CUDA tensor a kernel cannot take raises.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from image_search_tpu_torch import _build

NEG_INF = torch.finfo(torch.float32).min
# the head dims each kernel is built at (csrc/attention.cu's dispatch,
# attention_bwd.cu, qkv_attention.cu's kHd); a CUDA tensor at any other raises
# 32: the learned-retrieval example's towers; 64: ViT-L/14 and every text
# tower; 80 and 104: OpenCLIP H/14's and bigG's vision towers
FWD_HEAD_DIMS = (32, 64, 80, 104)  # B1, B1p, B6, B7
BWD_HEAD_DIMS = (32, 64, 80, 104)  # B5
QKV_HEAD_DIMS = (64,)  # B8
MAX_KEYS = 320  # csrc/attention_tc.cuh: kMaxKeyTiles = 20 key tiles of 16 held in registers
_TAIL = 8  # the split kernels' tail block: Sp = s_main + 8


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in its accumulation type: f32 for bf16/f16/f32, f64 for f64 (so
    that gradient checks in f64 see the same function)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _logits(q, k, causal: bool, sm_scale: float):
    """[B, S, H, Hd] q, k -> [B, H, S, S] logits in the accumulation type,
    masked positions at NEG_INF (never -inf)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", _acc(q), _acc(k)) * sm_scale
    if causal:
        S = q.shape[1]
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, NEG_INF)
    return logits - logits.amax(dim=-1, keepdim=True)


def attention_reference(q, k, v, causal: bool = False, sm_scale: float = 1.0):
    """Plain attention over [B, S, H, Hd] -> [B, S, H, Hd] (output in q.dtype)."""
    dtype = q.dtype
    p32 = torch.exp(_logits(q, k, causal, sm_scale))
    recip = 1.0 / p32.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", _acc(p32.to(dtype)), _acc(v))
    return (acc * recip).to(dtype).permute(0, 2, 1, 3)


def attention_packed_reference(q, k, v, causal: bool = False, sm_scale: float = 1.0):
    """Plain B1p over [B, S, H, Hd] -> [B, S, H, Hd]: p = exp(l - max) / sum in
    f32, THEN rounded to q.dtype, PV accumulated in f32 (``_attn_kernel``)."""
    dtype = q.dtype
    p32 = torch.exp(_logits(q, k, causal, sm_scale))
    p = (p32 / p32.sum(dim=-1, keepdim=True)).to(dtype)
    return torch.einsum("bhqk,bkhd->bhqd", _acc(p), _acc(v)).to(dtype).permute(0, 2, 1, 3)


def attention_split_reference(q, k, v, s_real: int, sm_scale: float = 1.0):
    """Plain B6 over operands padded to Sp = s_main + 8 rows, [B, Sp, H, Hd]
    -> [B, Sp, H, Hd]: every query row (pad rows too) over keys [0, s_real).

    ``_attn_kernel_split``'s rounding points: main logits (keys < s_main) and
    tail logits (keys s_main..Sp-1, those >= s_real at NEG_INF) in f32, one
    shared max and one shared denominator, each block's p divided by it in
    f32 and rounded to q.dtype, then main PV + tail PV added in f32. Pad keys
    are left out of the tail's PV (the TPU kernel multiplies them by 0), so a
    non-finite pad row cannot reach a real row.
    """
    Sp = q.shape[1]
    s_main = Sp - _TAIL
    dtype = q.dtype
    qa = _acc(q)
    lm = torch.einsum("bqhd,bkhd->bhqk", qa, _acc(k[:, :s_main])) * sm_scale
    lt = torch.einsum("bqhd,bkhd->bhqk", qa, _acc(k[:, s_main:])) * sm_scale
    lt = lt.masked_fill(torch.arange(_TAIL, device=q.device) >= s_real - s_main, NEG_INF)
    m = torch.maximum(lm.amax(dim=-1, keepdim=True), lt.amax(dim=-1, keepdim=True))
    pm, pt = torch.exp(lm - m), torch.exp(lt - m)
    denom = pm.sum(dim=-1, keepdim=True) + pt.sum(dim=-1, keepdim=True)
    pm, pt = (pm / denom).to(dtype), (pt / denom).to(dtype)
    main = torch.einsum("bhqk,bkhd->bhqd", _acc(pm), _acc(v[:, :s_main]))
    tail = torch.einsum("bhqk,bkhd->bhqd", _acc(pt[..., : s_real - s_main]), _acc(v[:, s_main:s_real]))
    return (main + tail).to(dtype).permute(0, 2, 1, 3)


def split_regime(S: int) -> bool:
    """True when the split-key kernel applies (S in (128k, 128k + 8], a
    non-empty aligned main block; the vision tower's 257)."""
    s_main = (S // 128) * 128
    return 0 < s_main < S <= s_main + _TAIL


def attention_route(S: int, heads: int, causal: bool, s_real: int | None = None) -> str:
    """Which core runs a layer: "padded", "split", "grouped" or "packed".

    The reference's choice (``image_search_tpu/models/clip.py::_attention``),
    read from the environment at each call: a sequence padded end to end
    (``s_real`` set, non-causal) takes B6's padded entry; ``ISX_ATTN_SPLIT=1``
    takes B6 for a non-causal S in :func:`split_regime`; a head group
    ``ISX_ATTN_PIPE`` (default 4; "" and "0" turn it off) that divides the
    head count takes B1; anything else takes B1p. The grouped kernel's bf16
    softmax (``ISX_ATTN_BF16SM=1``) is not ported and raises.
    """
    pipe_group = int(os.environ.get("ISX_ATTN_PIPE", "4") or 0)
    if s_real is not None and not causal:
        return "padded"
    if not causal and os.environ.get("ISX_ATTN_SPLIT") == "1" and split_regime(S):
        return "split"
    if pipe_group > 0 and heads % pipe_group == 0:
        if os.environ.get("ISX_ATTN_BF16SM") == "1":
            raise NotImplementedError(
                "ISX_ATTN_BF16SM=1: the grouped kernel's bf16 softmax is not ported; unset it"
            )
        return "grouped"
    return "packed"


def attention_bwd_reference(q, k, v, g, heads: int, causal: bool = False, sm_scale: float = 1.0):
    """Plain B5: (dq, dk, dv) of attention over the packed [B, S, H*Hd] layout
    from the output cotangent ``g``, each in q.dtype.

    The rounding points of ``_attn_bwd_kernel``: f32 logits, p32 = exp(l -
    max) / sum (a division), dv = bf16(p32)^T g, dp = g v^T, ds = p32 (dp -
    sum_k dp p32), dsb = (ds * sm_scale) in the input dtype, dq = dsb k and
    dk = dsb^T q, every product accumulated in f32.
    """
    B, S, DH = q.shape
    Hd = DH // heads
    dtype = q.dtype
    split = lambda t: t.reshape(B, S, heads, Hd)
    q4, k4, v4, g4 = split(q), split(k), split(v), split(g)
    p32 = torch.exp(_logits(q4, k4, causal, sm_scale))
    p32 = p32 / p32.sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bqhd->bkhd", _acc(p32.to(dtype)), _acc(g4))
    dp = torch.einsum("bqhd,bkhd->bhqk", _acc(g4), _acc(v4))
    ds = p32 * (dp - (dp * p32).sum(dim=-1, keepdim=True))
    dsb = _acc((ds * sm_scale).to(dtype))
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, _acc(k4))
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, _acc(q4))
    return tuple(t.to(dtype).reshape(B, S, DH) for t in (dq, dk, dv))


def _check_head_dim(what: str, D: int, heads: int, built) -> None:
    """Raises NotImplementedError, naming the head dim, where ``what`` is not
    built at D / heads: nothing below the wrapper may see it (the kernel
    would answer cudaErrorInvalidValue)."""
    if heads <= 0 or D % heads or D // heads not in built:
        Hd = D // heads if heads > 0 and D % heads == 0 else f"{D}/{heads}"
        raise NotImplementedError(
            f"{what}: head dim {Hd} not built (built: {built}); ROADMAP B.1 lists the head dims still to build"
        )


def _check_cuda_operands(heads, q, k, v, *more, built=FWD_HEAD_DIMS, what="attention kernel"):
    B, S, DH = q.shape
    for name, t in (("q", q), ("k", k), ("v", v), *(("g", t) for t in more)):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError(f"attention kernel: {name} must be bf16 on {q.device}, got {t.dtype} on {t.device}")
        if t.shape != q.shape:
            raise ValueError(f"attention kernel: {name} shape {tuple(t.shape)} != q {tuple(q.shape)}")
        if t.stride(2) != 1 or t.stride(0) != S * t.stride(1) or t.stride(1) % 8 or t.data_ptr() % 16:
            raise ValueError(
                f"attention kernel: {name} must be row-strided [B, S, H*Hd] with 16-byte aligned rows, "
                f"strides {t.stride()}"
            )
    _check_head_dim(what, DH, heads, built)
    if S > MAX_KEYS:
        raise NotImplementedError(
            f"attention kernel: S={S} > {MAX_KEYS}: a row's logits live in registers "
            f"(every sequence the towers run has at most 264 keys)"
        )


def _check_smem(device, smem: int, S: int) -> None:
    limit = getattr(torch.cuda.get_device_properties(device), "shared_memory_per_block_optin", 232448)
    if smem > limit:
        raise ValueError(f"attention kernel: S={S} needs {smem} B of shared memory > {limit}")


def _count(fn, Hd: int) -> None:
    """One launch of ``fn``'s kernel: ``fn.launches`` counts every head dim,
    ``fn.launches_by_hd[Hd]`` the launches at ``Hd``."""
    fn.launches += 1
    fn.launches_by_hd[Hd] = fn.launches_by_hd.get(Hd, 0) + 1


def fused_attention(q, k, v, heads: int, causal: bool = False, sm_scale: float = 1.0):
    """Attention over the packed layout [B, S, H*Hd] -> [B, S, H*Hd].

    ``q``, ``k`` and ``v`` may be row-strided views (for example column
    blocks of one fused qkv projection); the last dim must be contiguous.
    """
    B, S, DH = q.shape
    if q.device.type == "cpu":
        Hd = DH // heads
        out = attention_reference(
            q.reshape(B, S, heads, Hd), k.reshape(B, S, heads, Hd),
            v.reshape(B, S, heads, Hd), causal=causal, sm_scale=sm_scale,
        )
        return out.reshape(B, S, DH)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: no route for device {q.device}")
    _check_cuda_operands(heads, q, k, v)
    lib = _build.lib()
    Hd = DH // heads
    _check_smem(q.device, lib.isx_attention_smem_bytes(S, Hd), S)
    out = torch.empty((B, S, DH), dtype=q.dtype, device=q.device)
    rc = lib.isx_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, heads, Hd, q.stride(1), k.stride(1), v.stride(1), out.stride(1),
        int(causal), float(sm_scale), _build.stream_handle(q.device),
    )
    _build.check(rc, "attention kernel launch")
    _count(fused_attention, Hd)
    return out


fused_attention.launches = 0
fused_attention.launches_by_hd = {}


def _heads(t, heads: int):
    B, S, DH = t.shape
    return t.reshape(B, S, heads, DH // heads)


def _launch_normalized(q, k, v, heads: int, causal: bool, sm_scale: float, n_keys: int, s_main: int):
    """B1p's and B6's kernel (``isx_attention_fwd_normalized``): every row of
    q over keys [0, n_keys), PV summed over [0, s_main) and then the rest."""
    B, S, DH = q.shape
    _check_cuda_operands(heads, q, k, v)
    lib = _build.lib()
    Hd = DH // heads
    _check_smem(q.device, lib.isx_attention_smem_bytes(n_keys, Hd), S)
    out = torch.empty((B, S, DH), dtype=q.dtype, device=q.device)
    rc = lib.isx_attention_fwd_normalized(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, heads, Hd, q.stride(1), k.stride(1), v.stride(1), out.stride(1),
        n_keys, s_main, int(causal), float(sm_scale), _build.stream_handle(q.device),
    )
    _build.check(rc, "attention kernel launch")
    return out


def fused_attention_packed(q, k, v, heads: int, causal: bool = False, sm_scale: float = 1.0):
    """B1p: attention over the packed layout [B, S, H*Hd] with p normalised
    before the bf16 cast. Operands as for :func:`fused_attention`."""
    B, S, DH = q.shape
    if q.device.type == "cpu":
        out = attention_packed_reference(_heads(q, heads), _heads(k, heads), _heads(v, heads), causal, sm_scale)
        return out.reshape(B, S, DH)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_packed: no route for device {q.device}")
    out = _launch_normalized(q, k, v, heads, causal, sm_scale, S, S)
    _count(fused_attention_packed, DH // heads)
    return out


fused_attention_packed.launches = 0
fused_attention_packed.launches_by_hd = {}


def fused_attention_split(q, k, v, heads: int, sm_scale: float = 1.0):
    """B6 on unpadded operands [B, S, H*Hd], S in :func:`split_regime`
    (non-causal) -> [B, S, H*Hd].

    The reference pads q, k and v to Sp = s_main + 8 rows, runs the split
    kernel and slices the output back to S; the plain version does the same.
    The CUDA kernel takes the key limit and the split point as arguments, so
    it reads the S rows in place: the pad rows would only be skipped keys
    and discarded query rows, and no padded copies are made.
    """
    B, S, DH = q.shape
    if not split_regime(S):
        raise ValueError(
            f"S={S} not in the split kernel's regime (need s_main < S <= s_main+{_TAIL}, "
            f"s_main = (S//128)*128)"
        )
    s_main = (S // 128) * 128
    if q.device.type == "cpu":
        pad = lambda t: _heads(F.pad(t, (0, 0, 0, s_main + _TAIL - S)), heads)
        out = attention_split_reference(pad(q), pad(k), pad(v), S, sm_scale)
        return out[:, :S].reshape(B, S, DH)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_split: no route for device {q.device}")
    out = _launch_normalized(q, k, v, heads, False, sm_scale, S, s_main)
    _count(fused_attention_split, DH // heads)
    return out


fused_attention_split.launches = 0
fused_attention_split.launches_by_hd = {}


def fused_attention_split_padded(qp, kp, vp, heads: int, s_real: int, sm_scale: float = 1.0):
    """B6 on operands already padded to Sp = (s_real//128)*128 + 8 rows
    [B, Sp, H*Hd] (non-causal) -> [B, Sp, H*Hd]: keys >= s_real are masked
    by index, whatever their rows hold; output rows >= s_real are computed
    over the real keys and are never read by the towers."""
    B, Sp, DH = qp.shape
    if not (split_regime(s_real) and Sp == (s_real // 128) * 128 + _TAIL):
        raise ValueError(
            f"split kernel: Sp={Sp} with s_real={s_real} not in its regime "
            f"(need Sp == (s_real//128)*128 + {_TAIL} and s_real in split_regime)"
        )
    if qp.device.type == "cpu":
        out = attention_split_reference(_heads(qp, heads), _heads(kp, heads), _heads(vp, heads), s_real, sm_scale)
        return out.reshape(B, Sp, DH)
    if qp.device.type != "cuda":
        raise ValueError(f"fused_attention_split_padded: no route for device {qp.device}")
    out = _launch_normalized(qp, kp, vp, heads, False, sm_scale, s_real, Sp - _TAIL)
    _count(fused_attention_split_padded, DH // heads)
    return out


fused_attention_split_padded.launches = 0
fused_attention_split_padded.launches_by_hd = {}


def fused_attention_bwd(q, k, v, g, heads: int, causal: bool = False, sm_scale: float = 1.0):
    """(dq, dk, dv) of :func:`fused_attention` over the packed [B, S, H*Hd]
    layout, from the output cotangent ``g``; each a new contiguous tensor in
    q.dtype. Operands may be row-strided views, as for the forward."""
    B, S, DH = q.shape
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, g, heads, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_bwd: no route for device {q.device}")
    _check_cuda_operands(heads, q, k, v, g, built=BWD_HEAD_DIMS, what="attention backward kernel")
    lib = _build.lib()
    Hd = DH // heads
    _check_smem(q.device, lib.isx_attention_bwd_smem_bytes(S, Hd), S)
    dq, dk, dv = (torch.empty((B, S, DH), dtype=q.dtype, device=q.device) for _ in range(3))
    stats = torch.empty((3, B, heads, S), dtype=torch.float32, device=q.device)
    rc = lib.isx_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        B, S, heads, Hd, q.stride(1), k.stride(1), v.stride(1), g.stride(1),
        int(causal), float(sm_scale), _build.stream_handle(q.device),
    )
    _build.check(rc, "attention backward kernel launch")
    _count(fused_attention_bwd, Hd)
    return dq, dk, dv


fused_attention_bwd.launches = 0
fused_attention_bwd.launches_by_hd = {}


class AttentionCore(torch.autograd.Function):
    """Differentiable attention core over the packed layout: the forward of
    ``route`` (:func:`attention_route`: B1, B1p or B6), backward B5
    (:func:`fused_attention_bwd`) for every route that has one, as the
    reference's ``_grouped_bwd``, ``_core_bwd`` and ``_split_bwd`` all call
    ``_backward_packed``. Saves q, k and v for the backward. The padded
    route (``s_real`` set) has no VJP in the reference: it raises if a
    gradient is needed."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, causal: bool, sm_scale: float, route: str = "grouped", s_real=None):
        if route == "padded":
            if any(ctx.needs_input_grad[:3]):
                raise NotImplementedError(
                    "the padded vision path (ISX_VIT_SPAD) is inference only: its split kernel has no "
                    "gradient; unset ISX_VIT_SPAD to train"
                )
            return fused_attention_split_padded(q, k, v, heads, s_real, sm_scale)
        ctx.save_for_backward(q, k, v)
        ctx.args = (heads, causal, sm_scale)
        if route == "grouped":
            return fused_attention(q, k, v, heads, causal, sm_scale)
        if route == "packed":
            return fused_attention_packed(q, k, v, heads, causal, sm_scale)
        if route == "split" and not causal:
            return fused_attention_split(q, k, v, heads, sm_scale)
        raise ValueError(f"attention route {route!r} (causal={causal}) does not exist")

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*fused_attention_bwd(q, k, v, g.contiguous(), *ctx.args), None, None, None, None, None)


def _qkv_views(qkv):
    D = qkv.shape[-1] // 3
    return qkv[..., :D], qkv[..., D : 2 * D], qkv[..., 2 * D :]


def attention_qkv_packed_reference(qkv, heads: int, causal: bool = False, sm_scale: float = 1.0):
    """Plain B7: :func:`attention_packed_reference` on the three column views
    of qkv [B, S, 3*H*Hd] -> [B, S, H*Hd]."""
    B, S, D3 = qkv.shape
    q, k, v = (_heads(t, heads) for t in _qkv_views(qkv))
    return attention_packed_reference(q, k, v, causal, sm_scale).reshape(B, S, D3 // 3)


def fused_attention_qkv_packed(qkv, heads: int, causal: bool = False, sm_scale: float = 1.0):
    """B7: attention over the three column blocks [q | k | v] of one packed
    qkv [B, S, 3*H*Hd] -> [B, S, H*Hd], q unscaled: the f32 logits are
    multiplied by ``sm_scale``, p normalised in f32 before the cast (B1p's
    rounding). On the card, B1p's kernel on the three views (no copies)."""
    B, S, D3 = qkv.shape
    if D3 % 3:
        raise ValueError(f"fused_attention_qkv_packed: last dim {D3} is not 3 * D")
    if qkv.device.type == "cpu":
        return attention_qkv_packed_reference(qkv, heads, causal, sm_scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_attention_qkv_packed: no route for device {qkv.device}")
    out = _launch_normalized(*_qkv_views(qkv), heads, causal, sm_scale, S, S)
    _count(fused_attention_qkv_packed, D3 // 3 // heads)
    return out


fused_attention_qkv_packed.launches = 0
fused_attention_qkv_packed.launches_by_hd = {}


class AttentionQkvPackedCore(torch.autograd.Function):
    """Differentiable B7 (the reference's ``attention_qkv_packed_core``):
    the forward of :func:`fused_attention_qkv_packed`, the backward B5
    (:func:`fused_attention_bwd`) on the three column views at the same
    ``sm_scale``, concatenated on the last axis (``_packed_bwd``)."""

    @staticmethod
    def forward(ctx, qkv, heads: int, causal: bool = False, sm_scale: float = 1.0):
        ctx.save_for_backward(qkv)
        ctx.args = (heads, causal, sm_scale)
        return fused_attention_qkv_packed(qkv, heads, causal, sm_scale)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        grads = fused_attention_bwd(*_qkv_views(qkv), g.contiguous(), *ctx.args)
        return torch.cat(grads, dim=-1), None, None, None


def qkv_attention_reference(x, qkv_w, qkv_b, heads: int, causal: bool = False, sm_scale: float = 1.0):
    """Plain B8: x [B, S, D] (LN'd), qkv_w [3D, D] (``nn.Linear``'s layout),
    qkv_b [3D] -> [B, S, D]. qkv = (x @ qkv_w^T accumulated in f32) cast to
    x.dtype, then ``+ qkv_b`` in x.dtype; then B7's plain version."""
    qkv = torch.matmul(_acc(x), _acc(qkv_w).t()).to(x.dtype) + qkv_b.to(x.dtype)
    return attention_qkv_packed_reference(qkv, heads, causal, sm_scale)


def _check_qkv_operands(x, qkv_w, qkv_b, heads: int):
    B, S, D = x.shape
    for name, t, shape in (("x", x, (B, S, D)), ("qkv_w", qkv_w, (3 * D, D)), ("qkv_b", qkv_b, (3 * D,))):
        if t.device != x.device or t.dtype != torch.bfloat16:
            raise ValueError(f"qkv attention kernel: {name} must be bf16 on {x.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"qkv attention kernel: {name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"qkv attention kernel: {name} must be contiguous and 16-byte aligned")
    _check_head_dim("qkv attention kernel", D, heads, QKV_HEAD_DIMS)
    if S > MAX_KEYS:
        raise NotImplementedError(
            f"qkv attention kernel: S={S} > {MAX_KEYS}: a row's logits live in registers, as in B7"
        )
    lib = _build.lib()
    _check_smem(x.device, lib.isx_qkv_attention_smem_bytes(S), S)
    return lib


def fused_qkv_attention(x, qkv_w, qkv_b, heads: int, causal: bool = False, sm_scale: float = 1.0):
    """B8: the qkv projection and attention in one kernel, x [B, S, D] (LN'd),
    qkv_w [3D, D] (``nn.Linear``'s layout, the reference's ``[D, 3D]``
    transposed), qkv_b [3D] -> [B, S, D]; q unscaled, ``sm_scale`` on the
    f32 logits. On the card: bf16, head dim in ``QKV_HEAD_DIMS``,
    S <= ``MAX_KEYS``, contiguous operands; anything else raises."""
    B, S, D = x.shape
    if x.device.type == "cpu":
        return qkv_attention_reference(x, qkv_w, qkv_b, heads, causal, sm_scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention: no route for device {x.device}")
    lib = _check_qkv_operands(x, qkv_w, qkv_b, heads)
    out = torch.empty((B, S, D), dtype=x.dtype, device=x.device)
    rc = lib.isx_qkv_attention(
        x.data_ptr(), qkv_w.data_ptr(), qkv_b.data_ptr(), out.data_ptr(),
        B, S, heads, D // heads, int(causal), float(sm_scale), _build.stream_handle(x.device),
    )
    _build.check(rc, "qkv attention kernel launch")
    fused_qkv_attention.launches += 1
    return out


def qkv_attention_probe(x, qkv_w, qkv_b, heads: int):
    """B8's projection phase alone, on the card: the packed qkv [B, S, 3D]
    that :func:`fused_qkv_attention`'s attention phase reads, rounded as it
    rounds it. For the card tests (B8 against B7 on this qkv) and for
    timing the projection apart from the whole; no path calls it, and it
    counts no launch."""
    if x.device.type != "cuda":
        raise ValueError(f"qkv_attention_probe: runs on the card only, got {x.device}")
    lib = _check_qkv_operands(x, qkv_w, qkv_b, heads)
    B, S, D = x.shape
    qkv = torch.empty((B, S, 3 * D), dtype=x.dtype, device=x.device)
    rc = lib.isx_qkv_attention_probe(
        x.data_ptr(), qkv_w.data_ptr(), qkv_b.data_ptr(), qkv.data_ptr(),
        B, S, heads, D // heads, _build.stream_handle(x.device),
    )
    _build.check(rc, "qkv attention probe launch")
    return qkv


fused_qkv_attention.launches = 0
