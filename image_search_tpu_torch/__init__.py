"""image_search_tpu_torch -- the photo-search server on PyTorch and CUDA.

A port of ``image_search_tpu`` (JAX on a TPU, kept beside it as the
reference) to one NVIDIA Hopper card. It serves the same main path through
the same entry points and on-disk formats:

- photo in: uint8 -> ``ops.preprocess.fused_preprocess`` -> CLIP vision tower
  (``models.clip.encode_image``) -> ``index.index.VectorIndex``;
- query in: text -> tokenizer -> CLIP text tower -> int8 or f32 scores over
  the index -> exact top-k, with Rocchio feedback -> ``/search`` JSON.

Every Pallas kernel of that path is a CUDA kernel written for ``sm_90a``
(``csrc/``, built by ``_build``); beside each sits its plain PyTorch version,
which CPU tensors take. A CUDA tensor never falls back to the plain version.

Dtype policy (the reference's, ``image_search_tpu/models/clip.py:48-56``):
bf16 activations on the card; LayerNorm statistics, softmax and every
accumulation in f32; f32 matmuls in full f32 -- no TF32 anywhere
(:func:`check_precision`). The port imports torch and never jax.
"""

from __future__ import annotations


def check_precision() -> None:
    """Pin and verify full-f32 matmuls and convolutions.

    The preprocess resample (``ops/preprocess.py``) rounds to uint8 between
    its two passes, and TF32 would move values across that rounding; the f32
    index scan and the f32 reference forwards need full f32 too.
    """
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("TF32 matmuls are on; the port needs full f32 matmuls")
