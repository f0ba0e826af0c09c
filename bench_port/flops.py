"""Operations and bytes from shapes, the card's peaks, and roofline bounds.

``bound_s``, ``attn_fwd_bound_s`` and ``tower_full_ops`` are copies of
``chip_smoke.py``'s ``bound``, ``_attn_bound`` and ``tower_bound_ms``
arithmetic (seconds here, not milliseconds). Every bound counts each input
byte read once and each output byte written once, and the operations that
the inputs need, against the published peaks of one H100 SXM (NVIDIA's data
sheet, dense, at its 700 W limit).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12


def bound_s(nbytes: float, ops: float, peak: float = BF16_FLOP_PER_S) -> float:
    """The least seconds the card could take: bytes at the HBM rate against
    operations at ``peak``, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def _pairs(s: int, causal: bool) -> float:
    return s * (s + 1) / 2 if causal else s * s


def layer_ops(d: int, m: int, tokens: int, causal: bool) -> float:
    """One pre-LN block over ``tokens`` rows: the qkv, output and MLP
    matmuls and the attention's two products, 2 operations a multiply-add."""
    return 2 * tokens * (4 * d * d + 2 * d * m) + 4 * _pairs(tokens, causal) * d


def last_row_layer_ops(d: int, m: int, tokens: int) -> float:
    """A block whose output is read at one row only (the CLS or EOS row):
    k and v over every row, q, the output projection and the MLP at that
    row, its attention over ``tokens`` keys."""
    return 2 * tokens * 2 * d * d + 2 * (2 * d * d + 2 * d * m) + 4 * tokens * d


def tower_full_ops(d: int, m: int, layers: int, tokens: int, causal: bool) -> float:
    """Every layer counted in full (``chip_smoke.py::tower_bound_ms``): 161.7
    GFLOP an image for ViT-L/14, 334.2 for OpenCLIP H/14."""
    return layers * layer_ops(d, m, tokens, causal)


def vision_ops(cfg: dict) -> float:
    """What one image needs from the vision tower: the patch embedding, every
    layer but the last over all tokens, the last at the CLS row, and the
    projection."""
    v = cfg["vision"]
    d, m, L = v["hidden_size"], v["mlp_size"], v["num_layers"]
    grid = v["image_size"] // v["patch_size"]
    tokens = grid * grid + 1
    patch = 2 * grid * grid * (v["patch_size"] ** 2 * 3) * d
    return patch + (L - 1) * layer_ops(d, m, tokens, False) + last_row_layer_ops(d, m, tokens) + 2 * d * cfg["projection_dim"]


def text_ops(cfg: dict, tokens: int) -> float:
    """What one text needs from the text tower: its causal rows up to and
    including the first EOS (later rows cannot reach the pooled row), the
    last layer at the EOS row, and the projection."""
    t = cfg["text"]
    d, m, L = t["hidden_size"], t["mlp_size"], t["num_layers"]
    return (L - 1) * layer_ops(d, m, tokens, True) + last_row_layer_ops(d, m, tokens) + 2 * d * cfg["projection_dim"]


def tower_weight_bytes(tower: dict, bytes_per: int = 2) -> float:
    d, m, L = tower["hidden_size"], tower["mlp_size"], tower["num_layers"]
    return L * (4 * d * d + 2 * d * m) * bytes_per


def index_bytes(rows: int, dim: int) -> float:
    """int8 rows and their f32 scales, read once by a full scan."""
    return rows * (dim + 4)


def attn_fwd_bound_s(b: int, s: int, heads: int, hd: int, causal: bool) -> float:
    """Attention forward (B1 and its family): q, k and v read once and the
    output written once, in bf16."""
    d = heads * hd
    return bound_s(4 * b * s * d * 2, 4 * b * heads * _pairs(s, causal) * hd)


def attn_bwd_bound_s(b: int, s: int, heads: int, hd: int, causal: bool) -> float:
    """Attention backward (B5): q, k, v and the output's gradient read once,
    dq, dk and dv written once; five products a (query, key) pair."""
    d = heads * hd
    return bound_s(7 * b * s * d * 2, 5 * 2 * b * heads * _pairs(s, causal) * hd)


def b2_bound_s(b: int, rows: int, dim: int, penalty: bool = False) -> float:
    """B2 over ``rows`` live rows of a slab: int8 rows and f32 scales (and
    penalties) read once, the int8 queries and their scales read once, the
    f32 scores written once; 2 int8 operations a multiply-add."""
    nbytes = rows * (dim + 4 + (4 if penalty else 0)) + b * (dim + 4) + 4 * b * rows
    return bound_s(nbytes, 2 * b * rows * dim, INT8_OP_PER_S)
