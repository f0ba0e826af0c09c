"""Operation and byte counts against hand-worked values."""

import pytest

from bench_port import flops, model_config

L14 = model_config.model(model_config.load("clip-vit-l14"))
H14 = model_config.model(model_config.load("openclip-vit-h14"))


def _full(m):
    v = m["vision"]
    return flops.tower_full_ops(v["hidden_size"], v["mlp_size"], v["num_layers"], 257, False)


def test_vision_tower_counted_in_full():
    # 24 x (2 x 257 x (4 x 1024^2 + 2 x 1024 x 4096) + 4 x 257^2 x 1024)
    assert _full(L14) == pytest.approx(161.716e9, rel=1e-5)
    assert _full(H14) == pytest.approx(334.202e9, rel=1e-5)


def test_vision_ops_count_what_an_image_needs():
    d, m, t = 1024, 4096, 257
    last = 2 * t * 2 * d * d + 2 * (2 * d * d + 2 * d * m) + 4 * t * d
    want = 2 * 256 * 588 * d + 23 * (2 * t * (4 * d * d + 2 * d * m) + 4 * t * t * d) + last + 2 * d * 768
    assert flops.vision_ops(L14) == pytest.approx(want)
    assert 0.95 * _full(L14) < flops.vision_ops(L14) < _full(L14)


def test_text_ops_stop_at_eos():
    assert flops.text_ops(L14, 10) < flops.text_ops(L14, 77)
    d, m = 768, 3072
    one = 2 * 10 * (4 * d * d + 2 * d * m) + 4 * 55 * d
    assert flops.text_ops(L14, 10) == pytest.approx(11 * one + 2 * 10 * 2 * d * d + 2 * (2 * d * d + 2 * d * m)
                                                    + 4 * 10 * d + 2 * d * 768)


def test_corpus_bytes():
    assert 10_000_000 * 768 == 7.68e9
    assert flops.index_bytes(10_000_000, 768) == 7.72e9
    assert flops.index_bytes(10_000_000, 768) / flops.HBM_BYTES_PER_S == pytest.approx(2.3045e-3, rel=1e-3)


def test_bounds_take_the_binding_resource():
    assert flops.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert flops.bound_s(1.0, 989e12) == pytest.approx(1.0)
    # B2 at B=1 over 1M rows of 768: bytes bind (0.232 ms in PERF.md's kernel table)
    assert flops.b2_bound_s(1, 1_000_000, 768) * 1e3 == pytest.approx(0.2316, rel=1e-3)
    # B1 at the vision shape: 0.1006 ms, bytes (PERF.md); B5 0.0704 ms
    assert flops.attn_fwd_bound_s(160, 257, 16, 64, False) * 1e3 == pytest.approx(0.1006, rel=1e-3)
    assert flops.attn_bwd_bound_s(64, 257, 16, 64, False) * 1e3 == pytest.approx(0.0704, rel=1e-3)
