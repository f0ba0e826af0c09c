"""The query-by-photo cell at a tiny size on the CPU: its traffic, the port's
towers against the plain reference at a sequence past the short kernels'
320 keys, the driver end to end (the program passes its check, the control
and planted faults fail it) and its readers."""

import copy
import time

import pytest
import torch

from bench_port import gen_photo_query, harness, model_config, weights
from bench_port.drivers.common import Cell
from bench_port.reference.clip import Clip, f32_exact
from bench_port.tests import tiny

MIX = {
    "kind": "search_image",
    "corpus": {"rows": 20000, "block_rows": 8192, "rank": 8, "noise": 0.02},
    "pool": 6,
    "long_side": [120, 200],
    "portrait_share": 0.25,
    "grain": 4.0,
    "jpeg_quality": 85,
    "rate_per_s": 10,
    "burst": None,
    "new_share": 0.4,
    "marks": [1, 5],
    "mark_from_top": 20,
    "think_s": [0.3, 1.0],
    "warmup_s": 1.5,
    "check_requests": 16,
    # f32 on both sides here: the program reads ~4e-7 and 0, the control ~0.1 and 0.05-0.08
    "limits": {"score_gap": 0.001, "rank_gap": 0.001},
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cell(tmp_path, seconds=2.0, seed=2**31 + 21, trace=False):
    return Cell("tiny-photo", tiny.config(), dict(MIX), seed, seconds, trace, torch.device("cpu"), str(tmp_path),
                time.perf_counter())


def test_the_cell_is_declared_with_its_files():
    bench = harness.spec()
    w = harness.workload(bench, "dfn-h14-378-photo-query-2m")
    cfg, mix = model_config.load(w["config"]), harness.traffic(w["traffic"])
    assert harness.driver(mix["kind"]).run and mix["corpus"]["rows"] == 2_000_000
    m = model_config.model(cfg)
    assert (m["vision"]["image_size"] // m["vision"]["patch_size"]) ** 2 + 1 == 730
    assert m["vision"]["act"] == m["text"]["act"] == "quick_gelu"
    from image_search_tpu_torch.config import get_config

    model_config.check_against_preset(cfg, get_config(cfg["preset"]))


def test_schedule_is_reproducible_and_refinements_repost_their_photo():
    mix = dict(MIX, pool=64, rate_per_s=30, warmup_s=5)
    reqs = gen_photo_query.schedule(mix, 7, 40.0)
    assert reqs == gen_photo_query.schedule(mix, 7, 40.0) and reqs != gen_photo_query.schedule(mix, 8, 40.0)
    assert abs(sum(r["window"] for r in reqs) - 30 * 40) <= 1
    new = [r for r in reqs if r["kind"] == "new"]
    assert 0.3 < len(new) / len(reqs) < 0.5
    assert len({r["photo"] for r in new[:64]}) == 64  # every pool photo before any twice
    for r in reqs:
        if r["kind"] == "refine":
            prev = reqs[r["prev"]]
            assert prev["photo"] == r["photo"] and 0.3 <= r["at"] - prev["at"] <= 3.0
            assert 1 <= len(r["ranks"]) <= 5
    pick = gen_photo_query.check_sample(reqs, 7, 64)
    assert len(pick) == 64 and sum(1 for i in pick if reqs[i]["kind"] == "new") == 32
    assert min(len(reqs[i]["ranks"]) for i in pick if reqs[i]["kind"] == "refine") == 5


def test_pool_sizes_span_the_range_a_quarter_portrait():
    shapes = gen_photo_query.shapes(dict(MIX, pool=64, long_side=[1280, 2048]))
    assert len(set(shapes)) == 64 and sum(1 for h, w in shapes if h > w) == 16
    assert min(max(s) for s in shapes) == 1280 and max(max(s) for s in shapes) == 2048


def _long_config():
    """A tiny quick-GELU configuration whose vision sequence (18 x 18 + 1 =
    325 tokens) passes the short kernels' 320 keys and the text's 16."""
    cfg = copy.deepcopy(tiny.TINY_CONFIG)
    cfg["vision_config"].update(image_size=72, patch_size=4)
    return cfg


def test_port_towers_match_the_plain_reference_past_320_keys():
    """The port's towers (the long-key plain attention on the CPU) against
    ``reference/clip.py`` on the harness's weights, both in f32."""
    from image_search_tpu_torch.config import CLIPConfig, TextConfig, VisionConfig
    from image_search_tpu_torch.models.clip import CLIP, encode_image, encode_text

    m = model_config.model(_long_config())
    t, v = m["text"], m["vision"]
    cfg = CLIPConfig(
        name="tiny-long", projection_dim=m["projection_dim"],
        text=TextConfig(hidden_size=t["hidden_size"], num_layers=t["num_layers"], num_heads=t["num_heads"],
                        act=t["act"], vocab_size=t["vocab_size"], context_length=t["context_length"],
                        eos_token_id=t["eos_token_id"]),
        vision=VisionConfig(hidden_size=v["hidden_size"], num_layers=v["num_layers"], num_heads=v["num_heads"],
                            act=v["act"], image_size=v["image_size"], patch_size=v["patch_size"]))
    assert cfg.vision.seq_len == 325 > cfg.text.context_length
    state = weights.make(m, 2**31 + 5, "cpu", torch.float32)
    model = CLIP(cfg)
    model.load_state_dict(state, strict=True)
    g = torch.Generator().manual_seed(3)
    px = torch.randn(3, 72, 72, 3, generator=g)
    ids = torch.randint(0, 126, (3, 16), generator=g)
    ids[:, 9:] = t["eos_token_id"]
    ref = Clip(m, state)
    with torch.no_grad(), f32_exact():
        pairs = ((encode_image(model, px), ref.encode_image(px)), (encode_text(model, ids), ref.encode_text(ids)))
    for got, want in pairs:
        assert (got - want).norm() / want.norm() < 1e-4


def test_program_is_correct_and_the_control_is_not(tmp_path):
    out = harness.driver("search_image").control(_cell(tmp_path))
    assert out["program_correct"], out["program"]
    assert not out["control_correct"], out["control"]


def _planted(monkeypatch, fault):
    from image_search_tpu_torch.index import index as index_mod
    from image_search_tpu_torch.models import clip as clip_mod

    if fault == "dropped position":  # the last patch's pixels never reach the tower
        patchify = clip_mod.patchify

        def dropped(pixels, patch):
            x = patchify(pixels, patch).clone()
            x[:, -1] = 0
            return x

        monkeypatch.setattr(clip_mod, "patchify", dropped)
    elif fault == "gelu for quick-gelu":
        act = clip_mod._act
        monkeypatch.setattr(clip_mod, "_act", lambda x, kind: act(x, "gelu" if kind == "quick_gelu" else kind))
    else:  # a missing Rocchio mark: a refinement's last mark is dropped
        inner = index_mod.VectorIndex.search_with_feedback

        def one_less(self, emb, selected, k, approx=False):
            return inner(self, emb, selected[:-1] if len(selected) > 1 else selected, k, approx=approx)

        monkeypatch.setattr(index_mod.VectorIndex, "search_with_feedback", one_less)


@pytest.mark.parametrize("fault", ["dropped position", "gelu for quick-gelu", "missing rocchio mark"])
def test_planted_fault_fails_the_check(tmp_path, monkeypatch, fault):
    _planted(monkeypatch, fault)
    res = harness.driver("search_image").run(_cell(tmp_path))
    assert not res.correct, res.checks


def test_traced_run_feeds_every_reader(tmp_path):
    """A traced run on the CPU: the readers of the program's spans read a
    number; those of device time and of the long-key kernel read none (no
    card, no kernel past 320 keys at this size)."""
    res = harness.driver("search_image").run(_cell(tmp_path, trace=True))
    assert res.correct, res.checks
    ctx = res.context
    read = {name: harness.reader(name)(ctx) for name in
            ("photo.decode_ms", "photo.mfu_pct", "photo.tower_device_ms", "photo.attn_long_roofline",
             "search.p50_ms", "search.p95_ms")}
    assert read["photo.decode_ms"] > 0 and 0 < read["photo.mfu_pct"] < 100
    assert read["search.p50_ms"] <= read["search.p95_ms"]
    assert read["photo.attn_long_roofline"] is None and ctx["long_launches"] == 0
    assert ctx["after"]["counters"]["image_searches"] > ctx["before"]["counters"].get("image_searches", 0)


def test_long_roofline_reads_its_kernels_and_needs_a_launch():
    read = harness.reader("photo.attn_long_roofline")
    ctx = {"trace": {"by_kernel": {"void attn_fwd::attn_fwd_long_kernel<80, false>(...)": 2e-3,
                                   "void attn_fwd::attn_fwd_kernel<64, false, 5>(...)": 1.0}},
           "attn_calls": [(160, 730, 16, 80, False, False), (32, 77, 16, 64, True, False)], "long_launches": 1}
    from bench_port import flops

    assert read(ctx) == pytest.approx(100 * flops.attn_fwd_bound_s(160, 730, 16, 80, False) / 2e-3)
    assert read(dict(ctx, long_launches=0)) is None and read(dict(ctx, long_launches=None)) is None


def _uploads(in_flight, n=256, seconds=40.0):
    """``n`` uploads over ``seconds``, ``in_flight`` at a time back to back:
    the same work, each upload's spans longer the more are in flight."""
    wall = seconds * in_flight / n
    starts = [k * wall for k in range(n // in_flight) for _ in range(in_flight)]
    ns = lambda t: int(1e9 * t)
    rec = {"count": {"image_embed": n, "index_search": n},
           "host_s": {"image_embed": 0.8 * wall * n, "index_search": 0.2 * wall * n},
           "intervals": {"image_embed": [[ns(t), ns(t + 0.8 * wall)] for t in starts],
                         "index_search": [[ns(t + 0.8 * wall), ns(t + wall)] for t in starts]}}
    return {"spans": rec, "corpus_rows": 2_000_000,
            "model": model_config.model(model_config.load("dfn5b-clip-vit-h14-378"))}


def test_step_share_counts_overlapping_uploads_once():
    """One upload at a time, or 8 or 16 in flight with each twice or four
    times as long (the summed walls 8 and 16 times the window): the union of
    their spans is the window either way, and so is the share."""
    from bench_port import flops

    read = harness.reader("photo.mfu_pct")
    one, eight, sixteen = _uploads(1), _uploads(8), _uploads(16)
    m = one["model"]
    least = flops.vision_ops(m) / flops.BF16_FLOP_PER_S + flops.b2_bound_s(1, 2_000_000, m["projection_dim"])
    assert read(one) == pytest.approx(100 * 256 * least / 40.0)
    assert read(eight) == pytest.approx(read(one)) and read(sixteen) == pytest.approx(read(one))
