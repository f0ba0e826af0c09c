"""The traffic generators: deterministic per seed, the stated shares and
rates, the same amount of work on every seed."""

import collections

import pytest
import torch

from bench_port import gen_corpus, gen_photos, gen_search, harness

MIX = harness.traffic("search-10m")


def test_schedule_is_a_function_of_the_seed():
    a = gen_search.schedule(MIX, 2**31 + 5, 20)
    assert a == gen_search.schedule(MIX, 2**31 + 5, 20)
    assert a != gen_search.schedule(MIX, 2**31 + 6, 20)


def test_schedule_rate_and_shares():
    reqs = gen_search.schedule(MIX, 12345, 20)
    window = [r for r in reqs if r["window"]]
    assert len(window) == round(MIX["rate_per_s"] * 20)
    assert all(0 <= r["at"] < 20 for r in window)
    assert len(reqs) - len(window) == round(MIX["rate_per_s"] * MIX["warmup_s"])
    kinds = collections.Counter(r["kind"] for r in window)
    assert abs(kinds["new"] / len(window) - MIX["new_share"]) < 0.03
    for r in window:
        n = len(r["q"].split())
        assert MIX["words"][0] <= n <= MIX["words"][1]
        if r["kind"] == "refine":
            prev = reqs[r["prev"]]
            assert prev["q"] == r["q"] and MIX["think_s"][0] <= r["at"] - prev["at"] <= MIX["think_s"][1]
            assert MIX["marks"][0] <= len(r["ranks"]) <= MIX["marks"][1]
            assert all(0 <= j < MIX["mark_from_top"] for j in r["ranks"])
        else:
            assert r["prev"] == -1 and r["ranks"] == []


def test_every_seed_gets_the_same_arrivals_in_another_order():
    gaps = []
    for seed in (1, 2**31 + 99):
        t = [0.0] + [r["at"] for r in gen_search.schedule(MIX, seed, 20) if r["window"]]
        gaps.append(sorted(round(b - a, 9) for a, b in zip(t, t[1:])))
    assert len(gaps[0]) == len(gaps[1])
    assert sum(abs(a - b) for a, b in zip(*gaps)) / len(gaps[0]) < 1e-6


def test_bursts_raise_the_rate_inside_them():
    mix = dict(MIX, burst={"factor": 5, "period_s": 10, "length_s": 1})
    t = [r["at"] for r in gen_search.schedule(mix, 3, 20) if r["window"]]
    inside = sum(1 for x in t if x % 10 < 1)
    assert len(t) == round(MIX["rate_per_s"] * (18 + 2 * 5))
    assert abs(inside - 2 * 5 * MIX["rate_per_s"]) < 0.05 * inside


def test_check_sample_is_half_new_and_holds_the_longest_refinements():
    reqs = gen_search.schedule(MIX, 7, 20)
    pick = gen_search.check_sample(reqs, 7, 64)
    assert len(pick) == 64 and pick == gen_search.check_sample(reqs, 7, 64)
    assert sum(1 for i in pick if reqs[i]["kind"] == "new") == 32
    assert max(len(reqs[i]["ranks"]) for i in pick) == MIX["marks"][1]


def test_corpus_blocks_are_reproducible_alone():
    mix = gen_corpus.mix_matrix(torch, 5, 8, 32, "cpu")
    a = gen_corpus.block(torch, 5, 3, 100, mix, 0.02)
    assert torch.equal(a, gen_corpus.block(torch, 5, 3, 100, mix, 0.02))
    assert not torch.equal(a, gen_corpus.block(torch, 5, 4, 100, mix, 0.02))
    assert gen_corpus.row_of("media/" + gen_corpus.rel_path(1234567)) == 1234567
    with pytest.raises(ValueError):
        gen_corpus.row_of("media/other/1.jpg")


def test_photos_are_reproducible_and_a_quarter_portrait():
    a = gen_photos.pixels(torch, 9, 0, 60, 80, 4.0, "cpu")
    assert a.shape == (60, 80, 3) and (a == gen_photos.pixels(torch, 9, 0, 60, 80, 4.0, "cpu")).all()
    assert not (a == gen_photos.pixels(torch, 10, 0, 60, 80, 4.0, "cpu")).all()
    shapes = gen_photos.sizes(48, 4032, 3024, 0.25)
    assert sum(1 for h, w in shapes if h > w) == 12
    assert gen_photos.pool_index("/x/" + gen_photos.link_name(1234), 48) == 1234 % 48


def test_finetune_photos_are_one_set_on_every_seed(tmp_path):
    from bench_port.drivers import common, finetune
    from bench_port.tests import tiny

    def files(seed):
        cell = common.Cell("t", tiny.config(), tiny.FINETUNE_MIX, seed, 1.0, False, torch.device("cpu"),
                           str(tmp_path / str(seed)), 0.0)
        pairs = finetune.make_data(torch, cell, str(tmp_path / str(seed) / "photos"))
        return [open(p, "rb").read() for p, _ in pairs], [c for _, c in pairs]

    a, cap_a = files(2**31 + 11)
    b, cap_b = files(2**31 + 12)
    assert sorted(a) == sorted(b) and len(set(a)) == len(a)
    assert a != b and cap_a != cap_b  # the seed orders the photos and draws the captions
    assert files(2**31 + 11) == (a, cap_a)


def test_no_weight_leaf_is_drawn_constant():
    from bench_port import model_config, weights
    from bench_port.tests import tiny

    m = model_config.model(tiny.config())
    state = weights.make(m, 2**31 + 7, "cpu", torch.float32)
    for key, t in state.items():
        if key != "logit_scale":
            assert float(t.std()) > 0.005, key
    assert abs(float(state["vision.blocks.0.ln1.weight"].mean()) - 1) < 0.02
    assert abs(float(state["text.blocks.1.qkv.bias"].mean())) < 0.01
    assert torch.equal(state["text.blocks.1.qkv.bias"], weights.make(m, 2**31 + 7, "cpu", torch.float32)["text.blocks.1.qkv.bias"])
