"""Each kind of cell driven end to end on the CPU at a tiny size, the card's
check skipped: the program's answers pass the comparison, the control (the
reference one precision step down) fails it, and so does the program with
its timed path broken underneath, once for each fault the cell can have."""

import time

import pytest
import torch

from bench_port import harness
from bench_port.drivers.common import Cell
from bench_port.tests import tiny


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cell(tmp_path, kind, seconds=2.0, seed=2**31 + 11):
    mixes = {"search": (tiny.SEARCH_MIX, tiny.config()), "scan": (tiny.SCAN_MIX, tiny.config(chunk=40)),
             "finetune": (tiny.FINETUNE_MIX, tiny.config())}
    mix, cfg = mixes[kind]
    return Cell(f"tiny-{kind}", cfg, dict(mix), seed, seconds, False, torch.device("cpu"), str(tmp_path),
                time.perf_counter())


@pytest.mark.parametrize("kind", ["search", "scan", "finetune"])
def test_program_is_correct_and_the_control_is_not(tmp_path, kind):
    out = harness.driver(kind).control(_cell(tmp_path, kind))
    assert out["program_correct"], out["program"]
    assert not out["control_correct"], out["control"]


def _run(tmp_path, kind):
    return harness.driver(kind).run(_cell(tmp_path, kind))


def test_search_answer_altered_where_produced(tmp_path, monkeypatch):
    from image_search_tpu_torch.index import index as index_mod

    topk = index_mod.exact_topk

    def shifted(scores, k):
        v, i = topk(scores, k)
        return v, (i + 1) % scores.shape[1]  # every answer names its neighbour's row

    monkeypatch.setattr(index_mod, "exact_topk", shifted)
    res = _run(tmp_path, "search")
    assert not res.correct, res.checks


def test_scan_answer_altered_where_produced(tmp_path, monkeypatch):
    from image_search_tpu_torch.models import embedder

    enc = embedder.encode_image
    monkeypatch.setattr(embedder, "encode_image", lambda model, px: enc(model, px).roll(1, dims=0))
    res = _run(tmp_path, "scan")
    assert not res.correct, res.checks


def test_finetune_step_that_leaves_the_state_unchanged(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    res = _run(tmp_path, "finetune")
    assert not res.correct, res.checks


def test_finetune_half_the_batch_left_out(tmp_path, monkeypatch):
    from image_search_tpu_torch.train import contrastive

    loss = contrastive.clip_loss

    def half(img, txt, scale):
        n = img.shape[0] // 2
        return loss(img[:n], txt[:n], scale)

    monkeypatch.setattr(contrastive, "clip_loss", half)
    res = _run(tmp_path, "finetune")
    assert not res.correct, res.checks


def test_finetune_answer_altered_where_produced(tmp_path, monkeypatch):
    from image_search_tpu_torch.train import contrastive

    loss = contrastive.clip_loss

    def altered(img, txt, scale):
        value, metrics = loss(img, txt, scale)
        return value * 1.01, dict(metrics, loss=value * 1.01)

    monkeypatch.setattr(contrastive, "clip_loss", altered)
    res = _run(tmp_path, "finetune")
    assert not res.correct, res.checks
