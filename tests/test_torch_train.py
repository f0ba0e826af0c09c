"""The port's single-device training against the JAX package's, at
``tiny_test_config`` sizes on the CPU in f32.

Weights come from the reference's ``init_params`` and pass through
``params_from_jax`` / ``params_to_jax``; batches are made with numpy from a
seed. Tolerances: the loss at 1e-6, the first step's loss and gradients at
rtol 1e-4 and atol 1e-5, one AdamW update on given gradients at 1e-6.
"""

import dataclasses
import glob
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_search_tpu.config import tiny_test_config
from image_search_tpu.models import clip as jclip
from image_search_tpu.train import contrastive as jtrain
from image_search_tpu_torch.ingest.decode import write_bmp24
from image_search_tpu_torch.models.convert import build_model, params_from_jax, params_to_jax
from image_search_tpu_torch.tokenizer import HashTokenizer
from image_search_tpu_torch.train import contrastive, finetune
from image_search_tpu_torch.train.checkpoint import load_train_state, save_train_state


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    jparams = jax.tree.map(np.asarray, jclip.init_params(jax.random.key(0), cfg))
    return cfg, jparams, params_from_jax(jparams, cfg)


def make_batch(cfg, B, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.text.eos_token_id - 1, size=(B, cfg.text.context_length))
    ids[:, 0] = cfg.text.eos_token_id - 1
    ids[:, -1] = cfg.text.eos_token_id
    ids[1, 5:] = cfg.text.eos_token_id  # an earlier first EOS
    pix = rng.normal(size=(B, cfg.vision.image_size, cfg.vision.image_size, 3))
    return ids.astype(np.int32), pix.astype(np.float32)


def _model(cfg, state):
    return build_model(cfg, state, "cpu", torch.float32, trainable=True)


def _step(cfg, state, ids, pix, lr=1e-3, remat=False, remat_policy=""):
    init_fn, step_fn = contrastive.make_train_step(
        cfg, contrastive.adamw(lr), torch.float32, remat, "cpu", remat_policy=remat_policy
    )
    s = init_fn(_model(cfg, state))
    return step_fn(s, ids, pix)


def _grads(model):
    return {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("B", [4, 9])
def test_clip_loss_matches_reference(B):
    rng = np.random.default_rng(B)
    img, txt = (rng.normal(size=(B, 16)).astype(np.float32) for _ in range(2))
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt[0] = img[0]  # one exact match
    scale = np.float32(14.3)
    want, wm = jtrain.clip_loss(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(scale))
    got, gm = contrastive.clip_loss(torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(scale))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    assert float(gm["img_to_txt_acc"]) == float(wm["img_to_txt_acc"])


def test_first_step_loss_and_gradients_match_reference(setup):
    cfg, jparams, state = setup
    ids, pix = make_batch(cfg, 8)

    def loss_fn(p):
        img, txt, scale = jclip.forward(p, cfg, jnp.asarray(ids), jnp.asarray(pix), compute_dtype=jnp.float32)
        return jtrain.clip_loss(img, txt, scale)[0]

    # the loss the reference's make_train_step differentiates
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, jparams))

    s, m = _step(cfg, state, ids, pix)
    np.testing.assert_allclose(float(m["loss"]), float(want_loss), rtol=1e-4, atol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads), cfg)
    got = _grads(s.model)
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_adamw_update_matches_optax(setup):
    """One AdamW update on fixed given gradients, every parameter decayed
    (logit_scale and the LayerNorms too, as optax.adamw does)."""
    cfg, jparams, state = setup
    rng = np.random.default_rng(7)
    jgrads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.01).astype(np.float32), jparams)
    opt = optax.adamw(1e-3, weight_decay=0.01)

    @jax.jit
    def update(p, g):
        updates, _ = opt.update(g, opt.init(p), p)
        return optax.apply_updates(p, updates)

    new = update(jax.tree.map(jnp.asarray, jparams), jax.tree.map(jnp.asarray, jgrads))
    want = params_from_jax(jax.tree.map(np.asarray, new), cfg)

    model = _model(cfg, state)
    torch_opt = contrastive.adamw(1e-3)(model.parameters())
    given = params_from_jax(jgrads, cfg)
    for k, p in model.named_parameters():
        p.grad = given[k].clone()
    torch_opt.step()
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("policy", ["", "dots_with_no_batch_dims_saveable"])
def test_remat_step_matches_plain(setup, policy):
    """Recompute changes what is kept for the backward, not the math; the
    remat path runs the full last blocks instead of the CLS/EOS-only ones.
    Gradients, not parameters after AdamW: its first update is about
    lr * sign(g), which turns round-off in near-zero gradients (the k bias)
    into full-lr differences."""
    cfg, _, state = setup
    ids, pix = make_batch(cfg, 8, seed=3)
    plain, mp = _step(cfg, state, ids, pix)
    remat, mr = _step(cfg, state, ids, pix, remat=True, remat_policy=policy)
    assert abs(float(mp["loss"]) - float(mr["loss"])) < 1e-6
    gp, gr = _grads(plain.model), _grads(remat.model)
    for k in gp:
        np.testing.assert_allclose(gr[k].numpy(), gp[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_unknown_remat_policy_raises(setup):
    with pytest.raises(ValueError, match="remat policy"):
        contrastive.make_train_step(setup[0], contrastive.adamw(1e-3), remat=True, device="cpu", remat_policy="nope")


def test_train_state_resume_equals_uninterrupted(setup, tmp_path):
    """Save after step 2 and resume in a fresh state: steps 3-4 give the same
    parameters and moments as a run that never stopped."""
    cfg, _, state = setup
    ids, pix = make_batch(cfg, 8, seed=4)
    init_fn, step_fn = contrastive.make_train_step(cfg, contrastive.adamw(1e-3), torch.float32, False, "cpu")
    a = init_fn(_model(cfg, state))
    for i in range(4):
        a, _ = step_fn(a, ids, pix)
        if i == 1:
            save_train_state(str(tmp_path / "ckpt"), a)
            save_train_state(str(tmp_path / "ckpt"), a)  # a second save swaps the directory
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]
    assert load_train_state(str(tmp_path / "missing"), init_fn(_model(cfg, state))) is None
    b = load_train_state(str(tmp_path / "ckpt"), init_fn(_model(cfg, state)))
    assert b.step == 2
    for _ in range(2):
        b, _ = step_fn(b, ids, pix)
    assert b.step == a.step == 4
    for (k, x), y in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(x, y), k
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    for i in sa:
        assert all(torch.equal(sa[i][n], sb[i][n]) for n in ("exp_avg", "exp_avg_sq", "step"))


def _pairs(root, n, size=(36, 36), seed=0):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        write_bmp24(str(root / f"im{i}.bmp"), rng.integers(0, 256, size=(*size, 3), dtype=np.uint8))
        (root / f"im{i}.txt").write_text(f"caption number {i % 4}")
    return str(root)


def test_run_finetune_end_to_end_and_resume(setup, tmp_path):
    """Sidecar dataset -> decode -> preprocess -> train -> train state; a
    second run from the same checkpoint directory continues at the saved
    step."""
    cfg, _, state = setup
    pairs = finetune.find_pairs(_pairs(tmp_path / "data", 8))
    assert len(pairs) == 8
    tok = HashTokenizer(cfg.text.vocab_size, cfg.text.context_length)
    ckpt = str(tmp_path / "ckpt")
    model, losses = finetune.run_finetune(
        _model(cfg, state), cfg, tok, pairs, batch_size=8, steps=3, learning_rate=1e-3,
        log_every=100, checkpoint_dir=ckpt, device="cpu",
    )
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert next(model.parameters()).dtype == torch.float32
    _, more = finetune.run_finetune(
        _model(cfg, state), cfg, tok, pairs, batch_size=8, steps=5, learning_rate=1e-3,
        log_every=100, checkpoint_dir=ckpt, device="cpu",
    )
    assert len(more) == 2


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_read_by_the_other_package(setup, tmp_path, writer):
    from image_search_tpu.models.convert import load_checkpoint as jload, save_checkpoint as jsave
    from image_search_tpu_torch.models.convert import load_checkpoint, save_checkpoint

    cfg, jparams, state = setup
    path = str(tmp_path / "ck.safetensors")
    if writer == "port":
        save_checkpoint(path, params_to_jax(_model(cfg, state)), cfg)
        got, got_cfg = jload(path)
    else:
        jsave(path, jparams, cfg)
        got, got_cfg = load_checkpoint(path)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(cfg)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    for key, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        np.testing.assert_array_equal(np.asarray(flat_got[key]), leaf)
    assert len(flat_got) == len(jax.tree.leaves(jparams))


def test_retrieval_metrics_match_reference():
    from image_search_tpu.utils.eval import retrieval_metrics as jmetrics
    from image_search_tpu_torch.utils.eval import retrieval_metrics

    rng = np.random.default_rng(0)
    img = rng.normal(size=(30, 16)).astype(np.float32)
    for txt in (img + 0.5 * rng.normal(size=img.shape).astype(np.float32), np.tile(img[:1], (30, 1))):
        assert retrieval_metrics(img, txt, (1, 3, 10)) == jmetrics(img, txt, (1, 3, 10))


def test_evaluate_pairs_matches_reference(setup, tmp_path):
    """Sizes whose resample is exact (a side at the 28 px input) keep both
    preprocesses equal, so the ranks agree; an undecodable file is skipped."""
    from image_search_tpu.models.embedder import ClipEmbedder as JaxEmbedder
    from image_search_tpu.train.eval import evaluate_pairs as jevaluate
    from image_search_tpu_torch.models.embedder import ClipEmbedder
    from image_search_tpu_torch.train.eval import evaluate_pairs

    cfg, jparams, state = setup
    rng = np.random.default_rng(2)
    pairs = []
    for i, (h, w) in enumerate([(28, 28), (28, 64), (90, 28), (28, 29), (28, 40), (50, 28)]):
        p = str(tmp_path / f"im{i}.bmp")
        write_bmp24(p, rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8))
        pairs.append((p, f"caption number {i}"))
    bad = str(tmp_path / "bad.bmp")
    open(bad, "wb").write(b"not an image")
    pairs.insert(2, (bad, "broken"))
    tok = HashTokenizer(cfg.text.vocab_size, cfg.text.context_length, eos_id=cfg.text.eos_token_id)
    model = build_model(cfg, state, "cpu", torch.float32)
    got, n = evaluate_pairs(ClipEmbedder(model, tokenizer=tok), pairs, ks=(1, 3), batch_size=4)
    want, n_ref = jevaluate(JaxEmbedder(jax.tree.map(jnp.asarray, jparams), cfg, tokenizer=tok), pairs, ks=(1, 3), batch_size=4)
    assert n == n_ref == 6
    assert got == want


def test_finetune_cli_with_eval_dir(setup, tmp_path, caplog):
    """finetune.main on the CPU: retrieval measured before and after, the
    output checkpoint written in the reference's format with new weights;
    with --thumb-cache the photos it decoded leave tiles behind."""
    from image_search_tpu.models.convert import load_checkpoint as jload, save_checkpoint as jsave

    cfg, jparams, _ = setup
    ckpt = str(tmp_path / "in.safetensors")
    jsave(ckpt, jparams, cfg)
    out = str(tmp_path / "out.safetensors")
    with caplog.at_level(logging.INFO):
        finetune.main([
            "--data-dir", _pairs(tmp_path / "data", 8), "--weights", ckpt, "--out", out,
            "--batch-size", "8", "--steps", "2", "--lr", "1e-3",
            "--eval-dir", _pairs(tmp_path / "eval", 4, seed=1), "--device", "cpu",
            "--thumb-cache", str(tmp_path / "thumbs"),
        ])
    assert "retrieval BEFORE" in caplog.text and "retrieval AFTER" in caplog.text
    assert len(glob.glob(str(tmp_path / "thumbs" / "*" / "*.jpg"))) >= 8
    trained, cfg2 = jload(out)
    assert cfg2 == cfg
    assert not np.array_equal(np.asarray(trained["vision"]["blocks"]["qkv_w"]), jparams["vision"]["blocks"]["qkv_w"])


@pytest.mark.parametrize("what", ["--fsdp", "--mesh-model", "--mesh-data", "siglip", "mesh"])
def test_unported_paths_raise(setup, tmp_path, what):
    cfg = setup[0]
    if what == "siglip":
        from image_search_tpu_torch.config import get_config

        with pytest.raises(NotImplementedError, match="SigLIP"):
            contrastive.make_train_step(get_config("siglip-base-patch16-224"), contrastive.adamw(1e-3), device="cpu")
        return
    if what == "mesh":
        with pytest.raises(NotImplementedError, match="mesh"):
            contrastive.make_train_step(cfg, contrastive.adamw(1e-3), device="cpu", fsdp=True)
        return
    flag = {"--fsdp": ["--fsdp"], "--mesh-model": ["--mesh-model", "2"], "--mesh-data": ["--mesh-data", "4"]}[what]
    with pytest.raises(NotImplementedError, match=what):
        finetune.main(["--data-dir", str(tmp_path), "--weights", "x", "--out", "y", "--device", "cpu", *flag])


def test_batch_prefetcher_builds_the_next_batch_during_the_step():
    import threading
    import time

    events, lock = [], threading.Lock()

    def make_batch():
        with lock:
            events.append("build")
        time.sleep(0.05)
        return len(events)

    pf = finetune.BatchPrefetcher(make_batch)
    try:
        assert pf.next() == 1
        time.sleep(0.1)  # the "step": batch 2 is built meanwhile
        t0 = time.monotonic()
        assert pf.next() == 2
        assert time.monotonic() - t0 < 0.03
    finally:
        pf.close()
