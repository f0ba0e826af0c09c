"""The fine-tune CLI (``train/finetune.py``) on seeded captioned photos.

Set-up: the photos and their caption sidecars (the CLI's layout), a
random-init checkpoint of the harness's f32 weights for ``--seed`` (the
CLI's master weights), and the CLI's own
``main`` with its flags. The harness wraps ``make_train_step`` so that it
sees every step: the first three are the comparison's (each step's loss;
the first gradient, read from AdamW's first moment after step 1; the
parameters' change after step 3), then ``warm_steps`` more, then the
window, which opens at a step's start and closes at the first step start
``--seconds`` later: ``finetune_pairs_per_s`` is the pairs of the steps
between, over the time between (each step's input wait included, the
CLI's prefetch thread running). The run then stops the CLI by raising out
of its step.

The data set is one batch of pairs, drawn by the CLI in a new order every
step: the loss is the same function of any order, so the plain reference
trains on the files in their own order and needs nothing of the CLI's
sampling.
"""

from __future__ import annotations

import math
import os
import random
import statistics
import sys
import time

from bench_port import gen_photos, gen_search, harness, model_config, weights
from bench_port.drivers import common
from bench_port.drivers.scan import _AttnShapes
from bench_port.reference.train import leaf_norms, leaves
from bench_port.trace import Tracer

BETA1, BETA2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01  # the CLI's AdamW (train/contrastive.py::adamw)
CHECKED_STEPS = 3


class WindowClosed(Exception):
    """Raised out of the CLI's step when the window has closed."""


def make_data(torch, cell: common.Cell, directory: str) -> list:
    """The photos and captions -> [(photo path, caption)] in file order.

    The photos are one fixed set (sizes and pixels from a constant stream):
    decoding them is the step's input work, and pixels drawn from the seed
    made that work, and the rate, differ from seed to seed. The seed draws
    the captions, their pairing with the photos and the files' order."""
    mix, rng = cell.mix, random.Random(cell.seed)
    words = gen_search.vocabulary(mix["vocabulary"])
    n = mix["pairs"]
    longs = [mix["long_side"][0] + (mix["long_side"][1] - mix["long_side"][0]) * i // max(1, n - 1) for i in range(n)]
    shapes = [(long, long * 3 // 4) if i % 4 == 0 else (long * 3 // 4, long) for i, long in enumerate(longs)]
    order = list(range(n))
    rng.shuffle(order)
    paths = gen_photos.write_pool(torch, gen_search.FIXED, directory, [shapes[j] for j in order], mix["grain"],
                                  mix["jpeg_quality"], cell.device, content=order)
    lens = [mix["caption_words"][0] + i % (mix["caption_words"][1] - mix["caption_words"][0] + 1) for i in range(n)]
    rng.shuffle(lens)
    pairs = []
    for p, k in zip(paths, lens):
        caption = " ".join(rng.choice(words) for _ in range(k))
        with open(p[:-4] + ".txt", "w") as f:
            f.write(caption)
        pairs.append((p, caption))
    return pairs


class _Steps:
    """The CLI's train step, seen from outside: ``make_train_step`` swapped
    for one whose ``step_fn`` records the checked steps' readings, opens and
    closes the window, and raises ``WindowClosed`` at the close."""

    def __init__(self, torch, cell: common.Cell, p0: dict, tracer, shapes, keep_grads: bool = False):
        from image_search_tpu_torch.train import contrastive

        self.torch, self.cell, self.p0 = torch, cell, p0
        self.losses, self.grad_norms, self.step_norms = [], {}, {}
        self.keep_grads, self.first_grads = keep_grads, {}
        self.starts, self.t_open, self.t_close, self.n_open, self.n_close = [], None, None, None, None
        self._mod, make = contrastive, contrastive.make_train_step
        self._original = make
        warm = CHECKED_STEPS + cell.mix["warm_steps"]
        window = None

        def make_train_step(*a, **kw):
            init_fn, step_fn = make(*a, **kw)

            def wrapped(state, ids, pixels):
                nonlocal window
                n, now = len(self.starts), time.perf_counter()
                self.starts.append(now)
                if n == warm:
                    self.t_open, self.n_open = now, n
                    if shapes:
                        shapes.on = True
                    window = tracer.window()
                    window.__enter__()
                elif self.t_open is not None and now >= self.t_open + cell.seconds:
                    self.t_close, self.n_close = now, n
                    window.__exit__(None, None, None)
                    if shapes:
                        shapes.on = False
                    raise WindowClosed
                if n == warm - 1:
                    tracer.start()
                state, metrics = step_fn(state, ids, pixels)
                if n < CHECKED_STEPS:
                    self._read(n, state, metrics)
                return state, metrics

            return init_fn, wrapped

        contrastive.make_train_step = make_train_step

    def _read(self, n: int, state, metrics) -> None:
        torch = self.torch
        self.losses.append(float(metrics["loss"]))
        named = dict(state.model.named_parameters())
        if n == 0:  # AdamW's first moment after one step is (1 - beta1) x the gradient
            moments = {k: state.optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p)) for k, p in named.items()}
            self.grad_norms = leaf_norms(moments, 1 / (1 - BETA1))
            if self.keep_grads:
                self.first_grads = {k: (v.float() / (1 - BETA1)).cpu() for k, v in moments.items()}
        if n == CHECKED_STEPS - 1:
            self.step_norms = leaf_norms({k: p.detach().float() - self.p0[k].float() for k, p in named.items()})
            self.p0 = None

    def restore(self) -> None:
        self._mod.make_train_step = self._original


def _tokens(caption: str, context: int) -> int:
    return min(len(caption.split()), context - 2) + 2


def _measure(torch, cell: common.Cell, keep_grads: bool = False) -> dict:
    from image_search_tpu_torch.train import finetune

    common.quiet_program_logs()
    m, mix = cell.model, cell.mix
    data = os.path.join(cell.tmp, "photos")
    pairs = make_data(torch, cell, data)
    # f32 at full precision: weights on the bf16 grid would stay on it
    # through bf16 compute at lr 1e-5 (an update is ~8% of a bf16 step)
    state = weights.make(m, cell.seed, cell.device, torch.float32)
    ckpt = os.path.join(cell.tmp, "init.safetensors")
    weights.write_checkpoint(ckpt, m, state, model_config.checkpoint_config_json(cell.config))
    shapes = _AttnShapes(torch) if cell.trace else None
    tracer = Tracer(torch, cell.trace)
    steps = _Steps(torch, cell, state, tracer, shapes, keep_grads)
    del state
    argv = ["--data-dir", data, "--weights", ckpt, "--out", os.path.join(cell.tmp, "out.safetensors"),
            "--batch-size", str(mix["batch_size"]), "--lr", repr(mix["lr"]), "--steps", str(10**9), "--device", str(cell.device)]
    argv += list(cell.config["deployment"].get("finetune_flags", []))
    try:
        finetune.main(argv)
    except WindowClosed:
        pass
    finally:
        steps.restore()
        if shapes:
            shapes.restore()
    tracer.stop()
    if steps.t_close is None:
        raise RuntimeError(f"the CLI stopped before the window closed ({len(steps.starts)} steps)")
    peak = common.peak_bytes(torch, cell.device)
    common.free(torch, cell.device)
    n_steps = steps.n_close - steps.n_open
    span = steps.t_close - steps.t_open
    gaps = [b - a for a, b in zip(steps.starts[steps.n_open:], steps.starts[steps.n_open + 1 : steps.n_close + 1])]
    print(f"finetune: {n_steps} steps of {mix['batch_size']} in {span} s; step ms median "
          f"{statistics.median(gaps) * 1e3 if gaps else 0.0}; losses {steps.losses}", file=sys.stderr)
    return {"pairs": pairs, "losses": steps.losses, "grad_norms": steps.grad_norms, "step_norms": steps.step_norms,
            "n_steps": n_steps, "span": span, "setup_s": steps.t_open - cell.start, "summary": tracer.summary(),
            "peak": peak, "attn_calls": shapes.calls if shapes else [], "first_grads": steps.first_grads}


def run(cell: common.Cell) -> harness.Result:
    import torch

    out = _measure(torch, cell)
    checks, correct = _check(torch, cell, out)
    summary, m = out["summary"], cell.model
    pairs = out["n_steps"] * cell.mix["batch_size"]
    context = {"pairs": pairs, "window_s": out["span"], "trace": summary, "model": m,
               "attn_calls": out["attn_calls"],
               "text_tokens": [_tokens(c, m["text"]["context_length"]) for _, c in out["pairs"]]}
    return harness.Result(
        end_to_end={"finetune_pairs_per_s": pairs / out["span"], "setup_s": out["setup_s"]}, context=context,
        correct=correct, checks=checks, attempted=out["n_steps"], failed=0,
        device=harness.device_record(torch, cell.device, 1, out["peak"]) | (
            {"busy_s": summary["busy_s"], "window_s": summary["window_s"]} if summary else {}),
        breakdown=summary["breakdown"] if summary else None,
    )


def _reference(torch, cell: common.Cell, pairs: list, lowp: bool = False, first_grads=None) -> dict:
    from bench_port.reference import train as ref_train

    state = weights.make(cell.model, cell.seed, cell.device, torch.float32)  # the checkpoint's values
    return ref_train.steps(cell.model, state, pairs, CHECKED_STEPS, cell.mix["lr"], cell.device,
                           lowp="fp8" if lowp else None, first_grads=first_grads)


def _cosines(torch, got: dict, want: dict, kept) -> list:
    """Each kept leaf's cosine between two first gradients (f64), lowest
    first."""
    a, b = leaves(got), leaves(want)
    cos = lambda x, y: float(torch.nn.functional.cosine_similarity(x.double().flatten(), y.double().flatten(), dim=0))
    return sorted((cos(a[k], b[k]), k) for k in kept)


def numbers(got: dict, want: dict) -> dict:
    """The three numbers a run is held to, each a relative gap, the worst
    of its kind: each checked step's loss; each leaf's first gradient norm,
    against the larger of that leaf's and the median leaf's reference norm;
    each leaf's change over the checked steps, the same way, over the
    leaves whose reference gradient is at least a thousandth of the median
    leaf's (a gradient that is nought to rounding, as a key's bias under
    softmax, moves its leaf by round-off alone). Leaves are the published
    model's (``leaves``)."""
    if len(got["losses"]) != len(want["losses"]):
        loss = math.inf
    else:
        loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    med_g = statistics.median(want["grad_norms"].values())
    grad = max(abs(got["grad_norms"].get(k, math.inf) - v) / max(v, med_g) for k, v in want["grad_norms"].items())
    kept = [k for k, v in want["grad_norms"].items() if v >= 1e-3 * med_g]
    med_d = statistics.median(want["step_norms"][k] for k in kept)
    step = max(abs(got["step_norms"].get(k, math.inf) - want["step_norms"][k]) / max(want["step_norms"][k], med_d)
               for k in kept)
    return {"loss_gap": loss, "grad_gap": grad, "step_gap": step}


def steady_numbers(got: dict, want: dict) -> dict:
    """Steadier stand-ins, printed beside the numbers: the first step's
    loss, and the change of the median leaf."""
    med_g = statistics.median(want["grad_norms"].values())
    kept = [k for k, v in want["grad_norms"].items() if v >= 1e-3 * med_g]
    med_want = statistics.median(want["step_norms"][k] for k in kept)
    med_got = statistics.median(got["step_norms"].get(k, math.inf) for k in kept)
    return {"loss1_gap": abs(got["losses"][0] - want["losses"][0]) / abs(want["losses"][0]),
            "median_step_gap": abs(med_got - med_want) / med_want}


def _worst(got: dict, want: dict, keys, n: int = 3) -> list:
    med = statistics.median(want[k] for k in keys)
    gaps = sorted(((abs(got.get(k, math.inf) - want[k]) / max(want[k], med), k) for k in keys), reverse=True)
    return [(k, g, got.get(k), want[k]) for g, k in gaps[:n]]


def _check(torch, cell: common.Cell, out: dict, want=None):
    want = want or _reference(torch, cell, out["pairs"])
    limits = cell.mix["limits"]
    nums = numbers(out, want)
    med_g = statistics.median(want["grad_norms"].values())
    kept = [k for k, v in want["grad_norms"].items() if v >= 1e-3 * med_g]
    print(f"finetune: losses {out['losses']} (reference {want['losses']}; {steady_numbers(out, want)}); widest gradient gaps "
          f"{_worst(out['grad_norms'], want['grad_norms'], list(want['grad_norms']))}; widest change gaps "
          f"{_worst(out['step_norms'], want['step_norms'], kept)}; {len(want['grad_norms']) - len(kept)} leaves "
          f"left out of the change", file=sys.stderr)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def control(cell: common.Cell) -> dict:
    """One run of the cell, then the control in the program's place (the
    reference's three steps with every matmul's operands in fp8), and the
    fault of a step that leaves half of the batch out, planted in the
    reference put in the program's place (a state left unchanged reads 1
    by construction)."""
    import torch

    out = _measure(torch, cell, keep_grads=True)
    ref_grads: dict = {}
    want = _reference(torch, cell, out["pairs"], first_grads=ref_grads)
    med_g = statistics.median(want["grad_norms"].values())
    cos = _cosines(torch, out["first_grads"], ref_grads, [k for k, v in want["grad_norms"].items() if v >= 1e-3 * med_g])
    out["first_grads"] = ref_grads = None
    print(f"finetune: first gradient's cosine to the reference, leaf by leaf: median {statistics.median(c for c, _ in cos)}, "
          f"lowest {cos[:5]}", file=sys.stderr)
    checks, correct = _check(torch, cell, out, want)
    limits = cell.mix["limits"]
    low = _reference(torch, cell, out["pairs"], lowp=True)
    ctrl = {k: {"value": v, "limit": limits[k]} for k, v in numbers(low, want).items()}
    half = _reference(torch, cell, out["pairs"][: len(out["pairs"]) // 2])
    fault = {k: {"value": v, "limit": limits[k]} for k, v in numbers(half, want).items()}
    return {"program": checks, "program_correct": correct, "control": ctrl,
            "control_correct": all(c["value"] <= c["limit"] for c in ctrl.values()), "fault_half_batch": fault}
