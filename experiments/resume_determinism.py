#!/usr/bin/env python3
"""Why two identical training runs of the port differ on one CUDA card.

    python3 experiments/resume_determinism.py

Two readings, each under PyTorch's default algorithms and under its
deterministic ones (``torch.backends.cudnn.deterministic`` for the first,
``torch.use_deterministic_algorithms(True, warn_only=True)`` for the
second), from the same seeds:

* ``resnet18_v1`` in float32 (B=2, 64x64) through ``Module.fit``, as in
  ``chip_smoke.py`` phase 13, three times: the first batch and tensor at
  which two fits stop being bitwise equal (output, gradients, weights or
  moving statistics), the address of four bound tensors modulo 1024 in
  each fit, and how far the fits end apart (each parameter's largest
  |diff| over its largest change; the moving statistics absolute);
* the full-width TransformerLM of phase 9 (bf16, float32 masters,
  ``Trainer("adam")``), three steps in each of three runs: two
  deterministic, one default; how many of its tensors differ, and any
  warning the deterministic mode raised.

Exits non-zero without a CUDA device.
"""
import gc
import os
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch
    if not torch.cuda.is_available():
        print("resume_determinism: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"cudnn {torch.backends.cudnn.version()}, benchmark "
          f"{torch.backends.cudnn.benchmark}")
    cs.count_updates(mx)
    cs.phase_setup(mx)

    rs = np.random.RandomState(4)
    n = cs.GRAD_VISION_SHAPE[0] * cs.MODULE_CKPT_BATCHES
    xs = rs.normal(size=(n,) + cs.GRAD_VISION_SHAPE[1:]).astype(np.float32)
    ys = rs.randint(0, 1000, n).astype(np.float32)
    sym = cs.resnet_symbol(mx, "resnet18_v1")

    def fit(epochs):
        mx.random.seed(0)
        mod = mx.mod.Module(sym, context=mx.gpu(0))
        it = mx.io.NDArrayIter(mx.nd.array(xs, ctx=mx.gpu(0)),
                               mx.nd.array(ys, ctx=mx.gpu(0)),
                               batch_size=cs.GRAD_VISION_SHAPE[0])
        rec = []

        def after_batch(_):
            ex = mod._exec
            rec.append({
                "output": {"output": mod.get_outputs()[0].detach().clone()},
                "gradient": {k: v.detach().clone()
                             for k, v in ex.grad_dict.items()},
                "weight": {k: v.detach().clone()
                           for k, v in ex.arg_dict.items()},
                "statistic": {k: v.detach().clone()
                              for k, v in ex.aux_dict.items()},
                "address": {k: v.data_ptr() % 1024
                            for k, v in list(ex.arg_dict.items())[:4]}})

        mod.fit(it, num_epoch=epochs, batch_end_callback=after_batch,
                optimizer="sgd", optimizer_params={
                    "learning_rate": cs.MODULE_CKPT_LR, "momentum": 0.9,
                    "wd": 1e-4},
                initializer=mx.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
        return mod, rec

    def first_difference(r1, r2):
        for i, (a, b) in enumerate(zip(r1, r2)):
            for part in ("output", "gradient", "weight", "statistic"):
                bad = sorted(((a[part][k] - b[part][k]).abs().max().item(), k)
                             for k in a[part]
                             if not torch.equal(a[part][k], b[part][k]))
                if bad:
                    return (f"batch {i}, {part}s: {len(bad)} of "
                            f"{len(a[part])} differ, largest {bad[-3:][::-1]};"
                            f" addresses mod 1024 {a['address']} and "
                            f"{b['address']}")
        return f"bitwise equal over {len(r1)} batches"

    def apart(m1, m2, start):
        a1, x1 = m1.get_params()
        a2, x2 = m2.get_params()
        return (max(((a2[k] - a1[k]).abs().max()
                     / (a1[k] - start[k]).abs().max().clamp_min(1e-30)
                     ).item() for k in a1),
                max((x2[k] - x1[k]).abs().max().item() for k in x1))

    start = fit(0)[0].get_params()[0]
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        runs = [fit(cs.MODULE_CKPT_EPOCHS) for _ in range(3)]
        print(f"== Module.fit, resnet18_v1 f32, cudnn.deterministic={det}")
        for i, j in ((0, 1), (1, 2), (0, 2)):
            print(f"  fit {i + 1} against fit {j + 1}: "
                  f"{first_difference(runs[i][1], runs[j][1])}; apart "
                  f"(parameters, statistics) "
                  f"{apart(runs[i][0], runs[j][0], start)}")
        del runs
    torch.backends.cudnn.deterministic = False

    batches = cs.lm_batches(mx)[:3]
    params = {}
    for tag, det in (("A", True), ("B", True), ("C", False)):
        gc.collect()
        torch.cuda.empty_cache()
        _, step, trainer = cs.lm_train_setup(mx)
        losses = []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(det, warn_only=True)
            try:
                for x, y in batches:
                    with mx.autograd.record():
                        loss = step(x, y)
                    loss.backward()
                    trainer.step(cs.TRAIN_BATCH)
                    losses.append(loss.item())
            finally:
                torch.use_deterministic_algorithms(False)
        print(f"== LM run {tag}, deterministic {det}: losses {losses}; "
              f"warnings {sorted({str(w.message)[:160] for w in caught})}")
        params[tag] = (cs.lm_params(trainer), losses)
        del step, trainer
    for x, y in (("A", "B"), ("A", "C")):
        diffs = [(a.float() - b.float()).abs().max().item()
                 for a, b in zip(params[x][0], params[y][0])]
        print(f"  LM {x} against {y}: {sum(d > 0 for d in diffs)} of "
              f"{len(diffs)} tensors differ, max |diff| {max(diffs):.3e}; "
              f"losses equal {params[x][1] == params[y][1]}")
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"resume_determinism: {time.perf_counter() - t0:.1f} s")
    sys.exit(rc)
