#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It serves the full-width flash-attention TransformerLM through the port's
own entry points and holds every kernel against its plain version:

1. setup: the card's name and power limit; build every kernel from
   ``mxnet_tpu_torch/csrc`` (one nvcc per source, in parallel); launch the
   toolchain probe ``add_one``;
2. the flash-attention kernel against its plain version on the card, at the
   serving shape (B=4, H=16, T=1024, D=64) and at small shapes, in float32
   (1e-4) and bfloat16 (3e-2), and its time beside the plain version's and
   ``scaled_dot_product_attention``'s (the yardstick; the port never calls
   it);
3. scoring in float32: ``net(tokens)`` at B=4, T=1024 launches the kernel
   once per layer, and its logits agree with the same net's with dense
   attention;
4. serving in float32: four greedy ``generate`` requests (prompts of 16, 100,
   300 and 700 tokens, 8 new tokens each); every step is one forward through
   the kernel, and the tokens equal the dense net's except at a printed
   near-tie;
5. the main path, in bfloat16 (the configuration's dtype): every kernel
   count set to 0, then one scoring batch and the four requests, timed;
   the counts read after it;
6. one bfloat16 decode step under torch.profiler: host time, device time
   and the kernels that take it;
7. a ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

The model is ``experiments/lm_mfu_probe.py``'s default width (vocab 32768,
dim 1024, 16 heads, ffn 4096, 12 layers, max_len 1024; about 219 M
parameters) with random weights from seed 0.  Nothing is cut.

Float32 comparisons run with TF32 off for matrix products and cuDNN
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), so float32 means IEEE float32.

Any failed check ends the script with a non-zero exit and no result line.
Without a CUDA device, or outside a checkout, it exits non-zero at once.
"""
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = dict(vocab=32768, dim=1024, num_layers=12, num_heads=16,
              ffn_dim=4096, max_len=1024)
PROMPTS = (16, 100, 300, 700)
MAX_NEW = 8
SCORE_BATCH = 4
TOL_F32 = 1e-4      # kernel vs plain, float32 (the reference's flash pin)
TOL_BF16 = 3e-2     # kernel vs plain, bfloat16 (the reference's bf16 pin)
# flash vs dense logits through all 12 layers: the reference's logit pin
TOL_LOGITS_F32 = 1e-4
NEAR_TIE = 1e-4     # top-2 dense logits closer than this may flip argmax
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_BYTES = 3.35e12


class CheckFailed(Exception):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)


def time_ms(fn, iters=25, warmup=3):
    """Median of ``iters`` CUDA-event timings of ``fn`` (L2 warm)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def attention_bound_ms(B, H, T, D, causal, itemsize, flops_rate):
    """Least time for the work this input needs: the larger of its bytes
    (q, k, v read once, o written once) over the memory rate and its
    operations (4*D per unmasked (q, k) pair) over the peak rate."""
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = 4.0 * B * H * D * pairs
    nbytes = 4.0 * B * H * T * D * itemsize
    t_ops, t_bytes = flops / flops_rate * 1e3, nbytes / H100_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def phase_setup(mx):
    import torch
    from mxnet_tpu_torch.kernels import _build, add_one
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    log = _build.build(force=True)
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(log)} "
          f"(nvcc in parallel)")
    for name, entry in sorted(log.items()):
        usage = [ln.strip() for ln in entry["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"  {name}: {entry['seconds']:.2f} s; " + " | ".join(
            sorted(set(usage))))
    x = torch.arange(8 * 128, dtype=torch.float32, device="cuda").reshape(8, 128)
    out = add_one.add_one(x)
    torch.cuda.synchronize()
    check(torch.equal(out, x + 1), "add_one probe disagrees with x + 1")
    t_kernel = time_ms(lambda: add_one.add_one(x))
    t_plain = time_ms(lambda: x + 1)
    print(f"K0 add_one probe: built, launched, exact; (8, 128) f32 kernel "
          f"{t_kernel:.4f} ms, plain x + 1 {t_plain:.4f} ms (launch-bound: "
          f"8 KiB moved)")


def phase_kernel(mx):
    import torch
    from mxnet_tpu_torch.kernels import flash_attention as kfa
    gen = torch.Generator(device="cpu").manual_seed(0)

    def qkv(B, H, T, D, dtype):
        return [torch.randn(B, H, T, D, generator=gen).to("cuda", dtype)
                for _ in range(3)]

    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    main_err = None
    cases = [(4, 16, 1024, 64, None), (2, 3, 128, 16, 32), (2, 3, 128, 32, 32),
             (2, 3, 128, 128, 32), (1, 2, 100, 64, None)]
    for B, H, T, D, blk in cases:
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            for causal in (False, True):
                q, k, v = qkv(B, H, T, D, dtype)
                if blk is None:
                    out = kfa.flash_attention_fwd(q, k, v, D ** -0.5, causal)
                else:   # through the op, whose block only sets divisibility
                    out = mx.nd.flash_attention(q, k, v, causal=causal,
                                                block_q=blk, block_k=blk)
                ref = kfa.dense_reference(q, k, v, D ** -0.5, causal)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                check(out.shape == ref.shape and out.dtype == dtype
                      and bool(torch.isfinite(out).all()),
                      f"flash output malformed at {(B, H, T, D)} {dtype}")
                check(err <= tol, f"flash vs plain at B={B} H={H} T={T} D={D} "
                      f"{dtype} causal={causal}: max err {err:.3e} > {tol}")
                errs[dtype] = max(errs[dtype], err)
                if (B, T, dtype, causal) == (4, 1024, torch.bfloat16, True):
                    main_err = err
                print(f"  flash B={B} H={H} T={T} D={D} "
                      f"{str(dtype)[6:]} causal={causal}: max err {err:.3e}")
    timings = {}
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (True, False):
            q, k, v = qkv(4, 16, 1024, 64, dtype)
            t_kernel = time_ms(lambda: kfa.flash_attention_fwd(
                q, k, v, 0.125, causal))
            t_plain = time_ms(lambda: kfa.dense_reference(q, k, v, 0.125,
                                                          causal))
            t_sdpa = time_ms(lambda: torch.nn.functional.
                             scaled_dot_product_attention(
                                 q, k, v, is_causal=causal, scale=0.125))
            rate = H100_BF16_FLOPS if dtype == torch.bfloat16 \
                else H100_F32_FLOPS
            bound, bound_by = attention_bound_ms(
                4, 16, 1024, 64, causal, q.element_size(), rate)
            timings[(dtype, causal)] = (t_kernel, t_plain, t_sdpa, bound,
                                        bound_by)
            print(f"  time B=4 H=16 T=1024 D=64 {str(dtype)[6:]} "
                  f"causal={causal}: kernel {t_kernel:.4f} ms, plain "
                  f"{t_plain:.4f} ms, sdpa {t_sdpa:.4f} ms, bound "
                  f"{bound:.4f} ms ({bound_by})")
    return errs, main_err, timings


def build_nets(mx):
    """The flash net, seeded and initialized on gpu(0), and a dense-attention
    net that shares its parameters."""
    import numpy as np
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
    mx.random.seed(0)
    t0 = time.perf_counter()
    flash = TransformerLM(**CONFIG, attn_type="flash")
    flash.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2), ctx=mx.gpu(0))
    # the first forward resolves the deferred shapes (draws in forward order)
    flash(mx.nd.array(np.zeros((1, 8), np.float32), ctx=mx.gpu(0)))
    dense = TransformerLM(**CONFIG, attn_type="dense",
                          params=flash.collect_params())
    n = sum(p.data().numel() for p in flash.collect_params().values())
    print(f"model: {n} parameters, built in {time.perf_counter() - t0:.1f} s")
    return flash, dense


def forward_counted(net, L, *args, fn=None):
    """Run one forward (or ``fn``) and check it launched the kernel L times."""
    from mxnet_tpu_torch.kernels import flash_attention as kfa
    before = kfa.LAUNCHES
    out = (fn or net)(*args)
    check(kfa.LAUNCHES - before == L,
          f"{kfa.LAUNCHES - before} flash launches in one forward, want {L}")
    return out


def phase_score_f32(mx, flash, dense, tokens, L):
    import torch
    logits = forward_counted(flash, L, tokens)
    ref = forward_counted(dense, 0, tokens)
    torch.cuda.synchronize()
    check(logits.shape == (SCORE_BATCH, CONFIG["max_len"], CONFIG["vocab"])
          and bool(torch.isfinite(logits).all()), "scoring logits malformed")
    err = (logits - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"scoring f32: logits max |flash - dense| {err:.3e} "
          f"(max |logit| {scale:.3f})")
    check(err <= TOL_LOGITS_F32, f"flash vs dense logits differ by {err:.3e}")


def serve(mx, net, prompts, L):
    """Greedy requests through ``generate``; each step is one forward."""
    import torch
    outs, times = [], []
    for p in prompts:
        prompt = mx.nd.array(p[None, :], ctx=mx.gpu(0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward_counted(net, L * MAX_NEW, prompt, MAX_NEW,
                              fn=net.generate)
        outs.append(mx.nd.asnumpy(out)[0])
        times.append(time.perf_counter() - t0)
    return outs, times


def phase_serve_f32(mx, flash, dense, prompts, L):
    import numpy as np
    got, _ = serve(mx, flash, prompts, L)
    want, _ = serve(mx, dense, prompts, 0)
    steps = dense._decode_steps()
    for p, g, w in zip(prompts, got, want):
        t0 = len(p)
        check(g.shape == (t0 + MAX_NEW,), "generated tokens malformed")
        diff = np.nonzero(g != w)[0]
        if diff.size == 0:
            print(f"  request T0={t0}: tokens equal the dense net's")
            continue
        i = int(diff[0])
        check(i >= t0, "generate changed the prompt")
        buf = np.zeros((1, CONFIG["max_len"]), np.float32)
        buf[0, :i] = w[:i]
        last = mx.nd.asnumpy(steps["logits"](
            mx.nd.array(buf, ctx=mx.gpu(0)),
            mx.nd.array([i - 1.0], ctx=mx.gpu(0))))[0]
        top2 = np.sort(last)[-2:]
        gap = float(top2[1] - top2[0])
        print(f"  request T0={t0}: token {i} differs (flash {g[i]:.0f}, "
              f"dense {w[i]:.0f}); dense top-2 logit gap {gap:.3e}")
        check(gap <= NEAR_TIE, f"tokens differ at {i} without a near-tie")
        print(f"  near-tie accepted at request T0={t0} position {i}")
    print("serving f32: greedy tokens agree with the dense net")


def phase_main(mx, flash, tokens, prompts, L):
    """The main path in bfloat16, with every kernel count set to 0 first."""
    import torch
    from mxnet_tpu_torch import kernels
    flash.cast("bfloat16")
    forward_counted(flash, L, tokens)          # warm-up, outside the count
    serve(mx, flash, prompts[:1], L)
    torch.cuda.synchronize()
    for mod in kernels.ALL:
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    logits = flash(tokens)
    torch.cuda.synchronize()
    t_score = time.perf_counter() - t0
    check(logits.dtype == torch.bfloat16 and logits.shape ==
          (SCORE_BATCH, CONFIG["max_len"], CONFIG["vocab"])
          and bool(torch.isfinite(logits).all()), "bf16 logits malformed")
    outs, times = serve(mx, flash, prompts, L)
    counts = {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
              for mod in kernels.ALL}
    print(f"main path bf16: scoring B={SCORE_BATCH} T={CONFIG['max_len']} "
          f"{t_score * 1e3:.1f} ms ({SCORE_BATCH * CONFIG['max_len'] / t_score:.0f}"
          f" tokens/s)")
    for p, out, t in zip(prompts, outs, times):
        print(f"  request T0={len(p)}: {t * 1e3:.1f} ms for {MAX_NEW} tokens "
              f"({MAX_NEW / t:.1f} tokens/s); new tokens {out[len(p):].astype(int).tolist()}")
    print(f"  kernel launches on the main path: {counts}")
    want = L * (1 + len(prompts) * MAX_NEW)
    check(counts["flash_attention"] == want,
          f"flash_attention launched {counts['flash_attention']} times on "
          f"the main path, want {want}")
    return counts


def phase_profile(mx, flash, prompt):
    """Where one bf16 greedy decode step's time goes: the host clock around
    the step (median of 5, profiler off), the device time of the kernels
    torch.profiler sees in one step, and the kernels that take most of it."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    step = flash._decode_steps()["greedy"]
    buf = np.zeros((1, CONFIG["max_len"]), np.float32)
    buf[0, :len(prompt)] = prompt
    buf = mx.nd.array(buf, ctx=mx.gpu(0))
    pos = mx.nd.array([len(prompt) - 1.0], ctx=mx.gpu(0))
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(buf, pos)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls[1:])
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        step(buf, pos)
        torch.cuda.synchronize()
    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched
    rows = sorted(((a.self_device_time_total / 1e3, a.count, a.key)
                   for a in prof.key_averages()
                   if a.device_type != torch.autograd.DeviceType.CPU
                   and a.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"decode step bf16, T0={len(prompt)}: host clock {wall_ms:.3f} ms "
          f"(median of 5, profiler off), kernel time {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of the step)")
    if not rows:
        print("  the profiler reported no device time")
    for ms, count, key in rows[:8]:
        print(f"  {ms:8.3f} ms  x{count:<4d} {key[:90]}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "mxnet_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout of the repository "
              "(mxnet_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import mxnet_tpu_torch as mx
    # float32 means IEEE float32 in every comparison below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    L = CONFIG["num_layers"]
    try:
        print("== phase 1: setup")
        phase_setup(mx)
        print("== phase 2: flash kernel vs plain version")
        errs, main_err, timings = phase_kernel(mx)
        print("== phase 3: scoring, float32, flash vs dense")
        flash, dense = build_nets(mx)
        rs = np.random.RandomState(42)
        tokens = mx.nd.array(rs.randint(0, CONFIG["vocab"], (
            SCORE_BATCH, CONFIG["max_len"])).astype(np.float32), ctx=mx.gpu(0))
        prompts = [rs.randint(0, CONFIG["vocab"], n).astype(np.float32)
                   for n in PROMPTS]
        phase_score_f32(mx, flash, dense, tokens, L)
        print("== phase 4: serving, float32, flash vs dense")
        phase_serve_f32(mx, flash, dense, prompts, L)
        print("== phase 5: main path, bfloat16")
        counts = phase_main(mx, flash, tokens, prompts, L)
        print("== phase 6: where one decode step's time goes")
        phase_profile(mx, flash, prompts[-1])
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    t_kernel, t_plain, t_sdpa, bound, bound_by = timings[(torch.bfloat16, True)]
    kernels_line = {"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/flash_attention.py:179",
        "replaces_function": "mxnet_tpu/ops/flash_attention.py:_flash_attention",
        "launches": counts["flash_attention"],
        "shape": "B=4 H=16 T=1024 D=64 bf16 causal",
        "max_abs_err": main_err,
        "max_err_f32": errs[torch.float32],
        "max_err_bf16": errs[torch.bfloat16],
        "ms": t_kernel,
        "plain_ms": t_plain,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": t_sdpa,
    }]}
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
