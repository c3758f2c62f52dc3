#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It serves the full-width flash-attention TransformerLM through the port's
own entry points and holds every kernel against its plain version:

1. setup: the card's name and power limit; build every kernel from
   ``mxnet_tpu_torch/csrc`` (one nvcc per source, in parallel); launch the
   toolchain probe ``add_one`` and time it beside ``x + 1``;
2. the flash-attention kernels against their plain version on the card:
   the bf16 tensor-core kernel (``sm90``) at the scoring shape (B=4, H=16,
   T=1024, D=64), the decode shape (B=1), D=128 at T=128 and a ragged
   T=100, the float32 kernel (``f32``) at the same shapes in float32 and at
   D 16 and 32 in bfloat16 (gates ``TOL_*`` below: float32 absolute,
   bfloat16 absolute and over the largest output); both kernels causal at
   the short sequences the serving buckets send them (B=4, T 1, 2, 16 and
   64), the sm90 kernel timed there; then their times at
   the scoring and decode shapes beside the plain version's, the bound and
   ``scaled_dot_product_attention``'s (the yardstick; the port never calls
   it), with the f32 kernel timed on the same bf16 inputs as well;
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
6. one bfloat16 decode step under torch.profiler: host time through the
   step's ``CachedOp`` and eagerly, device time, the flash kernel's share
   and the kernels that take it (without a device trace: the CUDA-event
   stream time of the step's 12 flash launches);
7. the KV-cache decode path (``generate(kv_cache=True)``, ``beam_search``,
   ``save_params``/``load_params``) on a fresh float32 net with the same
   weights: the four greedy requests give phase 4's static-shape tokens
   (a difference only at a printed near-tie), one sampled request gives
   the static path's tokens under the same seeded RandomState, a beam of
   width 1 gives the greedy tokens and one of width 4 returns log-probs
   within ``TOL_BEAM`` of a teacher-forced rescoring, and a net loaded
   from a saved checkpoint decodes the same tokens; then in bfloat16 the
   four requests, timed per request and per decode step beside phase 5's
   static-shape times, and the cost of the out-of-place cache write.  The
   KV path runs no flash kernel: its attention is plain torch, as in the
   JAX package;
8. serving through the Symbol graph on a fresh float32 net with the same
   weights: the net traced to a Symbol, its JSON written and loaded back,
   its parameters saved with ``nd.save``; a ``BucketedPredictor`` on
   ``gpu(0)`` from the JSON and the file, warmed over its 33 buckets (3
   batch x 11 sequence, 12 flash launches each), the four prompts served
   against eager ``net(tokens)`` with no bucket built; then the main
   serving path in bfloat16 (re-traced after ``cast``): every kernel count
   set to 0, 32 requests from 4 client threads through a ``MicroBatcher``,
   the counts read after it (12 sm90 launches per batch, none on f32);
   each coalesced result bitwise against its row of the same batch
   dispatched again, and against the same request served alone (bitwise
   where both ran one bucket, else within ``TOL_COALESCED_BF16``); the
   dispatch and host-copy time per bucket; and a ``ResilientServer`` that
   sheds a burst with ``Overloaded`` and fails a request past its deadline
   with ``DeadlineExceeded``;
9. a ``kernels`` JSON line (its ``launches`` are phase 8's), then the last
   line ``{"ok": true, "device": {...}}``.

The model is ``experiments/lm_mfu_probe.py``'s default width (vocab 32768,
dim 1024, 16 heads, ffn 4096, 12 layers, max_len 1024; about 219 M
parameters) with random weights from seed 0.  Nothing is cut.

Times: ``device`` is the CUDA-event time of 20 back-to-back calls queued
behind a spin kernel, per call (L2 warm): the kernels and the gaps between
them, without the host's enqueue.  ``call`` is the median of 25 CUDA-event
pairs around single calls, which on an idle card includes the host's
enqueue.  Both are printed; the ``kernels`` line's ``ms``, ``plain_ms`` and
``library_ms`` are device times.  torch.profiler serves only phase 6's
breakdown: it needs CUPTI's tracing, which a machine may deny or drop.

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
SHORT_T = (1, 2, 16, 64)   # phase 2's short sequences (serving buckets)
MAX_NEW = 8
SCORE_BATCH = 4
TOL_F32 = 1e-4      # kernel vs plain, float32 (the reference's flash pin)
TOL_BF16 = 3e-2     # kernel vs plain, bfloat16 (the reference's bf16 pin)
# bfloat16 kernel vs plain, max |out - ref| over max |ref|.  The absolute pin
# was set for outputs of order 1; at T=1024 the non-causal outputs are
# about 0.05.  Two roundings to bf16 of the same value differ by at most
# one ulp, 2^-7 of it, so this allows two ulps of the largest output.
TOL_BF16_REL = 2.0 ** -6
# flash vs dense logits through all 12 layers: the reference's logit pin
TOL_LOGITS_F32 = 1e-4
# a coalesced bf16 request against the same request served alone at
# another bucket, max |diff| over its valid logits.  The batch's other
# shape changes the GEMMs' accumulation order in all 12 layers, and the
# logits (up to about 7.8 here) are rounded to bf16, whose ulp is 2^-5 in
# [4, 8): the H100 read up to 3 ulps (9.4e-2, PERF.md), this allows 4.
# Another request's rows or padding leaking in move logits by their scale.
TOL_COALESCED_BF16 = 0.125
NEAR_TIE = 1e-4     # top-2 dense logits closer than this may flip argmax
TOL_BEAM = 1e-3     # beam log-prob vs a teacher-forced rescoring, float32
BEAM_PROMPT = 100   # the prompt of the sampled, beam and checkpoint checks
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_BYTES = 3.35e12


class CheckFailed(Exception):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)


def time_ms(fn, iters=25, warmup=3):
    """Call time: median of ``iters`` CUDA-event pairs around single calls
    of ``fn`` (L2 warm).  On an idle card the pair also brackets the host's
    enqueue, so a short kernel reads as its launch cost."""
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


def device_ms(fn, iters=20):
    """Device time: a CUDA-event pair around ``iters`` back-to-back calls of
    ``fn`` (after a warm-up call; L2 warm), per call.  The calls are
    enqueued while the stream is held by a spin kernel, so the pair
    brackets the kernels and the gaps between them, not the host's
    enqueue; the spin grows until it outlasts the enqueue."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000            # about 10 ms at the H100's 1.98 GHz
    for _ in range(4):             # up to about 0.65 s
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()    # the spin still ran: nothing waited
        torch.cuda.synchronize()
        if covered:
            break
        cycles *= 4
    check(covered, "the host's enqueue outlasted a 0.65 s spin")
    return start.elapsed_time(end) / iters


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
    """Card, build, and the toolchain probe K0 against ``x + 1``."""
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
    k0 = {"call": time_ms(lambda: add_one.add_one(x)),
          "plain_call": time_ms(lambda: x + 1),
          "ms": device_ms(lambda: add_one.add_one(x)),
          "plain_ms": device_ms(lambda: x + 1),
          "library_ms": device_ms(lambda: torch.add(x, 1.0)),
          "bound_ms": 2 * x.numel() * 4 / H100_BYTES * 1e3}
    print(f"K0 add_one probe: built, launched, exact; (8, 128) f32: call "
          f"{k0['call']:.4f} ms vs x + 1 {k0['plain_call']:.4f} ms; device "
          f"{k0['ms']:.4f} ms vs x + 1 {k0['plain_ms']:.4f} ms, torch.add "
          f"{k0['library_ms']:.4f} ms; bound {k0['bound_ms']:.2e} ms (bytes)")
    return k0


def phase_kernel(mx):
    """Each flash kernel against the plain version, then their times."""
    import torch
    from mxnet_tpu_torch.kernels import flash_attention as kfa
    gen = torch.Generator(device="cpu").manual_seed(0)

    def qkv(B, H, T, D, dtype):
        return [torch.randn(B, H, T, D, generator=gen).to("cuda", dtype)
                for _ in range(3)]

    errs = {}      # (variant, dtype, B, T, D, causal) -> (abs, rel) err
    short_times = {}   # T -> ({name: device ms}, bound) at B=4, bf16
    cases = [(4, 16, 1024, 64, None), (1, 16, 1024, 64, None),
             (2, 3, 128, 16, 32), (2, 3, 128, 32, 32), (2, 3, 128, 128, 32),
             (1, 2, 100, 64, None)]
    for B, H, T, D, blk in cases:
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            variant = kfa._variant(dtype, D)
            for causal in (False, True):
                q, k, v = qkv(B, H, T, D, dtype)
                before = kfa.VARIANT_LAUNCHES[variant]
                if blk is None:
                    out = kfa.flash_attention_fwd(q, k, v, D ** -0.5, causal)
                else:   # through the op, whose block only sets divisibility
                    out = mx.nd.flash_attention(q, k, v, causal=causal,
                                                block_q=blk, block_k=blk)
                ref = kfa.dense_reference(q, k, v, D ** -0.5, causal)
                torch.cuda.synchronize()
                check(kfa.VARIANT_LAUNCHES[variant] == before + 1,
                      f"flash at D={D} {dtype} did not launch {variant}")
                err = (out.float() - ref.float()).abs().max().item()
                rel = err / ref.float().abs().max().item()
                check(out.shape == ref.shape and out.dtype == dtype
                      and bool(torch.isfinite(out).all()),
                      f"flash output malformed at {(B, H, T, D)} {dtype}")
                what = (f"flash {variant} vs plain at B={B} H={H} T={T} D={D} "
                        f"{dtype} causal={causal}")
                check(err <= tol, f"{what}: max err {err:.3e} > {tol}")
                check(dtype != torch.bfloat16 or rel <= TOL_BF16_REL,
                      f"{what}: max err / max |ref| {rel:.3e} > "
                      f"{TOL_BF16_REL:.3e}")
                errs[(variant, dtype, B, T, D, causal)] = (err, rel)
                print(f"  flash {variant:4s} B={B} H={H} T={T} D={D} "
                      f"{str(dtype)[6:]} causal={causal}: max err {err:.3e}, "
                      f"over max |ref| {rel:.3e}")
    # the short sequences the serving buckets send through the kernels
    # (phase 8), causal: T below both kernels' q and k tiles (and the sm90
    # kernel's TMA boxes)
    for T in SHORT_T:
        for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
            variant = kfa._variant(dtype, 64)
            q, k, v = qkv(4, 16, T, 64, dtype)
            before = kfa.VARIANT_LAUNCHES[variant]
            out = kfa.flash_attention_fwd(q, k, v, 0.125, True)
            ref = kfa.dense_reference(q, k, v, 0.125, True)
            torch.cuda.synchronize()
            check(kfa.VARIANT_LAUNCHES[variant] == before + 1,
                  f"flash at T={T} {dtype} did not launch {variant}")
            check(out.shape == ref.shape and out.dtype == dtype
                  and bool(torch.isfinite(out).all()),
                  f"flash output malformed at T={T} {dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            what = f"flash {variant} vs plain at B=4 H=16 T={T} D=64 {dtype}"
            check(err <= tol, f"{what}: max err {err:.3e} > {tol}")
            check(dtype != torch.bfloat16 or rel <= TOL_BF16_REL,
                  f"{what}: max err / max |ref| {rel:.3e} > "
                  f"{TOL_BF16_REL:.3e}")
            errs[(variant, dtype, 4, T, 64, True)] = (err, rel)
            line = (f"  flash {variant:4s} B=4 H=16 T={T} D=64 "
                    f"{str(dtype)[6:]} causal=True: max err {err:.3e}, over "
                    f"max |ref| {rel:.3e}")
            if dtype == torch.bfloat16:
                t = {name: device_ms(fn) for name, fn in (
                    ("sm90", lambda: kfa.flash_attention_fwd(q, k, v, 0.125,
                                                             True)),
                    ("plain", lambda: kfa.dense_reference(q, k, v, 0.125,
                                                          True)),
                    ("sdpa", lambda: torch.nn.functional.
                     scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  scale=0.125)))}
                bound = attention_bound_ms(4, 16, T, 64, True, 2,
                                           H100_BF16_FLOPS)
                short_times[T] = (t, bound)
                line += ("; device ms: " + ", ".join(
                    f"{n} {ms:.4f}" for n, ms in t.items())
                    + f"; bound {bound[0]:.5f} ({bound[1]})")
            print(line)
    timings = {}
    for dtype, B in ((torch.bfloat16, 4), (torch.bfloat16, 1),
                     (torch.float32, 4)):
        for causal in (True, False):
            q, k, v = qkv(B, 16, 1024, 64, dtype)
            variant = kfa._variant(dtype, 64)
            fns = {variant: lambda: kfa.flash_attention_fwd(q, k, v, 0.125,
                                                            causal)}
            if variant != "f32":   # the f32 kernel on the same bf16 inputs
                fns["f32"] = lambda: kfa._launch("f32", q, k, v, 0.125,
                                                 causal)
            fns["plain"] = lambda: kfa.dense_reference(q, k, v, 0.125, causal)
            fns["sdpa"] = lambda: torch.nn.functional.\
                scaled_dot_product_attention(q, k, v, is_causal=causal,
                                             scale=0.125)
            row = {name: (device_ms(fn), time_ms(fn))
                   for name, fn in fns.items()}
            rate = H100_BF16_FLOPS if dtype == torch.bfloat16 \
                else H100_F32_FLOPS
            row["bound"] = attention_bound_ms(B, 16, 1024, 64, causal,
                                              q.element_size(), rate)
            timings[(dtype, B, causal)] = row
            print(f"  time B={B} H=16 T=1024 D=64 {str(dtype)[6:]} "
                  f"causal={causal}, device (call) ms: " + ", ".join(
                      f"{name} {d:.4f} ({c:.4f})"
                      for name, (d, c) in row.items() if name != "bound")
                  + f"; bound {row['bound'][0]:.4f} ({row['bound'][1]})")
    return errs, timings, short_times


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


def check_tokens(mx, dense, what, got, want, t0):
    """``got`` equals ``want`` (the dense net's static-path tokens), or
    first differs after the prompt where the dense net's top-2 logits are
    within NEAR_TIE of each other, which is printed."""
    import numpy as np
    check(got.shape == (t0 + MAX_NEW,), "generated tokens malformed")
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        print(f"  request T0={t0}: {what} tokens equal the dense net's")
        return
    i = int(diff[0])
    check(i >= t0, "generate changed the prompt")
    buf = np.zeros((1, CONFIG["max_len"]), np.float32)
    buf[0, :i] = want[:i]
    last = mx.nd.asnumpy(dense._decode_steps()["logits"](
        mx.nd.array(buf, ctx=mx.gpu(0)),
        mx.nd.array([i - 1.0], ctx=mx.gpu(0))))[0]
    top2 = np.sort(last)[-2:]
    gap = float(top2[1] - top2[0])
    print(f"  request T0={t0}: token {i} differs ({what} {got[i]:.0f}, "
          f"dense {want[i]:.0f}); dense top-2 logit gap {gap:.3e}")
    check(gap <= NEAR_TIE, f"tokens differ at {i} without a near-tie")
    print(f"  near-tie accepted at request T0={t0} position {i}")


def phase_serve_f32(mx, flash, dense, prompts, L):
    got, _ = serve(mx, flash, prompts, L)
    want, _ = serve(mx, dense, prompts, 0)
    for p, g, w in zip(prompts, got, want):
        check_tokens(mx, dense, "flash", g, w, len(p))
    print("serving f32: greedy tokens agree with the dense net")
    return want


def reset_counts():
    """Every kernel launch count set to 0."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.kernels import flash_attention as kfa
    for mod in kernels.ALL:
        mod.LAUNCHES = 0
    for variant in kfa.VARIANT_LAUNCHES:
        kfa.VARIANT_LAUNCHES[variant] = 0


def read_counts():
    """{kernel: launches}, with the flash kernel also by variant."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.kernels import flash_attention as kfa
    counts = {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
              for mod in kernels.ALL}
    counts.update({f"flash_attention.{v}": n
                   for v, n in kfa.VARIANT_LAUNCHES.items()})
    return counts


def phase_main(mx, flash, tokens, prompts, L):
    """The main path in bfloat16, with every kernel count set to 0 first."""
    import torch
    flash.cast("bfloat16")
    forward_counted(flash, L, tokens)          # warm-up, outside the count
    serve(mx, flash, prompts[:1], L)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits = flash(tokens)
    torch.cuda.synchronize()
    t_score = time.perf_counter() - t0
    check(logits.dtype == torch.bfloat16 and logits.shape ==
          (SCORE_BATCH, CONFIG["max_len"], CONFIG["vocab"])
          and bool(torch.isfinite(logits).all()), "bf16 logits malformed")
    outs, times = serve(mx, flash, prompts, L)
    counts = read_counts()
    print(f"main path bf16: scoring B={SCORE_BATCH} T={CONFIG['max_len']} "
          f"{t_score * 1e3:.1f} ms ({SCORE_BATCH * CONFIG['max_len'] / t_score:.0f}"
          f" tokens/s)")
    for p, out, t in zip(prompts, outs, times):
        print(f"  request T0={len(p)}: {t * 1e3:.1f} ms for {MAX_NEW} tokens "
              f"({MAX_NEW / t:.1f} tokens/s); new tokens {out[len(p):].astype(int).tolist()}")
    print(f"  kernel launches on the main path: {counts}")
    want = L * (1 + len(prompts) * MAX_NEW)
    check(counts["flash_attention"] == want
          and counts["flash_attention.sm90"] == want
          and counts["flash_attention.f32"] == 0,
          f"flash launches on the main path: {counts}; want {want}, all of "
          f"them on the sm90 kernel")
    return counts, times


def host_clock_ms(fn):
    """Host clock of one call of ``fn``, synchronized on both sides: the
    median of 5 calls after a warm-up."""
    import torch
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls[1:])


def kernel_rows(fn):
    """(ms, launches, name) of each kernel torch.profiler sees in one call
    of ``fn``, largest first; empty when it sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched
    return sorted(((a.self_device_time_total / 1e3, a.count, a.key)
                   for a in prof.key_averages()
                   if a.device_type != torch.autograd.DeviceType.CPU
                   and a.self_device_time_total > 0), reverse=True)


def phase_profile(mx, flash, prompt):
    """Where one bf16 greedy decode step's time goes: the host clock around
    the step (median of 5, profiler off), the device time of the kernels
    torch.profiler sees in one step, and the kernels that take most of it;
    where the profiler sees no device time, ``device_ms`` of the step's
    flash launches instead."""
    import numpy as np
    import torch
    step = flash._decode_steps()["greedy"]
    buf = np.zeros((1, CONFIG["max_len"]), np.float32)
    buf[0, :len(prompt)] = prompt
    buf = mx.nd.array(buf, ctx=mx.gpu(0))
    pos = mx.nd.array([len(prompt) - 1.0], ctx=mx.gpu(0))
    wall_ms = host_clock_ms(lambda: step(buf, pos))
    step._active = False           # the same step run eagerly, op by op
    eager_ms = host_clock_ms(lambda: step(buf, pos))
    step._active = True
    rows = kernel_rows(lambda: step(buf, pos))
    print(f"decode step bf16, T0={len(prompt)}: host clock {wall_ms:.3f} ms "
          f"through its CachedOp, {eager_ms:.3f} ms eager (medians of 5, "
          f"profiler off)")
    if rows:
        busy_ms = sum(r[0] for r in rows)
        flash = [r for r in rows if "flash_attention" in r[2]]
        flash_ms = sum(r[0] for r in flash)
        print(f"  kernel time (torch.profiler) {busy_ms:.3f} ms "
              f"({100 * busy_ms / wall_ms:.1f}% of the step)")
        print(f"  flash: {flash_ms:.3f} ms in {sum(r[1] for r in flash)} "
              f"launches ({100 * flash_ms / busy_ms:.1f}% of kernel time)")
    else:
        # No device trace.  The step waits for the stream somewhere inside
        # (queued behind a spin, its enqueue never finishes first), so only
        # its flash launches are timed, on inputs of the step's shape.
        from mxnet_tpu_torch.kernels import flash_attention as kfa
        L, H = CONFIG["num_layers"], CONFIG["num_heads"]
        q, k, v = (torch.randn(1, H, CONFIG["max_len"], CONFIG["dim"] // H,
                               device="cuda", dtype=torch.bfloat16)
                   for _ in range(3))
        scale = (CONFIG["dim"] // H) ** -0.5
        flash_ms = device_ms(lambda: [kfa.flash_attention_fwd(
            q, k, v, scale, True) for _ in range(L)], iters=3)
        print("  kernel time not measured: torch.profiler saw no device time")
        print(f"  flash: {flash_ms:.3f} ms of stream time in {L} launches "
              f"({100 * flash_ms / wall_ms:.1f}% of the host clock)")
    for ms, count, key in rows[:8]:
        print(f"  {ms:8.3f} ms  x{count:<4d} {key[:90]}")


def teacher_forced_logp(mx, net, seq, t0):
    """The log-probability ``net`` gives seq[t0:] after seq[:t0], from one
    forward over the whole sequence (float64 sums of float32 log-probs)."""
    import torch
    logits = net(mx.nd.array(seq[None, :], ctx=mx.gpu(0)))[0]
    logp = torch.log_softmax(logits.double(), dim=-1)
    ids = torch.as_tensor(seq[t0:], device=logp.device).long()
    return float(logp[torch.arange(t0 - 1, len(seq) - 1), ids].sum())


def kv_step(mx, net, prompt):
    """One greedy KV decode step at position len(prompt), on zero caches."""
    cell = net._kv_step()["greedy"]
    caches = net._init_caches(1, ctx=mx.gpu(0), dtype=net.head.weight.dtype)
    cur = mx.nd.array(prompt[None, :1], ctx=mx.gpu(0))
    pos = mx.nd.array([float(len(prompt))], ctx=mx.gpu(0))
    return lambda: cell(cur, pos, *caches)


def kv_step_bound_ms(mx, net):
    """Least time of one B=1 KV step on the card: the bytes it must move
    (every weight read once, but one row of each embedding table; the
    caches read once and the new caches written once) over the memory
    rate.  Its operations, about two per weight, take far less."""
    weights = 0
    for p in net.collect_params().values():
        t = p.data()
        rows = 1 if p.name.endswith(("tok_weight", "pos_weight")) \
            else t.shape[0]
        weights += rows * t[0].numel() * t.element_size()
    caches = sum(c.numel() * c.element_size()
                 for c in net._init_caches(1, ctx=mx.gpu(0),
                                           dtype=net.head.weight.dtype))
    return (weights + 2 * caches) / H100_BYTES * 1e3


def cache_write_ms(dtype):
    """Device time of one step's cache writes (2 per layer at B=1) made as
    ``mha_decode_step`` makes them, out of place, beside the same writes in
    place, and their bound (the out-of-place write reads and writes every
    cache once)."""
    import torch
    L, H = CONFIG["num_layers"], CONFIG["num_heads"]
    dh, tmax = CONFIG["dim"] // H, CONFIG["max_len"]
    caches = [torch.randn(1, H, tmax, dh, device="cuda").to(dtype)
              for _ in range(2 * L)]
    row = torch.randn(1, H, 1, dh, device="cuda").to(dtype)
    col = torch.tensor([tmax // 2], device="cuda")
    out_of_place = device_ms(lambda: [c.index_copy(2, col, row)
                                      for c in caches], iters=5)
    in_place = device_ms(lambda: [c.index_copy_(2, col, row)
                                  for c in caches], iters=5)
    nbytes = 2 * sum(c.numel() * c.element_size() for c in caches)
    return out_of_place, in_place, nbytes / H100_BYTES * 1e3


def phase_kv(mx, prompts, static_tokens, static_times):
    """KV-cache decode, beam search and a checkpoint round trip on a fresh
    float32 net with phase 3's weights, then the KV requests in bfloat16
    timed beside phase 5's static-shape ones."""
    import tempfile
    import numpy as np
    import torch
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
    from mxnet_tpu_torch.kernels import flash_attention as kfa
    flash, dense = build_nets(mx)
    launches = kfa.LAUNCHES            # build_nets' forward launched flash
    kv = {}
    for p, want in zip(prompts, static_tokens):
        prompt = mx.nd.array(p[None, :], ctx=mx.gpu(0))
        kv[len(p)] = mx.nd.asnumpy(flash.generate(prompt, MAX_NEW,
                                                  kv_cache=True))[0]
        check_tokens(mx, dense, "KV", kv[len(p)], want, len(p))
    print("KV decode f32: greedy tokens agree with the static path")
    p = next(p for p in prompts if len(p) == BEAM_PROMPT)
    prompt = mx.nd.array(p[None, :], ctx=mx.gpu(0))
    sampled = [mx.nd.asnumpy(net.generate(
        prompt, MAX_NEW, temperature=0.8, rng=np.random.RandomState(11),
        **kw))[0] for net, kw in ((flash, {"kv_cache": True}), (dense, {}))]
    print(f"  sampled request T0={BEAM_PROMPT}, temperature 0.8: KV "
          f"{sampled[0][BEAM_PROMPT:].astype(int).tolist()}, static "
          f"{sampled[1][BEAM_PROMPT:].astype(int).tolist()}")
    check(np.array_equal(*sampled), "sampled KV tokens differ from static")
    seq1, lp1 = flash.beam_search(prompt, MAX_NEW, beam=1)
    check(np.array_equal(mx.nd.asnumpy(seq1)[0], kv[BEAM_PROMPT]),
          "beam width 1 differs from KV greedy")
    seq4, lp4 = flash.beam_search(prompt, MAX_NEW, beam=4)
    seq4 = mx.nd.asnumpy(seq4)[0]
    lp4 = float(mx.nd.asnumpy(lp4)[0])
    resc = teacher_forced_logp(mx, dense, seq4, BEAM_PROMPT)
    print(f"  beam 1 = greedy; beam 4: log-prob {lp4:.6f}, teacher-forced "
          f"{resc:.6f} (|diff| {abs(lp4 - resc):.3e}); greedy "
          f"{float(mx.nd.asnumpy(lp1)[0]):.6f}; tokens "
          f"{seq4[BEAM_PROMPT:].astype(int).tolist()}")
    check(abs(lp4 - resc) <= TOL_BEAM, "beam log-prob differs from rescoring")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = os.path.join(d, "lm.params")
        t0 = time.perf_counter()
        flash.save_params(path)
        t_save = time.perf_counter() - t0
        fresh = TransformerLM(**CONFIG, attn_type="flash")
        t0 = time.perf_counter()
        fresh.load_params(path, ctx=mx.gpu(0))
        t_load = time.perf_counter() - t0
        size = os.path.getsize(path)
    got = mx.nd.asnumpy(fresh.generate(prompt, MAX_NEW, kv_cache=True))[0]
    print(f"  checkpoint: save_params {t_save:.2f} s, load_params into a "
          f"fresh net on gpu(0) {t_load:.2f} s ({size / 1e6:.0f} MB); KV "
          f"tokens {'identical' if np.array_equal(got, kv[BEAM_PROMPT]) else 'DIFFER'}")
    check(np.array_equal(got, kv[BEAM_PROMPT]), "loaded net decodes otherwise")
    del fresh
    writes = {dt: cache_write_ms(dt)
              for dt in (torch.float32, torch.bfloat16)}
    flash.cast("bfloat16")
    flash.generate(mx.nd.array(prompts[0][None, :], ctx=mx.gpu(0)), MAX_NEW,
                   kv_cache=True)                  # warm-up
    print("KV decode bf16 (host clock; static = phase 5's request times):")
    for p, t_static in zip(prompts, static_times):
        prompt = mx.nd.array(p[None, :], ctx=mx.gpu(0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mx.nd.asnumpy(flash.generate(prompt, MAX_NEW, kv_cache=True))[0]
        t_req = time.perf_counter() - t0
        check(out.shape == (len(p) + MAX_NEW,) and np.array_equal(
            out[:len(p)], p), "bf16 KV tokens malformed")
        steps = len(p) + MAX_NEW - 1
        print(f"  request T0={len(p)}: KV {t_req * 1e3:.1f} ms for {steps} "
              f"steps ({t_req / steps * 1e3:.3f} ms/step), static "
              f"{t_static * 1e3:.1f} ms for {MAX_NEW} forwards; one KV step "
              f"{host_clock_ms(kv_step(mx, flash, p)):.3f} ms (median of 5); "
              f"new tokens {out[len(p):].astype(int).tolist()}")
    rows = kernel_rows(kv_step(mx, flash, prompts[-1]))
    print(f"  one KV step's bound: {kv_step_bound_ms(mx, flash):.4f} ms "
          "(bytes)")
    if rows:
        busy_ms = sum(r[0] for r in rows)
        print(f"  one KV step under torch.profiler: {busy_ms:.3f} ms of "
              f"kernel time in {sum(r[1] for r in rows)} launches")
        for ms, count, key in rows[:6]:
            print(f"  {ms:8.3f} ms  x{count:<4d} {key[:90]}")
    else:
        print("  KV step kernel time not measured: torch.profiler saw no "
              "device time")
    for dt, (oop, inp, bound) in writes.items():
        print(f"  cache writes per step, {str(dt)[6:]} ({2 * CONFIG['num_layers']}"
              f" caches of B=1): out of place {oop:.4f} ms, in place "
              f"{inp:.4f} ms, out-of-place bound {bound:.4f} ms (bytes)")
    delta = kfa.LAUNCHES - launches
    print(f"  flash launches while decoding with the KV cache: {delta}")
    check(delta == 0, "the KV path launched the flash kernel")


def percentile(xs, q):
    """The q-th percentile of ``xs`` (nearest rank)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, int(round(q / 100 * len(xs))) - 1))]


def serve_breakdown(mx, pred, keys):
    """Host clock of one dispatch (graph run, synchronized) and of the
    host copy of its outputs, per bucket key: medians of 5 after a
    warm-up."""
    import numpy as np
    import torch
    out = {}
    for key in keys:
        shapes = pred.spec.bucket_input_shapes(key)
        padded = {n: np.zeros(s, np.float32) for n, s in shapes.items()}
        disp, copy = [], []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = pred._dispatch(key, padded)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            host = [mx.nd.asnumpy(o) for o in outs]
            t2 = time.perf_counter()
            disp.append((t1 - t0) * 1e3)
            copy.append((t2 - t1) * 1e3)
        nbytes = sum(h.nbytes for h in host)
        out[key] = (statistics.median(disp[1:]), statistics.median(copy[1:]),
                    nbytes)
        print(f"  bucket {key}: dispatch {out[key][0]:.3f} ms, host copy "
              f"{out[key][1]:.3f} ms of {nbytes / 2 ** 20:.0f} MiB "
              f"({nbytes / out[key][1] / 1e6:.2f} GB/s)")
    return out


def phase_serving(mx, prompts, L):
    """Serving through the Symbol graph on a fresh net with phase 7's
    weights: graph round trip, float32 bucketed predictor against eager
    scoring, then the bfloat16 main serving path through a MicroBatcher
    (counted) and the ResilientServer's typed rejections."""
    import tempfile
    import threading
    import numpy as np
    import torch
    from mxnet_tpu_torch.kernels import flash_attention as kfa
    from mxnet_tpu_torch.observability import metrics as M
    from mxnet_tpu_torch.serving import (BucketedPredictor, DeadlineExceeded,
                                         MicroBatcher, Overloaded,
                                         ResilientServer, pow2_buckets)
    flash, dense = build_nets(mx)
    del dense
    t0 = time.perf_counter()
    js = flash(mx.sym.var("data")).tojson()
    check(mx.sym.load_json(js).tojson() == js, "graph JSON round trip")
    t_trace = time.perf_counter() - t0
    max_shape = {"data": (SCORE_BATCH, CONFIG["max_len"])}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = os.path.join(d, "lm.params")
        mx.nd.save(path, {n: p.data()
                          for n, p in flash.collect_params().items()})
        t0 = time.perf_counter()
        pred = BucketedPredictor(js, path, max_shape, seq_axes={"data": 1})
        t_load = time.perf_counter() - t0
    keys = pred.spec.all_keys()
    n_keys = len(pow2_buckets(SCORE_BATCH)) * len(
        pow2_buckets(CONFIG["max_len"]))          # 3 x 11 at full width
    print(f"graph: {len(json.loads(js)['nodes'])} nodes, traced and "
          f"round-tripped through JSON in {t_trace:.2f} s; predictor on "
          f"gpu(0) from the JSON and the params file in {t_load:.2f} s; "
          f"{len(keys)} buckets")
    check(len(keys) == n_keys, f"bucket lattice has {len(keys)} keys, "
          f"want {n_keys}")
    compiles, launches = M.SERVE_COMPILES.value, dict(kfa.VARIANT_LAUNCHES)
    t0 = time.perf_counter()
    pred.warmup()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    built = M.SERVE_COMPILES.value - compiles
    warm = {v: kfa.VARIANT_LAUNCHES[v] - launches[v] for v in launches}
    print(f"serving f32: warmup built {built:.0f} buckets in {t_warm:.2f} s, "
          f"flash launches {warm}")
    check(built == n_keys and warm["f32"] == L * n_keys
          and warm["sm90"] == 0,
          f"warmup: {built} buckets, flash launches {warm}; want {n_keys} "
          f"and {L * n_keys} on f32")
    compiles = M.SERVE_COMPILES.value
    for p in prompts:
        got = pred.predict(data=p[None, :])[0]
        want = mx.nd.asnumpy(flash(mx.nd.array(p[None, :], ctx=mx.gpu(0))))
        bucket = pred.spec.route({"data": (1, len(p))})
        check(got.shape == (1, bucket[1], CONFIG["vocab"])
              and np.isfinite(got).all(), f"served logits malformed: "
              f"{got.shape} at T0={len(p)}")
        err = float(np.abs(got[:, :len(p)] - want).max())
        print(f"  request T0={len(p)} -> bucket {bucket}: valid logits max "
              f"|served - net(tokens)| {err:.3e}")
        check(err <= TOL_LOGITS_F32, f"served logits differ by {err:.3e}")
    check(M.SERVE_COMPILES.value == compiles, "requests built buckets")
    pred.close()
    del pred

    # the main serving path: bfloat16
    flash.cast("bfloat16")
    pred = BucketedPredictor(flash(mx.sym.var("data")), {n: p.data() for n, p in
                                   flash.collect_params().items()},
                             max_shape, seq_axes={"data": 1})
    t0 = time.perf_counter()
    pred.warmup()
    torch.cuda.synchronize()
    print(f"serving bf16: warmup built {pred.num_compiled} buckets in "
          f"{time.perf_counter() - t0:.2f} s")
    rs = np.random.RandomState(7)
    reqs = [rs.randint(0, CONFIG["vocab"], (1, PROMPTS[i % len(PROMPTS)]))
            .astype(np.float32) for i in range(32)]
    solo = [pred.predict(data=r)[0] for r in reqs]
    compiles = M.SERVE_COMPILES.value
    batches, served = M.SERVE_BATCHES.value, M.SERVE_REQUESTS.value
    groups = []                    # (start, end, inputs) of each dispatch
    routed = pred._predict_routed

    def timed_routed(inputs):
        start = time.perf_counter()
        outs = routed(inputs)
        groups.append((start, time.perf_counter(), inputs))
        return outs

    pred._predict_routed = timed_routed
    results, lat = [None] * len(reqs), [None] * len(reqs)
    batcher = MicroBatcher(pred)

    def client(idx):
        for i in idx:
            t = time.perf_counter()
            results[i] = batcher.submit(data=reqs[i]).result()[0]
            lat[i] = (t, time.perf_counter())

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(range(c, 32, 4),))
               for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    counts = read_counts()
    batcher.close()
    pred._predict_routed = routed
    dispatches = M.SERVE_BATCHES.value - batches
    ms = [(b - a) * 1e3 for a, b in lat]
    tokens = sum(r.shape[1] for r in reqs)
    print(f"  MicroBatcher, 4 client threads, 32 requests: {dispatches:.0f} "
          f"batches, {M.SERVE_REQUESTS.value - served:.0f} requests, "
          f"{32 / len(groups):.2f} rows per batch (last batch "
          f"{M.SERVE_COALESCED_ROWS.get():.0f} rows); latency p50 "
          f"{percentile(ms, 50):.2f} ms, p99 {percentile(ms, 99):.2f} ms; "
          f"{32 / wall:.1f} requests/s, {tokens / wall:.0f} prompt tokens/s "
          f"in {wall:.2f} s")
    # each request's batch and row there: its ids open exactly one row
    where = {}
    for g, (_, _, inputs) in enumerate(groups):
        for row, ids in enumerate(inputs["data"]):
            hits = [i for i, r in enumerate(reqs)
                    if np.array_equal(ids[:r.shape[1]], r[0])]
            check(len(hits) == 1 and hits[0] not in where,
                  f"batch {g} row {row} matches requests {hits}")
            where[hits[0]] = (g, row)
    check(sorted(where) == list(range(len(reqs))),
          f"requests missing from the batches: {sorted(where)}")
    # queueing: from a request's submit to its batch's dispatch
    queue_ms = [(groups[where[i][0]][0] - lat[i][0]) * 1e3
                for i in range(len(reqs))]
    service = [(b - a) * 1e3 for a, b, _ in groups]
    print(f"  queueing p50 {percentile(queue_ms, 50):.2f} ms, p99 "
          f"{percentile(queue_ms, 99):.2f} ms; dispatch + host copy per "
          f"batch p50 {percentile(service, 50):.2f} ms, p99 "
          f"{percentile(service, 99):.2f} ms")
    print(f"  kernel launches on the serving path: {counts}")
    check(counts["flash_attention"] == L * dispatches
          and counts["flash_attention.sm90"] == L * dispatches
          and counts["flash_attention.f32"] == 0,
          f"flash launches while serving: {counts}; want {L} x "
          f"{dispatches:.0f} dispatches, all on the sm90 kernel")
    check(M.SERVE_COMPILES.value == compiles, "traffic built buckets")
    # the same batches dispatched again: a coalesced result is its row
    for g, (_, _, inputs) in enumerate(groups):
        again = routed(inputs)[0]
        for i, (g_i, row) in where.items():
            check(g_i != g or np.array_equal(results[i], again[row:row + 1]),
                  f"request {i}: coalesced result differs from row {row} "
                  f"of its batch dispatched again")
    worst, same, same_bucket = 0.0, 0, 0
    for i, (r, got, want) in enumerate(zip(reqs, results, solo)):
        check(got.shape[0] == 1 and got.shape[2] == CONFIG["vocab"]
              and np.isfinite(got.astype(np.float32)).all(),
              "coalesced result malformed")
        a = got[:, :r.shape[1]].astype(np.float32)    # the valid region
        b = want[:, :r.shape[1]].astype(np.float32)
        same += bool(np.array_equal(a, b))
        key = pred.spec.route({"data": groups[where[i][0]][2]["data"].shape})
        if key == pred.spec.route({"data": r.shape}):
            same_bucket += 1
            check(np.array_equal(a, b), f"request {i} ran at its solo "
                  f"bucket {key} and differs from its solo result")
        else:
            worst = max(worst, float(np.abs(a - b).max()))
    print(f"  coalesced vs solo: 32 results equal to their rows of the same "
          f"batches dispatched again; {same_bucket} of 32 ran at their solo "
          f"bucket (bitwise equal); {same} of 32 valid regions identical; "
          f"max |diff| at another bucket {worst:.3e} (limit "
          f"{TOL_COALESCED_BF16})")
    check(worst <= TOL_COALESCED_BF16, f"coalesced results differ from "
          f"solo by {worst:.3e} at another bucket")
    serve_breakdown(mx, pred, [(1, 16), (1, 128), (1, 512), (1, 1024),
                               (4, 1024)])

    server = ResilientServer(pred, max_queue=2)
    server.warmup()
    ready = server.readyz()
    check(server.healthz()["ok"] and ready["ready"],
          f"server not ready: {ready}")
    burst, shed = [], 0
    for r in reqs[3::4] * 2:                 # 16 requests at T0=700
        try:
            burst.append(server.submit(data=r))
        except Overloaded as e:
            check(e.retry_after_s >= 0, "Overloaded without retry-after")
            shed += 1
    for f in burst:
        f.result()
    late = server.submit(data=reqs[0], deadline_ms=0.0)
    try:
        late.result()
        check(False, "a request past its deadline was served")
    except DeadlineExceeded:
        pass
    stats = server.stats()
    print(f"  ResilientServer max_queue=2: burst of 16, {len(burst)} "
          f"admitted and served, {shed} shed with Overloaded; a request "
          f"past its deadline failed with DeadlineExceeded; readyz "
          f"{server.readyz()['ready']}, expired dispatches "
          f"{stats['expired_dispatches']}")
    check(shed >= 1 and stats["expired_dispatches"] == 0
          and server.readyz()["ready"], f"server stats {stats}")
    server.close()
    pred.close()
    return counts


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
        k0 = phase_setup(mx)
        print("== phase 2: flash kernels vs plain version")
        errs, timings, short_times = phase_kernel(mx)
        print("== phase 3: scoring, float32, flash vs dense")
        flash, dense = build_nets(mx)
        rs = np.random.RandomState(42)
        tokens = mx.nd.array(rs.randint(0, CONFIG["vocab"], (
            SCORE_BATCH, CONFIG["max_len"])).astype(np.float32), ctx=mx.gpu(0))
        prompts = [rs.randint(0, CONFIG["vocab"], n).astype(np.float32)
                   for n in PROMPTS]
        phase_score_f32(mx, flash, dense, tokens, L)
        print("== phase 4: serving, float32, flash vs dense")
        static_tokens = phase_serve_f32(mx, flash, dense, prompts, L)
        print("== phase 5: main path, bfloat16")
        counts, static_times = phase_main(mx, flash, tokens, prompts, L)
        print("== phase 6: where one decode step's time goes")
        phase_profile(mx, flash, prompts[-1])
        print("== phase 7: KV-cache decode")
        del flash, dense
        phase_kv(mx, prompts, static_tokens, static_times)
        print("== phase 8: serving through the symbol graph")
        counts = phase_serving(mx, prompts, L)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    bf16, f32 = torch.bfloat16, torch.float32

    def flash_entry(name, variant, source, dtype, launches):
        """The kernel at the scoring shape, causal; the decode shape's
        numbers beside it for the bf16 kernel."""
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": "mxnet_tpu/ops/flash_attention.py:179",
                 "replaces_function":
                     "mxnet_tpu/ops/flash_attention.py:_flash_attention",
                 "launches": launches}
        for B in ((4, 1) if dtype == bf16 else (4,)):
            t = timings[(dtype, B, True)]
            err, rel = errs[(variant, dtype, B, 1024, 64, True)]
            nums = {"shape": f"B={B} H=16 T=1024 D=64 {str(dtype)[6:]} "
                             "causal",
                    "max_abs_err": err, "max_rel_err": rel,
                    "ms": t[variant][0], "call_ms": t[variant][1],
                    "plain_ms": t["plain"][0], "bound_ms": t["bound"][0],
                    "bound_by": t["bound"][1], "library_ms": t["sdpa"][0]}
            if B == 4:
                entry.update(nums)
            else:
                entry["decode"] = nums
        entry["max_err_all_shapes"] = max(
            e[0] for key, e in errs.items() if key[0] == variant)
        if variant == "sm90":
            entry["short"] = {
                f"B=4 H=16 T={T} D=64 bf16 causal": {
                    "max_abs_err": errs[(variant, bf16, 4, T, 64, True)][0],
                    "ms": t["sm90"], "plain_ms": t["plain"],
                    "bound_ms": bound[0], "bound_by": bound[1],
                    "library_ms": t["sdpa"]}
                for T, (t, bound) in short_times.items()}
        return entry

    kernels_line = {"kernels": [
        {"name": "add_one", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/add_one.cu",
         "replaces": "experiments/flash_probe.py:40",
         "launches": counts["add_one"], "max_abs_err": 0.0,
         "ms": k0["ms"], "call_ms": k0["call"], "plain_ms": k0["plain_ms"],
         "bound_ms": k0["bound_ms"], "bound_by": "bytes",
         "library_ms": k0["library_ms"]},
        flash_entry("flash_attention_fwd_sm90", "sm90",
                    "mxnet_tpu_torch/csrc/flash_attention_fwd_sm90.cu", bf16,
                    counts["flash_attention.sm90"]),
        flash_entry("flash_attention_fwd", "f32",
                    "mxnet_tpu_torch/csrc/flash_attention_fwd.cu", f32,
                    counts["flash_attention.f32"]),
    ]}
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
