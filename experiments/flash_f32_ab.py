#!/usr/bin/env python3
"""Compare the flash-attention kernels of two checkouts on one CUDA card.

    python3 experiments/flash_f32_ab.py --base DIR [--rounds 2]

DIR is the root of another checkout of this repository (for example the
parent commit, unpacked with ``git archive`` into a git-ignored directory
such as ``build/base``).  Both trees' ``mxnet_tpu_torch/csrc`` flash
sources are built with nvcc into ``build/ab/`` and loaded side by side
with ctypes.  Then, on the same inputs:

* the float32 kernels (``flash_attention_fwd.cu``, ``flash_attention_bwd.cu``)
  are timed in turns (base, this tree, this tree, base per round) at
  H=16, T=1024, D=64: the forward at B=4 causal and not and B=8
  non-causal, the backward at B=8 causal and not, each checked against the
  plain version (``kernels/flash_attention.py``) at 1e-4 of the largest
  output;
* the bf16 kernels (``*_sm90.cu``) of both trees are run at B=2, T=1024,
  D 64 and 128, causal and not, and their outputs compared bitwise.

A tree's float32 kernels take one of two interfaces, told apart by their
source: the FMA kernels (no ``wgmma_tf32``: the forward keeps no lse, the
backward takes two (bh, tq) scratches) or the 3xTF32 kernels (the forward
writes lse when given a pointer, the backward reads it beside a scratch of
two planes).  Times are CUDA-event device times (``chip_smoke.device_ms``).
Exits non-zero if a build, a check or a bitwise comparison fails.
"""
import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_fwd_sm90", "flash_attention_bwd_sm90")


def build(tree, tag):
    """nvcc every flash source of ``tree`` into build/ab/<tag>, in parallel;
    returns {name: ctypes.CDLL}."""
    sys.path.insert(0, ROOT)
    from mxnet_tpu_torch.kernels import _build
    csrc = os.path.join(tree, "mxnet_tpu_torch", "csrc")
    out_dir = os.path.join(ROOT, "build", "ab", tag)
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name in SOURCES:
        src = os.path.join(csrc, name + ".cu")
        digest = hashlib.sha256(open(src, "rb").read()).hexdigest()[:12]
        out = os.path.join(out_dir, f"lib{name}-{digest}.so")
        jobs[name] = (out, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {tag}/{name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(out)
    return libs, "wgmma_tf32" in open(os.path.join(
        csrc, "flash_attention_fwd.cu")).read()


class Kernels:
    """One tree's four flash entry points, called on PyTorch's stream."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def __init__(self, libs, tf32):
        P, I, F = self.P, self.I, self.F
        self.tf32 = tf32
        self.fwd = libs["flash_attention_fwd"].mxt_flash_attention_fwd
        self.fwd.argtypes = [P] * (5 if tf32 else 4) + [I] * 4 + [F, I, I, P]
        self.bwd = libs["flash_attention_bwd"].mxt_flash_attention_bwd
        self.bwd.argtypes = [P] * 10 + [I] * 4 + [F, I, I, P]
        self.fwd90 = libs["flash_attention_fwd_sm90"].\
            mxt_flash_attention_fwd_sm90
        self.fwd90.argtypes = [P] * 5 + [I] * 4 + [F, I, I, P]
        self.bwd90 = libs["flash_attention_bwd_sm90"].\
            mxt_flash_attention_bwd_sm90
        self.bwd90.argtypes = [P] * 10 + [I] * 4 + [F, I, I, P]

    @staticmethod
    def _stream():
        import torch
        return torch.cuda.current_stream().cuda_stream

    @staticmethod
    def _ok(err, what):
        if err != 0:
            raise SystemExit(f"{what}: CUDA error {err}")

    def forward(self, q, k, v, scale, causal, sm90=False):
        import torch
        B, H, tq, D = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((B, H, tq), dtype=torch.float32, device=q.device)
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()]
        if sm90 or self.tf32:
            ptrs.append(lse.data_ptr())
        fn = self.fwd90 if sm90 else self.fwd
        self._ok(fn(*ptrs, B * H, tq, k.shape[2], D, scale, int(causal),
                    int(q.dtype == torch.bfloat16), self._stream()), "fwd")
        return o, lse

    def backward(self, q, k, v, o, do, lse, scale, causal, sm90=False):
        import torch
        B, H, tq, D = q.shape
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        if sm90 or self.tf32:
            planes = torch.empty(2 * B * H * (-(-tq // 64) * 64),
                                 dtype=torch.float32, device=q.device)
            stats = (lse.data_ptr(), planes.data_ptr())
        else:
            scratch = torch.empty((2, B * H, tq), dtype=torch.float32,
                                  device=q.device)
            stats = (scratch[0].data_ptr(), scratch[1].data_ptr())
        fn = self.bwd90 if sm90 else self.bwd
        self._ok(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), *stats, B * H, tq, k.shape[2], D, scale,
                    int(causal), int(q.dtype == torch.bfloat16),
                    self._stream()), "bwd")
        return dq, dk, dv


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True,
                    help="root of the checkout to compare against")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_f32_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import device_ms
    from mxnet_tpu_torch.kernels import flash_attention as kfa
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    trees = {"base": Kernels(*build(os.path.abspath(args.base), "base")),
             "this": Kernels(*build(ROOT, "this"))}
    print("interfaces: " + ", ".join(
        f"{t} {'3xTF32' if k.tf32 else 'FMA'}" for t, k in trees.items()))
    gen = torch.Generator().manual_seed(0)

    def rnd(B, T, D, dtype):
        return torch.randn(B, 16, T, D, generator=gen).to("cuda", dtype)

    failed = []
    order = ["base", "this", "this", "base"] * args.rounds
    for what, B, causal in (("K1", 4, True), ("K1", 4, False),
                            ("K1", 8, False), ("K1b", 8, True),
                            ("K1b", 8, False)):
        q, k, v, do = (rnd(B, 1024, 64, torch.float32) for _ in range(4))
        o_ref, lse = kfa.dense_reference(q, k, v, 0.125, causal,
                                         return_lse=True)
        if what == "K1":
            want = (o_ref,)
            calls = {t: (lambda t=t: trees[t].forward(q, k, v, 0.125,
                                                      causal)[:1])
                     for t in trees}
        else:
            want = kfa.bwd_reference(q, k, v, o_ref, do, 0.125, causal)
            calls = {t: (lambda t=t: trees[t].backward(
                q, k, v, o_ref, do, lse, 0.125, causal)) for t in trees}
        for t, fn in calls.items():
            got = fn()
            torch.cuda.synchronize()
            rel = max(((g - w).abs().max() / w.abs().max()).item()
                      for g, w in zip(got, want))
            if rel > 1e-4:
                failed.append(f"{what} {t} B={B} causal={causal}: {rel:.3e}")
        times = {t: [] for t in trees}
        for t in order:
            times[t].append(device_ms(calls[t]))
        print(f"{what} f32 B={B} H=16 T=1024 D=64 causal={causal}, device "
              "ms: " + "; ".join(
                  f"{t} " + " ".join(f"{x:.4f}" for x in times[t])
                  for t in trees)
              + f"; this / base {min(times['this']) / min(times['base']):.3f}")
    for D in (64, 128):
        for causal in (True, False):
            q, k, v, do = (rnd(2, 1024, D, torch.bfloat16) for _ in range(4))
            outs = {}
            for t, kern in trees.items():
                o, lse = kern.forward(q, k, v, D ** -0.5, causal, sm90=True)
                outs[t] = (o, lse) + kern.backward(q, k, v, o, do, lse,
                                                   D ** -0.5, causal,
                                                   sm90=True)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b)
                       for a, b in zip(outs["base"], outs["this"]))
            print(f"sm90 bf16 B=2 H=16 T=1024 D={D} causal={causal}: O, "
                  f"lse, dq, dk, dv bitwise equal across the trees: {same}")
            if not same:
                failed.append(f"sm90 D={D} causal={causal} differs")
    if failed:
        print("flash_f32_ab: FAILED: " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
