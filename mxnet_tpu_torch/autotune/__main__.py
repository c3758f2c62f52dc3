"""``python -m mxnet_tpu_torch.autotune --smoke``: the tuner's end-to-end
check (parity: ``mxnet_tpu/autotune/__main__.py``).

Runs ``tune()`` on a small pinned MLP and checks the decision's lifecycle:
the sweep completes, the decision file round-trips through
``decisions.load``, and a second ``tune()`` against the same (model
signature, card) is a pure cache hit with zero measured runs.
``--expect-cached`` makes a cache miss fatal, so a second process can
prove the reload across processes.  ``--cpu`` tunes on the CPU; the
default is ``gpu(0)``, which needs a CUDA device.  Prints a one-line JSON
verdict; exit 0 or 1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _build(ctx):
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn

    mx.random.seed(11)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu"))
        net.add(nn.Dense(16, activation="relu"))
        net.add(nn.Dense(1))
    net.hybridize()
    net.initialize(mx.init.Xavier(), ctx=ctx)
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.05, "momentum": 0.9},
                       kvstore="tpu_sync", update_on_kvstore=False)
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.normal(0, 1, (32, 16)).astype("f"), ctx=ctx)
    y = mx.nd.array(rs.normal(0, 1, (32, 1)).astype("f"), ctx=ctx)
    return net, gluon.loss.L2Loss(), tr, x, y


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mxnet_tpu_torch.autotune")
    ap.add_argument("--smoke", action="store_true",
                    help="small pinned-MLP sweep + decision round trip")
    ap.add_argument("--expect-cached", action="store_true",
                    help="fail unless the decision loads with zero "
                         "measured runs")
    ap.add_argument("--dir", default=None,
                    help="decision directory (default MXNET_AUTOTUNE_DIR)")
    ap.add_argument("--cpu", action="store_true",
                    help="tune on the CPU instead of gpu(0)")
    args = ap.parse_args(argv)
    if not args.smoke:
        ap.print_help()
        return 2
    if args.dir:
        os.environ["MXNET_AUTOTUNE_DIR"] = args.dir
    if os.environ.get("MXNET_AUTOTUNE_DIR"):
        os.environ.setdefault("MXNET_FLIGHT_DIR",
                              os.environ["MXNET_AUTOTUNE_DIR"])

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.autotune import decisions, sweep

    decisions.enable()
    t0 = time.time()
    out = {"ok": False, "expect_cached": bool(args.expect_cached)}
    try:
        ctx = mx.cpu() if args.cpu else mx.gpu(0)
        net, loss_fn, tr, x, y = _build(ctx)
        rec = sweep.tune(net, loss_fn, tr, x, y, ks=(2, 4), pairs=4,
                         bucket_candidates_mb=(8, 32), apply_env=False)
        if rec is None:
            raise RuntimeError("tune() returned no decision")
        out["sweep_runs"] = sweep.last_sweep_runs
        out["knobs"] = rec["knobs"]
        decisions.reset_cache()
        rt = decisions.load(rec["signature"])
        if decisions.decisions_dir() is not None:
            if rt is None or rt["knobs"] != rec["knobs"]:
                raise RuntimeError(f"decision round-trip mismatch: {rt!r}")
        if args.expect_cached and sweep.last_sweep_runs != 0:
            raise RuntimeError(
                f"expected a pure decision-cache hit but the tuner "
                f"performed {sweep.last_sweep_runs} measured runs")
        if not args.expect_cached and sweep.last_sweep_runs == 0:
            raise RuntimeError("first tune() performed zero measured "
                               "runs — the sweep never executed")
        out["ok"] = True
    except Exception as e:  # noqa: BLE001 — report, don't crash
        out["error"] = f"{type(e).__name__}: {e}"
    out["elapsed_s"] = round(time.time() - t0, 2)
    print(json.dumps(out, sort_keys=True))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
