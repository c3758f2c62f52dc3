"""Offline run reporter: render a run summary from the crash-durable
journal (+ flight dumps) — ``python -m mxnet_tpu_torch.observability.report
<run_dir>`` (parity: ``mxnet_tpu/observability/report.py``; the journal
format is shared, so it reads a journal that either package wrote).

The journal (``journal.py``) is written to survive the process; this is
the tool that reads it afterwards.  It answers the operator's morning
questions without a live process to scrape: what run is this, how many
times did it (re)start, what fraction of wall-clock was goodput, how
often did the supervisor retry/rewind/stall, what was the checkpoint
cadence, where did MFU trend, and which post-mortem/flight dumps hold
the detail.  ``--diff`` renders two runs side by side (the
before/after-a-fix view); ``--json`` emits the machine-readable summary
for dashboards.

The module itself touches only the standard library — summarizing a
dead run must not require the runtime the run used.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional

__all__ = ["load_journal", "summarize_run", "render", "render_diff",
           "find_run_dir", "main"]

#: events the timeline section renders, in severity order
_TIMELINE_EVENTS = ("supervisor_retry", "supervisor_divergence",
                    "supervisor_stall", "post_mortem", "oom",
                    "preempted", "slo_burn", "perf_regression",
                    "serve_degradation")


def find_run_dir(path: str) -> str:
    """Accept a run dir (holds ``journal*.jsonl``) or a parent of run
    dirs (newest journal wins) — ``make report`` points at the parent."""
    if glob.glob(os.path.join(path, "journal*.jsonl")):
        return path
    candidates = glob.glob(os.path.join(path, "*", "journal.jsonl"))
    if not candidates:
        raise FileNotFoundError(
            f"no journal.jsonl under {path!r} (is MXNET_RUN_DIR set for "
            "the runs you want reported?)")
    return os.path.dirname(max(candidates, key=os.path.getmtime))


def load_journal(run_dir: str) -> List[dict]:
    """Every parseable journal entry, rotation-aware (``journal.1`` is
    the older generation), in write order.  Torn tails — the SIGKILL
    case the journal exists for — are skipped, not fatal."""
    entries: List[dict] = []
    for fname in ("journal.1.jsonl", "journal.jsonl"):
        fpath = os.path.join(run_dir, fname)
        if not os.path.exists(fpath):
            continue
        with open(fpath, "r", encoding="utf-8") as f:
            for raw in f:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    e = json.loads(raw)
                except ValueError:
                    continue  # torn line (crash mid-write)
                if isinstance(e, dict) and "event" in e:
                    entries.append(e)
    return entries


def _last_goodput(entries: List[dict]) -> Optional[dict]:
    """The most recent goodput view in the journal (milestones embed
    ``goodput_pct`` + per-class seconds)."""
    for e in reversed(entries):
        if e.get("classes") is not None:
            return {"goodput_pct": e.get("goodput_pct"),
                    "classes": e.get("classes")}
    return None


def summarize_run(run_dir: str) -> dict:
    """The machine-readable run summary the renderers (and tests)
    consume."""
    entries = load_journal(run_dir)
    if not entries:
        raise FileNotFoundError(f"journal under {run_dir!r} is empty")
    starts = [e for e in entries if e["event"] == "process_start"]
    times = [e["t"] for e in entries if isinstance(e.get("t"), (int, float))]
    counts: Dict[str, int] = {}
    for e in entries:
        counts[e["event"]] = counts.get(e["event"], 0) + 1
    # downtime between incarnations: last entry of one process to the
    # process_start of the next — reported beside the taxonomy (the
    # dead process could not meter its own absence)
    downtime = 0.0
    for s in starts[1:]:
        prior = [t for t in times if t < s["t"]]
        if prior:
            downtime += max(0.0, s["t"] - max(prior))
    milestones = [e for e in entries if e["event"] == "milestone"]
    saves = [e for e in entries if e["event"] == "checkpoint_save"]
    save_steps = [e.get("step") for e in saves if e.get("step") is not None]
    cadence = None
    if len(save_steps) >= 2:
        cadence = (save_steps[-1] - save_steps[0]) / (len(save_steps) - 1)
    timeline = [
        {"t": e.get("t"), "event": e["event"], "step": e.get("step"),
         "detail": {k: v for k, v in e.items()
                    if k not in ("t", "event", "run", "pid", "step")}}
        for e in entries if e["event"] in _TIMELINE_EVENTS]
    mfu = [{"step": e.get("step"), "mfu": e.get("mfu")}
           for e in milestones if e.get("mfu") is not None]
    dumps = [e.get("dump_path") for e in entries
             if e["event"] == "flight_dump"]
    return {
        "run_dir": os.path.abspath(run_dir),
        "run_id": starts[0].get("run") if starts else
                  entries[0].get("run"),
        "incarnations": len(starts),
        "resumes": counts.get("run_resumed", 0),
        "wall_s": (max(times) - min(times)) if len(times) > 1 else 0.0,
        "downtime_s": downtime,
        "entries": len(entries),
        "event_counts": counts,
        "goodput": _last_goodput(entries),
        "last_step": max((e.get("step") for e in entries
                          if e.get("step") is not None), default=None),
        "checkpoint": {"saves": len(saves), "steps": save_steps,
                       "cadence_steps": cadence},
        "timeline": timeline,
        "mfu_trajectory": mfu,
        "flight_dumps": dumps,
    }


def _fmt_s(x: Optional[float]) -> str:
    return "-" if x is None else f"{x:.1f}s"


def render(s: dict) -> str:
    """Human-readable run summary."""
    lines = [
        f"run {s['run_id']}  ({s['run_dir']})",
        f"  incarnations: {s['incarnations']}  resumes: {s['resumes']}  "
        f"wall: {_fmt_s(s['wall_s'])}  restart downtime: "
        f"{_fmt_s(s['downtime_s'])}",
        f"  journal entries: {s['entries']}  last step: {s['last_step']}",
    ]
    g = s.get("goodput")
    if g and g.get("classes"):
        lines.append(f"  goodput: {g.get('goodput_pct', 0.0):.1f}%")
        for cls, b in sorted(g["classes"].items(),
                             key=lambda kv: -kv[1].get("seconds", 0.0)):
            lines.append(f"    {cls:<18} {b.get('seconds', 0.0):8.2f}s  "
                         f"({b.get('events', 0)} events)")
    else:
        lines.append("  goodput: (no milestone carried a ledger — "
                     "MXNET_GOODPUT off or run too short)")
    ck = s["checkpoint"]
    lines.append(f"  checkpoints: {ck['saves']} saves"
                 + (f", cadence ~{ck['cadence_steps']:.0f} steps"
                    if ck["cadence_steps"] else "")
                 + (f", steps {ck['steps']}" if ck["steps"] else ""))
    if s["mfu_trajectory"]:
        pts = "  ".join(f"{p['step']}:{p['mfu']:.3f}"
                        for p in s["mfu_trajectory"][-8:])
        lines.append(f"  mfu trajectory (step:mfu): {pts}")
    if s["timeline"]:
        lines.append(f"  incidents ({len(s['timeline'])}):")
        for e in s["timeline"][-20:]:
            d = ", ".join(f"{k}={v}" for k, v in e["detail"].items()
                          if v is not None)
            lines.append(f"    [{e['event']}] step={e['step']}"
                         + (f"  {d}" if d else ""))
    else:
        lines.append("  incidents: none")
    if s["flight_dumps"]:
        lines.append(f"  flight dumps: {len(s['flight_dumps'])} "
                     f"(latest: {s['flight_dumps'][-1]})")
    return "\n".join(lines)


def render_diff(a: dict, b: dict) -> str:
    """Two runs side by side: the before/after-a-fix comparison."""
    def _g(s, key, default=0.0):
        g = s.get("goodput") or {}
        return g.get(key) or default

    rows = [("run", a["run_id"], b["run_id"]),
            ("incarnations", a["incarnations"], b["incarnations"]),
            ("wall_s", f"{a['wall_s']:.1f}", f"{b['wall_s']:.1f}"),
            ("goodput_pct", f"{_g(a, 'goodput_pct'):.1f}",
             f"{_g(b, 'goodput_pct'):.1f}"),
            ("last_step", a["last_step"], b["last_step"]),
            ("checkpoint saves", a["checkpoint"]["saves"],
             b["checkpoint"]["saves"]),
            ("incidents", len(a["timeline"]), len(b["timeline"]))]
    classes = sorted(set((a.get("goodput") or {}).get("classes") or {})
                     | set((b.get("goodput") or {}).get("classes") or {}))
    for cls in classes:
        ca = ((a.get("goodput") or {}).get("classes") or {}).get(cls, {})
        cb = ((b.get("goodput") or {}).get("classes") or {}).get(cls, {})
        rows.append((f"  {cls}_s", f"{ca.get('seconds', 0.0):.2f}",
                     f"{cb.get('seconds', 0.0):.2f}"))
    w = max(len(str(r[0])) for r in rows)
    out = [f"{'':<{w}}  {'run A':>24}  {'run B':>24}"]
    out += [f"{str(k):<{w}}  {str(va):>24}  {str(vb):>24}"
            for k, va, vb in rows]
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.observability.report",
        description="Render a run summary from a crash-durable run "
                    "journal (MXNET_RUN_DIR)")
    ap.add_argument("run_dir", help="run dir with journal.jsonl, or a "
                                    "parent dir (newest run wins)")
    ap.add_argument("--diff", metavar="RUN_DIR2",
                    help="second run dir: render both side by side")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the machine-readable summary")
    args = ap.parse_args(argv)
    try:
        a = summarize_run(find_run_dir(args.run_dir))
        if args.diff:
            b = summarize_run(find_run_dir(args.diff))
            if args.as_json:
                print(json.dumps({"a": a, "b": b}, indent=2, default=str))
            else:
                print(render_diff(a, b))
        elif args.as_json:
            print(json.dumps(a, indent=2, default=str))
        else:
            print(render(a))
    except FileNotFoundError as e:
        print(f"report: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
