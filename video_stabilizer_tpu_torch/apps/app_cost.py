#!/usr/bin/env python
"""Run one of the port's apps in this process and print what it cost: its
wall time, the time spent in chosen module-level functions of the app
(each call synchronized), the card's peak memory, and each program's
captures, replays and evictions.

    python video_stabilizer_tpu_torch/apps/app_cost.py [--root DIR]
        [--time NAME ...] APP [-- APP ARGS]

APP names a module of ``video_stabilizer_tpu_torch.apps`` (for example
``grid_search_smoother``); the arguments after ``--`` go to its
``main()``. ``--root`` imports the package from another checkout, so that
two commits' apps run through the same measurement. The last line of the
output is one JSON object with the figures.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys
import time


def card_name() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_calls(fn, sync, record):
    """``fn`` with each call's host seconds, from a synchronized start to
    the device's end of its work, appended to ``record``."""
    def run(*args, **kw):
        sync()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync()
        record.append(time.perf_counter() - t0)
        return out
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--root", help="checkout to import the package from "
                    "(default: the one holding this script)")
    ap.add_argument("--time", action="append", default=[],
                    help="a module-level function of the app to time")
    ap.add_argument("app")
    ap.add_argument("app_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.abspath(args.root or os.path.join(here, "..", ".."))
    # Run as a file, this script's directory leads sys.path: the root
    # takes its place.
    if sys.path and os.path.abspath(sys.path[0]) == here:
        sys.path.pop(0)
    sys.path.insert(0, root)

    import torch

    app = importlib.import_module(
        f"video_stabilizer_tpu_torch.apps.{args.app}")
    from video_stabilizer_tpu_torch.utils import graphs

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    times, saved = {}, {}
    for name in args.time:
        times[name], saved[name] = [], getattr(app, name)
        setattr(app, name, timed_calls(saved[name], sync, times[name]))
    app_args = args.app_args[1:] if args.app_args[:1] == ["--"] \
        else args.app_args
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        app.main(app_args)
        sync()
    finally:
        for name, fn in saved.items():
            setattr(app, name, fn)
    wall = time.perf_counter() - t0
    result = dict(
        app=args.app, root=root, args=app_args, wall_s=wall,
        timed={n: dict(calls=len(t), total_s=sum(t), each_s=t)
               for n, t in times.items()},
        programs={p.name: dict(captures=p.captures, replays=p.replays,
                               evictions=getattr(p, "evictions", None))
                  for p in graphs.PROGRAMS if p.captures or p.replays},
        device=card_name() if cuda else "cpu")
    if cuda:
        result.update(
            max_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
            max_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
            reserved_at_end_gb=torch.cuda.memory_reserved() / 1e9)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
