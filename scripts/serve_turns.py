#!/usr/bin/env python3
"""Serve full moonshot from chip_smoke.py of several checkouts in turns, on
one card, to compare their steps within one call.

    python3 scripts/serve_turns.py PARENT_ROOT CHANGE_ROOT [--order PCCPPCCP]

Each letter of --order is one turn: P runs the first checkout, C the
second, each in a fresh process started in that checkout (its
chip_smoke.py and src/, its kernels built into its own .torch_ext_build
on its first turn).  A turn runs chip_smoke.py's phase_serve_moe: run M
(contiguous), the whole-prompt Model.prefill of request 0, and run MP
(paged, 25 pages), with that phase's own checks.  The table reads the
phase's own lines: M's and MP's prefill-step and decode-tick medians
and, where the checkout's phase times it, the whole prefill on the CUDA
binding (host clock, synchronized, median of 3; "—" where it does not).
Host-clock step times spread widely between runs on one machine, so the
turns alternate and the table gives every turn.  Needs one Hopper card.
"""

import argparse
import re
import subprocess
import sys
from pathlib import Path

TURN = """
import sys
import torch
sys.path.insert(0, "src")
import chip_smoke as c

torch.backends.cuda.matmul.allow_tf32 = False
c.phase_build()
c.phase_serve_moe(torch)
"""
STEP = re.compile(r"\[serve\] (M|MP) \S+[^:]*: (prefill|decode) step .*?median ([\d.]+) ms")
WHOLE = re.compile(r"\[moe-serve\] Model\.prefill of request 0 .*?CUDA binding ([\d.]+) ms")


def turn(root: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", TURN], cwd=root, capture_output=True,
                         text=True, timeout=1200)
    if out.returncode:
        raise SystemExit(f"turn in {root} failed (rc {out.returncode}):\n{out.stdout[-3000:]}"
                         f"\n{out.stderr[-3000:]}")
    got = {f"{run} {kind}": float(ms) for run, kind, ms in STEP.findall(out.stdout)}
    whole = WHOLE.search(out.stdout)
    got["whole prefill"] = float(whole.group(1)) if whole else None
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--order", default="PCCPPCCP")
    args = ap.parse_args()
    roots = {"P": args.parent.resolve(), "C": args.change.resolve()}
    cols = ("M prefill", "M decode", "MP prefill", "MP decode", "whole prefill")
    print("turn | " + " | ".join(f"{c} ms" for c in cols), flush=True)
    for i, side in enumerate(args.order):
        got = turn(roots[side])
        print(f"{side}{i + 1} | " + " | ".join("—" if got.get(c) is None else f"{got[c]:.1f}"
                                              for c in cols), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
