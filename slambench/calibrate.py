"""Readings that the limits of `correct` are set from: several seeds of
one cell in one process, each a full set-up and warm-up and a short
window, with the numbers of the program and of the control (the reference
in the next precision down, put in the program's place) side by side.

  python -m slambench.calibrate --workload <cell> --seeds 1 2 3 \\
      [--seconds 1] [--out FILE.jsonl]

One JSON line a seed: {"seed", "program": {number: value}, "control":
{...}, "control_judged" (the control's numbers against the cell's limits,
without `init_gap`, which the control fails whatever it computes),
"diag" and "diag_control" (each captured call's gaps by step and by
leaf), "wall_frames_per_s", "cycles"}. Needs the card; the benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m slambench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from .check import judge
    from .run import NoCard, cell_parts, require_cards, run
    try:
        require_cards(1)
    except NoCard as err:
        print(str(err), file=sys.stderr)
        return 2
    from .frames import FrameSource
    spec, cfg, traffic = cell_parts(args.workload)
    frames = FrameSource(traffic["sequence"], cfg["cam"], cfg["scale"],
                         traffic["render_frames"], "cuda")
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            res = run(args.workload, seed, args.seconds, False,
                      control=True, frames=frames)
            ctl = {k: v for k, v in res["control_numbers"].items()
                   if k != "init_gap"}
            _, ctl_lines = judge(ctl, spec.get("limits", {}),
                                 require_all=False)
            line = json.dumps({
                "workload": args.workload, "seed": seed,
                "program": res["numbers"], "control": res["control_numbers"],
                "control_judged": ctl_lines,
                "diag": res["diag"], "diag_control": res["diag_control"],
                "wall_frames_per_s": res["window"]["frames"]
                / res["window"]["seconds"], "cycles": res["cycles"],
                "failed": res["failed"]})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
