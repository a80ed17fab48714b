"""Readings that the limits of ``gsbench/limits/scaffold-m360.train.json`` are
set from.

    python3 gsbench/calibrate_scaffold.py --seeds 11 12 ... [--control 2]

For each seed: the cell's set-up and a short window (the timed path, at the
cell's own size), then, with the program's state freed, the comparison with
the float32 reference: the program's reading. For the first ``--control``
seeds also

* the control: the program again from the same seed, its decode's forward
  with TF32 matrix products (``allow_tf32``), against the same reference;
* two faults planted in the reference and put in the program's place: the
  view distance dropped from the heads' input, and each check step shown
  the next check step's view.

Each reading is one JSON line on standard output. The benchmark's runs do
not run this; it needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "scaffold-m360.train"


@contextlib.contextmanager
def tf32_decode():
    """The program's ``decode_scaffold`` with TF32 matrix products."""
    import torch

    from gaustudio_torch.pipelines import train_scaffold as TS

    plain = TS.decode_scaffold

    def decode(*args, **kwargs):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return plain(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    TS.decode_scaffold = decode
    try:
        yield
    finally:
        TS.decode_scaffold = plain


@contextlib.contextmanager
def no_distance():
    """The reference's heads read a zero view distance."""
    import torch

    from gsbench.reference import scaffold as R

    plain = R.head_input

    def head_input(anchor, feat, campos):
        x = plain(anchor, feat, campos)
        return torch.cat([x[:, :-1], torch.zeros_like(x[:, -1:])], dim=1)

    R.head_input = head_input
    try:
        yield
    finally:
        R.head_input = plain


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.environ["USE_FLAX"] = "0"
    import torch

    from gsbench import run as harness

    spec = harness.cell_spec(harness._json(os.path.join(ROOT, "BENCHMARK.json")), CELL)
    if not torch.cuda.is_available():
        print("calibrate_scaffold: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    from gaustudio_torch.utils import kernels

    kernels.load()
    driver = harness._load(os.path.join(ROOT, "gsbench", "drivers", "train_scaffold.py"),
                           "gsbench_driver")

    def driven(seed, seconds):
        run = driver.Run(spec["config"], spec["traffic"], seed, device)
        run.setup()
        if seconds:
            run.window(seconds)
        run.release()
        gc.collect()
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return run

    def say(seed, what, numbers):
        print(json.dumps({"cell": CELL, "seed": seed, "what": what, **numbers}), flush=True)

    for n, seed in enumerate(args.seeds):
        run = driven(seed, args.seconds)
        ref = run.reference()
        say(seed, "program", run.compare(ref))
        if n < args.control:
            with tf32_decode():
                control = driven(seed, 0)
            say(seed, "control_tf32", control.compare(ref))
            del control
            with no_distance():
                run.adopt(run.reference())
            say(seed, "fault_no_distance", run.compare(ref))
            views = run.prog["views"]
            run.prog["views"] = views[1:] + views[:1]
            wrong = run.reference()
            run.adopt(wrong)
            run.prog["views"] = views
            say(seed, "fault_wrong_view", run.compare(ref))
        del run, ref
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
