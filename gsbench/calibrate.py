"""Readings that the limits of ``gsbench/limits/<cell>.json`` are set from.

    python3 gsbench/calibrate.py --workload <cell> --seeds 11 12 ... [--control 3]

For each seed: the cell's set-up and a short window (the timed path, at
the cell's own size and load), then, with the program's state freed, the
comparison with the float32 reference: the program's reading. For the
first ``--control`` seeds also

* the control: the reference with its rasterizer in bfloat16 put in the
  program's place (mixed precision: the loss and Adam stay float32);
* a fault planted in the reference put in the program's place: training,
  the loss of half the image (the top rows), the mean taken over it;
  render, each sampled view answered with the next sampled view's frame;
  mesh, the last fused view left out of the fusion.

Each reading is one JSON line on standard output. The benchmark's runs do
not run this; it needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def half_image_loss(loss_of):
    """``loss_of`` over the top half of the image only."""
    def cropped(out, gt, cfg):
        h = gt.shape[0] // 2
        return loss_of({k: v[:h] for k, v in out.items()}, gt[:h], cfg)
    return cropped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--raw", action="store_true",
                    help="also print the program's and the reference's training readings")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.environ["USE_FLAX"] = "0"
    import torch

    from gsbench import run as harness
    from gsbench.reference import train as RT

    spec = harness.cell_spec(harness._json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    from gaustudio_torch.utils import kernels

    kernels.load()
    driver = harness._load(os.path.join(ROOT, "gsbench", "drivers",
                                        spec["traffic"]["driver"] + ".py"), "gsbench_driver")
    kind = spec["traffic"]["driver"]
    for n, seed in enumerate(args.seeds):
        run = driver.Run(spec["config"], spec["traffic"], seed, device)
        run.setup()
        run.window(args.seconds)
        run.release()
        gc.collect()
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref = run.reference()
        print(json.dumps({"cell": args.workload, "seed": seed, "what": "program",
                          **run.compare(ref)}), flush=True)
        if args.raw and kind == "train":
            print(json.dumps({"seed": seed, "program": run.prog, "reference": ref}), flush=True)
        if n >= args.control:
            continue
        run.adopt(run.reference(torch.bfloat16))
        print(json.dumps({"cell": args.workload, "seed": seed, "what": "control",
                          **run.compare(ref)}), flush=True)
        if kind == "train":
            saved, RT.loss_of = RT.loss_of, half_image_loss(RT.loss_of)
            try:
                run.adopt(run.reference())
            finally:
                RT.loss_of = saved
        elif kind == "render":
            order = run.sample[1:] + run.sample[:1]
            run.adopt({"frames": {i: ref["frames"][j] for i, j in zip(run.sample, order)}})
        else:
            cams, run.cams = run.cams, run.cams[:-1]
            run.adopt(run.reference())
            run.cams = cams
        print(json.dumps({"cell": args.workload, "seed": seed, "what": "fault",
                          **run.compare(ref)}), flush=True)
        del run, ref
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
