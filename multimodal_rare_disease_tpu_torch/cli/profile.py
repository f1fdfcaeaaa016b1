"""Where the time of `predict_batch` goes on the card, by torch.profiler.

    python -m multimodal_rare_disease_tpu_torch.cli.profile \\
        [--preset efficientnet_clinicalbert] \\
        [--set text_encoder.fused_attn_out=true --set data.image_size=256]
    python -m multimodal_rare_disease_tpu_torch.cli.profile --entry

Builds the full-width model of the resolved config from seeded weights
in its compute dtype on the card, and the seeded batch of
`inference/seeded_batch.py` that chip_smoke.py drives too (uint8 images
at 256 px, built-in clinical descriptions varied by the augmenter),
B = 256. After two warm-up calls
it profiles three calls and prints, per call: the wall time, the
device's busy time (the kernels' self time) and idle share, the device
time of every kernel, and the device time by operator and input shape
down to 0.05 ms (which separates, say, the copy that reshapes the
attention context from the other copies). The first line names the card
and its power limit. With `--entry` it profiles the forward of
`entry.py`'s `entry()` (B = 8 at the default config) instead, each
call ending in a copy of the probabilities to the host. It runs on the
card only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

BATCH = 256
CALLS = 3
MIN_OP_MS = 0.05  # operator rows below this are not printed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--preset", default="default",
                        help="config preset (default: default)")
    parser.add_argument("--set", action="append", default=[],
                        metavar="KEY=JSON", help="config override")
    parser.add_argument("--entry", action="store_true",
                        help="profile the forward of entry.py's entry()")
    args = parser.parse_args(argv)
    if args.entry and (args.set or args.preset != "default"):
        parser.error("--entry runs the default config")

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        MultimodalPredictor,
    )
    from multimodal_rare_disease_tpu_torch.inference.seeded_batch import (
        seeded_requests,
    )
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )

    over = {}
    for item in args.set:
        key, _, value = item.partition("=")
        over[key] = json.loads(value)
    if args.entry:
        from multimodal_rare_disease_tpu_torch.entry import entry

        forward, inputs = entry()
        batch = inputs[1].shape[0]

        def call():
            return forward(*inputs).cpu()
    else:
        cfg = resolve_config(args.preset, over)
        pred = MultimodalPredictor(cfg, create_model(cfg, device="cpu",
                                                     seed=0))
        images, texts = seeded_requests(BATCH, seed=0)
        batch = BATCH

        def call():
            return pred.predict_batch(images, texts)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    for _ in range(2):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / CALLS

    n = CALLS
    kernels = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:  # kernels and copies only
            kernels[evt.key] += evt.self_device_time_total / 1e3 / n
    busy = sum(kernels.values())
    what = "entry() forward" if args.entry else f"config overrides {over}"
    print(f"{card} | {what} | B={batch}, {n} calls: "
          f"wall {wall_ms:.2f} ms/call, device busy {busy:.2f} ms/call, "
          f"idle {1 - busy / wall_ms:.1%}")
    print("device ms/call by kernel:")
    for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f}  {key[:110]}")
    print("device ms/call by operator and input shapes (with children):")
    ops = sorted(((e.device_time_total / 1e3 / n, e.key, e.input_shapes)
                  for e in prof.key_averages(group_by_input_shape=True)
                  if e.key.startswith("aten::") and e.device_time_total > 0),
                 key=lambda r: -r[0])
    for ms, key, shapes in (r for r in ops if r[0] >= MIN_OP_MS):
        print(f"  {ms:9.3f}  {key} {str(shapes)[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
