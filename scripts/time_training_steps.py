#!/usr/bin/env python3
"""Time the xl and xl-d128 training steps of the `cuda` backend, repeatedly,
in f32, in speed mode (compute_dtype="bfloat16") and in one TF32 pass
(precision="default").

    python3 scripts/time_training_steps.py [REPEATS]

Run from the root of the checkout whose port it should time (it imports
that tree's ``chip_smoke`` and package), on a machine with one CUDA card;
from another tree's root it times that tree, so that two versions compare
within one call. For each width it builds the xl training step as
``chip_smoke.py`` phase 5 does, takes one warm-up step, then REPEATS
(default 5) times ``chip_smoke.TRAIN_STEPS`` steps on the host clock
between two synchronises, and prints each repeat's ms/step, their min and
median, mode by mode in turn on the same graph (a tree whose
``chip_smoke`` has no speed mode times f32 alone). ``chip_smoke.py``
reports one such sample, which host-side stalls on a shared machine can
inflate.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(repeats: int) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("time_training_steps.py: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()} | tree {Path.cwd()}", flush=True)
    cs.phase_build()
    modes = {"f32": None}
    if hasattr(cs, "SPEED"):
        modes.update({"bf16": cs.SPEED, "precision=default": cs.ONE_PASS})
    for width in (cs.WIDTH, 2 * cs.WIDTH):
        name = "xl" if width == cs.WIDTH else f"xl-d{width}"
        feats_np, ei, etexts, _ = cs.xl_edges(width=width)
        graph = cs.encode(ei, etexts)
        init = cs.init_hypergnn(cs.train_config(width=width), torch.Generator().manual_seed(0))
        for label, mode in modes.items():
            extra = {} if mode is None else {"mode": mode}
            run, _ = cs._trainer(graph, feats_np, init, "cuda", dev, width, **extra)
            run()
            torch.cuda.synchronize()
            samples = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                for _ in range(cs.TRAIN_STEPS):
                    run()
                torch.cuda.synchronize()
                samples.append((time.perf_counter() - t0) / cs.TRAIN_STEPS * 1e3)
            print(f"training {name} {label}: ms/step over {cs.TRAIN_STEPS} steps, "
                  f"{repeats} repeats: {', '.join(f'{s:.3f}' for s in samples)} | "
                  f"min {min(samples):.3f} median {statistics.median(samples):.3f}",
                  flush=True)
            del run
            torch.cuda.empty_cache()
        del graph, init
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 5))
