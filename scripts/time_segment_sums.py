#!/usr/bin/env python3
"""Time kernels 1 and 7 (the CSR segment-sums) at the xl layout, repeatedly.

    python3 scripts/time_segment_sums.py [REPEATS]

Run from the root of the checkout whose port it should time (it imports
that tree's ``chip_smoke`` and package), on a machine with one CUDA card;
from another tree's root it times that tree, so that two versions compare
within one call (parent, change, change, parent). At d=64 and 128, in f32
and on bf16 rows, it times the wrapper of kernel 1 over the dst-sorted
rows (``SortPlan.dst_splits``, node 0's pad segment included), kernel 1 at
the dbias shape of kernel 2's backward (``SortPlan.rel_splits``: 240
segments of ~4,300 rows) and kernel 7 over the src- and dst-sorted bounds:
REPEATS (default 3) CUDA-event means of 20 back-to-back calls each
(``chip_smoke.cuda_ms``), then their min and median.
"""

from __future__ import annotations

import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(repeats: int) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("time_segment_sums.py: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()} | tree {Path.cwd()}", flush=True)
    cs.phase_build()
    g = cs._kernel_graph()
    plan = g.sort_plan.to(dev)
    n, u_pad, e_rows = cs.XL_N, g.char_ids.shape[0], g.rel_ids.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    k1, k7 = cs.kernels.csr_segment_sum, cs.kernels.dual_sorted_segment_sum
    for d in (64, 128):
        xa, xb = (torch.randn(e_rows, d, device=dev, generator=gen) for _ in range(2))
        for dtype in (torch.float32, torch.bfloat16):
            a, b = xa.to(dtype), xb.to(dtype)
            for label, call in (
                ("kernel 1, dst_splits", lambda: k1(b, plan.dst_splits, n)),
                ("kernel 1, dbias (rel_splits)", lambda: k1(b, plan.rel_splits, u_pad)),
                ("kernel 7, src_splits + dst_splits",
                 lambda: k7(a, b, n, plan.src_splits, plan.dst_splits)),
            ):
                ms = [cs.cuda_ms(call) for _ in range(repeats)]
                print(f"{label} d={d} {str(dtype).removeprefix('torch.')}: ms "
                      f"{', '.join(f'{t:.4f}' for t in ms)} | min {min(ms):.4f} "
                      f"median {statistics.median(ms):.4f}", flush=True)
        del xa, xb
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 3))
