#!/usr/bin/env python3
"""Time kernels 1 and 7 (the CSR segment-sums) at the xl layout, repeatedly.

    python3 scripts/time_segment_sums.py [REPEATS]

Run from the root of the checkout whose port it should time (it imports
that tree's ``chip_smoke`` and package), on a machine with one CUDA card;
from another tree's root it times that tree, so that two versions compare
within one call (parent, change, change, parent). At d=64 and 128, in f32,
on bf16 rows and in ``mode="fast"``, it times the wrapper of kernel 1 over
the dst-sorted rows (``SortPlan.dst_splits``, node 0's pad segment
included), kernel 1 at the dbias shape of kernel 2's backward
(``SortPlan.rel_splits``: 240 segments of ~4,300 rows) and kernel 7 over
the src- and dst-sorted bounds. Then, in f32 at d=64, kernel 1 on the four
reductions of the composed step's first shard at k=4 (the xl halo layout,
group-padded per shard): the aggregation over the shard's nodes, the dst
and src gathers' cotangents over its [local ++ halo] rows (long runs of
empty segments) and dbias, and kernel 7 over that cotangent pair. Each line: REPEATS (default 3) CUDA-event means
of 20 back-to-back calls each (``chip_smoke.cuda_ms``), then their min and
median, then the kernel alone (torch.profiler's device time of
``csr_segment_sum_kernel`` over 20 calls, ``chip_smoke.kernel_ms``): the
wrapper's host work can outlast a call of a few dozen microseconds.
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

    def report(label, call):
        ms = [cs.cuda_ms(call) for _ in range(repeats)]
        alone = cs.kernel_ms(call, "csr_segment_sum_kernel", calls=20)
        print(f"{label}: ms {', '.join(f'{t:.4f}' for t in ms)} | min {min(ms):.4f} "
              f"median {statistics.median(ms):.4f} | kernel alone {alone:.4f}", flush=True)

    for d in (64, 128):
        xa, xb = (torch.randn(e_rows, d, device=dev, generator=gen) for _ in range(2))
        for form, dtype, mode in (("float32", torch.float32, "exact"),
                                  ("bfloat16", torch.bfloat16, "exact"),
                                  ("fast", torch.float32, "fast")):
            a, b = xa.to(dtype), xb.to(dtype)
            report(f"kernel 1, dst_splits d={d} {form}",
                   lambda: k1(b, plan.dst_splits, n, mode))
            report(f"kernel 1, dbias (rel_splits) d={d} {form}",
                   lambda: k1(b, plan.rel_splits, u_pad, mode))
            report(f"kernel 7, src_splits + dst_splits d={d} {form}",
                   lambda: k7(a, b, n, plan.src_splits, plan.dst_splits, mode))
        del xa, xb
        torch.cuda.empty_cache()

    k = 4
    feats_np, xl = cs.xl_graph()
    inputs = cs.prepare_composed_inputs(xl, feats_np, k, halo=True, rel_sort_local=True,
                                        group_pad=256)
    cap, npp = inputs.src.shape[0] // k, inputs.nodes_per_shard
    rows = npp + k * inputs.halo_width
    x, x2 = (torch.randn(cap, cs.WIDTH, device=dev, generator=gen) for _ in range(2))
    for name, (splits, segments) in {
        "aggregation": (inputs.kernel_dst_splits[0], npp),
        "dst_cotangent": (inputs.kernel_dst_splits[0], rows),
        "src_cotangent": (inputs.kernel_src_splits[0], rows),
        "dbias": (inputs.kernel_rel_splits[0], inputs.char_ids.shape[0]),
    }.items():
        sp = torch.as_tensor(splits, device=dev)
        empty = int((splits[1: segments + 1] == splits[:segments]).sum())
        report(f"kernel 1, composed k={k} shard 0 {name} ({cap} rows, {segments} segments, "
               f"{empty} empty) d={cs.WIDTH} float32", lambda: k1(x, sp, segments))
    sa, sb = (torch.as_tensor(a, device=dev)
              for a in (inputs.kernel_src_splits[0], inputs.kernel_dst_splits[0]))
    report(f"kernel 7, composed k={k} shard 0 src + dst cotangents ({cap} rows a stream, "
           f"{rows} segments) d={cs.WIDTH} float32", lambda: k7(x, x2, rows, sa, sb))
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 3))
