#!/usr/bin/env python3
"""Time variants of kernels 2, 3, 5 and 6 side by side at the xl shapes.

    python3 scripts/tune_edge_kernels.py [--only SOURCE ...] [CSRC_DIR ...]

Run from the root of a checkout on a machine with one CUDA card and nvcc.
Each variant is a copy of ``graph_hypernetwork_forge_tpu_torch/csrc/``
under ``build/variants/`` with a few lines of a kernel source changed (the
first place each line occurs), built with the port's nvcc flags; the
wrappers then launch it in place of the built-in library.
``edge_transform.cu`` holds kernels 2 and 5, so each of its variants
times both. Variants named "ablation: ..." leave out part of the work (the
products, the row loads) to show where the time goes, so their errors are
large; kernels 2, 3, 5 and 6 are also timed in their one-TF32-pass mode
(precision="default") and in their bf16 form. The ablations and the
k-loop variants edit the f32 bodies, which come first in each source;
the variants named "bf16: ..." edit kernel 3's bf16 body. Kernels 3 and 6
are called with a run table built before the timing, as a SortPlan hands
it down on the main path.
Kernels 3 and 6 are timed against the library composition that computes
the same function: ``bmm`` per 256-row tile and ``index_add_`` of the tile
partials into their relations (and ``bmm`` alone). Each ``CSRC_DIR``
given (another tree's ``csrc/``, for example the parent commit's) is built
and timed as one more variant, source by source where its C interface is
the same as this tree's (else that source is skipped), so that two
versions compare within one call. Kernels 3 and 6 are also timed at other
run lengths than the SortPlan's (``RUN_TILES``, ``data/encoding.py``). ``--only`` keeps the named sources
(``edge_transform``, ``edge_transform_bwd``, ``segment_outer``). Every
line gives the best of three CUDA-event means of the wrapper (20 launches
each) and the max error against the plain version (kernels 3 and 6: scaled
by max(1, max|plain|)); each source build's call is also broken down by
kernel with torch.profiler; ptxas' registers, spills and stack of each
build come first. The chosen values are the sources' own.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.data.encoding import RUN_TILES  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.ops.cuda import build  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.ops.cuda import edge_transform as k2  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.ops.cuda import edge_transform_bwd as k3  # noqa: E402

# The package re-exports the function segment_outer under the module's name.
k6 = importlib.import_module("graph_hypernetwork_forge_tpu_torch.ops.cuda.segment_outer")

OUT = ROOT / "build" / "variants"
# The wrapper module of each source.
MODULES = {"edge_transform": k2, "edge_transform_bwd": k3, "segment_outer": k6}
C_FUNCTIONS = ("ghf_edge_transform", "ghf_edge_transform_bf16", "ghf_edge_transform_two",
               "ghf_edge_transform_two_bf16", "ghf_edge_transform_bwd",
               "ghf_edge_transform_bwd_bf16", "ghf_segment_outer", "ghf_segment_outer_bf16",
               "ghf_run_table")

K3_UNROLL = ("#pragma unroll 2\n        for (int kb = 0; kb < DOUT",
             "#pragma unroll 2\n        for (int kb = 0; kb < BM")
DX = "      // ---- 1. dx = g W^T: warps 2 (rows) x 4 (bank, 32 columns) ----------\n      {"
DW = "      // ---- 2. dW += X^T g: warps 4 (x_src^T, x_dst^T rows) x 2 (d_out) ---\n      {"
K3H_STAGES = "  static constexpr int kStages = 4;"
K3H_BLOCKS = "kMinBlocks = 1;"
K2_KSTEPS = "#pragma unroll 1\n    for (int ks = 0; ks < BK2 / 8; ++ks) {"
K6_KSTEPS = "#pragma unroll 2\n    for (int kb = 0; kb < BM; kb += 8) {"
VARIANTS = {
    "edge_transform_bwd": {
        "source": [],
        "k loops not unrolled": [(u, u.replace("unroll 2", "unroll 1")) for u in K3_UNROLL],
        "ablation: dx product only": [(DW, "      if (false) {")],
        "ablation: dW product only": [(DX, "      if (false) {")],
        "ablation: staging only, no products": [(DX, "      if (false) {"),
                                                (DW, "      if (false) {")],
        "ablation: products only, no row loads": [
            ("      if (s < chunks) load(s, s);", ""),
            ("        load(ch + kStages - 1, (ch + kStages - 1) % kStages);", "        ;")],
        "dW in groups of 2 n-tiles": [("constexpr int NG = 4; ", "constexpr int NG = 2; ")],
        "32-row chunks, two blocks an SM at d_out <= 64": [
            ("static constexpr int BM = 64;",
             "static constexpr int BM = DOUT <= 64 ? 32 : 64;"),
            ("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads, DOUT <= 64 ? 2 : 1)")],
        "bf16: 2 ring stages": [(K3H_STAGES, K3H_STAGES.replace("4;", "2;"))],
        "bf16: 3 ring stages": [(K3H_STAGES, K3H_STAGES.replace("4;", "3;"))],
        "bf16: 3 ring stages, two blocks an SM at d_out <= 64": [
            (K3H_STAGES, K3H_STAGES.replace("4;", "3;")),
            (K3H_BLOCKS, "kMinBlocks = DOUT == 64 ? 2 : 1;")],
        "bf16: dx stored from the accumulators": [(
            "  static constexpr bool kStageDx = true;",
            "  static constexpr bool kStageDx = false;")],
        "bf16: 2 ring stages, two blocks an SM at both widths": [
            (K3H_STAGES, K3H_STAGES.replace("4;", "2;")), (K3H_BLOCKS, "kMinBlocks = 2;")],
    },
    "edge_transform": {
        "source": [],
        "2 ring stages": [("constexpr int kStages2 = 3;", "constexpr int kStages2 = 2;")],
        "one block an SM": [("__launch_bounds__(kThreads2, 2)", "__launch_bounds__(kThreads2, 1)")],
        "2 n-tiles per group at d_out = 128": [(
            "constexpr int NG = kBN == 128 ? 1 : NT;",
            "constexpr int NG = kBN == 128 ? 2 : NT;")],
        "2 n-tiles per group at d_out = 64": [(
            "constexpr int NG = kBN == 128 ? 1 : NT;",
            "constexpr int NG = kBN == 128 ? 1 : 2;")],
        "K slices unrolled": [(K2_KSTEPS, K2_KSTEPS.replace("unroll 1", "unroll"))],
        "ablation: staging only, no products": [(
            K2_KSTEPS, K2_KSTEPS.replace("ks < BK2 / 8", "ks < 0"))],
        "ablation: products only, no row loads": [
            ("    if (s < chunks) load(s, s);", ""),
            ("      load(c + kStages2 - 1, (c + kStages2 - 1) % kStages2);", "      ;")],
    },
    "segment_outer": {
        "source": [],
        "3 ring stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
        "32-row chunks, 3 ring stages": [
            ("constexpr int BM = 64;", "constexpr int BM = 32;"),
            ("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
        "one block an SM": [("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;")],
        "three blocks an SM": [("constexpr int kMinBlocks = 2;",
                                "constexpr int kMinBlocks = 3;")],
        "8 warps (2 x 4), one block an SM": [
            ("constexpr int kWarpsN = 2;", "constexpr int kWarpsN = 4;"),
            ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;")],
        "8 warps (2 x 4), two blocks an SM": [
            ("constexpr int kWarpsN = 2;", "constexpr int kWarpsN = 4;")],
        "128 d_in columns a block (4 x 2 warps), one block an SM": [
            ("constexpr int CS = 64; ", "constexpr int CS = 128;"),
            ("constexpr int kWarpsM = 2; ", "constexpr int kWarpsM = 4; "),
            ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;")],
        "k loop unrolled by 4": [(K6_KSTEPS, K6_KSTEPS.replace("unroll 2", "unroll 4"))],
        "128-row chunks, one block an SM": [
            ("constexpr int BM = 64;", "constexpr int BM = 128;"),
            ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;")],
        "dW in groups of 2 n-tiles": [("NG = NW < 4 ? NW : 4;", "NG = NW < 2 ? NW : 2;")],
        "k loop not unrolled": [(K6_KSTEPS, K6_KSTEPS.replace("unroll 2", "unroll 1"))],
        "ablation: staging only, no products": [(
            K6_KSTEPS, K6_KSTEPS.replace("kb < BM", "kb < 0"))],
        "ablation: products only, no row loads": [
            ("    if (s < chunks) load(s, s);", ""),
            ("      load(ch + kStages - 1, (ch + kStages - 1) % kStages);", "      ;")],
    },
}
RUN_LENGTHS = (1, 2, 4, 8)


def c_interface(cu: Path) -> list[str]:
    """The ``extern "C"`` declarations of a source, whitespace folded."""
    text = cu.read_text()
    return [" ".join(m.split()) for m in re.findall(r'extern "C"[^{]*', text)]


def ptxas_summary(log: str) -> str:
    """``kernel<template args>: N registers, spill stores/loads, stack`` for
    each entry function in nvcc's ``-Xptxas=-v`` output."""
    out, name, frame = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"([a-z][a-z_]*_kernel)I(\w*?)EEv", m.group(1))
            name = (f"{k.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', k.group(2)))}>"
                    if k else m.group(1))
        elif "stack frame" in line:
            frame = line.strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers; {frame}")
    return " | ".join(out)


def start(source: str, name: str, subs, src_dir: Path = build.SOURCE_DIR
          ) -> tuple[Path, subprocess.Popen]:
    d = OUT / f"{source}-{len(list(OUT.glob(source + '-*')))}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src_dir, d)
    f = d / f"{source}.cu"
    text = f.read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{source} / {name}: {old!r} is not in the source")
        text = text.replace(old, new, 1)
    f.write_text(text)
    lib = d / f"lib{source}.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(d), "-o", str(lib), str(f)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)


def best_ms(fn) -> float:
    return min(cs.cuda_ms(fn) for _ in range(3))


def abs_err(got, want) -> float:
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    return max((a - b).abs().max().item() for a, b in zip(got, want))


def bf16_err(got, want) -> float:
    """Max error of bf16 outputs in bf16 ulps of the largest value."""
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    return max((a.float() - b.float()).abs().max().item()
               / (2.0**-7 * b.float().abs().max().item()) for a, b in zip(got, want))


def bf16_dx_err(got, want) -> float:
    """Kernel 3's bf16 form: the larger of dx's error in bf16 ulps of the
    largest value and dW's scaled f32 error."""
    return max(bf16_err(got[:2], want[:2]), scaled_err(got[2:], want[2:]))


def scaled_err(got, want) -> float:
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    return max(cs.scaled_err(a, b) for a, b in zip(got, want))


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=sorted(VARIANTS), default=sorted(VARIANTS))
    ap.add_argument("trees", nargs="*", help="other csrc/ directories to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_edge_kernels.py: torch.cuda.is_available() is false")
    print(f"card: {cs.card_line()}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    for old in OUT.iterdir():
        shutil.rmtree(old)
    jobs = {(src, name): start(src, name, subs)
            for src in args.only for name, subs in VARIANTS[src].items()}
    for tree in args.trees:
        tree = Path(tree).resolve()
        for src in args.only:
            if c_interface(tree / f"{src}.cu") != c_interface(build.SOURCE_DIR / f"{src}.cu"):
                print(f"tree {tree} / {src}: C interface differs, skipped", flush=True)
                continue
            jobs[(src, f"tree {tree}")] = start(src, f"tree {tree}", [], tree)
    libs = {}
    for key, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        print(f"build {key[0]} / {key[1]}: {ptxas_summary(log)}", flush=True)
        libs[key] = ctypes.CDLL(str(lib))
    # The wrappers' _lib() set the argument types; reuse them for each copy.
    for src in args.only:
        ref = MODULES[src]._lib()
        for (s, _), lib in libs.items():
            if s == src:
                for fn in C_FUNCTIONS:
                    if hasattr(ref, fn):
                        getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
                        getattr(lib, fn).restype = getattr(ref, fn).restype

    dev = torch.device("cuda")
    g = cs._kernel_graph()
    rel = torch.as_tensor(g.rel_ids, device=dev)
    e_rows, u_pad = g.rel_ids.shape[0], g.char_ids.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    own = {src: mod._lib for src, mod in MODULES.items()}
    for d in (64, 128):
        xs, xd, g_out = (torch.randn(e_rows, d, device=dev, generator=gen) for _ in range(3))
        wm, ws = (torch.randn(u_pad, d, d, device=dev, generator=gen) / d**0.5
                  for _ in range(2))
        bias = torch.randn(u_pad, d, device=dev, generator=gen)
        fwd = (xs, xd, rel, wm, ws, bias)
        bwd = (g_out, xs, xd, rel, wm, ws)
        outer = (xs, g_out, rel, u_pad)
        fwd_h, bwd_h, outer_h = (
            [t.bfloat16() if torch.is_tensor(t) and t.is_floating_point() else t for t in a]
            for a in (fwd, bwd, outer))
        # The run tables of the run length being timed, built before the
        # timing as a SortPlan's are.
        runs = {}
        plain2 = k2.edge_transform_sorted_combined_plain(*fwd)
        plain3 = k3.edge_transform_combined_bwd_plain(*bwd)
        plain5 = k2.edge_transform_sorted_plain(*fwd)
        plain6 = k6.segment_outer_plain(*outer)
        # (label, call, plain result, error) of each source's kernels.
        kernels_of = {
            "edge_transform": [
                ("kernel 2", lambda: k2.edge_transform_sorted_combined(*fwd),
                 plain2, abs_err),
                ("kernel 2, one TF32 pass",
                 lambda: k2.edge_transform_sorted_combined(*fwd, precision="default"),
                 plain2, abs_err),
                ("kernel 5", lambda: k2.edge_transform_sorted(*fwd), plain5, abs_err),
                ("kernel 5, one TF32 pass",
                 lambda: k2.edge_transform_sorted(*fwd, precision="default"),
                 plain5, abs_err),
                ("kernel 5, bf16", lambda: k2.edge_transform_sorted(*fwd_h),
                 k2.edge_transform_sorted_plain(*fwd_h), bf16_err),
            ],
            "edge_transform_bwd": [
                ("kernel 3", lambda: k3.edge_transform_combined_bwd(*bwd, runs=runs["k3"]),
                 plain3, scaled_err),
                ("kernel 3, one TF32 pass",
                 lambda: k3.edge_transform_combined_bwd(*bwd, precision="default",
                                                        runs=runs["k3"]),
                 plain3, scaled_err),
                ("kernel 3, bf16",
                 lambda: k3.edge_transform_combined_bwd(*bwd_h, runs=runs["k3"]),
                 k3.edge_transform_combined_bwd_plain(*bwd_h), bf16_dx_err),
            ],
            "segment_outer": [
                ("kernel 6", lambda: k6.segment_outer(*outer, runs=runs["k6"]), plain6,
                 scaled_err),
                ("kernel 6, one TF32 pass",
                 lambda: k6.segment_outer(*outer, precision="default", runs=runs["k6"]),
                 plain6, scaled_err),
                ("kernel 6, bf16", lambda: k6.segment_outer(*outer_h, runs=runs["k6"]),
                 k6.segment_outer_plain(*outer_h), scaled_err),
            ],
        }
        # The library compositions of kernels 3 and 6: bmm per tile, then
        # index_add_ of the tile partials into their relations.
        tiles = e_rows // 256
        tile_rel = rel[::256].long()
        g_t, xs_t, xd_t = (t.view(tiles, 256, d) for t in (g_out, xs, xd))
        w_t = torch.cat([wm, ws], dim=1)[tile_rel].transpose(1, 2).contiguous()
        x_t = torch.cat([xs_t, xd_t], dim=2).transpose(1, 2)

        def k3_library():
            dw = torch.zeros(u_pad, 2 * d, d, device=dev)
            return torch.bmm(g_t, w_t), dw.index_add_(0, tile_rel, torch.bmm(x_t, g_t))

        def k6_library():
            dw = torch.zeros(u_pad, d, d, device=dev)
            return dw.index_add_(0, tile_rel, torch.bmm(xs_t.transpose(1, 2), g_t))

        for label, call, bmm_alone in (
            ("kernel 3", k3_library, lambda: (torch.bmm(g_t, w_t), torch.bmm(x_t, g_t))),
            ("kernel 6", k6_library, lambda: torch.bmm(xs_t.transpose(1, 2), g_t)),
        ):
            print(f"{label} d={d} library, bmm + index_add_: {best_ms(call):.4f} ms; "
                  f"bmm alone {best_ms(bmm_alone):.4f} ms", flush=True)
        del g_t, xs_t, xd_t, w_t, x_t, k3_library, k6_library

        for (src, name), lib in libs.items():
            mod = MODULES[src]
            mod._lib = lambda lib=lib: lib
            # Kernels 3 and 6 walk runs of tiles: the source at every run
            # length, each variant at the SortPlan's.
            with_runs = src in ("edge_transform_bwd", "segment_outer")
            lengths = ((RUN_LENGTHS if name == "source" else (RUN_TILES,)) if with_runs
                       else (None,))
            for run_tiles in lengths:
                if with_runs:
                    runs["k3" if src == "edge_transform_bwd" else "k6"] = k3.run_table(
                        rel, u_pad, run_tiles)
                for label, call, want, err_of in kernels_of[src]:
                    err = err_of(call(), want)
                    ms = best_ms(call)
                    at = f", runs of {run_tiles} tiles" if with_runs else ""
                    print(f"{label} d={d} {name}{at}: {ms:.4f} ms, err {err:.2e}", flush=True)
                    if name == "source" and run_tiles in (None, RUN_TILES):
                        # Device time of one call by kernel.
                        cs.profile_device(f"{label} d={d} {name}", call, rows=8)
            mod._lib = own[src]
        del xs, xd, g_out, wm, ws, bias, fwd, bwd, outer, kernels_of, plain2, plain3
        del fwd_h, bwd_h, outer_h, plain5, plain6, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
