#!/usr/bin/env python3
"""Time variants of kernels 2 and 3 side by side at the xl shapes.

    python3 scripts/tune_edge_kernels.py [CSRC_DIR ...]

Run from the root of a checkout on a machine with one CUDA card and nvcc.
Each variant is a copy of ``graph_hypernetwork_forge_tpu_torch/csrc/``
under ``build/variants/`` with a few lines of a kernel source changed,
built with the port's nvcc flags; the wrapper then launches it in place of
the built-in library. Variants named "ablation: ..." leave out part of the
work (a product, the row loads, two of the three TF32 passes) to show where
the time goes, so their errors are large. Each ``CSRC_DIR`` given (another
tree's ``csrc/``, for example the parent commit's) is built and timed as
one more variant, so that two versions compare within one call. Kernel 3
is also timed at other run lengths (``RUN_TILES``). Every line gives the
best of three CUDA-event means of the wrapper (20 launches each) and the
max error against the plain version (kernel 3: scaled by max(1,
max|plain|)); ptxas' registers and spills of each build come first. The
chosen values are the sources' own.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.ops.cuda import build  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.ops.cuda import edge_transform as k2  # noqa: E402
from graph_hypernetwork_forge_tpu_torch.ops.cuda import edge_transform_bwd as k3  # noqa: E402

OUT = ROOT / "build" / "variants"
K3_UNROLL = ("#pragma unroll 2\n        for (int kb = 0; kb < DOUT",
             "#pragma unroll 2\n        for (int kb = 0; kb < BM")
DX = "      // ---- 1. dx = g W^T: warps 2 (rows) x 4 (bank, 32 columns) ----------\n      {"
DW = "      // ---- 2. dW += X^T g: warps 4 (x_src^T, x_dst^T rows) x 2 (d_out) ---\n      {"
K3_ONE_PASS = [
    ("tf32x3::mma3_tile<MX, NX>(acc, ahi, alo, bhi, blo);",
     "for (int i = 0; i < MX; ++i) for (int j = 0; j < NX; ++j) "
     "tf32x3::mma(acc[i][j], ahi[i], bhi[j]);"),
    ("tf32x3::mma3_tile<2, NG>(dw[q], ahi, alo, bhi, blo);",
     "for (int i = 0; i < 2; ++i) for (int j = 0; j < NG; ++j) "
     "tf32x3::mma(dw[q][i][j], ahi[i], bhi[j]);"),
]
VARIANTS = {
    "edge_transform_bwd": {
        "source": [],
        "k loops not unrolled": [(u, u.replace("unroll 2", "unroll 1")) for u in K3_UNROLL],
        "ablation: dx product only": [(DW, "      if (false) {")],
        "ablation: dW product only": [(DX, "      if (false) {")],
        "ablation: staging only, no products": [(DX, "      if (false) {"),
                                                (DW, "      if (false) {")],
        "ablation: one TF32 pass": K3_ONE_PASS,
        "ablation: products only, no row loads": [
            ("      if (s < chunks) load(s, s);", ""),
            ("        load(ch + kStages - 1, (ch + kStages - 1) % kStages);", "        ;")],
        "dW in groups of 2 n-tiles": [("constexpr int NG = 4; ", "constexpr int NG = 2; ")],
        "32-row chunks, two blocks an SM at d_out <= 64": [
            ("static constexpr int BM = 64;",
             "static constexpr int BM = DOUT <= 64 ? 32 : 64;"),
            ("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads, DOUT <= 64 ? 2 : 1)"),
            ("      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);",
             "      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\n"
             "  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,"
             " cudaSharedmemCarveoutMaxShared);")],
    },
    "edge_transform": {
        "source": [],
        "2 n-tiles per group at d_out = 128": [(
            "constexpr int NG = kBN == 128 ? 1 : NT;",
            "constexpr int NG = kBN == 128 ? 2 : NT;")],
        "2 n-tiles per group at d_out = 64": [(
            "constexpr int NG = kBN == 128 ? 1 : NT;",
            "constexpr int NG = kBN == 128 ? 1 : 2;")],
        "K slices unrolled": [(
            "#pragma unroll 1\n    for (int ks = 0;", "#pragma unroll\n    for (int ks = 0;")],
        "ablation: one TF32 pass": [(
            "tf32x3::mma3_tile<2, NG>(acc[q], ahi, alo, bhi, blo);",
            "for (int i = 0; i < 2; ++i) for (int j = 0; j < NG; ++j) "
            "tf32x3::mma(acc[q][i][j], ahi[i], bhi[j]);")],
    },
}


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
        text = text.replace(old, new)
    f.write_text(text)
    lib = d / f"lib{source}.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(d), "-o", str(lib), str(f)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)


def best_ms(fn) -> float:
    return min(cs.cuda_ms(fn) for _ in range(3))


def main(trees: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tune_edge_kernels.py: torch.cuda.is_available() is false")
    print(f"card: {cs.card_line()}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    for old in OUT.iterdir():
        shutil.rmtree(old)
    jobs = {(src, name): start(src, name, subs)
            for src, variants in VARIANTS.items() for name, subs in variants.items()}
    for tree in trees:
        for src in VARIANTS:
            jobs[(src, f"tree {tree}")] = start(src, f"tree {tree}", [], Path(tree).resolve())
    libs = {}
    for key, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        regs = [line.split(":", 1)[-1].strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
        print(f"build {key[0]} / {key[1]}: {' | '.join(regs)}", flush=True)
        libs[key] = ctypes.CDLL(str(lib))
    # The wrappers' _lib() set the argument types; reuse them for each copy.
    for src, wrapper in (("edge_transform", k2), ("edge_transform_bwd", k3)):
        ref = wrapper._lib()
        for (s, _), lib in libs.items():
            if s == src:
                for fn in ("ghf_edge_transform", "ghf_edge_transform_two",
                           "ghf_edge_transform_bwd"):
                    if hasattr(ref, fn):
                        getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
                        getattr(lib, fn).restype = getattr(ref, fn).restype

    dev = torch.device("cuda")
    g = cs._kernel_graph()
    rel = torch.as_tensor(g.rel_ids, device=dev)
    e_rows, u_pad = g.rel_ids.shape[0], g.char_ids.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    source_lib = k3._lib
    for d in (64, 128):
        xs, xd, g_out = (torch.randn(e_rows, d, device=dev, generator=gen) for _ in range(3))
        wm, ws = (torch.randn(u_pad, d, d, device=dev, generator=gen) / d**0.5
                  for _ in range(2))
        bias = torch.randn(u_pad, d, device=dev, generator=gen)
        fwd = (xs, xd, rel, wm, ws, bias)
        bwd = (g_out, xs, xd, rel, wm, ws)
        want2 = k2.edge_transform_sorted_combined_plain(*fwd)
        want3 = k3.edge_transform_combined_bwd_plain(*bwd)
        for (src, name), lib in libs.items():
            if src == "edge_transform":
                k2._lib = lambda lib=lib: lib
                err = (k2.edge_transform_sorted_combined(*fwd) - want2).abs().max().item()
                ms = best_ms(lambda: k2.edge_transform_sorted_combined(*fwd))
                print(f"kernel 2 d={d} {name}: {ms:.4f} ms, err {err:.2e}", flush=True)
            else:
                k3._lib = lambda lib=lib: lib
                runs = (2, 4, 8) if name == "source" else (k3.RUN_TILES,)
                for run_tiles in runs:
                    chosen, k3.RUN_TILES = k3.RUN_TILES, run_tiles
                    got = k3.edge_transform_combined_bwd(*bwd)
                    err = max(cs.scaled_err(a, b) for a, b in zip(got, want3))
                    ms = best_ms(lambda: k3.edge_transform_combined_bwd(*bwd))
                    k3.RUN_TILES = chosen
                    print(f"kernel 3 d={d} {name}, runs of {run_tiles} tiles: "
                          f"{ms:.4f} ms, err {err:.2e}", flush=True)
        k3._lib = source_lib
        del xs, xd, g_out, wm, ws, bias, fwd, bwd, want2, want3
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
