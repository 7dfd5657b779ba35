#!/usr/bin/env python3
"""Where a tile's time goes inside the general-width bodies of kernels 5 and
3 (`csrc/gated_layer_generic.cu`, `csrc/flow_stack_train_generic.cu`).

Builds the two sources alone with PWN_GENERIC_PHASES, which makes thread 0
of block 0 of every launch add up the clock cycles of each phase of its
tile (csrc/generic.cuh: activations in, slice waits, loads issued,
products, gates, epilogue), then runs, in fp32 on one CUDA card, the three
shapes of `chip_smoke.py` phase 8f: the tiny teacher's 10 layers at
1 x 16,000, the tiny student's 4 flows x 10 layers at 1 x 16,000, and one
flow at student_iaf's widths at 8 x 44,032.  For each it prints, beside the
card's name and power limit, the forward (kernel 5's accumulate epilogue
once per layer: kernel 2's route) and the backward with weight gradients
(kernel 3): ms per call (CUDA events over a few calls; the counters add a
few per cent) and cycles per tile by phase, for kernel 3 the layer pass and
the weight-gradient product apart (that product's "tile" is one block's
row range).

    python3 tools/torch_generic_phases.py [--before DIR]

With --before DIR it measures the first general bodies instead (commit
6f67de5, before their redesign): DIR holds their csrc/, as `git archive
6f67de5 pwn_tpu_torch/csrc | tar -x -C D` writes it under
D/pwn_tpu_torch/csrc; the tool adds the same phase markers at fixed
places of those sources (`BEFORE_MARKS`) before it builds them.  Their
phases: the synchronous weight fill and its two barriers count as slice
waits, and nothing is issued ahead.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pwn_tpu_torch.ops import _build  # noqa: E402
from pwn_tpu_torch.ops import flow_stack as fs  # noqa: E402
from pwn_tpu_torch.utils.platform import require_cuda  # noqa: E402

PHASES = ("activations in", "slice waits", "loads issued", "products",
          "gates", "epilogue")
SOURCES = ("gated_layer_generic.cu", "flow_stack_train_generic.cu")
ACCESSORS = {
    "gated_layer_generic.cu": "pwn_gated_layer_generic_phases",
    "flow_stack_train_generic.cu": "pwn_flow_stack_train_generic_phases",
}
# (file, text, the same text with the markers) in the first bodies' sources
BEFORE_MARKS = [
    ("generic.cuh", "    __syncthreads();\n    fma_tile(acc, a_t + k0 * AS, ws, n);\n",
     "    __syncthreads();\n    GEN_PHASE(1);\n    fma_tile(acc, a_t + k0 * AS, ws, n);\n"
     "    GEN_PHASE(3);\n"),
    ("gated_layer_generic.cu", "  extern __shared__ __align__(16) float smem[];\n",
     "  extern __shared__ __align__(16) float smem[];\n  GEN_PHASE_START();\n"),
    ("gated_layer_generic.cu", "  load_cat(a_t, x, cond, r0, R, T_, C, M, d);\n",
     "  load_cat(a_t, x, cond, r0, R, T_, C, M, d);\n  GEN_PHASE(0);\n"),
    ("gated_layer_generic.cu",
     "sigmoid_f(acc[i][2 + e] + bs));\n    }\n  }\n",
     "sigmoid_f(acc[i][2 + e] + bs));\n    }\n    GEN_PHASE(4);\n  }\n"),
    ("gated_layer_generic.cu",
     "    }\n  }\n}\n\ntemplate <class T, bool ACC>\nint launch(",
     "    }\n    GEN_PHASE(5);\n  }\n  GEN_PHASE_TILE(0);\n}\n\n"
     "template <class T, bool ACC>\nint launch("),
    ("flow_stack_train_generic.cu", "  extern __shared__ __align__(16) float smem[];\n",
     "  extern __shared__ __align__(16) float smem[];\n  GEN_PHASE_START();\n"),
    ("flow_stack_train_generic.cu", "    u_t[k * AS + r] = v;\n  }\n",
     "    u_t[k * AS + r] = v;\n  }\n  GEN_PHASE(0);\n"),
    ("flow_stack_train_generic.cu",
     "dz_t[h * AS + 4 * ty + i] = acc[i][j];\n    }\n  }\n",
     "dz_t[h * AS + 4 * ty + i] = acc[i][j];\n    }\n    GEN_PHASE(5);\n  }\n"),
    ("flow_stack_train_generic.cu",
     "cvt<T>(ta * sb);\n      }\n    }\n  }\n",
     "cvt<T>(ta * sb);\n      }\n    }\n    GEN_PHASE(4);\n  }\n"),
    ("flow_stack_train_generic.cu",
     "dcond32[at] = top ? v : dcond32[at] + v;\n        }\n      }\n    }\n  }\n",
     "dcond32[at] = top ? v : dcond32[at] + v;\n        }\n      }\n    }\n"
     "    GEN_PHASE(5);\n  }\n"),
    ("flow_stack_train_generic.cu",
     "cvt<T>(u_t[g * AS + r]);\n    }\n}\n",
     "cvt<T>(u_t[g * AS + r]);\n    }\n  GEN_PHASE(5);\n  GEN_PHASE_TILE(0);\n}\n"),
    ("flow_stack_train_generic.cu",
     "  __shared__ __align__(16) float ps[KS * WS], qs[KS * WS];\n",
     "  __shared__ __align__(16) float ps[KS * WS], qs[KS * WS];\n"
     "  GEN_PHASE_START();\n"),
    ("flow_stack_train_generic.cu",
     "    __syncthreads();\n    fma_tile(acc, ps, qs, KS);\n  }\n",
     "    __syncthreads();\n    GEN_PHASE(8 + 1);\n    fma_tile(acc, ps, qs, KS);\n"
     "    GEN_PHASE(8 + 3);\n  }\n"),
    ("flow_stack_train_generic.cu",
     "out[static_cast<size_t>(m) * (NQ + 1) + n] = acc[i][j];\n    }\n  }\n}\n",
     "out[static_cast<size_t>(m) * (NQ + 1) + n] = acc[i][j];\n    }\n  }\n"
     "  GEN_PHASE(8 + 5);\n  GEN_PHASE_TILE(8);\n}\n"),
]
ACCESSOR = """
extern "C" int {name}(unsigned long long* out) {{
  const unsigned long long zero[16] = {{}};
  cudaError_t err = cudaMemcpyFromSymbol(out, gen::gen_phase_cycles, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(gen::gen_phase_cycles, zero, sizeof(zero));
  return err;
}}
"""


def instrument_before(src: Path, out: Path) -> None:
    """The first bodies' generic.cuh and sources into `out` with the phase
    markers: the macro block of today's generic.cuh and the places of
    BEFORE_MARKS."""
    out.mkdir(parents=True, exist_ok=True)
    texts = {f: (src / f).read_text() for f in ("generic.cuh", *SOURCES)}
    today = (_build.CSRC / "generic.cuh").read_text()
    block = re.search(r"#ifdef PWN_GENERIC_PHASES\n.*?\n#endif\n", today,
                      re.S).group(0)
    texts["generic.cuh"] = texts["generic.cuh"].replace(
        "namespace gen {\n", "namespace gen {\n\n" + block, 1)
    for f, old, new in BEFORE_MARKS:
        if texts[f].count(old) != 1:
            raise RuntimeError(f"{f}: the place {old!r} is not the first "
                               "bodies'")
        texts[f] = texts[f].replace(old, new)
    for f in SOURCES:
        texts[f] += ("\n#ifdef PWN_GENERIC_PHASES"
                     + ACCESSOR.format(name=ACCESSORS[f]) + "#endif\n")
    for f, text in texts.items():
        (out / f).write_text(text)


def build(csrc: Path, tag: str) -> dict:
    """Each body alone, with PWN_GENERIC_PHASES, one nvcc each in parallel."""
    outs = {f: _build.BUILD_DIR / f"generic_phases_{tag}_{Path(f).stem}.so"
            for f in SOURCES}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
         "-DPWN_GENERIC_PHASES", "-o", str(o), str(csrc / f)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for f, o in outs.items()]
    for p, f in zip(procs, SOURCES):
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {f}:\n{log}")
    libs = {f: ctypes.CDLL(str(o)) for f, o in outs.items()}
    p, i = ctypes.c_void_p, ctypes.c_int
    for f, lib in libs.items():
        getattr(lib, ACCESSORS[f]).argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong)]
    libs[SOURCES[0]].pwn_gated_layer_acc_generic.argtypes = (
        [p] * 9 + [i] * 10 + [p])
    bwd = libs[SOURCES[1]]
    bwd.pwn_flow_stack_train_bwd_generic_workspace_bytes.argtypes = [i] * 9
    bwd.pwn_flow_stack_train_bwd_generic_workspace_bytes.restype = \
        ctypes.c_longlong
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", type=Path, default=None,
                    help="a directory holding commit 6f67de5's csrc/")
    args = ap.parse_args()
    device = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if args.before:
        src = next(args.before.rglob("gated_layer_generic.cu")).parent
        csrc = _build.BUILD_DIR / "generic_phases_before_csrc"
        shutil.rmtree(csrc, ignore_errors=True)
        instrument_before(src, csrc)
        tag, what = "before", "the first general bodies (6f67de5)"
    else:
        csrc, tag, what = _build.CSRC, "now", "the general bodies"
    libs = build(csrc, tag)
    fwd, bwd = libs[SOURCES[0]], libs[SOURCES[1]]
    p = ctypes.c_void_p
    bwd.pwn_flow_stack_train_bwd_generic.argtypes = (
        [p] * (13 if args.before else 14) + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3 + [p])
    cycles = (ctypes.c_ulonglong * 16)()
    stream = torch.cuda.current_stream().cuda_stream
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    tiny = (64, 128, 64, 40)
    dil_t, dil_s = (1, 2, 4, 8, 16) * 2, tuple(2 ** i for i in range(10))
    cases = [("tiny teacher, 1 x 16,000, 10 layers", tiny, dil_t, 1, 16000, 1),
             ("tiny student, 4 flows x 10 layers, 1 x 16,000", tiny, dil_s, 1,
              16000, 4),
             ("student_iaf widths, one flow, 8 x 44,032", (64, 128, 64, 80),
              dil_s, 8, 44032, 1)]
    for name, (C, G, S, M), dil, B, T, flows in cases:
        L = len(dil)
        gen = torch.Generator(device=device).manual_seed(0)

        def arr(shape, scale):
            return torch.randn(shape, generator=gen, device=device) * scale

        x0, cond = arr((B, T, C), 0.5), arr((B, T, M), 0.5)
        w_in = arr((L, G, 2 * C + M), (2 * C + M) ** -0.5)
        w_out = arr((L, C + S, G // 2), (G // 2) ** -0.5)
        b_g, b_rs, dskip = arr((L, G), 0.1), arr((L, C + S), 0.1), arr(
            (B, T, S), 1.0)
        packed = fs.pack_generic(w_in, w_out)
        acts = torch.empty((L, B, T, C), device=device)
        acc = torch.empty((B, T, S), device=device)
        skip = torch.empty((B, T, S), device=device)

        def forward():
            acts[0].copy_(x0)
            for _ in range(flows):
                for l, d in enumerate(dil):
                    w1 = (w_in if args.before else packed.gate)[l]
                    w2 = (w_out if args.before else packed.out)[l]
                    last = l == L - 1
                    err = fwd.pwn_gated_layer_acc_generic(
                        acts[l].data_ptr(), cond.data_ptr(), w1.data_ptr(),
                        b_g[l].data_ptr(), w2.data_ptr(), b_rs[l].data_ptr(),
                        None if last else acts[l + 1].data_ptr(),
                        acc.data_ptr(), skip.data_ptr() if last else None,
                        B, T, C, G, S, M, d, int(l == 0), int(last), 0, stream)
                    if err:
                        raise RuntimeError(f"forward launch failed: {err}")

        ws = torch.empty(bwd.pwn_flow_stack_train_bwd_generic_workspace_bytes(
            *((B, T, C, G, S, M, 1, n_sm, 0) if args.before else
              (B, T, L, C, G, S, M, 1, n_sm))), dtype=torch.uint8, device=device)
        dx, dcond = torch.empty_like(x0), torch.empty_like(cond)
        grads = [torch.empty_like(t) for t in (w_in, b_g, w_out, b_rs)]
        weights = ([w_in, b_g, w_out] if args.before else
                   [packed.gate, b_g, packed.dz, packed.dcat])
        dils = (ctypes.c_int * L)(*dil)

        def backward():
            for _ in range(flows):
                err = bwd.pwn_flow_stack_train_bwd_generic(
                    acts.data_ptr(), cond.data_ptr(), dskip.data_ptr(),
                    *(w.data_ptr() for w in weights), dx.data_ptr(),
                    dcond.data_ptr(), *(g.data_ptr() for g in grads),
                    ws.data_ptr(), B, T, L, C, G, S, M, dils, 1, n_sm, 0,
                    stream)
                if err:
                    raise RuntimeError(f"backward launch failed: {err}")

        for kernel, fn, src in (
                ("forward (kernel 5 accumulate x L)", forward, SOURCES[0]),
                ("backward with weight gradients (kernel 3)", backward,
                 SOURCES[1])):
            read = getattr(libs[src], ACCESSORS[src])
            fn()
            torch.cuda.synchronize()
            read(cycles)  # clear
            n = 3
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            torch.cuda.synchronize()
            read(cycles)
            parts = []
            for base, part in ((0, "layer"), (8, "weight-gradient product")):
                tiles = cycles[base + 7]
                if not tiles:
                    continue
                per = [cycles[base + k] / tiles for k in range(6)]
                total = sum(per) or 1.0
                parts.append(f"{part}: {tiles} blocks 0, "
                             f"{total:.0f} cycles a tile: " + ", ".join(
                                 f"{ph} {c:.0f} ({c / total:.2f})"
                                 for ph, c in zip(PHASES, per) if c))
            print(f"{smi}: {what}, {name}, fp32, {kernel}: "
                  f"{start.elapsed_time(end) / n:.3f} ms a call; "
                  + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
