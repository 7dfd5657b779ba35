#!/usr/bin/env python3
"""Where the time goes inside kernel 1 (`csrc/flow_stack.cu`).

Runs student_iaf's stack (10 layers, dilations 1..512, C=64, G=128, S=64,
M=80) at batch 8 x 2 s (T = 44,032) on one CUDA card, in builds of the
kernel made for this tool, and prints beside the card's name and power
limit:

* ms per call (CUDA events over 20 calls, in turns, twice) of the kernel
  as it is and of copies with one phase taken out: the gates replaced by
  the product of the two pre-activations, the residual and ring stores
  dropped, the weight waits dropped (the first three slices are loaded
  once and reused).  What a copy saves is what that phase costs; the
  copies compute wrong values and serve only for timing;
* the clock cycles per tile in each phase, from a build with
  PWN_FLOW_STACK_PHASES (thread 0 of block (0, 0) adds them up): waiting
  for weights, the gate product, the gates, the out product, the skip sum,
  residual and ring update (with its two barriers), and the tile's loads
  and skip store; per layer, divide by 10.  The counting slows the kernel
  (its ms per call is printed too), so these are shares, not times.

Run from the repository root:

    python3 tools/torch_flow_stack_phases.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pwn_tpu_torch.ops import _build  # noqa: E402
from pwn_tpu_torch.ops.flow_stack import segment_length  # noqa: E402
from pwn_tpu_torch.utils.platform import require_cuda  # noqa: E402

SOURCE = _build.CSRC / "flow_stack.cu"
PHASES = ("waiting for weights", "gate product", "gates", "out product",
          "skip sum, residual and ring update", "tile loads and skip store")

# (text in the source, its replacement) for each copy with a phase taken out
_GATES = ("pack(gate(acc[e] + bt.x, acc[f] + bs.x),\n"
          "                                            gate(acc[e + 1] + bt.y, "
          "acc[f + 1] + bs.y));")
_WAIT_GATE = "mbar_wait(full + 8 * st, ((c + i) / STAGES) & 1);"
_WAIT_OUT = "mbar_wait(full + 8 * st, (c / STAGES) & 1);"
_PRODUCER = ("for (int s = t_begin; s < t1; s += TT)\n"
             "        for (int l = 0; l < L; ++l)\n"
             "          for (int i = 0; i < NCH; ++i, ++c) {")
REMOVED = {
    "gates as a product": [(_GATES, (
        "pack((acc[e] + bt.x) * (acc[f] + bs.x),\n"
        "                                            (acc[e + 1] + bt.y) * "
        "(acc[f + 1] + bs.y));"))],
    "no residual or ring stores": [
        ("if (to_ring) sts32(swz(rs, ring_row, j) + 4 * q, xv);", ""),
        ("if (l + 1 < L) {  // the last layer's residual output is not needed",
         "if (false) {")],
    "no weight waits": [
        (_WAIT_GATE, "if (c + i < STAGES) " + _WAIT_GATE),
        (_WAIT_OUT, "if (c < STAGES) " + _WAIT_OUT),
        (_PRODUCER, _PRODUCER.replace("s < t1", "s < t_begin + 1")
         .replace("l < L", "l < 1").replace("i < NCH", "i < STAGES")),
        ("if (lane == 0) mbar_arrive(empty + 8 * ((c + i - 1) % STAGES));", ""),
        ("if (lane == 0) mbar_arrive(empty + 8 * ((c + NCH_IN - 1) % STAGES));",
         ""),
        ("if (lane == 0) mbar_arrive(empty + 8 * st);", "")],
}


def build(name: str, subs=(), defines=()) -> tuple:
    """Start compiling a copy of flow_stack.cu, with `subs` applied, into a
    library of its own; returns the compiler's process and the library's
    path (the caller starts every build before it waits for any)."""
    text = SOURCE.read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    stem = "fs_tool_" + name.replace(" ", "_")
    cu = _build.BUILD_DIR / f"{stem}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(text)
    out = cu.with_suffix(".so")
    return subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-shared", *[f"-D{d}" for d in defines], "-o", str(out), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


def load(proc, out: Path) -> ctypes.CDLL:
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {out.name}:\n{log}")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pwn_flow_stack_bf16.argtypes = ([p] * 7 + [i] * 7
                                        + [ctypes.POINTER(ctypes.c_int), i, p])
    lib.pwn_flow_stack_tile_rows.restype = i
    return lib


def main() -> int:
    device = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    jobs = {"kernel": build("kernel"),
            "phase counters": build("phase counters",
                                    defines=("PWN_FLOW_STACK_PHASES",))}
    jobs.update({k: build(k, subs) for k, subs in REMOVED.items()})
    libs = {k: load(*job) for k, job in jobs.items()}
    libs["phase counters"].pwn_flow_stack_phases.argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong)]

    B, T, C, G, S, M = 8, 44032, 64, 128, 64, 80
    dil = [2 ** i for i in range(10)]
    L = len(dil)
    gen = torch.Generator(device=device).manual_seed(0)

    def arr(shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    x0, cond = arr((B, T, C), 0.5).bfloat16(), arr((B, T, M), 0.5).bfloat16()
    w_in = arr((L, G, 2 * C + M), (2 * C + M) ** -0.5).bfloat16()
    w_out = arr((L, C + S, G // 2), (G // 2) ** -0.5).bfloat16()
    b_g, b_rs = arr((L, G), 0.1), arr((L, C + S), 0.1)
    skip = torch.empty((B, T, S), dtype=torch.bfloat16, device=device)
    seg = segment_length(B, T, torch.cuda.get_device_properties(
        device).multi_processor_count, libs["kernel"].pwn_flow_stack_tile_rows())
    ptrs = [t.data_ptr() for t in (x0, cond, w_in, b_g, w_out, b_rs, skip)]
    stream = torch.cuda.current_stream().cuda_stream

    def runner(lib):
        def run():
            err = lib.pwn_flow_stack_bf16(*ptrs, B, T, L, C, G, S, M,
                                          (ctypes.c_int * L)(*dil), seg, stream)
            if err:
                raise RuntimeError(f"kernel 1: launch failed ({err})")
        return run

    def time_ms(fn, n=20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    fns = {k: runner(lib) for k, lib in libs.items()}
    for fn in fns.values():
        fn()  # warm up
    torch.cuda.synchronize()
    names = list(fns)
    ms = {k: [] for k in names}
    for k in names + names[::-1]:  # in turns, on one card
        ms[k].append(time_ms(fns[k]))
    full = min(ms["kernel"])
    for k in names:
        saved = "" if k in ("kernel", "phase counters") else (
            f"; saves {full - min(ms[k]):.4f} ms "
            f"({(full - min(ms[k])) / full:.2f} of the kernel's)")
        print(f"{smi}: kernel 1 B={B} T={T} segment {seg}, {k}: "
              + " / ".join(f"{v:.4f}" for v in ms[k]) + " ms per call"
              + saved, flush=True)

    lib = libs["phase counters"]
    cycles = (ctypes.c_ulonglong * 7)()
    lib.pwn_flow_stack_phases(cycles)  # clear
    for _ in range(20):
        fns["phase counters"]()
    torch.cuda.synchronize()
    lib.pwn_flow_stack_phases(cycles)
    tiles = max(cycles[6], 1)
    per_tile = [cycles[k] / tiles for k in range(6)]
    total = sum(per_tile)
    print(f"{smi}: kernel 1 with phase counters: cycles per tile (block 0, "
          f"{tiles // 20} tiles a call, {total:.0f} in all, {total / L:.0f} a "
          f"layer): " + ", ".join(f"{p} {c:.0f} ({c / total:.2f})"
                                  for p, c in zip(PHASES, per_tile)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
