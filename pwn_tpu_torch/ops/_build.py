"""Build and load the port's CUDA kernels.

The sources in `pwn_tpu_torch/csrc/` have a plain C interface.  Each is
compiled by its own nvcc process, all started together, and the objects
are linked into one shared library, loaded with ctypes (no PyTorch
headers, so a build takes seconds, not minutes).  The library goes into
`pwn_tpu_torch/build/`, named by a hash of the flags and of every file
under `csrc/` (the sources and the headers they include), and is built at
first use.  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "flow_stack.cu", CSRC / "flow_stack_train.cu",
           CSRC / "ar_sampler.cu", CSRC / "gated_layer.cu",
           CSRC / "gated_layer_generic.cu",
           CSRC / "flow_stack_train_generic.cu")
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared",)
_P, _I = ctypes.c_void_p, ctypes.c_int
AR_SAMPLE_ARGTYPES = [   # pwn_ar_sample, also in the tools' own builds
    _P, _P, _P, _P, _P, _P, _P,     # cond, noise, front_k, front_b, w_rank,
                                    # b_rank, b_rs
    _P, _P, _P, _P, _P, _P, _P,     # head1_k, head1_b, head2_k, head2_b,
                                    # queue, wav, wav_ranks
    _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,  # B, T, L, C, G, S, M,
                                             # head_dim, K, gaussian
    ctypes.POINTER(ctypes.c_int),   # dilations
    ctypes.c_float, ctypes.c_float,  # log_scale_min, temperature
    _I, _I, _I, _P,                 # weights_bf16, cond_bf16, n_ranks, stream
]
AR_GENERIC_ARGTYPES = [  # pwn_ar_sample_generic (the cluster body)
    _P, _P, _P, _P, _P, _P, _P,     # cond, noise, front_k, front_b, w_rank,
                                    # b_rank, b_rs
    _P, _P, _P, _P, _P, _P, _P, _P,  # head1_k, head1_b, head2_k, head2_b,
                                     # dilations (card), queue, wav,
                                     # wav_ranks
    _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,  # B, T, L, C, G, S, M,
                                                 # head_dim, K, gaussian,
                                                 # sum(d + 1)
    ctypes.POINTER(ctypes.c_int),   # the plan's ints
    ctypes.c_float, ctypes.c_float,  # log_scale_min, temperature
    _I, _I, _P,                     # weights_bf16, cond_bf16, stream
]
AR_BLOCK_ARGTYPES = [  # pwn_ar_sample_block (the one-block body; an
                       # earlier tree's pwn_ar_sample_generic)
    _P, _P, _P, _P, _P, _P, _P, _P,  # cond, noise, front_k, front_b, w_in,
                                     # b_g, w_out, b_rs
    _P, _P, _P, _P, _P, _P, _P,     # head1_k, head1_b, head2_k, head2_b,
                                    # dilations (card), queue, wav
    _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,  # B, T, L, C, G, S, M,
                                                 # head_dim, K, gaussian,
                                                 # sum(d)
    ctypes.c_float, ctypes.c_float,  # log_scale_min, temperature
    _I, _I, _P,                     # weights_bf16, cond_bf16, stream
]


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, else PATH, else the toolkit's default prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are compiled on the machine with the card"
    )


def library_path(csrc: Path = CSRC) -> Path:
    """The library's path, named by a hash of the flags and of every file
    under `csrc` (names and bytes), so that an edited header builds anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for f in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(f.relative_to(csrc).as_posix().encode() + b"\0")
        h.update(f.read_bytes())
    return BUILD_DIR / f"pwn_kernels-{h.hexdigest()[:16]}.so"


def compile_library(out: Path) -> str:
    """Compile SOURCES into `out`: one nvcc per source, run in parallel,
    then one link.  Returns nvcc's output (the ptxas -v reports).  Raises
    RuntimeError with the compiler's output if the build fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.parent / f"{tag}.{src.stem}.o" for src in SOURCES]
    procs = [subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)]
    logs = [f"== {src.name}\n{proc.communicate()[0]}"
            for src, proc in zip(SOURCES, procs)]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        failed = [s.name for s, p in zip(SOURCES, procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        link = subprocess.run(
            [nvcc_path(), *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               + "\n".join(logs))
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    log = "\n".join(logs)
    out.with_suffix(".log").write_text(log)
    return log


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, compiled first if it is not built."""
    path = library_path()
    if not path.exists():
        compile_library(path)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pwn_flow_stack_bf16.argtypes = [
        p, p, p, p, p, p, p,           # x0, cond, w_in_t, b_g, w_out_t, b_rs, skip
        i, i, i, i, i, i, i,           # B, T, L, C, G, S, M
        ctypes.POINTER(ctypes.c_int),  # dilations
        i, p,                          # segment length, stream
    ]
    lib.pwn_flow_stack_bf16.restype = i
    lib.pwn_flow_stack_tile_rows.argtypes = []
    lib.pwn_flow_stack_tile_rows.restype = i
    lib.pwn_flow_stack_smem_bytes.argtypes = [i]
    lib.pwn_flow_stack_smem_bytes.restype = ctypes.c_longlong
    lib.pwn_flow_stack_train_bwd_bf16.argtypes = [
        p, p, p, p, p, p,              # acts, cond, dskip, w_in, b_g, w_out
        p, p, p, p, p, p, p,           # dx, dcond, dw_in, db_g, dw_out,
                                       # db_rs, workspace
        i, i, i, i, i, i, i,           # B, T, L, C, G, S, M
        ctypes.POINTER(ctypes.c_int),  # dilations
        i, i, p,                       # want_wgrads, SM count, stream
    ]
    lib.pwn_flow_stack_train_bwd_bf16.restype = i
    lib.pwn_flow_stack_train_bwd_workspace_bytes.argtypes = [i] * 8
    lib.pwn_flow_stack_train_bwd_workspace_bytes.restype = ctypes.c_longlong
    lib.pwn_flow_stack_train_wgrad_bf16.argtypes = [
        p, p, p, p, p,                 # x, cond, dg, dout, z
        p, p, p, p, p,                 # dw_in, db_g, dw_out, db_rs, workspace
        i, i, i, i, i, i, i, i, p,     # B, T, C, G, S, M, dilation, SM count,
                                       # stream
    ]
    lib.pwn_flow_stack_train_wgrad_bf16.restype = i
    lib.pwn_flow_stack_train_wgrad_workspace_bytes.argtypes = [i] * 7
    lib.pwn_flow_stack_train_wgrad_workspace_bytes.restype = ctypes.c_longlong
    lib.pwn_ar_sample.argtypes = AR_SAMPLE_ARGTYPES
    lib.pwn_ar_sample.restype = i
    lib.pwn_ar_sample_geometry.argtypes = [
        i, i, i, i, i, i, i, i, i, i, i,  # L, C, G, S, M, head_dim, K, gaussian,
                                          # weights_bf16, cond_bf16, n_ranks
        ctypes.POINTER(ctypes.c_int),     # out: rows, ranks, stages, smem,
                                          # clusters
    ]
    lib.pwn_ar_sample_geometry.restype = i
    lib.pwn_ar_sample_generic.argtypes = AR_GENERIC_ARGTYPES
    lib.pwn_ar_sample_generic.restype = i
    lib.pwn_ar_sample_generic_geometry.argtypes = [
        i, i, i, i, i, i, i, i, i, i,  # L, C, G, S, M, head_dim, K,
                                       # gaussian, weights_bf16, cond_bf16
        ctypes.POINTER(ctypes.c_int),  # the plan's ints
        ctypes.POINTER(ctypes.c_int),  # out: rows, ranks, stages, smem,
                                       # clusters
    ]
    lib.pwn_ar_sample_generic_geometry.restype = i
    lib.pwn_ar_sample_block.argtypes = AR_BLOCK_ARGTYPES
    lib.pwn_ar_sample_block.restype = i
    lib.pwn_ar_sample_block_geometry.argtypes = [
        i, i, i, i, i, i, i, i, i,     # C, G, S, M, head_dim, K, gaussian,
                                       # weights_bf16, cond_bf16
        ctypes.POINTER(ctypes.c_int),  # out: threads, smem, blocks at once
    ]
    lib.pwn_ar_sample_block_geometry.restype = i
    lib.pwn_gated_layer_bf16.argtypes = [
        p, p, p, p, p, p, p, p,        # x, cond, w_in, b_g, w_out, b_out, res,
                                       # skip
        i, i, i, i, i, i, i, p,        # B, T, C, G, S, M, dilation, stream
    ]
    lib.pwn_gated_layer_bf16.restype = i
    lib.pwn_gated_layer_acc_bf16.argtypes = [
        p, p, p, p, p, p, p, p, p,     # x, cond, w_in, b_g, w_out, b_rs, res,
                                       # skip_acc, skip
        i, i, i, i, i, i, i, i, i, p,  # B, T, C, G, S, M, dilation, first,
                                       # last, stream
    ]
    lib.pwn_gated_layer_acc_bf16.restype = i
    lib.pwn_generic_smem_bytes.argtypes = [i] * 5  # C, G, S, M, backward
    lib.pwn_generic_smem_bytes.restype = ctypes.c_longlong
    lib.pwn_generic_tile_rows.argtypes = [i] * 5  # C, G, S, M, backward
    lib.pwn_generic_tile_rows.restype = i
    lib.pwn_gated_layer_generic.argtypes = [
        p, p, p, p, p, p, p, p,        # x, cond, w_gate, b_g, w_out (packed),
                                       # b_out, res,
                                       # skip
        i, i, i, i, i, i, i, i, p,     # B, T, C, G, S, M, dilation, is_bf16,
                                       # stream
    ]
    lib.pwn_gated_layer_generic.restype = i
    lib.pwn_gated_layer_acc_generic.argtypes = [
        p, p, p, p, p, p, p, p, p,     # x, cond, w_gate, b_g, w_out (packed),
                                       # b_rs, res,
                                       # skip_acc, skip
        i, i, i, i, i, i, i, i, i, i,  # B, T, C, G, S, M, dilation, first,
        p,                             # last, is_bf16, stream
    ]
    lib.pwn_gated_layer_acc_generic.restype = i
    lib.pwn_flow_stack_train_bwd_generic.argtypes = [
        p, p, p, p, p, p, p,           # acts, cond, dskip, w_gate, b_g, w_dz,
                                       # w_dcat (packed)
        p, p, p, p, p, p, p,           # dx, dcond, dw_in, db_g, dw_out,
                                       # db_rs, workspace
        i, i, i, i, i, i, i,           # B, T, L, C, G, S, M
        ctypes.POINTER(ctypes.c_int),  # dilations
        i, i, i, p,                    # want_wgrads, SM count, is_bf16, stream
    ]
    lib.pwn_flow_stack_train_bwd_generic.restype = i
    lib.pwn_flow_stack_train_wgrad_generic.argtypes = [
        p, p, p, p, p,                 # x, cond, dg, dout, z (stored layouts)
        p, p, p, p, p,                 # dw_in, db_g, dw_out, db_rs, workspace
        i, i, i, i, i, i, i, i, i, p,  # B, T, C, G, S, M, dilation, SM count,
                                       # is_bf16, stream
    ]
    lib.pwn_flow_stack_train_wgrad_generic.restype = i
    lib.pwn_flow_stack_train_wgrad_generic_workspace_bytes.argtypes = [i] * 7
    lib.pwn_flow_stack_train_wgrad_generic_workspace_bytes.restype = \
        ctypes.c_longlong
    lib.pwn_flow_stack_train_bwd_generic_workspace_bytes.argtypes = [i] * 9
    # (B, T, L, C, G, S, M, want_wgrads, SM count)
    lib.pwn_flow_stack_train_bwd_generic_workspace_bytes.restype = \
        ctypes.c_longlong
    lib.pwn_cuda_error_string.argtypes = [i]
    lib.pwn_cuda_error_string.restype = ctypes.c_char_p
    return lib
