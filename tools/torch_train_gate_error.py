#!/usr/bin/env python3
"""The error of the fast tanh and sigmoid of kernel 3's layer pass
(`csrc/flow_stack_train.cu::tanh_fast`, `sigmoid_fast`: hardware exp2 and
reciprocal, exponents clamped at 30 nats), and of libm's `tanhf` and
`1 / (1 + expf(-x))` beside them, against both functions in fp64.

Builds one small library from `flow_stack_train.cu` and a sweep kernel in
the same translation unit (so the sweep calls the kernel's own functions),
then, on one CUDA card, runs every fp32 value x with |x| <= 64 (the clamps
bite at |x| = 15 and 30) and prints, beside the card's name and power
limit, the largest absolute error of each function, the largest relative
error of each tanh (it is unbounded near 0 for the fast one, whose
e^2x - 1 cancels), and the largest absolute error of the derivative
factors the layer pass forms from them, 1 - tanh^2 and s (1 - s).
Run from the repository root:

    python3 tools/torch_train_gate_error.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pwn_tpu_torch.ops import _build  # noqa: E402
from pwn_tpu_torch.utils.platform import require_cuda  # noqa: E402

SOURCE = _build.CSRC / "flow_stack_train.cu"
NAMES = ("tanh_fast abs", "tanhf abs", "sigmoid_fast abs",
         "1/(1+expf(-x)) abs", "tanh_fast rel", "tanhf rel",
         "1 - tanh_fast^2 abs", "sigmoid_fast (1 - sigmoid_fast) abs")
SWEEP = r"""
#include "%s"

namespace {
__global__ void gate_error_sweep(unsigned last_bits, unsigned* out) {
  float m[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i <= last_bits;
       i += gridDim.x * blockDim.x) {
    for (unsigned sign = 0; sign < 2; ++sign) {
      const float x = __uint_as_float(i | (sign << 31));
      const double t = tanh((double)x), s = 1.0 / (1.0 + exp(-(double)x));
      const float tf = tanh_fast(x), tl = tanhf(x);
      const float sf = sigmoid_fast(x), sl = 1.f / (1.f + expf(-x));
      m[0] = fmaxf(m[0], (float)fabs(tf - t));
      m[1] = fmaxf(m[1], (float)fabs(tl - t));
      m[2] = fmaxf(m[2], (float)fabs(sf - s));
      m[3] = fmaxf(m[3], (float)fabs(sl - s));
      if (t != 0.0) {
        m[4] = fmaxf(m[4], (float)(fabs(tf - t) / fabs(t)));
        m[5] = fmaxf(m[5], (float)(fabs(tl - t) / fabs(t)));
      }
      m[6] = fmaxf(m[6], (float)fabs((1.f - tf * tf) - (1.0 - t * t)));
      m[7] = fmaxf(m[7], (float)fabs(sf * (1.f - sf) - s * (1.0 - s)));
    }
  }
  for (int k = 0; k < 8; ++k) atomicMax(out + k, __float_as_uint(m[k]));
}
}  // namespace

extern "C" int pwn_gate_error(float* host_out) {
  unsigned* out = nullptr;
  cudaError_t err = cudaMalloc(&out, 8 * sizeof(unsigned));
  if (err == cudaSuccess) err = cudaMemset(out, 0, 8 * sizeof(unsigned));
  if (err == cudaSuccess) {
    gate_error_sweep<<<1056, 256>>>(0x42800000u, out);  // bits of 64.0f
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = cudaMemcpy(host_out, out, 8 * sizeof(unsigned), cudaMemcpyDeviceToHost);
  cudaFree(out);
  return (int)err;
}
"""


def main() -> int:
    require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "gate_error.cu"
    lib_path = _build.BUILD_DIR / "gate_error.so"
    src.write_text(SWEEP % SOURCE)
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o",
         str(lib_path), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    out = (ctypes.c_float * 8)()
    err = lib.pwn_gate_error(out)
    if err:
        raise RuntimeError(f"the sweep failed with CUDA error {err}")
    print(f"{smi}: every fp32 x with |x| <= 64, against fp64:")
    for name, v in zip(NAMES, out):
        print(f"  {name:38s} {v:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
