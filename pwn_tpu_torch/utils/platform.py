"""Device selection and float32 precision policy.

The port runs on a CUDA card or not at all: `require_cuda` never hands
back the CPU.  The CPU path exists for the tests, which pass CPU tensors
explicitly.  Under a launcher of several processes each process takes
the card of its `LOCAL_RANK`.
"""

from __future__ import annotations

import torch

from pwn_tpu_torch.parallel.mesh import launcher_rank


def configure_precision() -> None:
    """Keep float32 matmuls and convolutions in full float32.

    cuBLAS defaults to full float32 already, but cuDNN's default is TF32,
    which would put the float32 upsampler's transposed convolutions (and
    any float32 reference compared against a kernel) at about three
    decimal digits.  Set both flags so neither default decides.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def require_cuda() -> torch.device:
    """This process's CUDA device, `cuda:LOCAL_RANK` (`cuda:0` without a
    launcher), made the current device, with the precision policy
    applied; raises if there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port's synthesis path runs "
            "on an NVIDIA GPU (CPU tensors are for the tests only)"
        )
    configure_precision()
    device = torch.device("cuda", launcher_rank())
    torch.cuda.set_device(device)
    return device
