"""pwn_tpu_torch — the PyTorch / CUDA port of pwn_tpu, for NVIDIA Hopper.

The JAX package `pwn_tpu` is the reference; this package mirrors its
module names (`ops/conv.py`, `models/student.py`, `generate.py`, ...) so
each piece has an obvious counterpart.  Public functions keep JAX's
channels-last `(B, T, C)` layout so tests compare like with like.

What is ported: student IAF synthesis (mel -> waveform in one parallel
pass) through `generate_student` and `vocode_many`, and in chunks through
`stream_student_chunks` and the streaming HTTP server (`serve.py`, with
batching across requests), copy-synthesis metrics (`evaluate.py`), teacher
training on
the synthetic corpus through `run_teacher_training`, distillation of the
student from a frozen teacher and direct student training through
`run_distillation` and `run_student_direct_training` (with a workdir:
checkpoints with exact resume, metrics, TensorBoard and sample dumps),
teacher autoregressive sampling through `generate_teacher`, and the
command line `python -m pwn_tpu_torch.cli` (train-teacher,
train-student, distill-student, generate, eval, serve).  The flow stack runs
in hand-written CUDA C++ kernels on a CUDA tensor (`csrc/flow_stack.cu`
for inference, `csrc/flow_stack_train.cu` for the training forward and
backward) and in its plain PyTorch versions (`ops/flow_stack.py`) on a
CPU tensor; the AR sampling loop likewise (`csrc/ar_sampler.cu`,
`ops/ar_sampler.py`).

This package imports `torch` and never `jax`, nor anything of the JAX
package `pwn_tpu`: the configuration dataclasses are the port's own copy
(`pwn_tpu_torch/config.py`).
"""

from pwn_tpu_torch.config import Config, get_config, override  # noqa: F401

__version__ = "0.1.0"

# entry points load torch model code on first touch only
_LAZY = {
    "generate_student": "pwn_tpu_torch.generate",
    "generate_teacher": "pwn_tpu_torch.generate",
    "vocode_many": "pwn_tpu_torch.generate",
    "stream_student_chunks": "pwn_tpu_torch.generate",
    "mel_from_wav": "pwn_tpu_torch.generate",
    "init_student": "pwn_tpu_torch.models.student",
    "init_teacher": "pwn_tpu_torch.models.teacher",
    "run_teacher_training": "pwn_tpu_torch.training.loop",
    "run_distillation": "pwn_tpu_torch.training.loop",
    "run_student_direct_training": "pwn_tpu_torch.training.loop",
    "require_cuda": "pwn_tpu_torch.utils.platform",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'pwn_tpu_torch' has no attribute {name!r}")
