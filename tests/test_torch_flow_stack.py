"""The port's flow stack: the plain PyTorch version against the JAX Pallas
kernel (interpret mode, as the reference's own CPU tests run it) and its
XLA scan, the wrapper's dispatch and argument checks, and — on a CUDA
card only — the hand-written kernels against the plain version: kernel 1
at student widths, kernel 5's accumulate loop at C=128.

JAX is imported inside the fixture that needs it, so the CUDA cases also
run where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_flow_stack.py
"""

import numpy as np
import pytest
import torch

from pwn_tpu_torch.ops import _build
from pwn_tpu_torch.ops.flow_stack import (KERNEL_DIMS, TRAIN_KERNEL_DIMS,
                                          check_kernel_args, flow_stack,
                                          flow_stack_reference,
                                          segment_length)
from pwn_tpu_torch.ops.gated_layer import flow_stack_by_layers, gated_layer

SMALL = dict(B=2, T=1024, C=16, M=8, G=32, S=16, dilations=(1, 2, 4, 512))
STUDENT_DILATIONS = tuple(2 ** i for i in range(10))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per host; torch's default of
    one intra-op thread per core oversubscribes it (measured ~60x slower
    than alone), so these tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, T, C, M, G, S, dilations):
    rng = np.random.default_rng(seed)
    L = len(dilations)

    def mk(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(
        x0=mk(B, T, C, scale=1.0), cond=mk(B, T, M, scale=1.0),
        w_in=mk(L, 2 * C + M, G), b_g=mk(L, G),
        w_out=mk(L, G // 2, C + S), b_rs=mk(L, C + S),
    )


def _torch(args, dtype=torch.float32, device="cpu"):
    """Operands in the wrapper's contract: the JAX weights transposed to
    (out, in), biases float32, the rest `dtype`."""
    out = {}
    for k, v in args.items():
        t = torch.from_numpy(v)
        if k in ("w_in", "w_out"):
            t = t.transpose(1, 2).contiguous()
        out[k] = t.to(device, torch.float32 if k in ("b_g", "b_rs") else dtype)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def jax_stack():
    pytest.importorskip("jax")
    from pwn_tpu.ops.pallas.flow_stack import _reference_xla, fused_flow_stack

    return fused_flow_stack, _reference_xla


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from pwn_tpu_torch.utils.platform import require_cuda

    return require_cuda()


def _jax_args(args, dtype):
    import jax.numpy as jnp

    return {k: jnp.asarray(v).astype(dtype) for k, v in args.items()}


def test_reference_matches_pallas_and_xla_fp32(jax_stack):
    """float32: the two differ only in summation order (1e-5 relative)."""
    fused, xla = jax_stack
    import jax.numpy as jnp

    dil = SMALL["dilations"]
    args = _inputs(0, **SMALL)
    got = flow_stack_reference(**_torch(args), dilations=dil).numpy()
    pallas = np.asarray(fused(**_jax_args(args, jnp.float32), dilations=dil,
                              interpret=True))
    scan = np.asarray(xla(**_jax_args(args, jnp.float32), dilations=dil))
    assert _rel(got, pallas) < 1e-5
    assert _rel(got, scan) < 1e-5


def test_reference_matches_pallas_and_xla_bf16(jax_stack):
    """bfloat16.  Against the Pallas kernel, which rounds at the same points
    (x and z every layer, fp32 GEMM sums, bf16 output): only summation order
    differs, flipping an occasional bf16 rounding that the later layers
    carry, so 1e-2 (2.5 bf16 ulps of the row max).  The XLA scan also rounds
    each GEMM's output to bf16 before the bias, a rounding the kernel does
    not do; 2e-2 covers that extra ulp."""
    fused, xla = jax_stack
    import jax.numpy as jnp

    dil = SMALL["dilations"]
    args = _inputs(1, **SMALL)
    got = flow_stack_reference(**_torch(args, torch.bfloat16), dilations=dil)
    assert got.dtype == torch.bfloat16
    jargs = _jax_args(args, jnp.bfloat16)
    jargs["b_g"] = jargs["b_g"].astype(jnp.float32)
    jargs["b_rs"] = jargs["b_rs"].astype(jnp.float32)
    pallas = fused(**jargs, dilations=dil, interpret=True)
    scan = xla(**jargs, dilations=dil)
    assert _rel(got.float().numpy(), pallas) < 1e-2
    assert _rel(got.float().numpy(), scan) < 2e-2


def test_reference_batch_rows_are_isolated():
    """Changing row 1 cannot change row 0 (the spec of
    tests/test_flow_stack.py's history-isolation test)."""
    dil = SMALL["dilations"]
    args = _torch(_inputs(2, **SMALL))
    a = flow_stack_reference(**args, dilations=dil)
    args["x0"] = args["x0"].clone()
    args["x0"][1] += 3.0
    b = flow_stack_reference(**args, dilations=dil)
    assert torch.equal(a[0], b[0])
    assert not torch.allclose(a[1], b[1])


@pytest.mark.parametrize("t0,t1", [(1100, 1500), (1023, 1024), (1500, 2000)])
def test_halo_recompute_is_exact(t0, t1):
    """The kernel's segment argument: the stack's output on [t0, t1) depends
    on x0 and cond only in [t0 - sum(d), t1), so a segment recomputed from
    zero history over that window equals the full-length result."""
    dil = STUDENT_DILATIONS
    shape = dict(SMALL, B=1, T=2000, dilations=dil)
    args = _torch(_inputs(3, **shape))
    full = flow_stack_reference(**args, dilations=dil)
    lo = max(0, t0 - sum(dil))
    window = {k: (v[:, lo:t1] if k in ("x0", "cond") else v)
              for k, v in args.items()}
    seg = flow_stack_reference(**window, dilations=dil)
    torch.testing.assert_close(seg[:, t0 - lo:], full[:, t0:t1],
                               rtol=1e-6, atol=1e-6)


def test_wrapper_on_cpu_is_the_reference_and_launches_nothing():
    dil = SMALL["dilations"]
    args = _torch(_inputs(4, **SMALL))
    before = flow_stack.launches
    got = flow_stack(**args, dilations=dil)
    assert flow_stack.launches == before
    torch.testing.assert_close(
        got, flow_stack_reference(**args, dilations=dil), rtol=0, atol=0)


def _kernel_shaped(B=2, T=256, dtype=torch.bfloat16):
    C, G, S, M = KERNEL_DIMS
    return _torch(_inputs(5, B, T, C, M, G, S, STUDENT_DILATIONS), dtype)


@pytest.mark.parametrize("change,match", [
    (lambda a: a.update(x0=a["x0"].float()), "x0 must be bfloat16"),
    (lambda a: a.update(b_g=a["b_g"].bfloat16()), "b_g must be float32"),
    (lambda a: a.update(x0=a["x0"][..., :32], w_in=a["w_in"][..., 16:]),
     "kernel is built for"),
    (lambda a: a.update(cond=a["cond"][:, :100]), "cond must be"),
    (lambda a: a.update(b_rs=a["b_rs"][:, :64]), "b_rs must be"),
    (lambda a: a.update(w_in=a["w_in"][..., :-16]), "w_in must be"),
    (lambda a: None, "CUDA device"),
])
def test_kernel_argument_checks(change, match):
    """What the kernel does not take raises before any launch; a CPU tensor
    that reaches the kernel path is refused, never computed."""
    args = _kernel_shaped()
    change(args)
    with pytest.raises(ValueError, match=match):
        check_kernel_args(**args, dilations=STUDENT_DILATIONS)


def test_kernel_argument_checks_dilations():
    args = _kernel_shaped()
    with pytest.raises(ValueError, match="dilations"):
        check_kernel_args(**args, dilations=STUDENT_DILATIONS[:-1])
    with pytest.raises(ValueError, match="dilations"):
        check_kernel_args(**args, dilations=(0,) + STUDENT_DILATIONS[1:])


@pytest.mark.parametrize("B,T,n_sm,tile,want", [
    (8, 44032, 132, 128, 2816),   # bench shape: 16 segments per row
    (1, 1000, 132, 128, 128),     # short row: one tile per segment
    (200, 5000, 132, 128, 5120),  # more rows than SMs: one segment per row
    (3, 1, 132, 128, 128),
])
def test_segment_length(B, T, n_sm, tile, want):
    seg = segment_length(B, T, n_sm, tile)
    assert seg == want and seg % tile == 0
    assert B * -(-T // seg) <= max(n_sm, B)


def test_build_needs_nvcc(monkeypatch):
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    assert _build.library_path().parent == _build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_library_name_follows_every_csrc_file(tmp_path):
    """The library is named by a hash of every file under csrc/, the shared
    header included: a copy with the same bytes gets the same name, and a
    copy whose header differs by one byte another, so an edited header
    never loads a library built from the old one."""
    import shutil

    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    assert _build.library_path(copy) == _build.library_path()
    header = copy / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    assert _build.library_path(copy) != _build.library_path()
    assert _build.library_path(copy).parent == _build.BUILD_DIR


@pytest.mark.gpu
@pytest.mark.parametrize("B,T", [(8, 4096), (1, 1000), (3, 5003), (2, 300),
                                 (1, 1)])
def test_kernel_matches_reference_on_card(cuda, B, T):
    """bf16 kernel vs the plain version in fp32, per batch row:
    max|diff| / max|ref| within 0.02 (the bound chip_smoke.py states)."""
    args = _kernel_shaped(B, T)
    args = {k: v.to(cuda) for k, v in args.items()}
    before = flow_stack.launches
    with torch.inference_mode():
        out = flow_stack(**args, dilations=STUDENT_DILATIONS)
        ref = flow_stack_reference(**{k: v.float() for k, v in args.items()},
                                   dilations=STUDENT_DILATIONS)
    torch.cuda.synchronize()
    assert flow_stack.launches == before + 1
    err = (out.float() - ref).abs().reshape(B, -1).amax(1)
    scale = ref.abs().reshape(B, -1).amax(1)
    assert (err / scale <= 0.02).all(), (err / scale).tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("B,T", [(2, 4096), (1, 1000), (3, 5003), (1, 1)])
def test_wide_stack_runs_the_layer_kernel_on_card(cuda, B, T):
    """At C=128 (large_student_sharded's widths, which kernel 1 is not built
    for) `flow_stack` runs kernel 5's accumulate epilogue once per layer:
    10 launches, none of kernel 1, and per batch row within 0.02 of the
    plain version in fp32 (the bound chip_smoke.py states)."""
    C, G, S, M = TRAIN_KERNEL_DIMS[1]
    args = _torch(_inputs(6, B, T, C, M, G, S, STUDENT_DILATIONS),
                  torch.bfloat16, cuda)
    k1, k5 = flow_stack.launches, gated_layer.launches
    with torch.inference_mode():
        out = flow_stack(**args, dilations=STUDENT_DILATIONS)
        ref = flow_stack_reference(**{k: v.float() for k, v in args.items()},
                                   dilations=STUDENT_DILATIONS)
    torch.cuda.synchronize()
    assert (flow_stack.launches - k1, gated_layer.launches - k5) == (0, 10)
    assert out.dtype == torch.bfloat16 and out.shape == (B, T, S)
    err = (out.float() - ref).abs().reshape(B, -1).amax(1)
    scale = ref.abs().reshape(B, -1).amax(1)
    assert (err / scale <= 0.02).all(), (err / scale).tolist()


@pytest.mark.gpu
def test_kernel_matches_the_layer_chain_on_card(cuda):
    """Kernel 1 against kernel 5's accumulate epilogue once per layer
    (`flow_stack_by_layers`) on the same operands at the headline shape,
    batch 8 x 2 s at 22.05 kHz (T = 44,032): both keep the reference
    megakernel's rounding, so per batch row max|diff| / max|ref| within
    0.02 (the bound chip_smoke.py states)."""
    B, T = 8, 44032
    args = {k: v.to(cuda) for k, v in _kernel_shaped(B, T).items()}
    k1, k5 = flow_stack.launches, gated_layer.launches
    with torch.inference_mode():
        out = flow_stack(**args, dilations=STUDENT_DILATIONS)
        chain = flow_stack_by_layers(**args, dilations=STUDENT_DILATIONS)
    torch.cuda.synchronize()
    assert (flow_stack.launches - k1, gated_layer.launches - k5) == (1, 10)
    assert out.shape == chain.shape == (B, T, KERNEL_DIMS[2])
    err = (out.float() - chain.float()).abs().reshape(B, -1).amax(1)
    scale = chain.float().abs().reshape(B, -1).amax(1)
    assert (err / scale <= 0.02).all(), (err / scale).tolist()
