"""Sequence-parallel synthesis: one utterance spread over ranks by time
(counterpart of `pwn_tpu/parallel/sp.py`).

Every op of the student is pointwise or a causal dilated conv, so time
sharding needs only boundary samples.  Two paths, as in the reference:

* Overlap-recompute (`make_sp_generate_mega`): rank r of n computes its
  T/n samples from a window that starts R samples earlier, R the flow
  chain's receptive field rounded up to a hop (`sp_mega_geometry`), with
  the mel frames around it, through the same body as a streaming window
  (`generate.stream_window`: kernel 1 for student_iaf, kernel 5's
  accumulate chain for large_student_sharded), then all_gathers along
  time.  No other communication.  `local_window` is one rank's compute,
  so one process can run every rank in turn.

* Halo exchange (`make_sp_generate`): each rank holds T/n samples of z and
  F/n mel frames (`shard_mel_time`) and takes from its neighbours what its
  convolutions reach: the upsampler the frames around its own (the window
  aligned to the utterance's edges as in the overlap path), each flow's
  shift one sample from the left, each gated layer of dilation d the last
  d samples of the left neighbour's layer input.  The reference has GSPMD
  derive these exchanges and forces its XLA stack; the port exchanges
  explicitly and keeps kernel 5 (`ops/gated_layer.py::
  gated_layer_accumulate`) on `[halo | local]`, rank 0's halo the causal
  zero history.  A shard must cover the largest dilation: the exchange
  reaches one neighbour, as GSPMD's does.

The halo path is written once, as a rank program (`sp_program`, a
generator) that yields each exchange (`Exchange`) and gets back what its
neighbours sent: `run_in_group` serves it with point-to-point sends over
the process group (Gloo or NCCL), `run_in_process` serves n programs in
lockstep in one process.  At n = 1 both paths are the plain `generate`.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from pwn_tpu_torch.config import Config
from pwn_tpu_torch.parallel.mesh import process_count, process_index
from pwn_tpu_torch.parallel.tp import gather_along, global_noise


def sp_mega_geometry(cfg: Config) -> tuple[int, int]:
    """(R, H): overlap samples (the flow chain's receptive field rounded
    up to a hop multiple) and the upsampler's frame halo."""
    sc = cfg.student
    hop = cfg.dsp.hop_length
    r = sc.n_flows * (sum(sc.flow_dilations) + 1)
    R = -(-r // hop) * hop
    H = cfg.teacher.upsample_kernel_mult * len(
        cfg.teacher.upsample_strides
    ) + 2
    return R, H


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


# ------------------------------------------------------ overlap-recompute


def validate_sp_mega(cfg: Config, n: int, n_frames: int) -> None:
    """The reference's refusals of an overlap-recompute split of n_frames
    over n ranks; nothing at n = 1 (the plain generate)."""
    hop = cfg.dsp.hop_length
    R, H = sp_mega_geometry(cfg)
    if n == 1:
        return
    if n_frames % n:
        raise ValueError(f"frames {n_frames} not divisible by {n} devices")
    shard_T = (n_frames // n) * hop
    if shard_T < R + H * hop:
        raise ValueError(
            f"SP shard of {shard_T} samples is smaller than the overlap "
            f"{R} + upsampler halo {H * hop}; use >= "
            f"{(R + H * hop) * n // hop} frames or fewer shards")
    if shard_T + R + 2 * H * hop > n_frames * hop:
        raise ValueError("window exceeds the utterance; use more frames")


def local_window(cfg: Config, model, z: torch.Tensor, mel, rank: int, n: int,
                 cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rank `rank` of n's samples (B, T/n) of the overlap-recompute split:
    the window of R + T/n samples of the global noise z (B, T) ending at
    its shard's end (starting at 0 on rank 0) and the mel frames around it
    (B, F, n_mels), through `generate.stream_window`.  With `cond` (the
    whole call's (B, T, n_mels) conditioning) the window takes its slice
    of it and skips the upsampler."""
    from pwn_tpu_torch.generate import stream_window

    hop = cfg.dsp.hop_length
    R, H = sp_mega_geometry(cfg)
    B, T = z.shape
    shard_T = T // n
    WT = R + shard_T
    ws = 0 if rank == 0 else rank * shard_T - R
    out_off = 0 if rank == 0 else R
    if cond is not None:
        with torch.no_grad():
            wav = model.flows_from_z(z[:, ws: ws + WT], cond[:, ws: ws + WT])
        return wav[:, out_off: out_off + shard_T]
    F_ = T // hop
    WF = WT // hop + 2 * H
    f_start = min(max(ws // hop - H, 0), F_ - WF)
    return stream_window(cfg, model, z[:, ws: ws + WT],
                         mel[:, f_start: f_start + WF],
                         [ws - f_start * hop] * B, [out_off] * B)


def make_sp_generate_mega(cfg: Config, temperature: float = 1.0):
    """`(model, seed, mel) -> wav (B, T)` on every rank: time split over
    every rank of the group by overlap-recompute.  Each rank draws the
    global noise (`parallel/tp.py::global_noise`), computes its
    `local_window` from the whole mel (B, F, n_mels), and all_gathers along
    time.  One rank: the plain `generate` from the same generator."""

    @torch.no_grad()
    def generate(model, seed: int, mel):
        n, rank = process_count(), process_index()
        device = _model_device(model)
        mel = torch.as_tensor(mel, dtype=torch.float32, device=device)
        B, F_ = mel.shape[0], mel.shape[1]
        z = global_noise(cfg, seed, (B, F_ * cfg.dsp.hop_length), device,
                         temperature)
        if n == 1:
            return model.generate_from_z(z, mel)
        validate_sp_mega(cfg, n, F_)
        return gather_along(local_window(cfg, model, z, mel, rank, n), 1)

    return generate


# ---------------------------------------------------------- halo exchange


def validate_sp(cfg: Config, n: int, n_frames: int) -> None:
    """The reference's refusals of a halo-exchange split of n_frames over n
    ranks: the frames must divide, and a shard must cover the largest
    dilation (the exchange reaches one neighbour)."""
    if n_frames % n:
        raise ValueError(f"frames {n_frames} not divisible by {n} devices")
    shard_samples = n_frames * cfg.dsp.hop_length // n
    max_dil = max(cfg.student.flow_dilations)
    if shard_samples < max_dil:
        raise ValueError(
            f"sequence-parallel shard of {shard_samples} samples is "
            f"smaller than the max dilation {max_dil}; use >= "
            f"{max_dil * n // cfg.dsp.hop_length} frames or fewer shards")


def shard_mel_time(mel, rank: int, n: int):
    """Rank `rank` of n's frames of mel (B, F, n_mels): (B, F/n, n_mels)."""
    Fs = mel.shape[1] // n
    return mel[:, rank * Fs: (rank + 1) * Fs]


class Exchange(NamedTuple):
    """One exchange of a rank program: what it sends to rank - 1 and to
    rank + 1 (None: nothing that way).  The program gets back (what rank -
    1 sent right, what rank + 1 sent left), each shaped as its own message
    that way, None at the edges of the world or where it sent nothing."""

    to_left: Optional[torch.Tensor] = None
    to_right: Optional[torch.Tensor] = None


def _msg(t: torch.Tensor) -> torch.Tensor:
    """A message: a contiguous copy, so the sender may overwrite its
    buffers once the exchange is done."""
    return t.clone(memory_format=torch.contiguous_format)


def _halo_cond(cfg: Config, model, mel_local: torch.Tensor, rank: int,
               n: int):
    """The conditioning of this rank's samples (B, T/n, n_mels).  The
    upsampler needs H frames around them; its window of F/n + 2H frames is
    aligned to the utterance's edges as in `local_window` (zero frames
    would leak the first stage's bias through the second), so each rank
    collects K = 2H frames from each side, over ceil(K / (F/n)) exchanges
    when a shard is shorter than K."""
    hop = cfg.dsp.hop_length
    _, H = sp_mega_geometry(cfg)
    Fs = mel_local.shape[1]
    F_ = Fs * n
    WF = min(Fs + 2 * H, F_)
    K = WF - Fs
    left, right = mel_local[:, :0], mel_local[:, :0]
    for _ in range(-(-K // Fs)):
        to_left = _msg(torch.cat([mel_local, right], 1)[:, :K])
        to_right = _msg(torch.cat([left, mel_local], 1)[:, -K:])
        fl, fr = yield Exchange(to_left, to_right)
        left = torch.zeros_like(to_right) if fl is None else fl
        right = torch.zeros_like(to_left) if fr is None else fr
    ext = torch.cat([left, mel_local, right], 1)  # frames from rank*Fs - K
    start = min(max(rank * Fs - H, 0), F_ - WF)
    lo = start - (rank * Fs - K)
    cond = model.upsample_cond(ext[:, lo: lo + WF])
    off = (rank * Fs - start) * hop
    return cond[:, off: off + Fs * hop]


def _halo_stack(stack, x_in: torch.Tensor, cond: torch.Tensor):
    """One flow's WaveNetStack ("infer" mode) on this rank's samples: the
    front 1x1, then each layer through kernel 5's accumulate epilogue on a
    window [halo | local] of D + T/n samples (D the largest dilation), the
    layer of dilation d taking the last d samples of the left neighbour's
    layer input into the d samples before its own (the rest of the halo is
    never read); the fp32 skip sum spans the window, in buffers allocated
    once (a time slice of a (B, T, S) buffer is not contiguous for B > 1),
    rounded at the last layer as `flow_stack` rounds it; the head on the
    local part."""
    from pwn_tpu_torch.ops.gated_layer import gated_layer_accumulate

    if stack.mode != "infer":
        raise ValueError(f"halo-exchange SP runs the 'infer' stack mode, "
                         f"not {stack.mode!r}")
    x = stack.front(x_in)
    dt, dev = stack.dtype, x.device
    w_in, b_g, w_out, b_rs = stack.stacked()
    dils = stack.dilations
    L, D = len(dils), max(dils)
    B, Tl, C = x.shape
    S = w_out.shape[1] - C
    W = D + Tl
    cond_w = torch.zeros((B, W, cond.shape[-1]), dtype=dt, device=dev)
    cond_w[:, D:] = cond
    bufs = [torch.zeros((B, W, C), dtype=dt, device=dev) for _ in range(2)]
    skip_acc = (torch.zeros((B, W, S), dtype=torch.float32, device=dev)
                if L > 1 else None)
    skip = torch.zeros((B, W, S), dtype=dt, device=dev)
    cur = bufs[0]
    cur[:, D:] = x
    for l, d in enumerate(dils):
        halo, _ = yield Exchange(to_right=_msg(cur[:, W - d:]))
        if halo is None:
            cur[:, D - d: D] = 0
        else:
            cur[:, D - d: D] = halo
        last = l == L - 1
        out = skip if last else bufs[(l + 1) % 2]
        gated_layer_accumulate(cur, cond_w, w_in[l], b_g[l], w_out[l],
                               b_rs[l], d, skip_acc, first=l == 0, last=last,
                               out=out)
        cur = out
    h = F.relu(skip[:, D:])
    h = F.relu(stack.head1(h))
    return stack.head2(h).float()


def sp_program(cfg: Config, model, z_local: torch.Tensor,
               mel_local: torch.Tensor, rank: int, n: int,
               cond_local: Optional[torch.Tensor] = None):
    """Rank `rank` of n's halo-exchange synthesis as a generator of
    `Exchange`s, returning its samples (B, T/n): z_local its (B, T/n) of
    the global noise, mel_local its (B, F/n, n_mels) frames (or
    `cond_local`, its (B, T/n, n_mels) of the whole call's conditioning,
    which skips the upsampler).  The flows as `StudentIAF.flows_from_z`,
    in the same order of operations.  `run_in_group` and `run_in_process`
    run it without grad (a context manager held across a yield would leak
    into the caller)."""
    if cond_local is None:
        cond_local = yield from _halo_cond(cfg, model, mel_local, rank, n)
    clamp = cfg.student.log_scale_clamp
    z = z_local.float()
    for flow in model.flows:
        prev, _ = yield Exchange(to_right=_msg(z[:, -1:]))
        if prev is None:
            prev = torch.zeros_like(z[:, -1:])
        out = yield from _halo_stack(
            flow, torch.cat([prev, z[:, :-1]], 1)[..., None], cond_local)
        log_s = torch.clamp(out[..., 1], -clamp, clamp)
        z = z * torch.exp(log_s) + out[..., 0]
    return torch.clamp(z, -1.0, 1.0)


def _resume(program, reply):
    """Run a rank program to its next exchange, without grad."""
    with torch.no_grad():
        return program.send(reply)


def run_in_group(program, rank: int, n: int):
    """Serve a rank program's exchanges with point-to-point sends to the
    neighbouring ranks of the process group (`dist.batch_isend_irecv`);
    returns the program's result."""
    reply = None
    while True:
        try:
            ex = _resume(program, reply)
        except StopIteration as stop:
            return stop.value
        ops, fl, fr = [], None, None
        if rank > 0 and ex.to_left is not None:
            ops.append(dist.P2POp(dist.isend, ex.to_left, rank - 1))
        if rank + 1 < n and ex.to_right is not None:
            ops.append(dist.P2POp(dist.isend, ex.to_right, rank + 1))
        if rank > 0 and ex.to_right is not None:
            fl = torch.empty_like(ex.to_right)
            ops.append(dist.P2POp(dist.irecv, fl, rank - 1))
        if rank + 1 < n and ex.to_left is not None:
            fr = torch.empty_like(ex.to_left)
            ops.append(dist.P2POp(dist.irecv, fr, rank + 1))
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        reply = (fl, fr)


def run_in_process(programs: Sequence,
                   call: Optional[Callable] = None) -> List:
    """Serve n rank programs in one process, in lockstep: each runs to its
    next exchange in rank order, then every message is delivered.
    `call(rank, fn)` runs each stretch of a rank's compute (`fn()`), so a
    caller can time it or count its launches; returns every result."""
    call = call or (lambda rank, fn: fn())
    n = len(programs)
    replies: list = [None] * n
    results: list = [None] * n
    while True:
        reqs, done = [], 0
        for r, prog in enumerate(programs):
            try:
                reqs.append(call(r, lambda: _resume(prog, replies[r])))
            except StopIteration as stop:
                results[r] = stop.value
                reqs.append(None)
                done += 1
        if done == n:
            return results
        if done:
            raise RuntimeError("rank programs made different exchanges")
        for r, ex in enumerate(reqs):
            fl = reqs[r - 1].to_right if r > 0 else None
            fr = reqs[r + 1].to_left if r + 1 < n else None
            replies[r] = (fl if ex.to_right is not None else None,
                          fr if ex.to_left is not None else None)


def sp_generate_in_process(cfg: Config, model, z: torch.Tensor, mel, n: int,
                           cond: Optional[torch.Tensor] = None,
                           call: Optional[Callable] = None) -> torch.Tensor:
    """Every rank of an n-way halo-exchange split in this process
    (`run_in_process`): z (B, T) the global noise, mel (B, F, n_mels) (or
    `cond` (B, T, n_mels)); returns (B, T)."""
    validate_sp(cfg, n, mel.shape[1])
    Ts = z.shape[1] // n
    progs = [sp_program(cfg, model, z[:, r * Ts: (r + 1) * Ts],
                        shard_mel_time(mel, r, n), r, n,
                        None if cond is None else cond[:, r * Ts: (r + 1) * Ts])
             for r in range(n)]
    return torch.cat(run_in_process(progs, call), 1)


def make_sp_generate(cfg: Config, temperature: float = 1.0):
    """`(model, seed, mel_local) -> wav (B, T)` on every rank: time split
    over every rank of the group by halo exchange.  mel_local is this
    rank's (B, F/n, n_mels) (`shard_mel_time`); each rank draws the global
    noise (`parallel/tp.py::global_noise`), keeps its T/n samples, runs
    `sp_program` through `run_in_group`, and all_gathers along time.  One
    rank: the plain `generate` from the same generator."""

    @torch.no_grad()
    def generate(model, seed: int, mel_local):
        n, rank = process_count(), process_index()
        device = _model_device(model)
        mel_local = torch.as_tensor(mel_local, dtype=torch.float32,
                                    device=device)
        B, Fs = mel_local.shape[0], mel_local.shape[1]
        T = Fs * n * cfg.dsp.hop_length
        z = global_noise(cfg, seed, (B, T), device, temperature)
        if n == 1:
            return model.generate_from_z(z, mel_local)
        validate_sp(cfg, n, Fs * n)
        Ts = T // n
        part = run_in_group(sp_program(cfg, model,
                                       z[:, rank * Ts: (rank + 1) * Ts],
                                       mel_local, rank, n), rank, n)
        return gather_along(part, 1)

    return generate
