"""Waveform generation (counterpart of `pwn_tpu/generate.py`): the
student's mel -> waveform in one parallel pass, for one utterance
(`generate_student`) or many of any lengths (`vocode_many`, the CLI's
`generate --source-dir` path), or in chunks as a stream
(`stream_student_chunks`, and the server's batch engine through
`stream_window`), and the teacher's autoregressive synthesis
(`generate_teacher`).

Noise comes from torch generators, so it differs from `jax.random`'s;
the student entry points also take the noise `z` explicitly, and the
sampling functions under `generate_teacher` take `noise=`, which is how
the tests hold the port against the reference.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from pwn_tpu_torch.config import Config
from pwn_tpu_torch.models import sampling
from pwn_tpu_torch.models.student import StudentIAF, sample_base_noise
from pwn_tpu_torch.models.teacher import TeacherWaveNet
from pwn_tpu_torch.parallel.sp import sp_mega_geometry
from pwn_tpu_torch.utils import dsp
from pwn_tpu_torch.utils.platform import require_cuda
from pwn_tpu_torch.utils.profiling import count, span


def mel_from_wav(cfg: Config, wav: np.ndarray, device=None) -> torch.Tensor:
    """Host wav (T,) float32 -> conditioning mel (1, T//hop, n_mels) float32
    on `device` (default: the CUDA card; the CPU only when passed):
    preemphasis, clip to [-1, 1], normalized log-mel."""
    if device is None:
        device = require_cuda()
    x = torch.as_tensor(np.asarray(wav, np.float32), device=device)[None]
    x = torch.clamp(dsp.preemphasis(x, cfg.dsp.preemphasis), -1.0, 1.0)
    mel = dsp.mel_spectrogram(x, cfg.dsp)
    return mel[:, : wav.shape[-1] // cfg.dsp.hop_length]


def mel_from_wav_host(cfg: Config, wav: np.ndarray) -> np.ndarray:
    """`mel_from_wav` in host numpy: (T,) float32 -> (T//hop, n_mels).  The
    server computes request mels here, off the card's lock."""
    wav = np.asarray(wav, np.float32)
    if cfg.dsp.preemphasis:
        x = wav - cfg.dsp.preemphasis * np.concatenate(
            [[0.0], wav[:-1]]).astype(np.float32)
    else:
        x = wav
    x = np.clip(x, -1.0, 1.0)
    mel = dsp.mel_spectrogram_np(x[None], cfg.dsp)
    return mel[0, : len(wav) // cfg.dsp.hop_length]


def coerce_mel(cfg: Config, mel) -> np.ndarray:
    """Externally supplied mel (F, n_mels) or (1, F, n_mels) -> validated
    host (1, F, n_mels) float32 array.  The convention is
    `mel_spectrogram`'s: cfg.dsp.n_mels Slaney bands, dB normalized to
    [0, 1], from a preemphasized source."""
    if isinstance(mel, torch.Tensor):
        mel = mel.detach().cpu().numpy()
    arr = np.asarray(mel, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[None]
    if (arr.ndim != 3 or arr.shape[0] != 1
            or arr.shape[-1] != cfg.dsp.n_mels):
        raise ValueError(
            f"mel must be (frames, {cfg.dsp.n_mels}) or "
            f"(1, frames, {cfg.dsp.n_mels}); got {arr.shape}"
        )
    if not np.isfinite(arr).all():
        raise ValueError("mel contains non-finite values")
    return arr


def _host_deemphasis(wav: np.ndarray, coef: float) -> np.ndarray:
    """Deemphasis IIR x[t] = y[t] + coef*x[t-1] on the host: a sequential
    filter has no parallelism for the card to use."""
    if coef == 0.0:
        return np.asarray(wav, np.float32)
    from scipy.signal import lfilter

    return lfilter([1.0], [1.0, -coef], np.asarray(wav),
                   axis=-1).astype(np.float32)


def item_generator(seed: int, index: int, device) -> torch.Generator:
    """The noise stream of item `index`: seeded by (seed, index) alone, so
    an item's audio does not depend on which batch it lands in."""
    state = np.random.SeedSequence([seed, index]).generate_state(2)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def load_student(cfg: Config, workdir: str, device) -> StudentIAF:
    """A student built for synthesis ("infer" stacks) holding the serving
    parameters of `workdir`'s latest student checkpoint: the EMA when the
    checkpoint carries it."""
    from pwn_tpu_torch.training.loop import restore_serving_params

    params, _ = restore_serving_params(cfg, workdir, "student", device=device)
    model = StudentIAF(cfg, device=device)
    model.load_state_dict(params)
    return model.eval()


@torch.inference_mode()
def generate_student(cfg: Config, model: StudentIAF, mel,
                     generator: torch.Generator | None = None,
                     temperature: float = 1.0,
                     z: torch.Tensor | None = None) -> np.ndarray:
    """Single-pass synthesis of mel (1, F, n_mels); returns the first row's
    deemphasized (F*hop,) float32 waveform.  Noise is drawn from
    `generator` unless `z` (B, F*hop) is given."""
    device = _model_device(model)
    mel = torch.as_tensor(mel, dtype=torch.float32, device=device)
    B, Fr = mel.shape[0], mel.shape[1]
    if z is None:
        if generator is None:
            raise ValueError("pass generator= or z=")
        z = sample_base_noise(cfg, generator, (B, Fr * cfg.dsp.hop_length))
    wav = model.generate_from_z(z.to(device) * temperature, mel)
    return _host_deemphasis(wav.cpu().numpy(), cfg.dsp.preemphasis)[0]


@torch.inference_mode()
def vocode_many(cfg: Config, model: StudentIAF, mels: Sequence,
                seed: int = 0, temperature: float = 1.0,
                batch_size: int = 8, bucket_frames: int = 64,
                z: Sequence | None = None) -> list:
    """Vocode many variable-length utterances at batched throughput.

    Items are bucketed by length (rounded up to `bucket_frames`) and run
    through the flows in `batch_size` groups; a ragged group is filled
    with repeats of its last item, whose outputs are dropped.  Each
    item's result is exact, independent of batch composition and padding:
    the flows are causal over (z, cond), so padded tails cannot reach a
    real sample, and the upsampler (the only non-causal module) is made
    exact at the true right boundary by a tail splice.  A zero mel frame
    adds nothing to a transposed conv, so the bucket-padded conditioning
    differs from the true-length one only within the upsampler's halo H
    of the boundary; re-upsampling the item's last W = 2H+4 frames and
    splicing in its last S = (H+2)*hop samples overwrites every such
    position with an exact value.  Items shorter than W frames are
    upsampled alone at their true length.

    Item i's noise is `sample_base_noise` of the bucket length from
    `item_generator(seed, i)`, or `z[i]` (at least T_i samples) if given,
    times `temperature`.  Item i's waveform then equals
    `generate_from_z(z_i[:T_i], mel_i)`, deemphasized on the host.

    mels: (F_i, n_mels) or (1, F_i, n_mels) arrays.  Returns a list of
    (T_i,) float32 numpy waveforms, in order.

    The groups run as a two-deep pipeline: group n+1's conditioning and
    flows are enqueued before group n is read back and deemphasized, so
    the host filters one group while the card computes the next.  On a
    card nothing in enqueueing a group waits on it: the uploads go
    through pinned memory, and a group's readback copies into pinned
    memory on a side stream once an event marks its flows done, then
    waits on that copy alone.  A model on the CPU runs the same loop with
    plain copies.

    Under a profiler it records, per group, the spans `vocode.cond`,
    `vocode.readback` and `vocode.deemphasis` (in the order cond(1),
    cond(2), readback(1), deemphasis(1), cond(3), readback(2), ...), and
    counts `vocode.samples_computed` (rows times bucket samples, pad rows
    included), `vocode.samples_useful` (the group's true lengths),
    `vocode.groups` and `vocode.groups_overlapped` (the groups read back
    after the next group's flows were enqueued: all but a call's last)
    (`utils/profiling.py`).
    """
    device = _model_device(model)
    hop = cfg.dsp.hop_length
    _, H = sp_mega_geometry(cfg)
    W = 2 * H + 4
    S = (H + 2) * hop
    items = [coerce_mel(cfg, m)[0] for m in mels]
    if z is not None and len(z) != len(items):
        raise ValueError(f"got {len(z)} noise arrays for {len(items)} mels")
    buckets: dict = {}
    for i, m in enumerate(items):
        fb = -(-m.shape[0] // bucket_frames) * bucket_frames
        buckets.setdefault(fb, []).append(i)

    coef = cfg.dsp.preemphasis
    cuda = device.type == "cuda"
    copier = torch.cuda.Stream(device) if cuda else None

    def upload(a: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(a)
        return t.pin_memory().to(device, non_blocking=True) if cuda \
            else t.to(device)

    def noise(i: int, Tb: int) -> torch.Tensor:
        if z is None:
            return sample_base_noise(cfg, item_generator(seed, i, device),
                                     (Tb,))
        zi = upload(np.asarray(z[i], np.float32)[:Tb])
        if zi.shape[0] < items[i].shape[0] * hop:
            raise ValueError(f"z[{i}] is shorter than item {i}")
        return F.pad(zi, (0, Tb - zi.shape[0]))

    def up(mel: np.ndarray) -> torch.Tensor:
        return model.upsample_cond(upload(mel))

    def launch(fb: int, group: list) -> tuple:
        """Enqueue a group's conditioning, noise and flows: (group, the
        flows' output, an event after them on a card)."""
        Tb = fb * hop
        rows = group + [group[-1]] * (batch_size - len(group))
        with span("vocode.cond"):
            if all(items[i].shape[0] >= W for i in group):
                cond = up(np.stack([
                    np.pad(items[i], ((0, fb - items[i].shape[0]), (0, 0)))
                    for i in rows]))
                tails = up(np.stack([items[i][-W:] for i in rows]))
                for row, i in enumerate(rows):
                    T_i = items[i].shape[0] * hop
                    cond[row, T_i - S: T_i] = tails[row, -S:]
            else:
                cond = torch.cat([
                    F.pad(up(items[i][None]),
                          (0, 0, 0, Tb - items[i].shape[0] * hop))
                    for i in rows])
        zb = torch.stack([noise(i, Tb) for i in rows]) * temperature
        wav = model.flows_from_z(zb, cond)
        done = torch.cuda.current_stream(device).record_event() if cuda \
            else None
        return group, wav, done

    def finish(group: list, wav: torch.Tensor, done, overlapped: bool):
        """Read a launched group back, deemphasize it and keep its items'
        waveforms.  `wav` is held until its copy has landed."""
        with span("vocode.readback"):
            if cuda:
                with torch.cuda.stream(copier):
                    copier.wait_event(done)
                    host = torch.empty(wav.shape, dtype=wav.dtype,
                                       pin_memory=True)
                    host.copy_(wav, non_blocking=True)
                    copied = copier.record_event()
                copied.synchronize()
            else:
                host = wav
            host = host.numpy()
        with span("vocode.deemphasis"):
            got = _host_deemphasis(host, coef)
            if np.may_share_memory(got, host):
                # no filter (coef 0): the outputs must own their samples
                got = got.copy()
        lengths = [items[i].shape[0] * hop for i in group]
        count("vocode.samples_computed", batch_size * wav.shape[1])
        count("vocode.samples_useful", sum(lengths))
        count("vocode.groups")
        if overlapped:
            count("vocode.groups_overlapped")
        for i, T_i, w in zip(group, lengths, got):
            out[i] = w[:T_i]

    out: list = [None] * len(items)
    pending = None
    for fb in sorted(buckets):
        idxs = buckets[fb]
        for at in range(0, len(idxs), batch_size):
            launched = launch(fb, idxs[at: at + batch_size])
            if pending is not None:
                finish(*pending, overlapped=True)
            pending = launched
    if pending is not None:
        finish(*pending, overlapped=False)
    return out


def _stream_geometry(cfg: Config, chunk_frames: int):
    """(R, H, CT, WT, WF) of streaming windows: the receptive-field prefix
    (samples), the upsampler's frame halo, chunk samples, window samples,
    window frames."""
    hop = cfg.dsp.hop_length
    R, H = sp_mega_geometry(cfg)
    CT = chunk_frames * hop
    WT = CT + R
    return R, H, CT, WT, WT // hop + 2 * H


def _stream_plan(cfg: Config, F: int, chunk_frames: int, cover_tail: bool):
    """Window descriptors for streaming an F-frame mel: yields (ws, f_start,
    off, out_off, trim): the base-noise window start (samples), the mel
    window start (frames), the cond offset and the output offset within the
    window, and how many leading samples of the emitted CT-sample chunk to
    drop (non-zero only for the final partial chunk).  Shared by
    `stream_student_chunks` and the server's batch engine, so the two are
    window for window the same."""
    hop = cfg.dsp.hop_length
    R, H, CT, WT, WF = _stream_geometry(cfg, chunk_frames)
    for c in range(F // chunk_frames):
        start = c * CT
        ws = max(0, start - R)
        f_start = min(max(ws // hop - H, 0), F - WF)
        yield ws, f_start, ws - f_start * hop, start - ws, 0
    rem = F % chunk_frames
    if cover_tail and rem:
        # the final partial chunk: the same window shape, ending at the
        # utterance's end; of its CT samples the first CT - rem*hop were
        # emitted already (F >= WF gives T >= WT, so ws >= 0)
        T = F * hop
        ws = T - WT
        f_start = min(max(ws // hop - H, 0), F - WF)
        yield ws, f_start, ws - f_start * hop, (T - CT) - ws, CT - rem * hop


class BlockNoise:
    """The base noise of one streamed request: block b holds samples
    [b*CT, (b+1)*CT) of every row, drawn as `sample_base_noise` of (B, CT)
    from `item_generator(seed, b, device)`, times `temperature`.  Any window
    reads the same values wherever it starts, so the direct stream and the
    server's batch engine give a request the same audio.  Windows advance
    monotonically: blocks before a window's first are dropped."""

    def __init__(self, cfg: Config, seed: int, chunk_samples: int, rows: int,
                 temperature: float, device):
        self.cfg, self.seed, self.CT, self.rows = cfg, seed, chunk_samples, rows
        self.temperature, self.device = temperature, device
        self.blocks: dict = {}

    def window(self, ws: int, n: int) -> torch.Tensor:
        """Samples [ws, ws + n) of every row, (rows, n), on the device."""
        CT = self.CT
        first, last = ws // CT, (ws + n - 1) // CT
        for old in [b for b in self.blocks if b < first]:
            del self.blocks[old]
        for b in range(first, last + 1):
            if b not in self.blocks:
                self.blocks[b] = sample_base_noise(
                    self.cfg, item_generator(self.seed, b, self.device),
                    (self.rows, CT)) * self.temperature
        full = torch.cat([self.blocks[b] for b in range(first, last + 1)], 1)
        lo = ws - first * CT
        return full[:, lo: lo + n]


@torch.inference_mode()
def stream_window(cfg: Config, model: StudentIAF, z_win: torch.Tensor,
                  mel_win, off: Sequence[int],
                  out_off: Sequence[int]) -> torch.Tensor:
    """One streaming window for B rows (counterpart of the reference's
    `_stream_window_fn` and `_batched_stream_window_fn`): upsample the mel
    windows (B, WF, n_mels), take WT = z_win.shape[1] samples of each row's
    conditioning from its `off`, run the flows on (z_win, cond), and return
    CT samples of each row from its `out_off`, (B, CT).  Rows of different
    requests at different window phases share one call, and each row's
    result is the same whatever rows share it.  The caller draws the noise
    windows z_win (B, WT)."""
    device = _model_device(model)
    B, WT = z_win.shape
    CT = WT - sp_mega_geometry(cfg)[0]
    mel_win = torch.as_tensor(mel_win, device=device)
    # each row upsampled alone: cuDNN's bf16 transposed convolutions round
    # some elements of a row differently in a batch of another size, and the
    # flows carry one ulp there far; a row's audio must not depend on the
    # rows that share its call (the flows' rows do not)
    cond = torch.stack([model.upsample_cond(mel_win[i: i + 1])[0, o: o + WT]
                        for i, o in enumerate(off)])
    wav = model.flows_from_z(z_win.to(device), cond)
    return torch.stack([wav[i, o: o + CT] for i, o in enumerate(out_off)])


@torch.inference_mode()
def stream_student_chunks(cfg: Config, model: StudentIAF, mel,
                          seed: int | None = None, z=None,
                          chunk_frames: int = 64, temperature: float = 1.0,
                          cover_tail: bool = False):
    """Streaming synthesis: yield (B, chunk_frames * hop) float32 numpy
    chunks of mel (B, F, n_mels) whose concatenation equals the whole call
    on the same noise.  Each chunk is recomputed with the flows' receptive
    field R = n_flows * (sum(dilations) + 1) (rounded up to a hop) before
    it and the upsampler's frame halo around it, in one window shape.

    cover_tail=True also yields a final partial chunk of
    (F % chunk_frames) * hop samples, from the same window shape ending at
    the utterance's end, so the whole utterance is synthesized.

    Noise: `z` (B, F*hop) as given (temperature not applied), or the block
    stream `BlockNoise(seed)` times `temperature`.
    """
    _, _, CT, WT, WF = _stream_geometry(cfg, chunk_frames)
    if isinstance(mel, torch.Tensor):
        mel = mel.detach().cpu().numpy()
    mel = np.asarray(mel, np.float32)
    B, F = mel.shape[0], mel.shape[1]
    if F % chunk_frames and not cover_tail:
        raise ValueError(
            f"frames {F} not divisible by chunk_frames {chunk_frames} "
            "(pass cover_tail=True to emit a final partial chunk)")
    if F < WF:
        raise ValueError(
            f"utterance of {F} frames is shorter than one streaming window "
            f"({WF}); call generate_student directly")
    if z is None and seed is None:
        raise ValueError("pass seed= (chunk-stream noise) or z=")
    device = _model_device(model)
    if z is not None:
        z = torch.as_tensor(z, dtype=torch.float32)
        z_at = lambda ws: z[:, ws: ws + WT]  # noqa: E731
    else:
        z_at = functools.partial(BlockNoise(cfg, seed, CT, B, temperature,
                                            device).window, n=WT)
    for ws, f_start, off, out_off, trim in _stream_plan(cfg, F, chunk_frames,
                                                        cover_tail):
        out = stream_window(cfg, model, z_at(ws),
                            mel[:, f_start: f_start + WF], [off] * B,
                            [out_off] * B).cpu().numpy()
        yield out[:, trim:] if trim else out


AR_BACKENDS = ("auto", "kernel", "pallas", "scan")


@torch.inference_mode()
def generate_teacher(cfg: Config, teacher: TeacherWaveNet, mel,
                     generator: torch.Generator, temperature: float = 1.0,
                     ar_backend: str = "auto",
                     ar_weights_dtype: str | None = None) -> np.ndarray:
    """AR teacher synthesis of mel (B, F, n_mels); returns the first row's
    deemphasized (F*hop,) float32 waveform, as the reference does.

    ar_backend: "auto" and "kernel" (or the reference's name "pallas")
    run the whole-loop sampler, `sampling.fast_sample_kernel`: the CUDA
    kernel on a model on the card, its plain version on a CPU model;
    "scan" runs the eager conv-queue loop `sampling.fast_sample`, only when
    asked for.  ar_weights_dtype ("float32" or "bfloat16") overrides the
    whole-loop sampler's weight storage (compute is fp32 either way);
    None keeps the compute dtype.  Noise is drawn from `generator`, which
    lives on the model's device.
    """
    if ar_backend not in AR_BACKENDS:
        raise ValueError(f"ar_backend {ar_backend!r}; one of {AR_BACKENDS}")
    mel = torch.as_tensor(mel, dtype=torch.float32,
                          device=_model_device(teacher))
    if ar_backend == "scan":
        wav = sampling.fast_sample(teacher, generator, mel,
                                   temperature=temperature)
    else:
        wav = sampling.fast_sample_kernel(teacher, generator, mel,
                                          temperature=temperature,
                                          weights_dtype=ar_weights_dtype)
    return _host_deemphasis(wav.cpu().numpy(), cfg.dsp.preemphasis)[0]
