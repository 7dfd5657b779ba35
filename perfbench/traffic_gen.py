"""The benchmark's one traffic generator: utterance lengths, mels and noise
for the vocoding mix, and a frozen copy of the program's
synthetic tone corpus and crop stream, which the training reference reads
to rebuild the batches the program's feed gives its first steps.

A mix's parameters live in `traffic/<mix>.json`.  Every seed gets the same
multiset of lengths (the distribution's quantiles) in another order, so
the seed changes the content and the order of the work, not its amount.
"""

from __future__ import annotations

import numpy as np


def seed_ints(seed: int, n: int) -> list:
    """n independent 63-bit seeds derived from the run's seed."""
    st = np.random.SeedSequence(int(seed)).generate_state(n, np.uint64)
    return [int(s) & ((1 << 63) - 1) for s in st]


def lengths_s(spec: dict, n: int, seed: int) -> np.ndarray:
    """n utterance lengths in seconds: the quantiles (i + 0.5) / n of the
    mix's distribution (a beta on [min_s, max_s]), in an order drawn from
    the seed."""
    from scipy.stats import beta as beta_dist

    if spec["dist"] != "beta":
        raise ValueError(f"length distribution {spec['dist']!r}")
    u = (np.arange(n) + 0.5) / n
    x = spec["min_s"] + (spec["max_s"] - spec["min_s"]) * beta_dist.ppf(
        u, spec["a"], spec["b"])
    return np.random.default_rng(seed).permutation(x)


def frames_of(seconds: np.ndarray, sample_rate: int, hop: int) -> np.ndarray:
    return np.maximum(1, np.round(seconds * sample_rate / hop)).astype(int)


def make_mels(frames, n_mels: int, seed: int, device) -> list:
    """One host float32 mel (F_i, n_mels) per entry of `frames`, drawn on
    the device in one call: Gaussian noise smoothed over 5 frames and 3
    bands, mapped into [0, 1] around 0.5."""
    import torch

    total = int(np.sum(frames))
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((1, 1, total + 4, n_mels + 2), generator=gen,
                    device=device)
    x = torch.nn.functional.avg_pool2d(x, (5, 3), stride=1)[0, 0]
    mel = (0.5 + 0.6 * x).clamp(0.0, 1.0).cpu().numpy()
    return np.split(mel, np.cumsum(frames)[:-1])


def item_noise(seed: int, index: int, n: int, device):
    """The base noise the program draws for item `index` of a batch job run
    with `seed` (`generate.vocode_many` without `z`): n Logistic(0, 1)
    draws from a generator on the device seeded by the SeedSequence of
    (seed, index), u clipped to [1e-5, 1 - 1e-5], log u - log1p(-u).  A
    frozen copy: the reference rebuilds each item's noise from it."""
    import torch

    state = np.random.SeedSequence([seed, index]).generate_state(2)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    u = torch.rand((n,), generator=gen, device=device)
    u = 1e-5 + u * (1.0 - 2e-5)
    return torch.log(u) - torch.log1p(-u)


# --------------------------------------------------------------------------
# frozen copy of the program's synthetic tone corpus and crop stream
# --------------------------------------------------------------------------

def tone_clip(seed: int, i: int, n_samples: int, sr: int) -> np.ndarray:
    """Clip i of the tone corpus of `seed`: 5 harmonics of a random f0 in
    80-400 Hz under a slow sine envelope, peak 0.7."""
    rng = np.random.default_rng(seed * 100003 + i)
    t = np.arange(n_samples) / sr
    wav = np.zeros_like(t, dtype=np.float32)
    f0 = rng.uniform(80.0, 400.0)
    for h in range(1, 6):
        amp = rng.uniform(0.05, 0.5) / h
        wav += (amp * np.sin(2 * np.pi * f0 * h * t
                             + rng.uniform(0, 2 * np.pi))).astype(np.float32)
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * t))
    wav *= env.astype(np.float32)
    return (wav / max(np.abs(wav).max(), 1e-3) * 0.7).astype(np.float32)


def tone_batches(stream_seed: int, steps: int, batch: int, crop: int,
                 sr: int, n_clips: int = 64, corpus_seed: int = 0):
    """The first `steps` (batch, crop) batches of the crop stream over the
    tone corpus: step k draws `batch` clip indices and a crop start each
    from default_rng((stream_seed << 20) ^ k)."""
    n_samples = max(crop, sr)
    clips = {}
    out = []
    for k in range(steps):
        rng = np.random.default_rng((stream_seed << 20) ^ k)
        rows = []
        for i in rng.integers(0, n_clips, size=batch):
            i = int(i)
            if i not in clips:
                clips[i] = tone_clip(corpus_seed, i, n_samples, sr)
            wav = clips[i]
            if len(wav) <= crop:
                row = np.zeros(crop, np.float32)
                row[: len(wav)] = wav
            else:
                start = int(rng.integers(0, len(wav) - crop))
                row = wav[start: start + crop]
            rows.append(row)
        out.append(np.stack(rows))
    return out
