"""grain-backed input pipeline (counterpart of
`pwn_tpu/data/grain_pipeline.py`), for deployments standardised on grain.

The same `grain.MapDataset` chain as the reference, so the same batches
bit for bit: the corpus, repeated without end, shuffled by seed, a
seeded `random_map` crop, batched; `start_step` slices the batched
dataset (`ds[start_step:]`), so a resume replays nothing.  Each process
reads its own partition of the corpus, as with the other engines.

grain is imported when the iterator is made, never at module import: a
machine without grain runs the other engines, and `data_engine="grain"`
there raises ModuleNotFoundError.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from pwn_tpu_torch.config import Config


def make_grain_iterator(
    dataset,
    cfg: Config,
    local_batch_size: int,
    seed: int = 0,
    start_step: int = 0,
    num_workers: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Infinite deterministic (local_batch, crop_samples) float32 batches
    over any indexable corpus (`WavCropDataset`, the synthetic ones).
    `num_workers` > 0 (default `train.grain_workers`) adds grain's
    multiprocess prefetch; the stream is the same with 0 or N workers,
    since every random draw is keyed by the index."""
    import grain

    crop = cfg.train.crop_samples

    def crop_fn(wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if len(wav) <= crop:
            out = np.zeros(crop, np.float32)
            out[: len(wav)] = wav
            return out
        start = int(rng.integers(0, len(wav) - crop))
        return wav[start : start + crop].astype(np.float32)

    ds = (
        grain.MapDataset.source(dataset)
        .repeat()
        .shuffle(seed=seed)
        .random_map(crop_fn, seed=seed + 1)
        .batch(local_batch_size)
    )
    if start_step:
        ds = ds[start_step:]
    it_ds = ds.to_iter_dataset()
    if num_workers is None:
        num_workers = cfg.train.grain_workers
    if num_workers > 0:
        from grain import multiprocessing as gmp

        it_ds = it_ds.mp_prefetch(
            gmp.MultiprocessingOptions(num_workers=num_workers))
    return iter(it_ds)
