"""The port's wav-directory corpus and its Python and grain streams
against the reference's (`pwn_tpu/data/pipeline.py`,
`pwn_tpu/data/grain_pipeline.py`), on the same files: `corpus_split`'s
lists, `WavCropDataset`'s items (a resampled file, a stereo one, rank
partitions, the LRU cap), and the batch streams with a resume at step k,
bit for bit.
"""

import numpy as np
import pytest
from scipy.io import wavfile

from pwn_tpu_torch import get_config, override
from pwn_tpu_torch.data import (SyntheticTones, WavCropDataset, corpus_split,
                                make_train_iterator)
from pwn_tpu_torch.utils.audio_io import write_wav
from torch_parity import jax_config

CFG = override(get_config("tiny_teacher"), "train.crop_samples", 512)
SR = CFG.dsp.sample_rate  # 16 kHz


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seven clips in two directories: mono PCM16 at the config's rate
    (one shorter than a crop), one at 22.05 kHz (resampled on read), a
    stereo one, a PCM32 one."""
    d = tmp_path_factory.mktemp("wavs")
    (d / "sub").mkdir()
    rng = np.random.default_rng(0)

    def pcm16(n):
        return (rng.uniform(-0.7, 0.7, n) * 32767).astype(np.int16)

    for i, n in enumerate((3000, 4100, 300, 5200)):
        wavfile.write(str(d / f"m{i}.wav"), SR, pcm16(n))
    wavfile.write(str(d / "sub" / "at22k.wav"), 22050, pcm16(4410))
    wavfile.write(str(d / "sub" / "stereo.wav"), SR,
                  np.stack([pcm16(2500), pcm16(2500)], axis=1))
    wavfile.write(str(d / "sub" / "pcm32.wav"), SR,
                  (rng.uniform(-0.5, 0.5, 2600) * 2 ** 31).astype(np.int32))
    return str(d)


@pytest.mark.parametrize("n_files", [45, 5])
def test_corpus_split_matches_the_reference(tmp_path, n_files):
    """Recursive sorted `*.wav`, every 20th held out; under 20 files both
    lists are the whole corpus; no wav raises FileNotFoundError."""
    from pwn_tpu.data.pipeline import corpus_split as ref_split

    for i in range(n_files):
        sub = tmp_path / f"d{i % 3}"
        sub.mkdir(exist_ok=True)
        (sub / f"utt_{i:03d}.wav").write_bytes(b"")
    (tmp_path / "notes.txt").write_text("not a wav")
    train, val = corpus_split(str(tmp_path))
    assert (train, val) == ref_split(str(tmp_path))
    if n_files >= 20:
        assert len(val) == 3 and len(train) == n_files - 3
        assert not set(train) & set(val)
    else:
        assert train == val and len(train) == n_files
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no .wav files"):
        corpus_split(str(empty))


@pytest.mark.parametrize("index,count", [(0, 1), (0, 2), (1, 2), (2, 3)])
def test_wav_crop_dataset_matches_the_reference(corpus, index, count):
    """This rank's partition `paths[index::count]` and every item: float32
    mono, resampled to the config's rate, bit-identical to the
    reference's."""
    from pwn_tpu.data.pipeline import WavCropDataset as RefDataset

    ours = WavCropDataset(corpus, SR, process_index=index,
                          process_count=count)
    ref = RefDataset(corpus, SR, process_index=index, process_count=count)
    assert ours.paths == ref.paths and len(ours) == len(ref) >= 2
    for i in range(len(ours)):
        a, b = ours[i], np.asarray(ref[i])
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    if count == 1:  # the 22.05 kHz clip: 4,410 samples read as 3,200
        at22 = ours.paths.index(next(p for p in ours.paths
                                     if p.endswith("at22k.wav")))
        assert len(ours[at22]) == 3200


def test_wav_crop_dataset_cache_lru(tmp_path):
    """The decode cache is byte-capped LRU, as the reference's
    (tests/test_data.py::test_wav_crop_dataset_cache_lru): items evict
    oldest first, reads stay correct whatever the budget, a budget of 0
    caches nothing; and each read equals the reference's."""
    from pwn_tpu.data.pipeline import WavCropDataset as RefDataset

    rng = np.random.default_rng(0)
    for i in range(4):
        write_wav(str(tmp_path / f"c{i}.wav"),
                  rng.uniform(-0.5, 0.5, 1000).astype(np.float32), SR)
    ref = RefDataset(str(tmp_path), SR, cache_bytes=9000)
    want = [np.asarray(ref[i]) for i in range(4)]
    ds = WavCropDataset(str(tmp_path), SR, cache_bytes=9000)  # ~2 clips
    got = [ds[i] for i in range(4)]
    assert list(ds._cache) == list(ref._cache) == [2, 3]
    assert ds._cache_size == ref._cache_size == 8000
    ds[2]
    assert list(ds._cache) == [3, 2]  # a hit moves to the end
    for i in range(4):
        np.testing.assert_array_equal(got[i], want[i])
        np.testing.assert_array_equal(ds[i], want[i])
    ds0 = WavCropDataset(str(tmp_path), SR, cache_bytes=0)
    for i in range(4):
        np.testing.assert_array_equal(ds0[i], want[i])
    assert len(ds0._cache) == 0


@pytest.mark.parametrize("index,count", [(0, 1), (1, 2)])
def test_python_iterator_over_a_wav_dir_matches_the_reference(corpus, index,
                                                              count):
    """`make_train_iterator` over this rank's partition: the reference's
    batches bit for bit, and a resume at step 3 equals the uninterrupted
    stream's step 3 onwards."""
    from pwn_tpu.data.pipeline import WavCropDataset as RefDataset
    from pwn_tpu.data.pipeline import make_train_iterator as ref_iterator

    ds = WavCropDataset(corpus, SR, process_index=index, process_count=count)
    ref_ds = RefDataset(corpus, SR, process_index=index, process_count=count)
    ours = make_train_iterator(ds, CFG, 3, seed=11)
    ref = ref_iterator(ref_ds, jax_config(CFG), 3, seed=11)
    stream = []
    for _ in range(5):
        a = next(ours)
        np.testing.assert_array_equal(a, next(ref))
        stream.append(a)
    resumed = make_train_iterator(ds, CFG, 3, seed=11, start_step=3)
    for k in (3, 4):
        np.testing.assert_array_equal(next(resumed), stream[k])


@pytest.mark.parametrize("source", ["wav_dir", "synthetic"])
def test_grain_stream_matches_the_reference(corpus, source):
    """The grain engine in-process over a wav dir and over a synthetic
    corpus: the reference's batches bit for bit, and `start_step` resumes
    the stream at step 2."""
    pytest.importorskip("grain")
    from pwn_tpu.data import SyntheticTones as RefTones
    from pwn_tpu.data.grain_pipeline import make_grain_iterator as ref_grain
    from pwn_tpu.data.pipeline import WavCropDataset as RefDataset

    from pwn_tpu_torch.data.grain_pipeline import make_grain_iterator

    if source == "wav_dir":
        ds, ref_ds = WavCropDataset(corpus, SR), RefDataset(corpus, SR)
    else:
        ds, ref_ds = SyntheticTones(6, 2000, SR), RefTones(6, 2000, SR)
    ours = make_grain_iterator(ds, CFG, 3, seed=5, num_workers=0)
    ref = ref_grain(ref_ds, jax_config(CFG), 3, seed=5, num_workers=0)
    stream = []
    for _ in range(4):
        a = next(ours)
        assert a.shape == (3, 512) and a.dtype == np.float32
        np.testing.assert_array_equal(a, next(ref))
        stream.append(a)
    resumed = make_grain_iterator(ds, CFG, 3, seed=5, start_step=2,
                                  num_workers=0)
    ref_resumed = ref_grain(ref_ds, jax_config(CFG), 3, seed=5,
                            start_step=2, num_workers=0)
    for k in (2, 3):
        a = next(resumed)
        np.testing.assert_array_equal(a, stream[k])
        np.testing.assert_array_equal(a, next(ref_resumed))
