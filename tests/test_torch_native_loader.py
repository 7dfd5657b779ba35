"""The port's binding of the C++ loader (`pwn_tpu_torch/data/
native_loader.py`, over the unchanged `native/loader.cc`) against the
reference's binding (`pwn_tpu/data/native_loader.py`): the same batches
for the same seed, start step, partition and cache budget; the
reference's own cases (stereo averaged, a short clip zero-padded, a
broken file skipped, an oversize data chunk refused, an undecodable
corpus raising), each against the reference; and two builds racing in two
processes.
"""

import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

from pwn_tpu_torch.data import native_loader
from pwn_tpu_torch.data.native_loader import NativeWavCropLoader

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _needs_gxx():
    """Both bindings compile `loader.cc` with g++ at first use."""
    from pwn_tpu.data.native_loader import native_available as ref_available

    if not (native_loader.native_available() and ref_available()):
        pytest.skip("g++ is not available: the loader cannot be built")


def _ref_loader(*args, **kw):
    from pwn_tpu.data.native_loader import NativeWavCropLoader as Ref

    return Ref(*args, **kw)


def _pair(*args, n: int = 3, **kw):
    """The first `n` batches of the port's loader and of the reference's on
    the same arguments, and their clip counts."""
    ours, ref = NativeWavCropLoader(*args, **kw), _ref_loader(*args, **kw)
    try:
        return ([next(ours) for _ in range(n)], [next(ref) for _ in range(n)],
                ours.n_clips, ref.n_clips)
    finally:
        ours.close()
        ref.close()


def _assert_same(ours, ref):
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The reference test's corpus: four PCM16 ramps, a stereo file, a
    100-sample clip and a file that is not a wav."""
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    for i in range(4):
        n = 3000 + 500 * i
        wavfile.write(str(d / f"mono_{i}.wav"), 16000,
                      (np.arange(n) % 20000 - 10000).astype(np.int16))
    wavfile.write(str(d / "stereo.wav"), 16000,
                  rng.integers(-5000, 5000, size=(2000, 2)).astype(np.int16))
    wavfile.write(str(d / "short.wav"), 16000, np.ones(100, np.int16) * 1000)
    (d / "broken.wav").write_bytes(b"RIFFnotawave")
    return str(d)


@pytest.mark.parametrize("seed,start_step,index,count,cache_bytes", [
    (1, 0, 0, 1, None),
    (7, 4, 0, 1, None),
    (3, 0, 1, 2, None),
    (5, 2, 0, 2, None),
    (11, 3, 0, 1, 1),       # every clip decoded on demand
    (11, 0, 2, 3, 4000),
])
def test_batches_match_the_reference(corpus, seed, start_step, index, count,
                                     cache_bytes):
    """Same (seed, start_step, partition, cache budget): the reference's
    clip count and batches bit for bit."""
    ours, ref, n, ref_n = _pair(corpus, 256, 4, seed=seed,
                                start_step=start_step, process_index=index,
                                process_count=count, cache_bytes=cache_bytes)
    assert n == ref_n
    _assert_same(ours, ref)


def test_stream_is_keyed_by_seed_and_step(corpus):
    """Step k of a loader started at step 0 equals the first batch of one
    started at step k; another seed gives another stream."""
    whole = NativeWavCropLoader(corpus, 256, 2, seed=7)
    stream = [next(whole) for _ in range(6)]
    whole.close()
    at4 = NativeWavCropLoader(corpus, 256, 2, seed=7, start_step=4)
    _assert_same([next(at4), next(at4)], stream[4:])
    at4.close()
    other = NativeWavCropLoader(corpus, 256, 2, seed=8)
    assert not np.array_equal(next(other), stream[0])
    other.close()


def test_stereo_is_averaged(tmp_path):
    """A stereo clip alone: each crop is a contiguous window of the mean of
    its channels, as the reference's."""
    rng = np.random.default_rng(1)
    st = rng.integers(-8000, 8000, size=(3000, 2)).astype(np.int16)
    wavfile.write(str(tmp_path / "st.wav"), 16000, st)
    ours, ref, n, ref_n = _pair(str(tmp_path), 512, 4, seed=2)
    assert n == ref_n == 1
    _assert_same(ours, ref)
    mean = st.astype(np.float64).mean(axis=1) / 32768.0
    row = ours[0][0].astype(np.float64)
    start = int(np.argmin([np.abs(mean[s:s + 512] - row).max()
                           for s in range(len(mean) - 511)]))
    np.testing.assert_allclose(row, mean[start:start + 512], atol=1 / 32768)


def test_short_clip_is_zero_padded(tmp_path):
    """A clip shorter than the crop: its samples, then zeros."""
    wavfile.write(str(tmp_path / "short.wav"), 16000,
                  np.ones(100, np.int16) * 1000)
    ours, ref, n, ref_n = _pair(str(tmp_path), 1024, 3, seed=5)
    assert n == ref_n == 1
    _assert_same(ours, ref)
    for row in ours[0]:
        np.testing.assert_array_equal(row[:100], np.float32(1000 / 32768.0))
        assert not row[100:].any()


def test_broken_file_is_skipped(tmp_path):
    """A file that is not a wav is skipped, not fatal."""
    (tmp_path / "broken.wav").write_bytes(b"RIFFnotawave")
    wavfile.write(str(tmp_path / "good.wav"), 16000,
                  (np.arange(3000) % 1000).astype(np.int16))
    ours, ref, n, ref_n = _pair(str(tmp_path), 256, 2, seed=1)
    assert n == ref_n == 1
    _assert_same(ours, ref)


def test_oversize_data_chunk_is_refused(tmp_path):
    """A data chunk claiming ~4 GB in a tiny file is a decode failure (not
    an allocation): only the good file counts."""
    fmt = struct.pack("<HHIIHH", 1, 1, 16000, 32000, 2, 16)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt
            + b"data" + struct.pack("<I", 0xFFFFFF00) + b"\x00" * 64)
    (tmp_path / "huge_claim.wav").write_bytes(
        b"RIFF" + struct.pack("<I", len(body)) + body)
    wavfile.write(str(tmp_path / "good.wav"), 16000,
                  (np.arange(2000) % 1000).astype(np.int16))
    ours, ref, n, ref_n = _pair(str(tmp_path), 256, 2, seed=1)
    assert n == ref_n == 1
    _assert_same(ours, ref)


def test_undecodable_corpus_raises(tmp_path):
    """No decodable PCM16 clip (float32 wavs): RuntimeError in both, every
    time (the reference once raced its producer into `key % 0`)."""
    rng = np.random.default_rng(0)
    for i in range(3):
        wavfile.write(str(tmp_path / f"f_{i}.wav"), 16000,
                      rng.random(1000).astype(np.float32))
    for _ in range(5):
        with pytest.raises(RuntimeError, match="no decodable"):
            NativeWavCropLoader(str(tmp_path), 256, 2, seed=1)
        with pytest.raises(RuntimeError, match="no decodable"):
            _ref_loader(str(tmp_path), 256, 2, seed=1)
    with pytest.raises(FileNotFoundError, match="no .wav files"):
        NativeWavCropLoader(str(tmp_path / "none"), 256, 2)


_BUILD_AND_LOAD = """
import ctypes, sys
sys.path.insert(0, sys.argv[1])
from pwn_tpu_torch.data.native_loader import build_native
lib = ctypes.CDLL(str(build_native(sys.argv[2])))
print(bool(lib.pwn_loader_create), bool(lib.pwn_loader_destroy))
"""


def test_two_builds_racing_both_load_a_whole_library(tmp_path):
    """Two processes building into one empty directory at once: both load
    a library with the C ABI, and one library is left, with no
    half-written file beside it."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_AND_LOAD, str(ROOT), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o.strip() for o in outs] == ["True True"] * 2
    assert [p.name for p in tmp_path.iterdir()] == [
        native_loader.library_path(tmp_path).name]
