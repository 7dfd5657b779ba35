"""ctypes binding of the C++ data loader (counterpart of
`pwn_tpu/data/native_loader.py`).

`native/loader.cc` is the repository's C++ loader, shared with the
reference and compiled here unchanged: RIFF/PCM16 decode (stereo
averaged, unreadable files skipped), a byte-capped int16 clip cache,
random crops keyed by splitmix64 of (seed, step, slot), and a producer
thread with a bounded queue, behind the C ABI `pwn_loader_create / next /
n_clips / destroy`.  The batch at step k depends on (seed, k) alone, so
`start_step` resumes the stream exactly; a batch's bytes equal the
reference binding's for the same arguments.  The producer runs in C++,
and ctypes releases the interpreter lock for each call.

The native path does not resample: it assumes the corpus is at the
config's rate (LJSpeech is, for the 22.05 kHz presets).  On a corpus at
another rate it feeds the clips as they are, as the reference does; the
Python pipeline (`pipeline.py`) resamples.

Build: g++ at first use, into `pwn_tpu_torch/build/`, the library named by
a hash of `loader.cc` and the flags.  The compiler writes a name of its
own, which is then renamed into place, so a process never loads a
library another process is still writing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from pwn_tpu_torch.data.pipeline import default_cache_bytes, list_wavs

SOURCE = Path(__file__).resolve().parents[2] / "native" / "loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """The library's path: a hash of the flags and of `loader.cc`."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0"
                       + SOURCE.read_bytes())
    return Path(build_dir) / f"libpwn_loader-{h.hexdigest()[:16]}.so"


def build_native(build_dir: Path = BUILD_DIR) -> Path:
    """Compile `loader.cc` unless its library exists; returns the path.
    Raises RuntimeError with g++'s output if the build fails."""
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                                   str(SOURCE)], capture_output=True,
                                  text=True)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found: the native loader is "
                               "compiled at first use") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {SOURCE}:\n"
                               + proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def load_native() -> ctypes.CDLL:
    """The loader's library with its C ABI declared, built first if
    needed; raises if it cannot be built (no g++, a failed compile)."""
    lib = ctypes.CDLL(str(build_native()))
    lib.pwn_loader_create.restype = ctypes.c_void_p
    lib.pwn_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,  # paths, n_paths
        ctypes.c_int, ctypes.c_int,                     # crop, batch
        ctypes.c_uint64, ctypes.c_int,                  # seed, queue_depth
        ctypes.c_uint64, ctypes.c_uint64,               # start_step, cache
    ]
    lib.pwn_loader_next.restype = ctypes.c_int64
    lib.pwn_loader_next.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float)]
    lib.pwn_loader_n_clips.restype = ctypes.c_int64
    lib.pwn_loader_n_clips.argtypes = [ctypes.c_void_p]
    lib.pwn_loader_destroy.restype = None
    lib.pwn_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    """Whether the loader's library builds and loads here."""
    try:
        load_native()
    except (OSError, RuntimeError):
        return False
    return True


class NativeWavCropLoader:
    """Deterministic, resumable batch iterator backed by the C++ loader:
    (batch_size, crop_samples) float32 arrays, the batch at step k a
    function of (seed, k) alone, over this process's partition
    `files[process_index::process_count]` (default: every `*.wav` under
    `wav_dir`, sorted).  `cache_bytes` (default `PWN_TPU_CACHE_BYTES` or
    4 GiB) caps the resident decoded clips; the rest decode on demand in
    the producer thread, which changes no batch."""

    def __init__(
        self,
        wav_dir: Optional[str],
        crop_samples: int,
        batch_size: int,
        seed: int = 0,
        start_step: int = 0,
        queue_depth: int = 4,
        process_index: int = 0,
        process_count: int = 1,
        files: Optional[List[str]] = None,
        cache_bytes: Optional[int] = None,
    ):
        self._lib = load_native()
        all_paths = list(files) if files is not None else list_wavs(wav_dir)
        paths = all_paths[process_index::process_count]
        if not paths:
            raise FileNotFoundError(f"no .wav files under {wav_dir}")
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        if cache_bytes is None:
            cache_bytes = default_cache_bytes()
        self._handle = self._lib.pwn_loader_create(
            arr, len(paths), crop_samples, batch_size, seed, queue_depth,
            start_step, cache_bytes)
        if not self._handle:
            raise RuntimeError(
                f"native loader: no decodable PCM16 wavs under {wav_dir}")
        self.batch_size = batch_size
        self.crop_samples = crop_samples
        self.n_clips = int(self._lib.pwn_loader_n_clips(self._handle))

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        if not self._handle:
            raise StopIteration
        out = np.empty((self.batch_size, self.crop_samples), np.float32)
        step = self._lib.pwn_loader_next(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if step < 0:
            raise StopIteration
        return out

    def close(self) -> None:
        """Stop the producer thread and free the corpus; call it only when
        no other thread is inside `__next__`."""
        if getattr(self, "_handle", None):
            self._lib.pwn_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
