"""Streaming vocoder HTTP server (counterpart of `pwn_tpu/serve.py`).

Protocol (standard library only, chunked transfer):

- ``GET /healthz`` -> ``{"status": "ok", ...}``: the device, admissions,
  the batch engine's calls, rows and retries, time-to-first-byte
  percentiles, draining;
- ``POST /synthesize[?temperature=T&chunk_frames=N&batching=off]`` with a
  RIFF wav body (copy-synthesis: the mel is computed on the host) or an
  ``.npy`` body holding a ``(frames, n_mels)`` float mel (the vocoder's
  production input, convention at `generate.coerce_mel`) -> raw
  little-endian PCM16 mono, streamed a chunk at a time as the card emits
  it; the sample rate in the ``X-Sample-Rate`` header.

One card, one compute stream: every device call and its copy to the host
runs under `VocoderService.lock`, which also keeps two requests from
building the stacks' cached weights at once.  The HTTP layer is threaded,
so health checks never wait on synthesis.  With ``batch_max > 1``
concurrent streams are batched across requests: `_BatchEngine` runs the
next windows of up to ``batch_max`` requests, each at its own window phase,
in one call of `generate.stream_window`.

Bounds: bodies past ``max_body_bytes`` get 413; admissions past
``max_pending`` (or while draining) get 503 with ``Retry-After``; each
request's chunks wait in a queue of ``queue_chunks``, so a slow client
holds bounded host memory, and a client that goes away stops its producer.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import NamedTuple, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch
from scipy.signal import lfilter

from pwn_tpu_torch import generate
from pwn_tpu_torch.config import Config
from pwn_tpu_torch.models.student import StudentIAF
from pwn_tpu_torch.utils.audio_io import read_wav
from pwn_tpu_torch.utils.platform import require_cuda

SHUTDOWN = "the batch engine is shut down"


def _pcm16(x: np.ndarray) -> bytes:
    return (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


class _ShortUtterance(Exception):
    """Raised before any chunk streams: the utterance is shorter than one
    streaming window, so it takes the whole-call route.  A type of its own,
    so that a ValueError relayed from the batch engine mid-stream is never
    taken for this decision (which would append a whole synthesis after
    chunks already sent)."""


class _Deemph:
    """Streaming one-pole deemphasis x[t] = y[t] + coef * x[t-1], its state
    carried across chunks, so the streamed output equals the whole call's
    host deemphasis sample for sample."""

    def __init__(self, coef: float):
        self.coef = coef
        self._zi = np.zeros(1, np.float64)

    def __call__(self, y: np.ndarray) -> np.ndarray:
        if self.coef == 0.0:
            return y
        x, self._zi = lfilter([1.0], [1.0, -self.coef], y.astype(np.float64),
                              zi=self._zi)
        return x.astype(np.float32)


class _Job(NamedTuple):
    """One streaming window of one request, queued to `_BatchEngine`."""

    mel_win: np.ndarray    # (1, WF, n_mels) host window
    z_win: torch.Tensor    # (1, WT) the request's noise window, temperature in
    off: int               # cond offset within the window
    out_off: int           # output offset within the window
    future: Future         # resolves to the (CT,) waveform row


class _BatchEngine:
    """Batching across requests: one device call per streaming window serves
    up to `max_batch` concurrent streams, each row at its own window phase
    (`generate.stream_window`).

    - Jobs gather for `gather_ms` after the first arrives, but only while
      more than one engine-routed stream is active, so a lone stream pays no
      batching delay.
    - A call runs exactly the rows gathered: nothing is padded.
    - `ValueError` and `TypeError` are relayed at once; any other error is
      retried once (a transient device error would otherwise fail every
      stream of the batch), and counted in `retries`.
    - `stop()` fails every queued job with an error naming the shutdown.
    """

    def __init__(self, service: "VocoderService", max_batch: int = 4,
                 gather_ms: float = 3.0):
        self.service = service
        # powers of two up to batch_max, as the reference reports them
        self.buckets = [b for b in (1, 2, 4, 8, 16) if b <= max_batch]
        self.max_batch = self.buckets[-1]
        self.gather_ms = gather_ms
        self.calls = 0    # device calls run
        self.rows = 0     # rows across those calls
        self.retries = 0  # calls retried after an error
        # engine-routed streams now active: the gather keys off this, so
        # direct-path and whole-call requests (which never queue jobs) do
        # not make a lone engine stream wait gather_ms a window
        self._streams = 0
        self._streams_lock = threading.Lock()
        self._stopped = False
        self._submit_lock = threading.Lock()
        self.jobs: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stream_started(self) -> None:
        with self._streams_lock:
            self._streams += 1

    def stream_done(self) -> None:
        with self._streams_lock:
            self._streams -= 1

    @property
    def active_streams(self) -> int:
        with self._streams_lock:
            return self._streams

    def submit(self, job: _Job) -> Future:
        with self._submit_lock:
            if not self._stopped:
                self.jobs.put(job)
                return job.future
        job.future.set_exception(RuntimeError(SHUTDOWN))
        return job.future

    def stop(self) -> None:
        """Refuse new jobs, fail the queued ones, and end the thread."""
        with self._submit_lock:
            self._stopped = True
            queued = []
            with contextlib.suppress(queue.Empty):
                while True:
                    queued.append(self.jobs.get_nowait())
            self.jobs.put(None)
        for job in queued:
            if job is not None:
                job.future.set_exception(RuntimeError(SHUTDOWN))
        self._thread.join(timeout=10)

    def _gather(self, batch: list) -> None:
        """Add queued jobs to `batch`, up to max_batch: within gather_ms
        while another engine stream is active, else only those waiting."""
        deadline = (time.monotonic() + self.gather_ms * 1e-3
                    if self.active_streams > 1 else None)
        while len(batch) < self.max_batch:
            try:
                if deadline is None:
                    nxt = self.jobs.get_nowait()
                else:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        return
                    nxt = self.jobs.get(timeout=rem)
            except queue.Empty:
                return
            if nxt is None:
                self.jobs.put(None)  # keep the stop for the loop
                return
            batch.append(nxt)

    def _run(self) -> None:
        with self.service.scope():
            while True:
                job = self.jobs.get()
                if job is None:
                    return
                batch = [job]
                self._gather(batch)
                self._execute(batch)

    def _execute(self, batch: list) -> None:
        svc = self.service

        def run_once() -> np.ndarray:
            with svc.lock:
                return generate.stream_window(
                    svc.cfg, svc.model, torch.cat([j.z_win for j in batch]),
                    np.concatenate([j.mel_win for j in batch]),
                    [j.off for j in batch],
                    [j.out_off for j in batch]).cpu().numpy()

        def fail(e: Exception) -> None:
            for j in batch:
                j.future.set_exception(e)

        try:
            out = run_once()
        except (ValueError, TypeError) as e:
            # deterministic: a second call would fail the same way
            return fail(e)
        except Exception:  # noqa: BLE001 — one retry before failing
            self.retries += 1
            try:
                out = run_once()
            except Exception as e:  # noqa: BLE001 — relay to every waiter
                return fail(e)
        self.calls += 1
        self.rows += len(batch)
        for i, j in enumerate(batch):
            j.future.set_result(out[i])


class VocoderService:
    """The config, the student, the device lock, admissions and statistics;
    shared by every HTTP thread."""

    def __init__(self, cfg: Config, model: StudentIAF,
                 chunk_frames: int = 64, max_pending: int = 4,
                 queue_chunks: int = 64, max_body_bytes: int = 64 * 2 ** 20,
                 batch_max: int = 1, batch_window_ms: float = 3.0):
        self.cfg = cfg
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.chunk_frames = chunk_frames
        self.max_pending = max_pending
        self.queue_chunks = queue_chunks
        self.max_body_bytes = max_body_bytes
        self.lock = threading.Lock()  # one card, one compute stream
        self._counter = itertools.count()  # request ids, atomic under the GIL
        self._pending = 0
        self._pending_cv = threading.Condition()
        self.requests_served = 0
        # draining stops admissions (503) while streams in flight finish
        self.draining = False
        self._ttfb_ms: "deque[float]" = deque(maxlen=512)
        self._stats_lock = threading.Lock()
        self.engine = (_BatchEngine(self, batch_max, batch_window_ms)
                       if batch_max > 1 else None)

    def scope(self) -> contextlib.ExitStack:
        """What a thread that touches the card enters first: inference mode
        and the current device are per thread."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        if self.device.type == "cuda":
            stack.enter_context(torch.cuda.device(self.device))
        return stack

    def close(self) -> None:
        if self.engine is not None:
            self.engine.stop()

    def try_admit(self) -> bool:
        """Reserve a synthesis slot; False when `max_pending` are taken or
        the server is draining (the HTTP layer then answers 503)."""
        if self.draining:
            return False
        with self._pending_cv:
            if self._pending >= self.max_pending:
                return False
            self._pending += 1
            return True

    def release(self) -> None:
        with self._pending_cv:
            self._pending -= 1
            self._pending_cv.notify_all()

    def wait_idle(self, timeout_s: float) -> bool:
        """Wait until no synthesis is admitted; False on timeout."""
        with self._pending_cv:
            return self._pending_cv.wait_for(lambda: self._pending == 0,
                                             timeout_s)

    @property
    def pending(self) -> int:
        with self._pending_cv:
            return self._pending

    def observe_ttfb(self, ms: float) -> None:
        with self._stats_lock:
            self._ttfb_ms.append(ms)

    def ttfb_stats(self) -> dict:
        with self._stats_lock:
            xs = sorted(self._ttfb_ms)
        if not xs:
            return {"count": 0}
        pick = lambda q: xs[min(len(xs) - 1, int(q * len(xs)))]  # noqa: E731
        return {"count": len(xs), "p50_ms": round(pick(0.50), 1),
                "p90_ms": round(pick(0.90), 1),
                "p99_ms": round(pick(0.99), 1), "max_ms": round(xs[-1], 1)}

    @classmethod
    def from_workdir(cls, cfg: Config, workdir: str, chunk_frames: int = 64,
                     device=None, **kwargs) -> "VocoderService":
        """Restore `workdir`'s latest student checkpoint (its EMA when it
        has one) on `device` (default: the CUDA card) and build the
        service; other kwargs go to the constructor."""
        device = require_cuda() if device is None else torch.device(device)
        return cls(cfg, generate.load_student(cfg, workdir, device),
                   chunk_frames, **kwargs)

    def synthesize_chunks(self, wav: np.ndarray, temperature: float,
                          chunk_frames: Optional[int] = None,
                          batching: bool = True):
        """Yield deemphasized float32 chunks for a conditioning waveform
        (copy-synthesis); its mel is computed on the host
        (`generate.mel_from_wav_host`)."""
        return self.synthesize_chunks_from_mel(
            generate.mel_from_wav_host(self.cfg, wav)[None], temperature,
            chunk_frames, batching)

    def synthesize_chunks_from_mel(self, mel, temperature: float,
                                   chunk_frames: Optional[int] = None,
                                   batching: bool = True):
        """Yield deemphasized float32 chunks for a conditioning mel (1, F,
        n_mels).  An utterance shorter than one streaming window, or than
        one chunk, comes as one whole-call chunk.

        Request k's noise is `generate.BlockNoise(seed=k)` on every route.
        The card's work runs in a producer thread that fills a bounded
        queue.  If the queue is full and the client stalls without leaving,
        a direct-route producer waits holding the device lock (an engine
        stream holds none between windows): `max_pending` bounds the damage.
        """
        cfg = self.cfg
        cf = chunk_frames or self.chunk_frames
        mel = np.asarray(mel, np.float32)
        req_id = next(self._counter)
        self.requests_served = req_id + 1
        F = mel.shape[1]
        _, _, CT, WT, WF = generate._stream_geometry(cfg, cf)
        deemph = _Deemph(cfg.dsp.preemphasis)
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_chunks)
        # set when the consumer is closed (the client is gone): a producer
        # facing a full queue stops instead of blocking
        abandoned = threading.Event()

        def put(item) -> bool:
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def noise(rows: int) -> generate.BlockNoise:
            return generate.BlockNoise(cfg, req_id, CT, rows, temperature,
                                       self.device)

        # the engine serves single-utterance rows at the service's chunk
        # size; other requests stream on the direct, lock-serialized path
        use_engine = (batching and self.engine is not None
                      and cf == self.chunk_frames and mel.shape[0] == 1)

        def produce_batched() -> None:
            z = noise(1)
            self.engine.stream_started()
            try:
                for ws, f_start, off, out_off, trim in generate._stream_plan(
                        cfg, F, cf, True):
                    with self.lock:
                        z_win = z.window(ws, WT)
                    fut = self.engine.submit(_Job(
                        mel[:, f_start: f_start + WF], z_win, off, out_off,
                        Future()))
                    chunk = fut.result(timeout=600)
                    if not put(("chunk", chunk[trim:] if trim else chunk)):
                        return
            finally:
                self.engine.stream_done()

        def produce_direct() -> None:
            with self.lock:
                for chunk in generate.stream_student_chunks(
                        cfg, self.model, mel, seed=req_id, chunk_frames=cf,
                        temperature=temperature, cover_tail=True):
                    if not put(("chunk", chunk[0])):
                        return

        def produce() -> None:
            with self.scope():
                try:
                    try:
                        # decided before any chunk streams, from the
                        # geometry both streaming routes enforce
                        if F < cf or F < WF:
                            raise _ShortUtterance
                        (produce_batched if use_engine else produce_direct)()
                    except _ShortUtterance:
                        # one whole call, deemphasized already: "whole"
                        # skips the consumer's filter
                        T = F * cfg.dsp.hop_length
                        with self.lock:
                            wav = generate.generate_student(
                                cfg, self.model, mel,
                                z=noise(mel.shape[0]).window(0, T))
                        if not put(("whole", wav)):
                            return
                except Exception as e:  # noqa: BLE001 — relay to the client
                    put(("error", e))
                put(("done", None))

        threading.Thread(target=produce, daemon=True).start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "done":
                    return
                if kind == "error":
                    raise payload
                yield deemph(payload) if kind == "chunk" else payload
        finally:
            abandoned.set()


def _make_handler(service: VocoderService):
    sr = service.cfg.dsp.sample_rate
    device = (torch.cuda.get_device_name(service.device)
              if service.device.type == "cuda" else "cpu")

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # chunked transfer needs it

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj: dict, headers=()) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path != "/healthz":
                self._json(404, {"error": "unknown path"})
                return
            eng = service.engine
            self._json(200, {
                "status": "ok",
                "device": device,
                "sample_rate": sr,
                "chunk_frames": service.chunk_frames,
                "requests_served": service.requests_served,
                "pending": service.pending,
                "max_pending": service.max_pending,
                "batch_max": eng.max_batch if eng else 1,
                "batch_calls": eng.calls if eng else 0,
                "batch_rows": eng.rows if eng else 0,
                # rows per device call: the batching actually achieved
                "batch_rows_per_call": (round(eng.rows / max(eng.calls, 1), 2)
                                        if eng else None),
                "batch_retries": eng.retries if eng else 0,
                "ttfb": service.ttfb_stats(),
                "draining": service.draining,
            })

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/synthesize":
                self._json(404, {"error": "unknown path"})
                return
            q = parse_qs(url.query)
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self.close_connection = True
                self._json(400, {"error": "bad Content-Length"})
                return
            if n > service.max_body_bytes:
                # answer on the header alone and close: the unread body
                # must not be taken for the next request
                self.close_connection = True
                self._json(413, {"error": f"body {n} bytes exceeds limit "
                                          f"{service.max_body_bytes}"})
                return
            # shed load before reading and decoding the body
            t_admit = time.monotonic()
            if not service.try_admit():
                self.close_connection = True  # body unread
                self._json(503, {"error": "server busy: "
                                          f"{service.max_pending} syntheses "
                                          "already pending"},
                           headers=[("Retry-After", "1")])
                return
            try:
                mel = wav = None
                try:
                    temperature = float(q.get("temperature", ["1.0"])[0])
                    cf = int(q.get("chunk_frames",
                                   [str(service.chunk_frames)])[0])
                    # ?batching=off streams on the direct path
                    batching = q.get("batching", ["on"])[0] != "off"
                    body = self.rfile.read(n)
                    if body[:6] == b"\x93NUMPY":
                        mel = generate.coerce_mel(service.cfg, np.load(
                            io.BytesIO(body), allow_pickle=False))
                    else:
                        wav, _ = read_wav(io.BytesIO(body), target_sr=sr)
                except Exception as e:  # noqa: BLE001 — any bad body is a 400
                    self._json(400, {"error": f"bad request: {e!r}"})
                    return
                try:
                    chunks = (
                        service.synthesize_chunks_from_mel(
                            mel, temperature, cf, batching)
                        if mel is not None
                        else service.synthesize_chunks(
                            wav, temperature, cf, batching))
                    first = next(chunks)  # errors before the headers
                except Exception as e:  # noqa: BLE001 — reported as a 500
                    self._json(500, {"error": repr(e)})
                    return
                service.observe_ttfb((time.monotonic() - t_admit) * 1e3)
                self.send_response(200)
                self.send_header("Content-Type", "audio/L16")
                self.send_header("X-Sample-Rate", str(sr))
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def send(payload: bytes) -> None:
                    self.wfile.write(f"{len(payload):X}\r\n".encode())
                    self.wfile.write(payload)
                    self.wfile.write(b"\r\n")

                send(_pcm16(first))
                for chunk in chunks:
                    send(_pcm16(chunk))
                self.wfile.write(b"0\r\n\r\n")
            finally:
                service.release()

    return Handler


def make_server(service: VocoderService, host: str = "127.0.0.1",
                port: int = 8600) -> ThreadingHTTPServer:
    """Build (not start) the server; tests drive it from a thread."""
    return ThreadingHTTPServer((host, port), _make_handler(service))


def drain_and_close(service: VocoderService, srv: ThreadingHTTPServer,
                    timeout_s: float = 30.0) -> None:
    """Graceful shutdown: stop admissions (503), wait up to `timeout_s` for
    the streams in flight, stop the engine (failing what it still has
    queued, so every open stream ends) and close the listener."""
    service.draining = True
    service.wait_idle(timeout_s)
    service.close()
    srv.server_close()


def serve_forever(cfg: Config, workdir: str, host: str, port: int,
                  chunk_frames: int = 64, max_pending: int = 4,
                  max_body_bytes: int = 64 * 2 ** 20, batch_max: int = 4,
                  batch_window_ms: float = 3.0, device=None) -> None:
    """Serve `workdir`'s student until SIGTERM or SIGINT, then drain."""
    import signal

    service = VocoderService.from_workdir(
        cfg, workdir, chunk_frames, device=device, max_pending=max_pending,
        max_body_bytes=max_body_bytes, batch_max=batch_max,
        batch_window_ms=batch_window_ms)
    # one synthesis first, so the first request pays neither the kernels'
    # build nor the stacks' weight caches
    warm = np.zeros(max((chunk_frames + 8) * cfg.dsp.hop_length * 2,
                        cfg.dsp.win_length * 4), np.float32)
    for _ in service.synthesize_chunks(warm, temperature=1.0):
        pass
    srv = make_server(service, host, port)

    def _shutdown(signum, frame):
        print(f"signal {signum}: draining {service.pending} in-flight "
              "streams...", flush=True)
        threading.Thread(target=srv.shutdown, daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _shutdown)
    print(f"serving {cfg.dsp.sample_rate} Hz vocoder on "
          f"http://{host}:{srv.server_address[1]}  (POST /synthesize, "
          "GET /healthz)", flush=True)
    try:
        srv.serve_forever()
    finally:
        drain_and_close(service, srv)
        print("server stopped", flush=True)
