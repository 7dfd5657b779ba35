"""The port's streaming vocoder server (`pwn_tpu_torch/serve.py`) on the CPU:
the cases of `tests/test_serve.py`, the two decisions the port takes where
the reference errs (a ValueError is not retried; stopping the engine fails
its queued jobs, so a drain that times out still ends every stream), and
one whole-slice parity test against JAX's streaming synthesis.

Every test drives a real ThreadingHTTPServer on 127.0.0.1 at an ephemeral
port, or the service directly, with a small student (2 flows x 3 layers).
Connections time out within 60 s and every join has a timeout.
"""

import http.client
import io
import itertools
import json
import threading
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from pwn_tpu import generate as jgen
from pwn_tpu import serve as jserve
from pwn_tpu_torch import generate as gen
from pwn_tpu_torch import get_config
from pwn_tpu_torch.serve import (SHUTDOWN, VocoderService, _Job,
                                 drain_and_close, make_server)
from torch_parity import SMALL_STUDENT, jax_config, paired_students

CFG = get_config("tiny_teacher", **SMALL_STUDENT)
SR, HOP = CFG.dsp.sample_rate, CFG.dsp.hop_length
CF = 8  # chunk frames
CT = CF * HOP


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per host; torch's default of
    one intra-op thread per core oversubscribes it, so these tests run
    torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return paired_students(CFG)


def _start(service):
    srv = make_server(service, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t


def _stop(srv, t, service):
    srv.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()
    srv.server_close()
    service.close()


@pytest.fixture(scope="module")
def server(models):
    service = VocoderService(CFG, models[2], chunk_frames=CF)
    srv, t = _start(service)
    yield srv, service
    _stop(srv, t, service)


@pytest.fixture(scope="module")
def server_batched(models):
    service = VocoderService(CFG, models[2], chunk_frames=CF, batch_max=4,
                             batch_window_ms=10.0)
    srv, t = _start(service)
    yield srv, service
    _stop(srv, t, service)


def _tone(seconds, hz=330, amp=0.25):
    return (amp * np.sin(2 * np.pi * hz * np.arange(int(seconds * SR)) / SR)
            ).astype(np.float32)


def _wav_body(wav):
    buf = io.BytesIO()
    wavfile.write(buf, SR, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
    return buf.getvalue()


def _round_trip(wav):
    """The wav as the server reads it back from a PCM16 body."""
    return (np.clip(wav, -1, 1) * 32767).astype(np.int16).astype(
        np.float32) / 32768.0


def _mel_body(mel):
    buf = io.BytesIO()
    np.save(buf, mel)
    return buf.getvalue()


def _post(srv, path, body, headers=None):
    conn = http.client.HTTPConnection(*srv.server_address, timeout=60)
    conn.request("POST", path, body=body,
                 headers=headers or {"Content-Length": str(len(body))})
    return conn, conn.getresponse()


def _pcm(r):
    return np.frombuffer(r.read(), "<i2")


def _get_json(srv, path):
    conn = http.client.HTTPConnection(*srv.server_address, timeout=60)
    conn.request("GET", path)
    r = conn.getresponse()
    body = json.loads(r.read())
    conn.close()
    return r.status, body


def _replay(service, first_id, n, wav, temperature=1.0):
    """The deemphasized, clipped streams that requests first_id .. first_id
    + n - 1 gave for `wav`, replayed through `synthesize_chunks`."""
    service._counter = itertools.count(first_id)
    out = [np.clip(np.concatenate(list(service.synthesize_chunks(
        _round_trip(wav), temperature))), -1.0, 1.0) for _ in range(n)]
    service._counter = itertools.count(first_id + 2 * n)
    return out


def test_healthz(server):
    srv, _ = server
    status, body = _get_json(srv, "/healthz")
    assert status == 200 and body["status"] == "ok"
    assert body["device"] == "cpu" and body["sample_rate"] == SR
    assert body["batch_max"] == 1 and body["batch_rows_per_call"] is None
    assert _get_json(srv, "/nope")[0] == 404


def test_synthesize_streams_pcm16(server):
    """cover_tail: the whole utterance comes back, its ragged tail too."""
    srv, _ = server
    wav = _tone(2.0) + 0.01 * np.random.default_rng(0).standard_normal(
        2 * SR).astype(np.float32)
    conn, r = _post(srv, "/synthesize?temperature=0.8", _wav_body(wav))
    assert r.status == 200 and r.getheader("X-Sample-Rate") == str(SR)
    out = _pcm(r).astype(np.float32) / 32767.0
    conn.close()
    assert len(out) == len(wav) // HOP * HOP
    assert np.isfinite(out).all() and np.abs(out).max() > 1e-4


def test_short_utterance_takes_the_whole_call(server, models):
    """Shorter than one window: one whole call on the request's block
    noise, so the route changes nothing of the audio."""
    srv, service = server
    wav = 0.2 * _tone(0.12, 220)
    k = service.requests_served
    conn, r = _post(srv, "/synthesize", _wav_body(wav))
    assert r.status == 200
    out = _pcm(r)
    conn.close()
    mel = gen.mel_from_wav_host(CFG, _round_trip(wav))[None]
    F = mel.shape[1]
    assert F < gen._stream_geometry(CFG, CF)[4] and len(out) == F * HOP
    z = gen.BlockNoise(CFG, k, CT, 1, 1.0, "cpu").window(0, F * HOP)
    ref = gen.generate_student(CFG, models[2], mel, z=z)
    want = (np.clip(ref, -1, 1) * 32767).astype(np.int16)
    assert np.abs(out.astype(int) - want).max() <= 1


def test_bad_request_and_unknown_path(server):
    srv, _ = server
    conn, r = _post(srv, "/synthesize", b"this is not a wav")
    assert r.status == 400
    r.read()
    conn.close()
    conn, r = _post(srv, "/nope", b"")
    assert r.status == 404
    r.read()
    conn.close()


def test_malformed_content_length_400(server):
    srv, _ = server
    conn = http.client.HTTPConnection(*srv.server_address, timeout=60)
    conn.putrequest("POST", "/synthesize")
    conn.putheader("Content-Length", "12abc")
    conn.endheaders()
    r = conn.getresponse()
    assert r.status == 400
    r.read()
    conn.close()


def test_oversize_body_rejected_413(server):
    """A 1 GB Content-Length is refused on the header, before any read."""
    srv, _ = server
    conn, r = _post(srv, "/synthesize", None,
                    headers={"Content-Length": str(1 << 30)})
    assert r.status == 413
    r.read()
    conn.close()


def test_busy_server_503_with_retry_after(models):
    """Shed before the body is read (so these requests send none: a body
    left unread may reset the connection before the answer is read)."""
    service = VocoderService(CFG, models[2], chunk_frames=CF, max_pending=0)
    srv, t = _start(service)
    try:
        conn, r = _post(srv, "/synthesize", b"")
        assert r.status == 503 and r.getheader("Retry-After") == "1"
        r.read()
        conn.close()
    finally:
        _stop(srv, t, service)


def test_draining_sheds_with_503(server):
    srv, service = server
    service.draining = True
    try:
        conn, r = _post(srv, "/synthesize", b"")
        assert r.status == 503 and r.getheader("Retry-After")
        r.read()
        conn.close()
    finally:
        service.draining = False


def test_slow_client_does_not_hold_the_device(server):
    """A client that stops reading mid-response does not block another
    request: the lock is held only while the card computes."""
    srv, _ = server
    body = _wav_body(_tone(2.0))
    conn_a, r_a = _post(srv, "/synthesize", body)
    assert r_a.status == 200
    first_a = r_a.read(512)
    conn_b, r_b = _post(srv, "/synthesize", body)
    assert r_b.status == 200
    out_b = r_b.read()
    conn_b.close()
    rest_a = r_a.read()
    conn_a.close()
    assert len(out_b) > 0 and len(first_a) + len(rest_a) == len(out_b)


def test_streamed_equals_generator_with_deemphasis(server):
    """The HTTP path equals `synthesize_chunks`' own output, PCM16 aside."""
    srv, service = server
    wav = _tone(2.0)
    k = service.requests_served
    conn, r = _post(srv, "/synthesize", _wav_body(wav))
    got = _pcm(r).astype(np.float32) / 32767.0
    conn.close()
    (ref,) = _replay(service, k, 1, wav)
    assert len(got) == len(ref)
    np.testing.assert_allclose(got, ref, atol=1.0 / 32767 + 1e-6)


def test_two_concurrent_clients_both_succeed(server):
    srv, _ = server
    body = _wav_body(_tone(2.0, 440))
    results = [None, None]

    def client(i):
        conn, r = _post(srv, "/synthesize", body)
        results[i] = (r.status, len(r.read()))
        conn.close()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert [s for s, _ in results] == [200, 200]
    assert results[0][1] == results[1][1] > 0


def test_abandoned_consumer_releases_device_lock(models):
    """A client gone while its chunk queue is full must not leave the
    producer blocked holding the lock."""
    service = VocoderService(CFG, models[2], chunk_frames=CF, queue_chunks=1)
    chunks = service.synthesize_chunks(0.1 * _tone(4.0, 220), temperature=1.0)
    next(chunks)
    chunks.close()
    assert service.lock.acquire(timeout=30), "the producer holds the lock"
    service.lock.release()


def test_batch_engine_rows_match_direct_stream(models):
    """One engine call over windows of three requests (their own noise,
    temperatures and phases, the partial tail's among them) gives each
    row the direct stream's chunk, and runs exactly three rows."""
    port = models[2]
    service = VocoderService(CFG, port, chunk_frames=CF, batch_max=4)
    try:
        mel = gen.mel_from_wav_host(CFG, 0.3 * _tone(1.5, 260))[None]
        F = mel.shape[1]
        _, _, _, WT, WF = gen._stream_geometry(CFG, CF)
        plan = list(gen._stream_plan(CFG, F, CF, True))
        assert plan[-1][4] > 0, "the wav should end in a partial chunk"
        picks, temps = [0, len(plan) // 2, len(plan) - 1], [1.0, 0.8, 0.5]
        jobs = []
        for j, (i, temp) in enumerate(zip(picks, temps)):
            ws, f_start, off, out_off, _ = plan[i]
            z = gen.BlockNoise(CFG, 100 + j, CT, 1, temp, "cpu")
            jobs.append(_Job(mel[:, f_start: f_start + WF], z.window(ws, WT),
                             off, out_off, Future()))
        service.engine._execute(jobs)
        for j, (i, temp) in enumerate(zip(picks, temps)):
            got = jobs[j].future.result(timeout=60)
            assert got.shape == (CT,)
            ref = list(gen.stream_student_chunks(
                CFG, port, mel, seed=100 + j, chunk_frames=CF,
                temperature=temp, cover_tail=True))[i][0]
            np.testing.assert_allclose(got[plan[i][4]:], ref, rtol=1e-5,
                                       atol=1e-5, err_msg=f"row {j}")
        assert service.engine.calls == 1 and service.engine.rows == 3
    finally:
        service.close()


def test_concurrent_clients_batched_equal_sequential(server_batched):
    """Two concurrent clients through the engine stream what two
    sequential requests with the same ids would: batching is invisible in
    the audio."""
    srv, service = server_batched
    wav = _tone(2.0)
    body = _wav_body(wav)
    k = service.requests_served
    outs = [None, None]

    def client(i):
        conn, r = _post(srv, "/synthesize", body)
        assert r.status == 200
        outs[i] = _pcm(r).astype(np.float32) / 32767.0
        conn.close()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    refs = _replay(service, k, 2, wav)
    assert not np.allclose(refs[0], refs[1]), "ids must give distinct noise"
    tol = 1.0 / 32767 + 1e-5

    def same(a, b):
        return a.shape == b.shape and np.allclose(a, b, atol=tol)

    assert ((same(outs[0], refs[0]) and same(outs[1], refs[1]))
            or (same(outs[0], refs[1]) and same(outs[1], refs[0])))
    assert service.engine.calls > 0


def test_batched_single_client_whole_path(server_batched):
    srv, _ = server_batched
    wav = _tone(1.3, 220)
    conn, r = _post(srv, "/synthesize?temperature=0.7", _wav_body(wav))
    assert r.status == 200
    out = _pcm(r).astype(np.float32) / 32767.0
    conn.close()
    assert len(out) == len(wav) // HOP * HOP
    assert np.isfinite(out).all() and np.abs(out).max() > 1e-4


def test_healthz_latency_stats_and_occupancy(server_batched):
    srv, _ = server_batched
    conn, r = _post(srv, "/synthesize", _wav_body(0.2 * _tone(1.0, 220)))
    assert r.status == 200
    r.read()
    conn.close()
    status, body = _get_json(srv, "/healthz")
    assert status == 200 and body["ttfb"]["count"] >= 1
    assert 0 < body["ttfb"]["p50_ms"] <= body["ttfb"]["p99_ms"]
    assert body["draining"] is False and body["batch_max"] == 4
    assert body["batch_rows_per_call"] >= 1 and body["batch_retries"] == 0


def test_drain_and_close_waits_for_pending(models):
    service = VocoderService(CFG, models[2], chunk_frames=CF, batch_max=2)
    srv = make_server(service, "127.0.0.1", 0)
    assert service.try_admit()
    released = threading.Event()
    go = threading.Event()

    def release_later():
        go.wait(30)
        released.set()
        service.release()

    t = threading.Thread(target=release_later, daemon=True)
    t.start()
    go.set()
    drain_and_close(service, srv, timeout_s=30.0)
    assert released.is_set() and service.pending == 0 and service.draining
    assert not service.engine._thread.is_alive()
    t.join(timeout=30)


def test_drain_with_zero_timeout_ends_an_open_stream(models):
    """Decision (reference `serve.py:686-696`): a drain that times out stops
    the engine, which fails what it has queued and refuses what comes, so
    an open stream ends with an error naming the shutdown instead of
    waiting on its next window."""
    service = VocoderService(CFG, models[2], chunk_frames=CF, batch_max=2,
                             queue_chunks=1)
    srv = make_server(service, "127.0.0.1", 0)
    chunks = service.synthesize_chunks(_tone(4.0), temperature=1.0)
    got, ended = [next(chunks)], []

    def consume():
        try:
            for c in chunks:
                got.append(c)
        except RuntimeError as e:
            ended.append(e)

    assert service.try_admit()  # the stream counts as pending
    drain_and_close(service, srv, timeout_s=0.0)
    reader = threading.Thread(target=consume, daemon=True)
    reader.start()
    reader.join(timeout=60)
    assert not reader.is_alive(), "the open stream did not end"
    assert len(ended) == 1 and SHUTDOWN in str(ended[0])
    n_windows = len(list(gen._stream_plan(CFG, 4 * SR // HOP, CF, True)))
    assert len(got) < n_windows and not service.engine._thread.is_alive()


def test_engine_stop_fails_queued_jobs(models, monkeypatch):
    """A job queued behind a running call fails at stop(), before the
    running call ends; a job submitted after stop() fails at once."""
    service = VocoderService(CFG, models[2], chunk_frames=CF, batch_max=2)
    entered, release = threading.Event(), threading.Event()

    def slow(cfg, model, z_win, mel_win, off, out_off):
        entered.set()
        release.wait(30)
        return torch.zeros((z_win.shape[0], CT))

    monkeypatch.setattr(gen, "stream_window", slow)
    mel_win = np.zeros((1, 21, CFG.dsp.n_mels), np.float32)

    def job():
        return _Job(mel_win, torch.zeros(1, CT + 128), 0, 0, Future())

    running = service.engine.submit(job())
    assert entered.wait(30)
    queued = service.engine.submit(job())
    stopper = threading.Thread(target=service.close)
    stopper.start()
    with pytest.raises(RuntimeError, match=SHUTDOWN):
        queued.result(timeout=30)
    assert not running.done()
    release.set()
    stopper.join(timeout=30)
    assert not stopper.is_alive()
    assert running.result(timeout=30).shape == (CT,)
    with pytest.raises(RuntimeError, match=SHUTDOWN):
        service.engine.submit(job()).result(timeout=1)


def test_batch_engine_retries_transient_failure(models, monkeypatch):
    """One transient failure is retried once (and counted), so it does not
    fail every co-batched stream; a persistent one fails the waiters."""
    service = VocoderService(CFG, models[2], chunk_frames=CF, batch_max=2)
    try:
        calls = {"n": 0}

        def flaky(cfg, model, z_win, *a):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient device error")
            return torch.ones((z_win.shape[0], CT))

        monkeypatch.setattr(gen, "stream_window", flaky)
        j = _Job(np.zeros((1, 21, 40), np.float32), torch.zeros(1, 8), 0, 0,
                 Future())
        service.engine._execute([j])
        assert j.future.result(timeout=30).shape == (CT,)
        assert service.engine.retries == 1 and service.engine.calls == 1

        def always(*a):
            calls["n"] += 1
            raise RuntimeError("hard failure")

        monkeypatch.setattr(gen, "stream_window", always)
        calls["n"] = 0
        j = j._replace(future=Future())
        service.engine._execute([j])
        with pytest.raises(RuntimeError, match="hard failure"):
            j.future.result(timeout=30)
        assert calls["n"] == 2 and service.engine.retries == 2
    finally:
        service.close()


@pytest.mark.parametrize("exc", [ValueError, TypeError])
def test_engine_relays_deterministic_errors_without_retry(models, monkeypatch,
                                                          exc):
    """Decision (reference `serve.py:235-246` retries every exception): a
    ValueError or TypeError would fail again, so it reaches the waiters
    after one call, and `batch_retries` stays 0."""
    service = VocoderService(CFG, models[2], chunk_frames=CF, batch_max=2)
    try:
        calls = []

        def bad(*a):
            calls.append(1)
            raise exc("a bad argument")

        monkeypatch.setattr(gen, "stream_window", bad)
        j = _Job(np.zeros((1, 21, 40), np.float32), torch.zeros(1, 8), 0, 0,
                 Future())
        service.engine._execute([j])
        with pytest.raises(exc, match="a bad argument"):
            j.future.result(timeout=30)
        assert len(calls) == 1 and service.engine.retries == 0
        assert service.engine.calls == 0
    finally:
        service.close()


def test_engine_valueerror_not_mistaken_for_short_utterance(models,
                                                            monkeypatch):
    """A ValueError relayed from the engine mid-stream is an error, never
    the whole-call route (which would append a second synthesis)."""
    service = VocoderService(CFG, models[2], chunk_frames=CF, batch_max=2)
    try:
        def bad(*a):
            raise ValueError("looks like a bad-arg error")

        monkeypatch.setattr(gen, "stream_window", bad)
        with pytest.raises(ValueError, match="bad-arg"):
            for _ in service.synthesize_chunks(_tone(2.0), temperature=1.0):
                pass
    finally:
        service.close()


def test_synthesize_from_mel_npy(server):
    srv, _ = server
    mel = gen.mel_from_wav_host(CFG, _tone(2.0))
    conn, r = _post(srv, "/synthesize?temperature=0.8", _mel_body(mel))
    assert r.status == 200 and r.getheader("X-Sample-Rate") == str(SR)
    out = _pcm(r).astype(np.float32) / 32767.0
    conn.close()
    assert len(out) == mel.shape[0] * HOP
    assert np.isfinite(out).all() and np.abs(out).max() > 1e-4


def test_bad_mel_rejected_400(server):
    srv, _ = server
    for bad in (np.zeros((40, 7), np.float32),
                np.full((40, CFG.dsp.n_mels), np.nan, np.float32)):
        conn, r = _post(srv, "/synthesize", _mel_body(bad))
        assert r.status == 400
        r.read()
        conn.close()


def test_served_pcm_matches_jax_stream(server_batched, models):
    """The whole slice against the reference: the PCM the server streams
    for request k (wav body -> host mel -> batch engine -> deemphasis ->
    PCM16) equals, within 1 LSB, PCM16 of JAX's `stream_student_chunks`
    on z = request k's block noise written out as numpy, deemphasized by
    the reference's `_Deemph`.  1 LSB: float32 differences of ~1e-5
    between the libraries flip a rounding to int16 at most by one."""
    srv, service = server_batched
    _, params, _ = models
    wav = _tone(1.2, 300) + 0.05 * _tone(1.2, 1250)
    k = service.requests_served
    conn, r = _post(srv, "/synthesize?temperature=0.8", _wav_body(wav))
    assert r.status == 200
    got = _pcm(r)
    conn.close()
    mel = gen.mel_from_wav_host(CFG, _round_trip(wav))
    T = mel.shape[0] * HOP
    z = gen.BlockNoise(CFG, k, CT, 1, 0.8, "cpu").window(0, T).numpy()
    chunks = jgen.stream_student_chunks(
        jax_config(CFG), params, jnp.asarray(mel[None]), z=z,
        chunk_frames=CF, cover_tail=True)
    ref = jserve._Deemph(CFG.dsp.preemphasis)(
        np.concatenate([np.asarray(c)[0] for c in chunks]))
    want = (np.clip(ref, -1, 1) * 32767).astype(np.int16)
    assert got.shape == want.shape == (T,)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert np.abs(want).max() > 100
