"""The port's command line (`python -m pwn_tpu_torch.cli`) on the CPU at tiny
fp32 sizes: train-teacher -> distill-student (`--teacher-step auto`, an
integer, live params) -> generate (student, teacher, `--dump-mel` /
`--mel`, `--mel-dir`, `--source-dir`, `--chunk-frames`), train-student,
eval against the reference's report, serve as a subprocess, bench (its
suite replaced by a recorder), and the refusal of a run without a card
and without `--device`.  Each command but serve runs in-process through
`cli.main` with `--device cpu`, and writes what it prints.
"""

import contextlib
import http.client
import io
import json
import os
import queue
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from pwn_tpu_torch import cli
from pwn_tpu_torch.utils.audio_io import read_wav, write_wav

ROOT = Path(__file__).resolve().parents[1]
SR = 16000  # tiny_teacher's sample rate
# tiny_teacher's DSP with a 3-layer teacher and a 2 x 3-layer student at
# C=16, two 1,024-sample crops, a checkpoint every 2 steps
OVERRIDES = [
    "student.n_flows=2", "student.layers_per_flow=3",
    "student.residual_channels=16", "student.gate_channels=32",
    "student.skip_channels=16", "teacher.n_blocks=1",
    "teacher.layers_per_block=3", "teacher.residual_channels=16",
    "teacher.gate_channels=32", "teacher.skip_channels=16",
    "teacher.n_mixtures=4", "train.global_batch_size=2",
    "train.crop_samples=1024", "train.checkpoint_every=2",
    "train.eval_sample_seconds=0.02", "train.ema_decay=0.5",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per host; torch's default of
    one intra-op thread per core oversubscribes it, so these tests run
    torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cli(*args):
    """(exit code, stdout, stderr) of one in-process CLI call on the CPU."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([*args, "--device", "cpu", *OVERRIDES])
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def workdirs(tmp_path_factory):
    """A teacher trained 4 steps (checkpoints at 2 and 4) and a student
    distilled 2 steps from the teacher step the probe picked."""
    root = tmp_path_factory.mktemp("cli")
    t, s = str(root / "teacher"), str(root / "student")
    logs = {"train": _cli("train-teacher", "tiny_teacher", "--workdir", t,
                          "--steps", "4"),
            "distill": _cli("distill-student", "tiny_teacher",
                            "--teacher-workdir", t, "--workdir", s,
                            "--teacher-step", "auto",
                            "--teacher-probe-steps", "1", "--steps", "2")}
    return root, t, s, logs


def test_train_teacher_then_distill_with_auto_selection(workdirs):
    _, t, s, logs = workdirs
    rc, out, err = logs["train"]
    assert rc == 0 and "teacher done: 4 steps, final {'loss'" in out
    assert sorted(os.listdir(os.path.join(t, "ckpt_teacher"))) == ["2", "4"]
    assert '"val_loss"' in err  # the metrics' stderr echo
    rc, out, _ = logs["distill"]
    assert rc == 0
    probes = [ln for ln in out.splitlines() if ln.startswith("[teacher-probe]")]
    assert len(probes) == 3 and "selected teacher step" in probes[-1]
    picked = int(probes[-1].split("selected teacher step ")[1].split()[0])
    assert f"loaded teacher @ step {picked} (ema params)" in out
    assert "student done: 2 steps" in out
    assert sorted(os.listdir(os.path.join(s, "samples"))) == [
        "step_00000002.wav"]


def test_distill_from_a_given_step_and_live_params(workdirs):
    root, t, *_ = workdirs
    rc, out, _ = _cli("distill-student", "tiny_teacher", "--teacher-workdir",
                      t, "--workdir", str(root / "student2"),
                      "--teacher-step", "2", "--teacher-params", "live",
                      "--steps", "1")
    assert rc == 0 and "loaded teacher @ step 2 (live params)" in out
    assert "student done: 1 steps" in out


def test_train_student_direct(tmp_path):
    rc, out, _ = _cli("train-student", "tiny_teacher", "--workdir",
                      str(tmp_path), "--steps", "2")
    assert rc == 0 and "student (direct) done: 2 steps" in out
    assert os.listdir(tmp_path / "ckpt_student") == ["2"]


@pytest.mark.parametrize("cmd", ["train-teacher", "train-student",
                                 "distill-student"])
def test_train_commands_take_a_data_dir(workdirs, tmp_path, cmd):
    """`--data-dir`: each train command trains on the wav files there, on
    the engine "auto" picks (the C++ loader where g++ builds it)."""
    _, t, *_ = workdirs
    data = tmp_path / "wavs"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        write_wav(str(data / f"utt{i}.wav"),
                  rng.uniform(-0.5, 0.5, 2400 + 300 * i).astype(np.float32),
                  SR)
    extra = (["--teacher-workdir", t] if cmd == "distill-student" else [])
    rc, out, _ = _cli(cmd, "tiny_teacher", "--workdir", str(tmp_path / "wd"),
                      "--data-dir", str(data), "--steps", "1", *extra)
    assert rc == 0 and "done: 1 steps" in out
    assert "data engine: native" in out


def test_generate_student_from_a_source_and_from_its_dumped_mel(workdirs,
                                                                tmp_path):
    """From a source wav with `--dump-mel`, then from that mel: the same
    audio (same mel, same noise seed), of the source's length."""
    _, _, s, _ = workdirs
    src = tmp_path / "src.wav"
    write_wav(str(src), np.sin(np.arange(4000) * 0.05).astype(np.float32) * 0.5,
              SR)
    a, b, mel = tmp_path / "a.wav", tmp_path / "b.wav", tmp_path / "m.npy"
    rc, out, _ = _cli("generate", "tiny_teacher", "--workdir", s, "--source",
                      str(src), "--output", str(a), "--dump-mel", str(mel))
    assert rc == 0 and f"wrote {a}: 0.25s @ {SR} Hz" in out
    assert np.load(mel).shape == (31, 40)
    rc, out, _ = _cli("generate", "tiny_teacher", "--workdir", s, "--mel",
                      str(mel), "--output", str(b))
    assert rc == 0 and f"wrote {b}" in out
    wa, wb = read_wav(str(a))[0], read_wav(str(b))[0]
    assert wa.shape == (31 * 128,) and np.array_equal(wa, wb)
    assert np.abs(wa).max() > 0


def test_generate_teacher(workdirs, tmp_path):
    _, t, _, _ = workdirs
    out_wav = tmp_path / "t.wav"
    rc, out, _ = _cli("generate", "tiny_teacher", "--model", "teacher",
                      "--workdir", t, "--seconds", "0.05", "--output",
                      str(out_wav), "--temperature", "0.8")
    assert rc == 0 and f"wrote {out_wav}: 0.05s" in out
    wav, sr = read_wav(str(out_wav))
    assert sr == SR and wav.shape == (768,) and np.isfinite(wav).all()


@pytest.mark.parametrize("mode", ["mel-dir", "source-dir"])
def test_generate_batch_mode(workdirs, tmp_path, mode):
    """`vocode_many` over a directory: one wav per input, named by its
    stem, at the input's length."""
    _, _, s, _ = workdirs
    inp = tmp_path / "in"
    inp.mkdir()
    rng = np.random.default_rng(0)
    frames = {"u1": 9, "u2": 20}
    for stem, n in frames.items():
        if mode == "mel-dir":
            np.save(inp / f"{stem}.npy", rng.uniform(0, 1, (n, 40)).astype(
                np.float32))
        else:
            write_wav(str(inp / f"{stem}.wav"), rng.uniform(
                -0.5, 0.5, n * 128).astype(np.float32), SR)
    rc, out, _ = _cli("generate", "tiny_teacher", "--workdir", s,
                      f"--{mode}", str(inp), "--output-dir",
                      str(tmp_path / "out"), "--batch-size", "2")
    assert rc == 0 and "vocoded 2 utterances" in out
    for stem, n in frames.items():
        wav, _ = read_wav(str(tmp_path / "out" / f"{stem}.wav"))
        assert wav.shape == (n * 128,)


@pytest.mark.parametrize("args,want", [
    (["bench"], ("student_iaf", {})),
    (["bench", "tiny_teacher", "train.crop_samples=1024"],
     ("tiny_teacher", {"train.crop_samples": "1024"})),
])
def test_unported_parts_exit_non_zero(args, want, monkeypatch):
    """Nothing of the reference's CLI is left unported: `bench [case]
    [k=v ...]` hands the case (default student_iaf) and the overrides to
    `benchmarks.run_bench` on the device asked for and prints its result
    as one JSON line."""
    from pwn_tpu_torch import benchmarks

    calls = []

    def fake(case, overrides, device):
        calls.append((case, overrides, device))
        return {"metric": "student_audio_sec_per_s_per_chip", "value": 1.0}

    monkeypatch.setattr(benchmarks, "run_bench", fake)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([*args, "--device", "cpu"])
    assert rc == 0 and calls == [(*want, torch.device("cpu"))]
    lines = out.getvalue().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["value"] == 1.0
    assert not hasattr(cli, "UNPORTED")


def test_no_card_is_an_error_not_the_cpu(tmp_path):
    """Without `--device` the CLI takes the CUDA card, and fails where
    there is none, also as a module (`bench`, which would otherwise run
    the suite)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train-teacher", "tiny_teacher", "--workdir",
                  str(tmp_path), "--steps", "1"])
    assert not os.listdir(tmp_path)
    proc = subprocess.run([sys.executable, "-m", "pwn_tpu_torch.cli", "bench"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_generate_streaming_writes_the_sources_length(workdirs, tmp_path):
    """`--chunk-frames 8` on a 31-frame source: three chunks and the
    7-frame tail, deemphasized together, equal to `stream_student_chunks`
    on the same seed."""
    from pwn_tpu_torch.config import get_config
    from pwn_tpu_torch.generate import (_host_deemphasis, load_student,
                                        mel_from_wav, stream_student_chunks)

    _, _, s, _ = workdirs
    src, out_wav = tmp_path / "src.wav", tmp_path / "stream.wav"
    write_wav(str(src), np.sin(np.arange(4000) * 0.05).astype(np.float32) * 0.5,
              SR)
    rc, out, _ = _cli("generate", "tiny_teacher", "--workdir", s, "--source",
                      str(src), "--output", str(out_wav), "--chunk-frames",
                      "8", "--temperature", "0.9")
    assert rc == 0 and f"wrote {out_wav}: 0.25s" in out
    wav = read_wav(str(out_wav))[0]
    assert wav.shape == (31 * 128,) and np.isfinite(wav).all()
    cfg = get_config("tiny_teacher", **dict(o.split("=") for o in OVERRIDES))
    mel = mel_from_wav(cfg, read_wav(str(src))[0], device="cpu")
    ref = _host_deemphasis(np.concatenate(list(stream_student_chunks(
        cfg, load_student(cfg, s, "cpu"), mel, seed=0, chunk_frames=8,
        temperature=0.9, cover_tail=True)), 1), cfg.dsp.preemphasis)[0]
    # as write_wav stores it: scaled down past full scale, PCM16, and read
    # back over 32768
    pcm = (ref / max(1.0, np.abs(ref).max()) * 32767.0).astype(np.int16)
    np.testing.assert_allclose(wav, pcm / 32768.0, rtol=0, atol=1 / 32768)


def test_eval_prints_the_references_report(tmp_path):
    from pwn_tpu.evaluate import copy_synthesis_report

    from torch_parity import jax_config
    from pwn_tpu_torch.config import get_config

    rng = np.random.default_rng(1)
    t = np.arange(6000) / SR
    # voiced, then quiet noise: no bin near the -100 dB floor, where the
    # two libraries' float32 FFT rounding is a large share of the value
    ref = (0.4 * np.sin(2 * np.pi * 200 * t) * (t < 0.25)
           + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
    gen = (0.8 * ref + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    write_wav(str(tmp_path / "ref.wav"), ref, SR)
    write_wav(str(tmp_path / "gen.wav"), gen[:5000], SR)
    rc, out, _ = _cli("eval", "tiny_teacher", "--ref",
                      str(tmp_path / "ref.wav"), "--gen",
                      str(tmp_path / "gen.wav"))
    assert rc == 0
    got = json.loads(out.strip().splitlines()[-1])
    a, b = read_wav(str(tmp_path / "ref.wav"))[0], read_wav(
        str(tmp_path / "gen.wav"))[0]
    want = copy_synthesis_report(jax_config(get_config("tiny_teacher")),
                                 a[:5000], b)
    assert list(got) == list(want) and len(got) == 6
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_serve_answers_healthz_and_stops_on_sigterm(workdirs):
    """`serve` as its own process on the CPU at a free port: /healthz and one
    synthesis answer, then SIGTERM drains and exits 0."""
    _, _, s, _ = workdirs
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           "OMP_NUM_THREADS": "1", "PYTHONUNBUFFERED": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen(
        [sys.executable, "-m", "pwn_tpu_torch.cli", "serve", "tiny_teacher",
         "--workdir", s, "--port", "0", "--device", "cpu", *OVERRIDES],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    try:
        first = lines.get(timeout=120)
        assert first.startswith("serving 16000 Hz vocoder on http://127.0.0.1:")
        port = int(first.split("127.0.0.1:")[1].split()[0])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["status"] == "ok" and health["device"] == "cpu"
        assert health["requests_served"] == 1  # the warm-up synthesis
        body = io.BytesIO()
        from scipy.io import wavfile

        wavfile.write(body, SR, (np.sin(np.arange(SR) * 0.05) * 8000).astype(
            np.int16))
        conn.request("POST", "/synthesize", body=body.getvalue())
        r = conn.getresponse()
        assert r.status == 200 and len(r.read()) == SR // 128 * 128 * 2
        conn.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    reader.join(timeout=30)
    rest = []
    while not lines.empty():
        rest.append(lines.get())
    assert rest[-1].strip() == "server stopped", (rest, proc.stderr.read())
    proc.stdout.close()
    proc.stderr.close()
