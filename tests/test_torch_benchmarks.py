"""The port's benchmark suite (`pwn_tpu_torch/benchmarks.py`) against the
JAX package's (`pwn_tpu/benchmarks.py`) on the CPU: the FLOP model and the
parameter bytes of the DP roofline equal the reference's, both chain timers
recover a per-iteration time from the same fake chain and refuse a signal
under the noise, the result and bounds guards, the kernel canary's per-row
verdict, the data-parallel audit over Gloo processes, and `run_bench`'s
one-line contract with its measurements replaced by fakes.
"""


import numpy as np
import pytest
import torch

from pwn_tpu import benchmarks as jax_bench
from pwn_tpu_torch import benchmarks as bench
from pwn_tpu_torch.config import get_config, list_configs, override
from torch_parity import SMALL_STUDENT, jax_config

# tiny_teacher cut for the CPU: crops of 1,024 samples, batch 8 (the
# reference's DP audit shape)
DP_CFG = get_config("tiny_teacher", **{"train.crop_samples": 1024,
                                       "train.global_batch_size": 8})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers per host; torch's default of
    one intra-op thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list_configs())
def test_flops_equal_the_reference(name):
    cfg = get_config(name)
    jcfg = jax_config(cfg)
    assert (bench.student_gen_flops_per_sample(cfg)
            == jax_bench.student_gen_flops_per_sample(jcfg))
    assert (bench.teacher_fwd_flops_per_sample(cfg)
            == jax_bench.teacher_fwd_flops_per_sample(jcfg))


@pytest.mark.parametrize("name", ["teacher_lj", "tiny_teacher"])
def test_param_bytes_equal_the_reference(name):
    cfg = get_config(name)
    got = bench.analytic_dp_efficiency(cfg, 18.0)
    want = jax_bench.analytic_dp_efficiency(jax_config(cfg), 18.0)
    assert got["param_bytes"] == want["param_bytes"]
    assert [r["devices"] for r in got["rows"]] == [2, 4, 8, 16, 64, 256]
    assert [r["link"] for r in got["rows"]] == ["nvlink"] * 3 + ["nic"] * 3


class _FakeClock:
    """A clock that moves only when the fake chain runs, so the timers'
    decisions follow the chain's own numbers and not the host's
    scheduling (under several test workers a sleep can overrun by more
    than the margin a decision rests on)."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        return self.now

    def chain(self, overhead_s: float, per_iter_s: float):
        """A fixed sync cost plus linear per-iteration work, as
        tests/test_benchmarks.py fakes the reference's chain."""

        def chain(n):
            self.now += overhead_s + per_iter_s * int(n)
            return np.float32(n)

        return chain


def _fake_clock(module, monkeypatch) -> _FakeClock:
    """Replace the `time` module a timer reads by a fake clock."""
    clock = _FakeClock()
    monkeypatch.setattr(module, "time", clock)
    return clock


@pytest.mark.parametrize("module", [bench, jax_bench], ids=["port", "jax"])
def test_time_chain_recovers_per_iter_time(module, monkeypatch):
    """The 20 ms fixed cost cancels, leaving 10 ms an iteration in both
    timers."""
    monkeypatch.setattr(module, "measure_round_trip_ms",
                        lambda *a, **k: 5.0)
    clock = _fake_clock(module, monkeypatch)
    dt, meta = module._time_chain(clock.chain(0.020, 0.010), n_iters=4,
                                  reps=3)
    assert dt is not None and "timing_error" not in meta
    assert dt == pytest.approx(0.010, rel=1e-9), (dt, meta)


@pytest.mark.parametrize("module", [bench, jax_bench], ids=["port", "jax"])
def test_time_chain_refuses_sub_noise_signal(module, monkeypatch):
    """All the time is the fixed cost: an explicit error and no number."""
    monkeypatch.setattr(module, "measure_round_trip_ms",
                        lambda *a, **k: 30.0)
    clock = _fake_clock(module, monkeypatch)
    dt, meta = module._time_chain(clock.chain(0.030, 0.0), n_iters=2,
                                  reps=1, max_doublings=2)
    assert dt is None
    assert "refusing" in meta["timing_error"]


def test_time_chain_follows_the_agreed_decision(monkeypatch):
    """Under `agree` the group's decision holds over the rank's own: a
    clear signal (10 ms against a 1.5 ms threshold) is re-timed when the
    group says no."""
    monkeypatch.setattr(bench, "measure_round_trip_ms", lambda *a, **k: 1.0)
    clock = _fake_clock(bench, monkeypatch)
    calls = []
    dt, meta = bench._time_chain(
        clock.chain(0.0, 0.005), n_iters=2, reps=1, max_doublings=1,
        agree=lambda ok: calls.append(ok) or False)
    assert calls == [True, True]
    assert dt is None and meta["n_iters"] == 4


def test_rate_result_zeroes_rates_on_error():
    out = bench._rate_result(None, {"timing_error": "boom"},
                             {"utt_per_s": lambda s: 8 / s}, {"batch": 8})
    assert out["utt_per_s"] == 0.0 and out["step_ms"] == 0.0
    assert out["error"] == "boom"


def test_rate_result_passes_through_valid_timing():
    out = bench._rate_result(0.010, {"n_iters": 4},
                             {"utt_per_s": lambda s: 8 / s}, {"batch": 8})
    assert out["utt_per_s"] == pytest.approx(800.0)
    assert out["step_ms"] == pytest.approx(10.0)
    assert "error" not in out


def test_plausibility_rejects_sub_floor_step():
    # 1 TFLOP in 1 us would be 1,000 TFLOP/s, above the H100's 989
    err = bench._plausibility_check(0.001, 1e12, 989.0)
    assert err is not None and "floor" in err
    assert bench._plausibility_check(0.0, 1e12, 989.0) is not None
    assert bench._plausibility_check(10.0, 1e12, 989.0) is None
    assert bench._plausibility_check(10.0, 1e12, None) is None
    assert bench._plausibility_check(-1.0, 1e12, None) is not None


def test_analytic_dp_guards_invalid_step():
    cfg = get_config("tiny_teacher")
    out = bench.analytic_dp_efficiency(cfg, step_ms=0.0)
    assert "error" in out and "rows" not in out
    out = bench.analytic_dp_efficiency(cfg, step_ms=18.0, counts=(8,))
    assert out["rows"][0]["predicted_efficiency"] > 0.9
    assert "not measured" in out["note"]


def test_peak_is_none_off_the_card():
    assert bench.peak_bf16_tflops("cpu") is None


@pytest.mark.parametrize("check", ["gen", "dx", "ar"])
def test_canary_flags_the_bad_row(check):
    """A reference output with row 5 offset by 0.3 fails the canary, and
    row 5 is the only one over its threshold."""
    ref = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (8, 64, 16)).astype(np.float32))
    bad = ref.clone()
    bad[5] += 0.3
    rows = {"gen": np.zeros(8), "dx": np.zeros(8), "ar": np.zeros(8)}
    rows[check] = (bench._row_rel(bad, ref) if check != "ar"
                   else (bad - ref).abs().reshape(8, -1).amax(1).numpy())
    out = bench._canary_verdict(rows["gen"], rows["dx"], rows["ar"], {})
    key, thresh = {"gen": ("gen_row_rel_err", bench.GEN_THRESH),
                   "dx": ("train_dx_row_rel_err", bench.DX_THRESH),
                   "ar": ("ar_row_abs_diff", bench.AR_THRESH)}[check]
    assert out["pass"] is False
    assert list(np.flatnonzero(np.asarray(out[key]) >= thresh)) == [5]
    clean = bench._canary_verdict(np.zeros(8), np.zeros(8), np.zeros(8), {})
    assert clean["pass"] is True


def test_canary_is_skipped_on_the_cpu():
    out = bench.kernel_canary(get_config("student_iaf"), device="cpu")
    assert set(out) == {"skipped"}


def test_canary_checks_run_on_the_plain_versions():
    """The canary's three checks end to end on the CPU, where every
    wrapper runs its plain version: every row within its threshold, one
    entry a row."""
    cfg = get_config("tiny_teacher", **SMALL_STUDENT)
    out = bench._canary_checks(cfg, 2, 256, torch.device("cpu"))
    assert out["pass"] is True, out
    assert all(len(out[k]) == 2 for k in ("gen_row_rel_err",
                                          "train_dx_row_rel_err",
                                          "ar_row_abs_diff"))
    assert out["layout"] == {"L": 3, "C": 16, "G": 32, "S": 16, "B": 2,
                             "T": 256, "ar_steps": 512}


def test_dp_equivalence_over_two_gloo_processes():
    """Each of 2 CPU processes takes 4 of the 8 rows; the averaged
    gradients and loss equal one process's on all 8."""
    out = bench._run_ranks("dp_equivalence", 2, DP_CFG, cpu=True,
                           timeout=240)
    assert out["pass"] is True, out
    assert (out["devices"], out["batch"]) == (2, 8)


def test_scaling_row_times_two_processes_in_lockstep():
    """A scaling row over 2 Gloo processes: both ranks time the same
    chains (rank 0's decision), and the row is a rate or an explicit
    timing error, never a clamped number."""
    cfg = override(DP_CFG, "train.global_batch_size", 2)
    row = bench._run_ranks("scaling", 2, cfg, 1, cpu=True, timeout=240)
    assert (row["devices"], row["batch"]) == (2, 4)
    assert ("utt_per_s" in row and row["utt_per_s"] > 0) or "error" in row


@pytest.mark.parametrize("one_card_fails", [False, True])
def test_scaling_efficiency_needs_the_one_card_row(monkeypatch,
                                                   one_card_fails):
    rows = {1: {"devices": 1, "batch": 8, "utt_per_s": 100.0},
            2: {"devices": 2, "batch": 16, "utt_per_s": 180.0}}
    if one_card_fails:
        rows[1] = {"devices": 1, "batch": 8, "error": "noise"}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(bench, "_run_ranks",
                        lambda task, n, *a, **k: dict(rows[n]))
    out = bench.measure_scaling(DP_CFG)
    if one_card_fails:
        assert out[1]["efficiency"] == "invalid (1-device baseline failed)"
    else:
        assert [r["efficiency"] for r in out] == [1.0, 0.9]


def _student_result(dt=0.05, meta=None):
    return bench._rate_result(
        dt, meta or {"n_iters": 8},
        {"audio_sec_per_s_per_chip": lambda s: 16.0 / s,
         "samples_per_s": lambda s: 8 * 44032 / s},
        {"batch": 8, "samples": 44032})


@pytest.fixture
def fake_measurements(monkeypatch):
    """Every measurement of `run_bench` replaced by a fixed result."""
    def train(key):
        return lambda cfg, **k: bench._rate_result(
            0.05, {}, {key: lambda s: 8 / s},
            {"batch": 8, "crop_samples": 16384})

    monkeypatch.setattr(bench, "measure_student_inference",
                        lambda cfg, **k: _student_result())
    monkeypatch.setattr(bench, "kernel_canary",
                        lambda cfg, **k: {"skipped": "fake"})
    monkeypatch.setattr(bench, "measure_teacher_train",
                        train("teacher_utt_per_s"))
    monkeypatch.setattr(bench, "measure_distill_train",
                        train("distill_utt_per_s"))
    monkeypatch.setattr(bench, "measure_student_direct_train",
                        train("student_direct_utt_per_s"))
    monkeypatch.setattr(bench, "measure_teacher_ar_sampling",
                        lambda cfg, **k: bench._rate_result(
                            0.2, {}, {"ar_us_per_step": lambda s: s},
                            {"batch": 8, "samples": 5376}))
    monkeypatch.setattr(bench, "_dp_equivalence_cpu_sim",
                        lambda: {"pass": True, "sim": "fake"})


def test_run_bench_prints_the_reference_contract(fake_measurements):
    out = bench.run_bench("student_iaf", device="cpu")
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert out["metric"] == "student_audio_sec_per_s_per_chip"
    assert out["value"] == 320.0 and out["vs_baseline"] == 3.2
    d = out["detail"]
    assert d["device"] == "cpu"
    assert {"student", "kernel_check", "teacher_train", "distill_train",
            "student_direct_train", "teacher_ar", "student_config4",
            "dp_equivalence", "dp_analytic", "mfu", "launches"} <= set(d)
    assert d["dp_analytic"]["step_ms"] == pytest.approx(50.0)
    assert d["mfu"]["peak_bf16_tflops"] is None


def test_run_bench_timing_failure_is_an_error(fake_measurements,
                                              monkeypatch):
    monkeypatch.setattr(bench, "measure_student_inference",
                        lambda cfg, **k: _student_result(
                            None, {"timing_error": "not separable"}))
    out = bench.run_bench("student_iaf", full=False, device="cpu")
    assert out["value"] == 0.0
    assert "not separable" in out["error"]


def test_run_bench_refuses_an_mfu_above_one(fake_measurements, monkeypatch):
    """With the FLOP floor bypassed, an MFU above 1 is still an error and
    its entry is dropped."""
    monkeypatch.setattr(bench, "peak_bf16_tflops", lambda *a, **k: 1.0)
    monkeypatch.setattr(bench, "_plausibility_check", lambda *a: None)
    out = bench.run_bench("student_iaf", full=False, device="cpu")
    assert "mfu.student_infer" in out["error"]
    assert out["detail"]["mfu"]["student_infer"] is None
