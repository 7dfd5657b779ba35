"""Typed configuration system with named presets (the port's own copy of
`pwn_tpu/config.py`, field for field and preset for preset, so that the
port imports nothing of the JAX package; tests/test_torch_config.py holds
the two equal).

Replaces the reference's YAML "case" system (`hparam.py` + `hparams/*.yaml`
[R], SURVEY.md §2a): there a module-global dot-dict `hp` was mutated by
`hp.set_hparam(case)` and imported everywhere.  Here configs are frozen
dataclasses passed explicitly — no global mutable state, chex-friendly, and
jit-safe (everything is static/hashable).

The five presets mirror BASELINE.json `configs[0..4]` exactly:
    0 tiny_teacher            — 2 blocks x 5 layers, 64 ch, 1 s @ 16 kHz, CPU-runnable
    1 teacher_lj              — 24-layer teacher (3 blocks), 10-component MoL, LJSpeech mel
    2 student_iaf             — 4 flows x 10-layer stacks distilled with KL + power loss
    3 multihost_dp            — batch 256 utterances across 2 hosts, psum sync
    4 large_student_sharded   — 6 flows, 128 ch, 24 kHz, stack sharded across chips

CLI `key=value` overrides are applied with `override()` (dotted paths).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class DSPConfig:
    """Signal-processing parameters (reference: `audio_utils.py` [R]).

    Conventions are pinned in SURVEY.md §8: LJSpeech-standard STFT
    (n_fft 1024 / hop 256 / Hann, centered reflect pad), Slaney mel-80,
    dB normalization to [0, 1], preemphasis 0.97.
    """

    sample_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float | None = None  # None -> sample_rate / 2
    preemphasis: float = 0.97
    # dB normalization: db in [min_db, 0] mapped to [0, 1].
    min_db: float = -100.0
    ref_db: float = 20.0

    @property
    def fmax_hz(self) -> float:
        return self.sample_rate / 2.0 if self.fmax is None else self.fmax


@dataclass(frozen=True)
class TeacherConfig:
    """Teacher WaveNet architecture (reference: `models.py`/`modules.py` [R]).

    Dilations cycle 2^0..2^(layers_per_block-1) within each block.
    """

    n_blocks: int = 3
    layers_per_block: int = 8  # 3 x 8 = 24 layers for the LJ preset
    kernel_size: int = 2
    residual_channels: int = 128
    gate_channels: int = 256  # split into tanh/sigmoid halves
    skip_channels: int = 128
    n_mixtures: int = 10  # mixture-of-logistics components
    # Output family: "mol" (discretized mixture of logistics, the
    # reference head [R]) or "gaussian" (single-Gaussian head — enables
    # the ClariNet closed-form distillation KL, ops/gaussian.py; the
    # trunk and all Pallas kernels are shared, only the 2-unit XLA head
    # and the loss change)
    output: str = "mol"
    # Mel upsampling: product of strides must equal DSPConfig.hop_length.
    upsample_strides: Tuple[int, ...] = (16, 16)
    upsample_kernel_mult: int = 2  # kernel = stride * mult per stage
    # Weight-normalize the upsampler's transposed-conv kernels
    # (ops/norm.py; the reference's `modules.py::normalize` wrapper [R]).
    # The gated stack stays unnormalized by design — its flat param
    # layout is shared by the Pallas kernels / AR sampler / TP rules
    # (see models/modules.py::UpsampleNet).  Measured on tiny_teacher
    # (CPU, 400 adam steps, 3 seeds): NLL 8.71 +- 0.6 (off) vs
    # 8.27 +- 0.65 (on) — parity within seed noise, no stability
    # difference on this model; default off (goldens pin the plain
    # parameterization).  Teacher and student share the flag.
    upsample_weight_norm: bool = False
    # Minimum log-scale for MoL (numerical floor, fp32 loss).
    log_scale_min: float = -9.0
    compute_dtype: str = "bfloat16"  # matmul/conv dtype; losses in fp32
    # Stack execution mode, in the reference's names: "off" (scan or
    # unrolled layers), "layer" (per-layer gated kernel), "mega" (whole-
    # stack kernel), "mega_train" (whole-stack forward + fused backward),
    # "auto" (the whole-stack kernels; teacher training loops map it to
    # mega_train).  The port maps these onto WaveNetStack's modes
    # (models/modules.py::resolve_stack_mode); the measurements behind the
    # reference's choice are in pwn_tpu/config.py.
    fused_layers: str = "auto"

    @property
    def n_layers(self) -> int:
        return self.n_blocks * self.layers_per_block

    @property
    def head_dim(self) -> int:
        """Output-head width: 3K MoL params or (mu, log_s)."""
        return 2 if self.output == "gaussian" else 3 * self.n_mixtures

    @property
    def dilations(self) -> Tuple[int, ...]:
        return tuple(
            2 ** (i % self.layers_per_block) for i in range(self.n_layers)
        )

    @property
    def receptive_field(self) -> int:
        return 1 + sum((self.kernel_size - 1) * d for d in self.dilations)


@dataclass(frozen=True)
class StudentConfig:
    """Student IAF architecture (SURVEY.md §8; BASELINE configs[2,4]).

    Each flow is a causal WaveNet over z emitting per-timestep (mu, log_s);
    z_i = z_{i-1} * s_i + mu_i keeps the Jacobian triangular.
    """

    n_flows: int = 4
    layers_per_flow: int = 10
    kernel_size: int = 2
    residual_channels: int = 64
    gate_channels: int = 128
    skip_channels: int = 64
    log_scale_clamp: float = 7.0  # |log s| clamp for stability
    compute_dtype: str = "bfloat16"
    fused_layers: str = "auto"  # see TeacherConfig.fused_layers
    # Base-noise family: "logistic" (Parallel WaveNet [PW], the default
    # pinned by the goldens) or "gaussian" (ClariNet: the affine flow
    # chain then makes every per-timestep output conditional exactly
    # N(mu_total, exp(log_det)^2), enabling the closed-form distill KL)
    base: str = "logistic"

    @property
    def flow_dilations(self) -> Tuple[int, ...]:
        return tuple(2 ** i for i in range(self.layers_per_flow))


@dataclass(frozen=True)
class DistillConfig:
    """Distillation loss weights (SURVEY.md §8, Parallel WaveNet [PW])."""

    kl_weight: float = 1.0
    power_loss_weight: float = 1.0
    # number of z samples per utterance for the KL Monte-Carlo estimate
    n_kl_samples: int = 1
    # direct (teacher-free) student training: weight of the closed-form
    # IAF likelihood term (training/student_direct.py; the reference's
    # WIP mode, SURVEY.md §2a low-confidence flag)
    ml_weight: float = 1.0
    # extra STFT magnitude-loss resolutions as (n_fft, hop, win) triples
    # averaged with the primary cfg.dsp resolution (multi-resolution
    # spectral loss, the standard vocoder lever for unvoiced/transient
    # fidelity; () keeps the single-resolution Parallel-WaveNet power
    # loss and the round-1/2 goldens bit-exact)
    power_loss_resolutions: tuple = ()
    # linearly ramp kl_weight over the first N steps (0 = constant):
    # lets the power loss anchor the student before reverse-KL mode-
    # seeking kicks in (whisper-collapse mitigation, SURVEY.md §7)
    kl_warmup_steps: int = 0
    # KL estimator: "auto" (closed_form when teacher.output and
    # student.base are both gaussian, else sampled), "sampled" (Parallel
    # WaveNet pathwise one-sample estimate [PW]) or "closed_form"
    # (ClariNet exact per-timestep Gaussian KL — requires the gaussian
    # teacher head AND gaussian student base; ops/gaussian.py)
    objective: str = "auto"
    # closed_form only: ClariNet's variance regularizer weight lambda on
    # |log sigma_T - log sigma_S|^2 (stabilizes the reverse KL's flat
    # gradient when the student variance collapses; paper uses 4)
    log_sigma_reg_weight: float = 4.0
    # Parallel WaveNet's CONTRASTIVE term [PW]: additionally MAXIMIZE the
    # KL between the student and the teacher evaluated under MISMATCHED
    # conditioning (the same student sample scored against another
    # utterance's mel, batch-rolled) — down-weights mode collapse onto
    # conditioning-independent audio.  gamma in the paper's notation;
    # they report 0.3.  0 keeps the extra teacher pass out of the graph
    # and the goldens bit-exact.  Rides the same kl_warmup ramp as the
    # matched KL.  No-op at (per-shard) batch 1, where the roll is the
    # identity.
    contrastive_weight: float = 0.0


@dataclass(frozen=True)
class TrainConfig:
    global_batch_size: int = 8
    crop_samples: int = 16000  # fixed-length random crop (train)
    learning_rate: float = 1e-3
    lr_decay_steps: int = 200_000
    lr_decay_rate: float = 0.5
    total_steps: int = 1_000_000
    grad_clip_norm: float = 10.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    checkpoint_every: int = 2000
    # checkpoints retained by the run's CheckpointManager; raise it to
    # keep a ladder of teacher checkpoints for distillability-aware
    # teacher selection (training/teacher_select.py — BASELINE.md r4
    # measured that an overtrained teacher distills 3x worse)
    keep_checkpoints: int = 3
    log_every: int = 50
    # Polyak/EMA parameter averaging (0 = off): checkpoints then carry
    # ema_params and downstream consumers (generate, the distillation
    # teacher input) run the average — the Parallel WaveNet recipe [PW]
    ema_decay: float = 0.0
    seed: int = 0
    # length of the audio progress artifact dumped at checkpoint cadence
    # (teacher AR samples are sequential — keep them short)
    eval_sample_seconds: float = 0.25
    # use the C++ loader (native/loader.cc) for wav-dir corpora when the
    # toolchain is available; the Python pipeline is the fallback
    native_loader: bool = True
    # input engine: "auto" (C++ loader for wav dirs, else python),
    # "native", "python", or "grain"
    data_engine: str = "auto"
    # grain engine only: multiprocess prefetch workers (0 = in-process)
    grain_workers: int = 0
    # synthetic corpus family when no --data-dir is given: "tones"
    # (5-harmonic AM tones) or "speech" (formant glides, fricatives,
    # plosives, silences — the harder signal)
    synthetic_corpus: str = "tones"
    # write native TensorBoard event files (utils/tensorboard.py;
    # dependency-free writer) next to the jsonl metrics
    tensorboard: bool = True


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout (SURVEY.md §2c/§2d).

    data axis: utterance-batch data parallelism (psum gradient sync).
    model axis: channel sharding of the dilated residual stack (TP).
    -1 on the data axis means "all remaining devices".
    """

    data: int = -1
    model: int = 1


@dataclass(frozen=True)
class Config:
    name: str = "default"
    dsp: DSPConfig = field(default_factory=DSPConfig)
    teacher: TeacherConfig = field(default_factory=TeacherConfig)
    student: StudentConfig = field(default_factory=StudentConfig)
    distill: DistillConfig = field(default_factory=DistillConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


# ---------------------------------------------------------------------------
# Presets (BASELINE.json configs[0..4])
# ---------------------------------------------------------------------------


def _tiny_teacher() -> Config:
    """configs[0]: 2 blocks x 5 layers, 64 residual ch, single 1 s 16 kHz
    clip, CPU-runnable AR sampling."""
    return Config(
        name="tiny_teacher",
        dsp=DSPConfig(sample_rate=16000, n_fft=512, hop_length=128,
                      win_length=512, n_mels=40),
        teacher=TeacherConfig(
            n_blocks=2,
            layers_per_block=5,
            residual_channels=64,
            gate_channels=128,
            skip_channels=64,
            upsample_strides=(8, 16),
            compute_dtype="float32",
        ),
        student=StudentConfig(compute_dtype="float32"),
        train=TrainConfig(global_batch_size=1, crop_samples=16000,
                          learning_rate=2e-3, total_steps=500,
                          checkpoint_every=250, log_every=10),
    )


def _teacher_lj() -> Config:
    """configs[1]: 24-layer teacher (3 blocks), 10-comp MoL, LJSpeech mel."""
    return Config(
        name="teacher_lj",
        dsp=DSPConfig(),
        teacher=TeacherConfig(),
        train=TrainConfig(global_batch_size=8, crop_samples=16384,
                          learning_rate=1e-3),
    )


def _student_iaf() -> Config:
    """configs[2]: student IAF, 4 flows x 10 layers, KL + power loss."""
    return Config(
        name="student_iaf",
        dsp=DSPConfig(),
        teacher=TeacherConfig(),
        student=StudentConfig(),
        distill=DistillConfig(),
        train=TrainConfig(global_batch_size=8, crop_samples=16384,
                          learning_rate=5e-4),
    )


def _multihost_dp() -> Config:
    """configs[3]: data-parallel distillation, batch 256 over 2 hosts."""
    return Config(
        name="multihost_dp",
        dsp=DSPConfig(),
        teacher=TeacherConfig(),
        student=StudentConfig(),
        distill=DistillConfig(),
        train=TrainConfig(global_batch_size=256, crop_samples=16384,
                          learning_rate=5e-4),
        mesh=MeshConfig(data=-1, model=1),
    )


def _large_student_sharded() -> Config:
    """configs[4] (stretch): 6 flows, 128 ch, 24 kHz, sharded across
    chips.

    TRAINING shards the BATCH (DP), not the stack: the model is
    activation-dominated, so Megatron gate-channel TP pays a (B, T, C+S)
    reduction per layer, where DP pays one gradient all-reduce per step,
    and DP keeps the fused whole-stack train kernels.  Generation and
    serving still shard over every device (batch-sharded, or sequence
    parallel for long utterances), and TP *state* sharding remains for
    storage.  The reference's analysis and its measurements are in the
    docstring of pwn_tpu/config.py::_large_student_sharded.
    """
    return Config(
        name="large_student_sharded",
        dsp=DSPConfig(sample_rate=24000),
        teacher=TeacherConfig(residual_channels=128, gate_channels=256,
                              skip_channels=128),
        student=StudentConfig(n_flows=6, residual_channels=128,
                              gate_channels=256, skip_channels=128),
        distill=DistillConfig(),
        train=TrainConfig(global_batch_size=64, crop_samples=24576,
                          learning_rate=5e-4),
        mesh=MeshConfig(data=-1, model=1),
    )


def _clarinet_gaussian() -> Config:
    """Beyond-reference preset: ClariNet-style single-Gaussian teacher +
    Gaussian-base student with the exact closed-form distillation KL
    (ops/gaussian.py; arXiv:1807.07281).  Same trunk/sizes as
    `student_iaf` so kernel perf carries over; only the 2-unit head,
    the base noise, and the objective differ."""
    return Config(
        name="clarinet_gaussian",
        dsp=DSPConfig(),
        teacher=TeacherConfig(output="gaussian"),
        student=StudentConfig(base="gaussian"),
        distill=DistillConfig(objective="closed_form"),
        train=TrainConfig(global_batch_size=8, crop_samples=16384,
                          learning_rate=5e-4),
    )


def _student_iaf_best() -> Config:
    """Beyond-reference preset: `student_iaf` with every distillation
    lever at its MEASURED best value (BASELINE.md r2+r5 A/Bs) —
    multi-resolution power loss, KL warmup, EMA teacher/serving params,
    and the Parallel WaveNet contrastive term.  With
    `distill-student student_iaf_best --teacher-step auto` this is the
    best-known recipe on the speech corpus: val KL 0.306 -> 0.101,
    mel-L2 ~20% under the plain recipe at every temperature with the
    same -37..-38 dBFS silence floor.  (`student_iaf` keeps the plain
    Parallel WaveNet loss — the goldens pin that graph.)"""
    return Config(
        name="student_iaf_best",
        dsp=DSPConfig(),
        teacher=TeacherConfig(),
        student=StudentConfig(),
        distill=DistillConfig(
            power_loss_resolutions=((512, 128, 512), (2048, 512, 2048)),
            kl_warmup_steps=1000,
            contrastive_weight=0.3,
        ),
        train=TrainConfig(global_batch_size=8, crop_samples=16384,
                          learning_rate=5e-4, ema_decay=0.9995,
                          keep_checkpoints=10),
    )


_PRESETS = {
    "tiny_teacher": _tiny_teacher,
    "teacher_lj": _teacher_lj,
    "student_iaf": _student_iaf,
    "multihost_dp": _multihost_dp,
    "large_student_sharded": _large_student_sharded,
    "clarinet_gaussian": _clarinet_gaussian,
    "student_iaf_best": _student_iaf_best,
}


def list_configs() -> Tuple[str, ...]:
    return tuple(_PRESETS)


def get_config(name: str, **overrides: Any) -> Config:
    """Load a named preset, optionally applying dotted-path overrides.

    >>> get_config("tiny_teacher")
    >>> get_config("teacher_lj", **{"train.learning_rate": 3e-4})
    """
    if name not in _PRESETS:
        raise KeyError(
            f"unknown config {name!r}; available: {sorted(_PRESETS)}"
        )
    cfg = _PRESETS[name]()
    for key, value in overrides.items():
        cfg = override(cfg, key, value)
    return cfg


def override(cfg: Config, dotted_key: str, value: Any) -> Config:
    """Return a new Config with `dotted_key` (e.g. 'train.learning_rate')
    replaced by `value`, coercing strings to the field's annotated type."""
    parts = dotted_key.split(".")

    def _rec(obj: Any, path: list[str]) -> Any:
        name = path[0]
        if not dataclasses.is_dataclass(obj) or not hasattr(obj, name):
            raise KeyError(f"no config field {dotted_key!r}")
        if len(path) == 1:
            return replace(obj, **{name: _coerce(obj, name, value)})
        return replace(obj, **{name: _rec(getattr(obj, name), path[1:])})

    return _rec(cfg, parts)


def _coerce(obj: Any, name: str, value: Any) -> Any:
    if not isinstance(value, str):
        return value
    current = getattr(obj, name)
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        try:
            return tuple(int(v) for v in value.strip("()").split(","))
        except ValueError:
            # nested tuples, e.g. distill.power_loss_resolutions=
            # "((512,128,512),(2048,512,2048))"
            import ast

            parsed = ast.literal_eval(value)
            return tuple(tuple(r) for r in parsed)
    return value


def to_dict(cfg: Config) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
