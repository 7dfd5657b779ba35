"""Command-line entry points of the port (counterpart of `pwn_tpu/cli.py`):

    python -m pwn_tpu_torch.cli train-teacher  <case> [--workdir D]
                                               [--steps N] [k=v ...]
    python -m pwn_tpu_torch.cli train-student  <case> [--workdir D] [...]
                                               (direct, no teacher)
    python -m pwn_tpu_torch.cli distill-student <case> --teacher-workdir D
                                               [--teacher-step auto] [...]
    python -m pwn_tpu_torch.cli generate        <case> --workdir D
                                               [--model student|teacher]
                                               [--chunk-frames N]
    python -m pwn_tpu_torch.cli eval            <case> --ref A --gen B
    python -m pwn_tpu_torch.cli serve           <case> --workdir D
                                               [--host H] [--port P]
    python -m pwn_tpu_torch.cli bench           [case] [k=v ...]

`<case>` is a named preset; trailing `key=value` pairs override dotted
config fields, e.g. `train.learning_rate=3e-4`.  The three train commands
take `--data-dir D`, a directory of wav files (default: the synthetic
corpus), read by the engine `train.data_engine` names.  Under a launcher
they train data-parallel, one process per card:

    torchrun --nproc-per-node 8 -m pwn_tpu_torch.cli train-teacher \
        teacher_lj --data-dir wavs/ --workdir runs/teacher

Every subcommand runs on the CUDA card (the card of its `LOCAL_RANK`
under a launcher), or fails if there is none; `--device cpu` runs it on
the CPU, as the tests do.  `bench` prints the benchmark suite's result
(`benchmarks.run_bench`, default case student_iaf) as one JSON line.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import torch


def _parse_overrides(pairs):
    out = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"override must be key=value, got {p!r}")
        k, v = p.split("=", 1)
        out[k] = v
    return out


def _load_config(case: str, overrides):
    from pwn_tpu_torch.config import get_config

    return get_config(case, **_parse_overrides(overrides))


def _device(name):
    """The CUDA card unless `--device` names another device."""
    from pwn_tpu_torch.utils.platform import require_cuda

    return require_cuda() if name is None else torch.device(name)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="pwn_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; the "
                             "run fails if there is none)")

    p_train = sub.add_parser("train-teacher", parents=[common],
                             help="train the AR teacher")
    p_train.add_argument("case")
    p_train.add_argument("--workdir", default="runs/teacher")
    p_train.add_argument("--data-dir", default=None,
                         help="wav corpus dir (default: the synthetic "
                              "corpus)")
    p_train.add_argument("--steps", type=int, default=None)
    p_train.add_argument("overrides", nargs="*")

    p_sdir = sub.add_parser(
        "train-student", parents=[common],
        help="train the student IAF directly (no teacher): closed-form "
             "likelihood + power loss")
    p_sdir.add_argument("case")
    p_sdir.add_argument("--workdir", default="runs/student")
    p_sdir.add_argument("--data-dir", default=None)
    p_sdir.add_argument("--steps", type=int, default=None)
    p_sdir.add_argument("overrides", nargs="*")

    p_dist = sub.add_parser("distill-student", parents=[common],
                            help="distill the student IAF from a teacher")
    p_dist.add_argument("case")
    p_dist.add_argument("--teacher-workdir", required=True)
    p_dist.add_argument("--teacher-case", default=None,
                        help="case the teacher was trained with "
                             "(default: same case)")
    p_dist.add_argument("--workdir", default="runs/student")
    p_dist.add_argument("--data-dir", default=None)
    p_dist.add_argument("--steps", type=int, default=None)
    p_dist.add_argument("--teacher-step", default="latest",
                        help="teacher checkpoint step to distill from: an "
                             "integer, 'latest', or 'auto' (short-distill "
                             "against every retained teacher checkpoint "
                             "and pick the lowest held-out val_loss)")
    p_dist.add_argument("--teacher-probe-steps", type=int, default=500,
                        help="distill steps per candidate for "
                             "--teacher-step auto")
    p_dist.add_argument("--teacher-params", choices=["ema", "live"],
                        default="ema",
                        help="use the EMA (Polyak-averaged) teacher params "
                             "when the checkpoint carries them, or the "
                             "live unaveraged params")
    p_dist.add_argument("overrides", nargs="*")

    p_gen = sub.add_parser("generate", parents=[common],
                           help="synthesize a waveform")
    p_gen.add_argument("case")
    p_gen.add_argument("--workdir", required=True)
    p_gen.add_argument("--model", choices=["student", "teacher"],
                       default="student")
    p_gen.add_argument("--source", default=None,
                       help="source wav for copy-synthesis mel "
                            "(default: synthetic clip)")
    p_gen.add_argument("--output", default="generated.wav")
    p_gen.add_argument("--mel", default=None,
                       help="condition on a (frames, n_mels) float .npy mel "
                            "instead of a source wav (convention: "
                            "generate.coerce_mel; produce one with "
                            "--dump-mel)")
    p_gen.add_argument("--dump-mel", default=None,
                       help="also write the conditioning mel to this .npy "
                            "path")
    p_gen.add_argument("--source-dir", default=None,
                       help="batch mode: vocode every .wav under this dir "
                            "(student only); see --output-dir")
    p_gen.add_argument("--mel-dir", default=None,
                       help="batch mode over (frames, n_mels) .npy mels "
                            "instead of wavs")
    p_gen.add_argument("--output-dir", default=None,
                       help="where batch mode writes <stem>.wav "
                            "(default: alongside --output)")
    p_gen.add_argument("--batch-size", type=int, default=8,
                       help="batch-mode device batch")
    p_gen.add_argument("--bucket-frames", type=int, default=64,
                       help="batch-mode length buckets, in mel frames")
    p_gen.add_argument("--seconds", type=float, default=1.0)
    p_gen.add_argument("--temperature", type=float, default=1.0)
    p_gen.add_argument("--ar-backend", choices=["auto", "scan", "pallas"],
                       default="auto",
                       help="teacher AR sampler: auto and pallas run the "
                            "whole-loop sampler (the CUDA kernel on the "
                            "card), scan the eager conv-queue loop")
    p_gen.add_argument("--ar-weights-dtype", choices=["bfloat16", "float32"],
                       default=None,
                       help="weight storage of the whole-loop AR sampler "
                            "(compute is fp32 either way; default: the "
                            "preset's compute dtype)")
    p_gen.add_argument("--chunk-frames", type=int, default=0,
                       help="student streaming mode: synthesize in chunks "
                            "of this many mel frames, each recomputed with "
                            "the flows' receptive field (0: one "
                            "whole-utterance call)")
    p_gen.add_argument("overrides", nargs="*")

    p_eval = sub.add_parser(
        "eval", parents=[common],
        help="copy-synthesis quality metrics between two wavs")
    p_eval.add_argument("case")
    p_eval.add_argument("--ref", required=True)
    p_eval.add_argument("--gen", required=True)
    p_eval.add_argument("overrides", nargs="*")

    p_srv = sub.add_parser(
        "serve", parents=[common],
        help="streaming vocoder HTTP server (POST /synthesize with a wav or "
             ".npy mel body -> chunked PCM16; GET /healthz)")
    p_srv.add_argument("case")
    p_srv.add_argument("--workdir", default="runs/student")
    p_srv.add_argument("--host", default="127.0.0.1")
    p_srv.add_argument("--port", type=int, default=8600,
                       help="0 takes a free port (printed at start)")
    p_srv.add_argument("--chunk-frames", type=int, default=64,
                       help="mel frames per streamed chunk")
    p_srv.add_argument("--max-pending", type=int, default=4,
                       help="concurrent syntheses before 503 shedding")
    p_srv.add_argument("--max-body-mb", type=int, default=64,
                       help="request-body cap in MB (413 past it)")
    p_srv.add_argument("--batch-max", type=int, default=4,
                       help="batching across requests: most concurrent "
                            "streams per device call (1 disables)")
    p_srv.add_argument("--batch-window-ms", type=float, default=3.0,
                       help="job gather window while more than one stream "
                            "is active")
    p_srv.add_argument("overrides", nargs="*")

    p_bench = sub.add_parser("bench", parents=[common],
                             help="run the benchmark suite")
    p_bench.add_argument("case", nargs="?", default="student_iaf")
    p_bench.add_argument("overrides", nargs="*")
    return parser


def _generate(args, device) -> int:
    from pwn_tpu_torch.data.pipeline import SyntheticTones
    from pwn_tpu_torch.generate import (coerce_mel, generate_student,
                                        generate_teacher, load_student,
                                        mel_from_wav)
    from pwn_tpu_torch.utils.audio_io import read_wav, write_wav

    cfg = _load_config(args.case, args.overrides)
    sr = cfg.dsp.sample_rate

    if args.source_dir or args.mel_dir:
        from pwn_tpu_torch.generate import vocode_many

        if args.model == "teacher":
            print("batch mode is student-only", file=sys.stderr)
            return 2
        if args.mel_dir:
            paths = sorted(glob.glob(os.path.join(args.mel_dir, "*.npy")))
            mels = [np.load(p, allow_pickle=False) for p in paths]
        else:
            paths = sorted(glob.glob(os.path.join(args.source_dir, "*.wav")))
            mels = [mel_from_wav(cfg, read_wav(p, target_sr=sr)[0], device)
                    for p in paths]
        if not paths:
            print("batch mode: no inputs found", file=sys.stderr)
            return 2
        out_dir = args.output_dir or os.path.dirname(
            os.path.abspath(args.output))
        os.makedirs(out_dir, exist_ok=True)
        model = load_student(cfg, args.workdir, device)
        t0 = time.perf_counter()
        wavs = vocode_many(cfg, model, mels, seed=0,
                           temperature=args.temperature,
                           batch_size=args.batch_size,
                           bucket_frames=args.bucket_frames)
        wall = time.perf_counter() - t0
        total = 0.0
        for p, w in zip(paths, wavs):
            stem = os.path.splitext(os.path.basename(p))[0]
            write_wav(os.path.join(out_dir, stem + ".wav"), w, sr)
            total += len(w) / sr
        print(f"vocoded {len(paths)} utterances, {total:.1f}s audio in "
              f"{wall:.1f}s wall ({total / wall:.0f}x realtime incl. "
              f"first-use work) -> {out_dir}")
        return 0

    if args.mel:
        mel = coerce_mel(cfg, np.load(args.mel, allow_pickle=False))
    else:
        if args.source:
            wav, _ = read_wav(args.source, target_sr=sr)
        else:
            wav = SyntheticTones(1, int(args.seconds * sr), sr, seed=42)[0]
        mel = mel_from_wav(cfg, wav.astype(np.float32), device)
    if args.dump_mel:
        np.save(args.dump_mel, coerce_mel(cfg, mel)[0])
        print(f"wrote mel {tuple(mel.shape[1:])} -> {args.dump_mel}")
    gen = torch.Generator(device=device).manual_seed(0)
    if args.model == "teacher":
        from pwn_tpu_torch.models.teacher import TeacherWaveNet
        from pwn_tpu_torch.training.loop import load_teacher_params

        params, _ = load_teacher_params(cfg, args.workdir, device=device)
        teacher = TeacherWaveNet(cfg, device=device)
        teacher.load_state_dict(params)
        out = generate_teacher(cfg, teacher, mel, gen, args.temperature,
                               ar_backend=args.ar_backend,
                               ar_weights_dtype=args.ar_weights_dtype)
    elif args.chunk_frames:
        from pwn_tpu_torch.generate import (_host_deemphasis,
                                            stream_student_chunks)

        # the chunks as a server would send them, assembled into one wav;
        # cover_tail streams the last F % chunk_frames frames too
        chunks = list(stream_student_chunks(
            cfg, load_student(cfg, args.workdir, device), mel, seed=0,
            chunk_frames=args.chunk_frames, temperature=args.temperature,
            cover_tail=True))
        out = _host_deemphasis(np.concatenate(chunks, axis=1),
                               cfg.dsp.preemphasis)[0]
    else:
        model = load_student(cfg, args.workdir, device)
        out = generate_student(cfg, model, mel, gen, args.temperature)
    write_wav(args.output, out, sr)
    print(f"wrote {args.output}: {len(out) / sr:.2f}s @ {sr} Hz")
    return 0


def main(argv=None) -> int:
    parser = _parser()
    # trailing key=value overrides after the options: argparse versions
    # differ on whether the `overrides` positional still takes them, so
    # whatever it leaves over that is key=value joins it
    args, extra = parser.parse_known_args(argv)
    if extra and (not hasattr(args, "overrides")
                  or any(e.startswith("-") or "=" not in e for e in extra)):
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if extra:
        args.overrides = [*args.overrides, *extra]
    device = _device(args.device)
    if args.cmd in ("train-teacher", "train-student", "distill-student"):
        from pwn_tpu_torch.parallel.mesh import ensure_distributed

        ensure_distributed(device)

    if args.cmd == "train-teacher":
        from pwn_tpu_torch.training.loop import run_teacher_training

        cfg = _load_config(args.case, args.overrides)
        res = run_teacher_training(cfg, workdir=args.workdir,
                                   data_dir=args.data_dir,
                                   num_steps=args.steps, device=device)
        print(f"teacher done: {res.steps_run} steps, "
              f"final {res.final_metrics}")
        return 0

    if args.cmd == "train-student":
        from pwn_tpu_torch.training.loop import run_student_direct_training

        cfg = _load_config(args.case, args.overrides)
        res = run_student_direct_training(cfg, workdir=args.workdir,
                                          data_dir=args.data_dir,
                                          num_steps=args.steps, device=device)
        print(f"student (direct) done: {res.steps_run} steps, "
              f"final {res.final_metrics}")
        return 0

    if args.cmd == "distill-student":
        from pwn_tpu_torch.training.loop import (load_teacher_params,
                                                 run_distillation)

        cfg = _load_config(args.case, args.overrides)
        tcfg = (_load_config(args.teacher_case, args.overrides)
                if args.teacher_case else cfg)
        prefer_ema = args.teacher_params == "ema"
        if args.teacher_step == "auto":
            from pwn_tpu_torch.training.teacher_select import \
                select_teacher_step

            t_step = select_teacher_step(
                cfg, args.teacher_workdir, teacher_cfg=tcfg,
                data_dir=args.data_dir, probe_steps=args.teacher_probe_steps,
                prefer_ema=prefer_ema, device=device)
        elif args.teacher_step == "latest":
            t_step = None
        else:
            t_step = int(args.teacher_step)
        teacher_params, tstep = load_teacher_params(
            tcfg, args.teacher_workdir, step=t_step, prefer_ema=prefer_ema,
            device=device)
        print(f"loaded teacher @ step {tstep} ({args.teacher_params} params)")
        res = run_distillation(cfg, teacher_params, workdir=args.workdir,
                               data_dir=args.data_dir, num_steps=args.steps,
                               device=device)
        print(f"student done: {res.steps_run} steps, "
              f"final {res.final_metrics}")
        return 0

    if args.cmd == "eval":
        from pwn_tpu_torch.evaluate import copy_synthesis_report
        from pwn_tpu_torch.utils.audio_io import read_wav

        cfg = _load_config(args.case, args.overrides)
        ref, _ = read_wav(args.ref, target_sr=cfg.dsp.sample_rate)
        gen, _ = read_wav(args.gen, target_sr=cfg.dsp.sample_rate)
        n = min(len(ref), len(gen))
        print(json.dumps(copy_synthesis_report(cfg, ref[:n], gen[:n],
                                               device)))
        return 0

    if args.cmd == "bench":
        from pwn_tpu_torch.benchmarks import run_bench

        print(json.dumps(run_bench(args.case, _parse_overrides(args.overrides),
                                   device=device)), flush=True)
        return 0

    if args.cmd == "serve":
        from pwn_tpu_torch.serve import serve_forever

        cfg = _load_config(args.case, args.overrides)
        serve_forever(cfg, args.workdir, args.host, args.port,
                      chunk_frames=args.chunk_frames,
                      max_pending=args.max_pending,
                      max_body_bytes=args.max_body_mb * 2 ** 20,
                      batch_max=args.batch_max,
                      batch_window_ms=args.batch_window_ms, device=device)
        return 0

    return _generate(args, device)


if __name__ == "__main__":
    sys.exit(main())
