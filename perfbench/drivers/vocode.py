"""Offline batch vocoding: one job of utterances, replayed through the
program's `generate.vocode_many` until the window ends.

Set-up draws the weights and the job's mels from the seed (lengths: the
mix's fixed quantiles in a seeded order) and runs the job once, which
warms every bucket length it uses.  As `generate --source-dir` does, the
job passes a seed and no noise: the program draws each item's noise on
the card.  The window counts the audio asked for (true lengths, padding
excluded) of every job it completes.  The check compares a seeded sample
of the last job's waveforms, the longest among them, with the reference's
synthesis of the same mel (fp32), deemphasized, from the item's noise
rebuilt by the benchmark's copy of the program's draw: the number
compared is the largest sample gap.
"""

from __future__ import annotations

import numpy as np

from perfbench import params, traffic_gen
from perfbench.core import Outcome
from perfbench.drivers import common
from perfbench.reference import wavenet as ref


def run(ctx):
    torch = ctx.torch
    from pwn_tpu_torch.generate import vocode_many
    from pwn_tpu_torch.models.student import StudentIAF

    cfg = ctx.program_config()
    t, z, dsp = ctx.traffic, ctx.sizes(), ctx.config["dsp"]
    hop, sr = dsp["hop_length"], dsp["sample_rate"]
    s_w, s_len, s_mel, s_noise, s_pick = ctx.sub_seeds(5)
    bucket = t["bucket_frames"]
    weights = params.make_weights(params.student_spec(z), s_w, ctx.device,
                                  ctx.config["init"])
    model = StudentIAF(cfg, device=ctx.device)
    model.load_state_dict(weights, strict=True)
    model.eval()
    frames = traffic_gen.frames_of(
        traffic_gen.lengths_s(t["lengths"], t["utterances"], s_len), sr, hop)
    mels = traffic_gen.make_mels(frames, z["n_mels"], s_mel, ctx.device)
    kw = dict(batch_size=t["batch_size"], bucket_frames=bucket,
              temperature=t["temperature"], seed=s_noise)
    faults = {"answer": lambda: common.patched(
        StudentIAF, "flows_from_z", common.alter_answer)}

    vocode_many(cfg, model, mels, **kw)          # warm-up: every bucket
    before = common.launch_counts()
    jobs = 0
    with common.fault(ctx, faults):
        with ctx.window() as win:
            while win.running():
                outs = vocode_many(cfg, model, mels, **kw)
                jobs += 1
    elapsed = win.elapsed_s
    launches = common.launches_since(before)
    ctx.read_memory()

    useful = jobs * int(frames.sum()) * hop
    chosen = common.pick(len(frames), t["check_utterances"], s_pick,
                         must=[int(np.argmax(frames))])
    got = {i: outs[i] for i in chosen}
    del outs, model
    ctx.free()

    ref.no_tf32()
    worst = []
    with torch.no_grad():
        for i in chosen:
            mel = torch.from_numpy(mels[i][None]).to(ctx.device)
            n_bucket = -(-int(frames[i]) // bucket) * bucket * hop
            zi = t["temperature"] * traffic_gen.item_noise(
                s_noise, i, n_bucket, ctx.device)[None, : frames[i] * hop]
            truth = ref.deemphasis(ref.student_wave(
                mel, zi, weights, z, "fp32")[0].cpu().numpy(),
                dsp["preemphasis"])
            if ctx.candidate == "fp8":
                cand = ref.deemphasis(ref.student_wave(
                    mel, zi, weights, z, "fp8")[0].cpu().numpy(),
                    dsp["preemphasis"])
            else:
                cand = got[i]
            worst.append(common.max_abs(cand, truth))
    out = Outcome(
        e2e={"audio_s_per_s": useful / sr / elapsed},
        attempted=jobs * len(frames), failed=0,
        checks={"wave_max_abs": max(worst)},
        counts={"useful_samples": useful, "jobs": jobs},
        notes={"launches": launches, "jobs": jobs,
               "audio_s_per_job": float(frames.sum() * hop / sr)})
    return out, win.trace

