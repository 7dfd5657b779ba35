"""Teacher AR sampling: calls of the program's whole-loop sampler
(`models/sampling.py::fast_sample_kernel`) at batch x frames, back to back,
each waveform read back to the host as `generate_teacher` reads it.

Set-up draws the weights (the MoL head's component-0 logit bias raised by
`pin_component0`, so that the draw's component choice never sits on a
tie: with random weights the AR loop is chaotic, and a flipped choice
sends two runs O(1) apart), `inputs` mels and their uniform streams from
the seed, and warms the call.  The window cycles through the inputs.
The check takes a seeded sample of the window's calls: the reference runs
the teacher forward over each call's own samples (teacher forcing, fp32)
and draws from the same uniforms; the number compared is the largest gap
between a sample the program drew and the reference's draw at that step.
"""

from __future__ import annotations

import numpy as np

from perfbench import params, traffic_gen
from perfbench.core import Outcome
from perfbench.drivers import common
from perfbench.reference import wavenet as ref


def run(ctx):
    torch = ctx.torch
    from pwn_tpu_torch.models import sampling
    from pwn_tpu_torch.models.teacher import TeacherWaveNet

    cfg = ctx.program_config()
    t, z, dsp = ctx.traffic, ctx.sizes(), ctx.config["dsp"]
    s_w, s_mel, s_noise, s_pick = ctx.sub_seeds(4)
    weights = params.make_weights(params.teacher_spec(z), s_w, ctx.device,
                                  ctx.config["init"])
    weights["stack.head2.bias"][0] += t["pin_component0"]
    model = TeacherWaveNet(cfg, device=ctx.device)
    model.load_state_dict(weights, strict=True)
    model.eval()
    B, Fr, P = t["batch"], t["frames"], t["inputs"]
    T, K = Fr * dsp["hop_length"], z["n_mixtures"]
    mels = torch.from_numpy(np.stack(traffic_gen.make_mels(
        [Fr] * (P * B), z["n_mels"], s_mel, ctx.device))).view(
        P, B, Fr, z["n_mels"]).to(ctx.device)
    gen = torch.Generator(device=ctx.device).manual_seed(s_noise)
    noise = 1e-5 + torch.rand((P, T, B, K + 1), generator=gen,
                              device=ctx.device) * (1 - 2e-5)

    def call(i):
        return sampling.fast_sample_kernel(
            model, None, mels[i % P], temperature=t["temperature"],
            noise=noise[i % P]).cpu()

    faults = {"answer": lambda: common.patched(
        sampling, "fast_sample_kernel", common.alter_answer)}
    call(0)                                       # warm-up
    before = common.launch_counts()
    outs = []
    with common.fault(ctx, faults):
        with ctx.window() as win:
            while win.running():
                outs.append(call(len(outs)))
    elapsed = win.elapsed_s
    launches = common.launches_since(before)
    ctx.read_memory()
    calls = len(outs)
    chosen = common.pick(calls, t["check_calls"], s_pick,
                         must=[calls - 1])
    got = {i: outs[i] for i in chosen}
    del outs, model
    ctx.free()

    ref.no_tf32()
    gaps = []
    with torch.no_grad():
        for i in chosen:
            wav = got[i].to(ctx.device)
            u = noise[i % P].transpose(0, 1)

            def draw(prec):
                cond = ref.match_length(ref.upsample(
                    mels[i % P], weights, "upsample.",
                    z["upsample_strides"], prec), T)
                return ref.mol_draw(ref.teacher_params(
                    wav, cond, weights, z["dilations"], prec), u,
                    z["log_scale_min"], t["temperature"])

            truth = draw("fp32")
            cand = draw("fp8") if ctx.candidate == "fp8" else wav
            gaps.append(float((cand - truth).abs().max()))
    steps = calls * T
    out = Outcome(
        e2e={"ar_us_per_step": elapsed / steps * 1e6},
        attempted=calls, failed=0, checks={"sample_max_gap": max(gaps)},
        counts={"steps": steps, "rows": B, "calls": calls},
        notes={"launches": launches, "calls": calls})
    return out, win.trace
