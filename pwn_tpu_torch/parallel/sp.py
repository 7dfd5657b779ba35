"""Overlap-recompute geometry (counterpart of
`pwn_tpu/parallel/sp.py::_sp_mega_geometry`).  Only the geometry is
ported; `generate.vocode_many` needs the upsampler halo H from it."""

from __future__ import annotations

from pwn_tpu_torch.config import Config


def sp_mega_geometry(cfg: Config) -> tuple[int, int]:
    """(R, H): overlap samples (the flow chain's receptive field rounded
    up to a hop multiple) and the upsampler's frame halo."""
    sc = cfg.student
    hop = cfg.dsp.hop_length
    r = sc.n_flows * (sum(sc.flow_dilations) + 1)
    R = -(-r // hop) * hop
    H = cfg.teacher.upsample_kernel_mult * len(
        cfg.teacher.upsample_strides
    ) + 2
    return R, H
