"""The MISO1 -> MVDR -> MISO2/MISO3 cascade as one call
(misonet_tpu/inference/cascade.py; reference Tester_Enhance.inference,
tester.py:846-975).

The JAX package ``vmap``s the MVDR over speakers; here the speakers are a
batch axis of one ``mvdr_beamform`` call (one weights launch), and MISO3's
per-speaker passes are folded into the batch of one forward.  The
conditioning channels go in the JAX package's (MISO1, BF) order.
"""

from __future__ import annotations

import torch

from misonet_tpu_torch.beamforming.mvdr import mvdr_beamform
from misonet_tpu_torch.inference.separate import make_full_array_decode
from misonet_tpu_torch.models import enhance_input


def beamform_sources(miso1_full: torch.Tensor, mix: torch.Tensor,
                     ref_ch: int = 0, power_iters: int = 100) -> torch.Tensor:
    """Per-speaker MVDR, all speakers in one call.

    miso1_full [B, S, C, T, F] per-speaker images at every mic
    mix        [B, C, T, F]
    -> beamformed [B, S, T, F] (tester.py:917-924 loops the speakers)."""
    return mvdr_beamform(miso1_full, mix[:, None], ref_ch=ref_ch,
                         power_iters=power_iters)


def enhance_inputs(mix: torch.Tensor, miso1_ref: torch.Tensor,
                   bf: torch.Tensor, joint: bool) -> torch.Tensor:
    """The enhancement net's input from mix [B, C, T, F] and the [B, S, T,
    F] estimates: MISO2's (``joint``) [B, C+2S, T, F], all speakers at
    once (tester.py:940-947); MISO3's [B*S, C+2, T, F], every speaker in
    the batch of one forward (tester.py:935-939)."""
    if joint:
        return enhance_input(mix, miso1_ref, bf)
    b, s, t, f = bf.shape
    return enhance_input(mix.repeat_interleave(s, dim=0),
                         miso1_ref.reshape(b * s, 1, t, f),
                         bf.reshape(b * s, 1, t, f))


def enhance(enhance_model, mix: torch.Tensor, miso1_ref: torch.Tensor,
            bf: torch.Tensor, joint: bool) -> torch.Tensor:
    """MISO2 (``joint``) or MISO3 over [B, S, T, F] estimates -> enhanced
    [B, S, T, F]."""
    est = enhance_model(enhance_inputs(mix, miso1_ref, bf, joint))
    return est if joint else est.reshape(bf.shape)


def make_cascade(miso1_model, enhance_model, num_mics: int, ref_ch: int = 0,
                 joint: bool = False):
    """Build the end-to-end cascade: mix [B, C, T, F] ->
    dict(miso1 [B, S, T, F], miso1_full [B, S, C, T, F], bf [B, S, T, F],
    enhanced [B, S, T, F]).  The models hold their parameters and run on
    their own device; no autograd.

    joint=False: MISO3 per-speaker enhancement; joint=True: MISO2."""
    decode = make_full_array_decode(miso1_model, num_mics, ref_ch)

    @torch.inference_mode()
    def cascade(mix: torch.Tensor) -> dict[str, torch.Tensor]:
        miso1_full = decode(mix)                             # [B, S, C, T, F]
        miso1_ref = miso1_full[:, :, ref_ch]
        bf = beamform_sources(miso1_full, mix, ref_ch)
        return {
            "miso1": miso1_ref,
            "miso1_full": miso1_full,
            "bf": bf,
            "enhanced": enhance(enhance_model, mix, miso1_ref, bf, joint),
        }

    return cascade
