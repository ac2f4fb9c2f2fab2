"""Operations and bytes of TF-GridNet's forward (``reference/tfgridnet.py``),
counted from a configuration's widths and the input shape, so the same number
holds whichever kernel computes the function.

FLOPs are 2 x multiply-adds of every matmul and conv, as
``torch.utils.flop_counter`` counts them (a conv per output position, a
transposed conv per input position); norms, activations, the softmax, the
LSTM's gate arithmetic and the STFT are not counted.  The groups:

  ``lstm``    each BLSTM's input projection and recurrent matmul, both
              directions, at every step (the first step's h = 0 included)
  ``deconv``  the full- and sub-band modules' ConvTranspose1d
  ``attn``    the 1x1 convs of Q, K, V and the heads' projection, Q K^T and
              the attention times V
  ``conv``    the input conv and the output transposed conv

A backward counts 2 x its forward (a gradient for the inputs and one for the
weights of every matmul).  Least bytes: each matmul's or conv's input read
once and output written once in the configuration's precision, the weights
once in it.
"""

from __future__ import annotations

import math

from benchmark import work

GROUPS = ("lstm", "deconv", "attn", "conv")


def shape(cfg: dict) -> dict:
    """The widths and sizes of one item of ``cfg``: D, I, J, H, L, E, M, S,
    T and F, the padded T and F and the two BLSTMs' sequence lengths."""
    m, ds = cfg["model"], cfg["dataset"]
    f = cfg["stft"]["length"] // 2 + 1
    t = work.frames(cfg)
    i, j = m["emb_ks"], m["emb_hs"]
    tp = math.ceil((t - i) / j) * j + i
    fp = math.ceil((f - i) / j) * j + i
    return {"d": m["emb_dim"], "i": i, "j": j, "h": m["lstm_hidden_units"],
            "l": m["attn_n_head"], "e": math.ceil(m["attn_approx_qk_dim"] / f),
            "m": ds["num_ch"], "s": ds["num_spks"], "t": t, "f": f,
            "tp": tp, "fp": fp, "f_steps": (fp - i) // j + 1,
            "t_steps": (tp - i) // j + 1, "blocks": m["n_layers"]}


def _blstm(n_seq, steps, cin, h):
    """(MACs, elements moved, weight elements) of one BLSTM over n_seq
    sequences of ``steps`` positions."""
    macs = 2 * n_seq * steps * 4 * h * (cin + h)
    return macs, n_seq * steps * (cin + 2 * h), 2 * 4 * h * (cin + h + 2)


def forward_item(cfg: dict) -> dict[str, tuple[int, int]]:
    """{group: (FLOPs, bytes)} of one item's forward."""
    s = shape(cfg)
    d, i, h, t, f = s["d"], s["i"], s["h"], s["t"], s["f"]
    elem = work.ELEM[cfg["precision"]]
    macs = dict.fromkeys(GROUPS, 0)
    moved = dict.fromkeys(GROUPS, 0)
    for n_seq, steps in ((s["tp"], s["f_steps"]), (s["fp"], s["t_steps"])):
        mac, act, wts = _blstm(n_seq, steps, d * i, h)
        macs["lstm"] += mac
        moved["lstm"] += act + wts
        # ConvTranspose1d 2H -> D, kernel I, over ``steps`` inputs a sequence
        macs["deconv"] += n_seq * steps * 2 * h * d * i
        moved["deconv"] += n_seq * (steps * 2 * h + (steps - 1) * s["j"] * d
                                    + i * d) + 2 * h * d * i
    tf = t * f
    dv = d // s["l"]
    macs["attn"] += tf * d * (2 * s["l"] * s["e"] + d + d)   # Q, K, V, proj
    macs["attn"] += s["l"] * t * t * (s["e"] * f + dv * f)   # QK^T, AV
    # x in; Q, K, V out; the scores; the heads' output; the projection's
    moved["attn"] += (tf * (d + 2 * s["l"] * s["e"] + d) + s["l"] * t * t
                      + 2 * tf * d + d * (2 * s["l"] * s["e"] + 2 * d))
    out = {g: (s["blocks"] * 2 * macs[g], s["blocks"] * moved[g] * elem)
           for g in ("lstm", "deconv", "attn")}
    conv_macs = tf * 2 * s["m"] * d * 9 + tf * d * 2 * s["s"] * 9
    conv_moved = tf * (2 * s["m"] + 2 * d + 2 * s["s"]) + 9 * d * (2 * s["m"]
                                                                  + 2 * s["s"])
    out["conv"] = (2 * conv_macs, conv_moved * elem)
    return out


def forward_flops(cfg: dict, groups=None) -> int:
    """FLOPs of one item's forward, of ``groups`` (all where None)."""
    return sum(fl for g, (fl, _) in forward_item(cfg).items()
               if groups is None or g in groups)


def of_passes(cfg: dict, passes: list[dict], group: str,
              backward: bool = False) -> tuple[int, int]:
    """FLOPs and least bytes of ``group`` over a stretch's ``passes`` (each
    {net, items, backward}): the forwards of every pass, or with
    ``backward`` the backwards (2 x the forward) of those that ran one."""
    fl, nb = forward_item(cfg)[group]
    k = 2 if backward else 1
    items = sum(p["items"] for p in passes if p["backward"] or not backward)
    return k * items * fl, k * items * nb
