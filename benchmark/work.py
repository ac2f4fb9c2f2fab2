"""Operations and bytes of the MISO nets, counted from a configuration's
channel plan and the input shape, so the same number holds whichever
kernel computes the function.

FLOPs are 2 x multiply-adds of every conv, as ``torch.utils.flop_counter``
counts them: a conv per output position, a transposed conv per input
position; norms, activations and the STFT are not counted (they are below
a tenth of a percent).  A layer is ``fused`` where the measured program
runs it through its hand kernels on the card (encoder levels 0-4 and
their decoder mirrors, in plans of 7 levels or more): its DenseBlock convs
are the ``dense_stack`` group, its other convs the ``stencil`` group, and
the backward of both the ``stencil_bwd`` group.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Layer:
    name: str
    kind: str        # conv, convT, dw (depthwise conv1d), pw (pointwise)
    cin: int
    cout: int
    f_in: int        # frequency bins in (1 for the TCN)
    f_out: int
    group: str       # dense_stack, stencil or other
    needs_dgrad: bool = True

    def macs(self, t: int) -> int:
        if self.kind == "conv":
            return t * self.f_out * self.cin * self.cout * 9
        if self.kind == "convT":
            return t * self.f_in * self.cin * self.cout * 9
        if self.kind == "dw":
            return t * self.cin * 3
        return t * self.cin * self.cout

    def weights(self) -> int:
        if self.kind in ("conv", "convT"):
            return self.cin * self.cout * 9
        return self.cin * 3 if self.kind == "dw" else self.cin * self.cout


def layers(plan: dict, in_channels: int, num_spks: int, f: int) -> list[Layer]:
    """Every conv of the net, encoder to decoder."""
    nb = plan["num_bottleneck"]
    en = list(plan["en_channels"])
    de = list(plan["de_channels"]) + [2 * num_spks]
    fused_plan = nb >= 7
    out: list[Layer] = []
    c_in = 2 * in_channels
    for i in range(nb):
        stride = 1 if i in (0, nb - 1) else 2
        f_out = (f - 3) // stride + 1
        fused = fused_plan and (i == 0 or (i <= 4 and stride == 2))
        out.append(Layer(f"enc{i}", "conv", c_in, en[i], f, f_out,
                         "stencil" if fused else "other", needs_dgrad=i > 0))
        f = f_out
        if i < 5:
            out += _dense(f"enc{i}_dense", en[i], en[i], en[i], f,
                          "dense_stack" if fused_plan else "other")
        c_in = en[i]
    c = plan["tcn_channels"]
    for r in range(plan["tcn_repeats"]):
        for b in range(plan["tcn_blocks"]):
            for d in (1, 2):
                name = f"tcn.repeat{r}_block{b}.dsconv{d}"
                out.append(Layer(name + ".dw", "dw", c, c, 1, 1, "other"))
                out.append(Layer(name + ".pw", "pw", c, c, 1, 1, "other"))
    c_x = c
    for i in range(nb):
        cin = c_x + en[nb - 1 - i]
        fused = fused_plan and i >= nb - 5
        if i >= 2:
            out += _dense(f"dec{i}_dense", cin, cin // 2, cin, f,
                          "dense_stack" if fused else "other")
        stride = 1 if i in (0, nb - 1) else 2
        f_out = (f - 1) * stride + 3
        out.append(Layer(f"dec{i}", "convT", cin, de[i + 1], f, f_out,
                         "stencil" if fused else "other"))
        f, c_x = f_out, de[i + 1]
    return out


def _dense(name, cin, g1, g2, f, group):
    widths = [g1] * 4 + [g2]
    return [Layer(f"{name}.convs.{k}", "conv", cin + k * g1, widths[k], f, f,
                  group) for k in range(5)]


def forward_flops(net: dict, t: int, groups=None) -> int:
    """FLOPs of one item's forward; ``net`` is {plan, in_channels, num_spks,
    f}; ``groups`` restricts the count to those layer groups."""
    return sum(2 * ly.macs(t) for ly in _layers(net)
               if groups is None or ly.group in groups)


def backward_flops(net: dict, t: int, groups=None) -> int:
    """FLOPs of one item's backward: a weight gradient per conv, and an input
    gradient where the input needs one (not the first conv's)."""
    return sum(2 * ly.macs(t) * (2 if ly.needs_dgrad else 1)
               for ly in _layers(net) if groups is None or ly.group in groups)


def forward_bytes(net: dict, t: int, group: str, elem: int) -> int:
    """Least bytes one item's forward of ``group`` moves: each layer's input
    read once and output written once in ``elem``-byte elements, the
    weights in ``elem`` bytes.  A DenseBlock counts its input and its five
    outputs once (each output is the next layers' input)."""
    total = 0
    for ly in _layers(net):
        if ly.group != group:
            continue
        if ".convs." in ly.name:
            first = ly.name.endswith(".convs.0")
            total += t * ly.f_out * (ly.cout + (ly.cin if first else 0))
        else:
            total += t * (ly.f_in * ly.cin + ly.f_out * ly.cout)
        total += ly.weights()
    return total * elem


def backward_bytes(net: dict, t: int, group: str, elem: int) -> int:
    """Least bytes one item's backward of ``group`` moves: the output
    gradient and the input read, the input gradient written where needed,
    the weight gradient written in float32."""
    total = 0
    for ly in _layers(net):
        if ly.group != group:
            continue
        x = t * ly.f_in * ly.cin
        g = t * ly.f_out * ly.cout
        total += elem * (g + x + (x if ly.needs_dgrad else 0))
        total += 4 * ly.weights()
    return total


def _layers(net: dict) -> list[Layer]:
    return layers(net["plan"], net["in_channels"], net["num_spks"], net["f"])


def nets(cfg: dict) -> dict[str, dict]:
    """{"miso1": ..., "miso3": ...}: each net of a configuration as
    {plan, in_channels, num_spks, f}."""
    ds, st = cfg["dataset"], cfg["stft"]
    f = st["length"] // 2 + 1
    out = {}
    for name in cfg["nets"]:
        spks = ds["num_spks"] if name == "miso1" else 1
        mics = ds["num_ch"] + (0 if name == "miso1" else 2)
        out[name] = {"plan": cfg["model"], "in_channels": mics,
                     "num_spks": spks, "f": f}
    return out


ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def of_passes(cfg: dict, passes: list[dict], group: str,
              backward: bool = False) -> tuple[int, int]:
    """FLOPs and least bytes of layer ``group`` over a stretch's ``passes``
    (each {net, items, backward}: one call of a net on ``items`` chunks,
    with its backward where ``backward``), in the configuration's
    precision: the forwards of every pass, or with ``backward`` the
    backwards of the passes that ran one."""
    per, t, elem = nets(cfg), frames(cfg), ELEM[cfg["precision"]]
    flops = nbytes = 0
    for p in passes:
        if backward and not p["backward"]:
            continue
        net, n = per[p["net"]], p["items"]
        if backward:
            flops += n * backward_flops(net, t, [group])
            nbytes += n * backward_bytes(net, t, group, elem)
        else:
            flops += n * forward_flops(net, t, [group])
            nbytes += n * forward_bytes(net, t, group, elem)
    return flops, nbytes


def frames(cfg: dict) -> int:
    """STFT frames of one chunk."""
    st, ds = cfg["stft"], cfg["dataset"]
    hop = st["length"] - st["overlap"]
    n = int(ds["chunk_time"] * ds["fs"]) + st["length"]
    extra = (-(n - st["length"])) % hop
    return (n + extra - st["length"]) // hop + 1
