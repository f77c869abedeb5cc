"""Plain PyTorch Retina U-Net (nnDetection, Baumgartner et al., MICCAI 2021,
arXiv:2106.00817; ``nndet/ptmodule/retinaunet/base.py``), written as one
function of a parameter dictionary.

It follows the published architecture and the layout of the benchmark's
configuration files: an encoder of two conv-instance-norm-ReLU layers per
stage (the first strided from stage 1 on), a U-FPN decoder (1x1 laterals,
transposed-conv up-sampling by the stage's stride), classifier and
regressor towers of conv-group-norm-ReLU shared over the decoder levels,
and a 1x1 segmentation head on the highest-resolution decoder map. Convs
pad as XLA's ``SAME`` (the odd pad on the high side). The instance norm
takes its mean and biased variance over every ``plane_stride``-th depth
plane from ``plane_stride // 2`` when the configuration states such a
stride and the map has at least two strides of planes (the statistics
estimator nnDetection's TPU trainer uses), over the whole map otherwise.

Everything runs in float32 with TF32 off (:func:`strict_float32`). With
``quant="fp8"`` every conv's input, weight and output is rounded to float8
e4m3 with one scale per tensor, as the program stores every activation in
bfloat16: the control of the check, one precision step below the bfloat16
the configurations state. ``quant="bf16"`` rounds them to bfloat16
instead, a witness of what that precision alone does to a number.

:func:`param_specs` lists every parameter with its shape and how it is
initialised; the harness makes the weights from it, so the program and this
reference get the same tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3


def strict_float32() -> None:
    """Plain float32 products: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------- geometry
def encoder_channels(cfg: dict) -> List[int]:
    n = len(cfg["conv_kernels"])
    return [min(cfg["start_channels"] * 2 ** i, cfg["max_channels"]) for i in range(n)]


def stage_strides(cfg: dict) -> List[Tuple[int, ...]]:
    """Stride of each stage's first conv (stage 0: 1)."""
    dim = cfg["dim"]
    return [(1,) * dim] + [tuple(s) for s in cfg["strides"]]


def cumulative_strides(cfg: dict) -> List[Tuple[int, ...]]:
    out = [(1,) * cfg["dim"]]
    for s in cfg["strides"]:
        out.append(tuple(a * b for a, b in zip(out[-1], s)))
    return out


def decoder_channels(cfg: dict) -> List[int]:
    """U-FPN output channels: ``fpn_channels`` from the lowest decoder level
    on, halving (at least 8) below it."""
    n = len(cfg["conv_kernels"])
    out = [cfg["fpn_channels"]] * n
    for level in reversed(range(min(cfg["decoder_levels"]))):
        out[level] = max(8, out[level + 1] // 2)
    return out


def anchors_per_position(cfg: dict) -> int:
    n = len(cfg["anchor_width"][0]) * len(cfg["anchor_height"][0])
    return n * len(cfg["anchor_depth"][0]) if cfg["dim"] == 3 else n


def classifier_out_classes(cfg: dict) -> int:
    return cfg["classifier_classes"] + (1 if cfg["cls_loss_type"] == "ce" else 0)


# -------------------------------------------------------------- parameters
def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """``(name, shape, init, value)`` of every parameter, in a fixed order.
    ``init`` is ``he``/``lecun`` (truncated normal of variance 2 or 1 over
    the fan-in, ``value`` the fan-in), ``normal`` (std ``value``) or
    ``const`` (filled with ``value``)."""
    dim = cfg["dim"]
    k = lambda ks: tuple(ks) if not isinstance(ks, int) else (ks,) * dim  # noqa: E731
    specs = []

    def conv(name, cin, cout, kernel, bias, init="he", std=0.0, bias_value=0.0):
        kernel = k(kernel)
        fan_in = cin * math.prod(kernel)
        specs.append((f"{name}.weight", (cout, cin, *kernel), init,
                      std if init == "normal" else float(fan_in)))
        if bias:
            specs.append((f"{name}.bias", (cout,), "const", bias_value))

    def norm(name, c):
        specs.append((f"{name}.weight", (c,), "const", 1.0))
        specs.append((f"{name}.bias", (c,), "const", 0.0))

    enc = encoder_channels(cfg)
    prev = cfg["in_channels"]
    for s, c in enumerate(enc):
        for i in range(2):
            base = f"encoder.stage{s}.ConvNormAct_{i}"
            conv(f"{base}.Conv_0", prev if i == 0 else c, c, cfg["conv_kernels"][s], bias=False)
            norm(f"{base}.InstanceNorm_0", c)
        prev = c
    dec = decoder_channels(cfg)
    strides = stage_strides(cfg)
    for level, cin in enumerate(enc):
        conv(f"decoder.lateral_P{level}_0.Conv_0", cin, dec[level], 1, bias=True)
        if level > 0:
            ratio = strides[level]
            name = f"decoder.up_P{level}.ConvTranspose_0"
            cin_up = dec[level]
            specs.append((f"{name}.weight", (cin_up, dec[level - 1], *ratio), "he",
                          float(cin_up * math.prod(ratio))))
            specs.append((f"{name}.bias", (dec[level - 1],), "const", 0.0))
    head_in, hc = dec[cfg["decoder_levels"][0]], cfg["head_channels"]
    a = anchors_per_position(cfg)
    prior = cfg["prior_prob"]
    for head in ("classifier", "regressor"):
        if head == "regressor" and cfg["learn_scale"]:
            specs.append(("regressor.scales", (len(cfg["decoder_levels"]),), "const", 1.0))
        for i in range(1 + cfg["head_num_convs"]):
            conv(f"{head}.tower.conv{i}.Conv_0", head_in if i == 0 else hc, hc, 3, bias=False)
            norm(f"{head}.tower.conv{i}.GroupNorm_0.GroupNorm_0", hc)
        if head == "classifier":
            bias = 0.0 if prior is None else -math.log((1 - prior) / prior)
            conv("classifier.out", hc, a * classifier_out_classes(cfg), 3, bias=True,
                 init="normal", std=0.01, bias_value=bias)
        else:
            conv("regressor.out", hc, a * 2 * dim, 3, bias=True, init="normal", std=0.01)
    seg_out = (1 if cfg["segmenter_fg_bg"] else cfg["seg_classes"]) + 1
    conv("segmenter.out", dec[0], seg_out, 1, bias=True, init="lecun")
    return specs


# --------------------------------------------------------------- the layers
def quantize(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` rounded to ``fp8`` (float8 e4m3 under one per-tensor scale, its
    largest magnitude mapped to 448) or to ``bf16``, returned in x's type;
    the gradient passes straight through the rounding."""
    if kind == "fp8":
        scale = FP8_MAX / x.detach().abs().amax().float().clamp(min=1e-12)
        q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    else:
        q = x.detach().to(torch.bfloat16).float()
    return x + (q.to(x.dtype) - x.detach())


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Net:
    """The forward of one configuration over a parameter dictionary."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor], quant: Optional[str] = None):
        self.cfg, self.p, self.quant = cfg, params, quant
        self.dim = cfg["dim"]
        self.plane_stride = cfg.get("in_plane_stride")
        self.norm_shapes: List[Tuple[int, ...]] = []  # maps seen by the instance norm

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        return quantize(t, self.quant) if self.quant else t

    def conv(self, x, name, stride=None, bias=True):
        w = self.p[f"{name}.weight"]
        ks = w.shape[2:]
        stride = tuple(stride) if stride is not None else (1,) * self.dim
        pads = [same_pads(n, kk, s) for n, kk, s in zip(x.shape[2:], ks, stride)]
        x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
        b = self.p.get(f"{name}.bias") if bias else None
        fn = F.conv3d if self.dim == 3 else F.conv2d
        return self._q(fn(self._q(x), self._q(w), b, stride))

    def conv_transpose(self, x, name, stride):
        fn = F.conv_transpose3d if self.dim == 3 else F.conv_transpose2d
        return self._q(fn(self._q(x), self._q(self.p[f"{name}.weight"]), self.p[f"{name}.bias"],
                          tuple(stride)))

    def instance_norm(self, x, name, eps=1e-5):
        self.norm_shapes.append(tuple(x.shape))
        depth = x.shape[2]
        step = self.plane_stride
        sel = x if not step or depth < 2 * step else x[:, :, step // 2::step]
        axes = tuple(range(2, x.dim()))
        mean = sel.mean(dim=axes, keepdim=True)
        var = (sel - mean).square().mean(dim=axes, keepdim=True)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        y = (x - mean) * torch.rsqrt(var + eps)
        return y * self.p[f"{name}.weight"].view(shape) + self.p[f"{name}.bias"].view(shape)

    def group_norm(self, x, name, channels_per_group=16, eps=1e-5):
        groups = max(1, x.shape[1] // channels_per_group)
        return F.group_norm(x, groups, self.p[f"{name}.weight"], self.p[f"{name}.bias"], eps)

    def encoder(self, x) -> List[torch.Tensor]:
        outs = []
        for s, stride in enumerate(stage_strides(self.cfg)):
            for i in range(2):
                base = f"encoder.stage{s}.ConvNormAct_{i}"
                x = self.conv(x, f"{base}.Conv_0", stride if i == 0 else None, bias=False)
                x = torch.relu(self.instance_norm(x, f"{base}.InstanceNorm_0"))
            outs.append(x)
        return outs

    def decoder(self, fmaps) -> List[torch.Tensor]:
        strides = stage_strides(self.cfg)
        outs: List[Optional[torch.Tensor]] = [None] * len(fmaps)
        up = None
        for level in reversed(range(len(fmaps))):
            x = self.conv(fmaps[level], f"decoder.lateral_P{level}_0.Conv_0")
            if up is not None:
                x = x + up
            if level > 0:
                up = self.conv_transpose(x, f"decoder.up_P{level}.ConvTranspose_0",
                                         strides[level])
            outs[level] = x
        return outs

    def tower(self, x, head):
        for i in range(1 + self.cfg["head_num_convs"]):
            x = self.conv(x, f"{head}.tower.conv{i}.Conv_0", bias=False)
            x = torch.relu(self.group_norm(x, f"{head}.tower.conv{i}.GroupNorm_0.GroupNorm_0"))
        return x

    @staticmethod
    def flatten(y: torch.Tensor, k: int) -> torch.Tensor:
        """``[N, A*k, *spatial]`` -> ``[N, prod(spatial)*A, k]``, position-major."""
        return y.movedim(1, -1).reshape(y.shape[0], -1, k)

    def heads(self, decoded: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The decoder maps -> ``box_logits [B, A, K]``, ``box_deltas [B, A,
        2*dim]``, ``seg_logits [B, *patch, S]``."""
        cfg = self.cfg
        maps = [decoded[level] for level in cfg["decoder_levels"]]
        k = classifier_out_classes(cfg)
        logits = torch.cat([self.flatten(self.conv(self.tower(m, "classifier"), "classifier.out"),
                                         k) for m in maps], dim=1)
        deltas = []
        for level, m in enumerate(maps):
            y = self.conv(self.tower(m, "regressor"), "regressor.out")
            if cfg["learn_scale"]:
                y = y * self.p["regressor.scales"][level]
            deltas.append(self.flatten(y, 2 * self.dim))
        seg = self.conv(decoded[0], "segmenter.out").movedim(1, -1)
        return {"box_logits": logits, "box_deltas": torch.cat(deltas, dim=1), "seg_logits": seg}

    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``images [B, *patch, C]`` (channel-last) -> :meth:`heads`."""
        return self.heads(self.decoder(self.encoder(images.float().movedim(-1, 1))))


def forward_flops(cfg: dict, batch: int = 1) -> int:
    """Model FLOPs of one forward at ``batch`` (2 per multiply-add of every
    conv and transposed conv), counted by ``FlopCounterMode`` on ``meta``
    tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    params = {name: torch.empty(shape, device="meta")
              for name, shape, _, _ in param_specs(cfg)}
    images = torch.empty((batch, *cfg["patch_size"], cfg["in_channels"]), device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        Net(cfg, params)(images)
    return int(counter.get_total_flops())


def norm_map_shapes(cfg: dict, batch: int = 1) -> List[Tuple[int, ...]]:
    """``[B, C, *spatial]`` of every instance-norm input of one forward."""
    params = {name: torch.empty(shape, device="meta")
              for name, shape, _, _ in param_specs(cfg)}
    net = Net(cfg, params)
    net(torch.empty((batch, *cfg["patch_size"], cfg["in_channels"]), device="meta"))
    return net.norm_shapes
