"""DWPose networks (`mmgt_tpu/models/dwpose.py`): the YOLOX-L person
detector and the RTMPose (DW-LL) whole-body 133-keypoint SimCC estimator,
the nets behind the reference's onnxruntime sessions
(src/dwpose/wholebody.py:14-27: yolox_l.onnx + dw-ll_ucoco_384.onnx).

The modules take NCHW inputs, as the ONNX graphs do, and produce the
graphs' tensors:
  YOLOX:   (B, 3, 640, 640) raw-pixel RGB -> (B, 8400, 85) raw grid
           predictions (obj/cls sigmoided)
  RTMPose: (B, 3, 384, 288) normalised crops -> simcc_x (B, 133, 576),
           simcc_y (B, 133, 768)
Pre- and post-processing live in `mmgt_tpu_torch.data.dwpose_infer`.

Parameter names are the mmdet / mmpose state-dict keys (those that
`utils.convert.map_yolox` / `map_rtmpose` give the JAX package's names),
so the ONNX files' initializers load by name
(`utils.convert.load_dwpose_weights`). Every BatchNorm uses eps 1e-5, the
JAX package's (flax's default); mmdet's YOLOX configs use 1e-3 (ROADMAP
§3). ConvModules pad k//2 on both sides, as mmdet/mmpose do.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mmgt_tpu_torch.device import resolve_device

BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """Inference BatchNorm over dim 1 with the torch keys weight, bias,
    running_mean, running_var (no num_batches_tracked)."""

    def __init__(self, c: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class ConvBnAct(nn.Module):
    """mmcv ConvModule: conv (no bias, k//2 padding on both sides) + BN +
    SiLU."""

    def __init__(self, cin: int, out: int, k: int = 3, stride: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, out, k, stride, k // 2, groups=groups, bias=False)
        self.bn = BatchNorm(out)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Focus(nn.Module):
    """Space-to-depth stem (YOLOX): the four phases in the order top-left,
    bottom-left, top-right, bottom-right, then a 3x3 ConvModule."""

    def __init__(self, cin: int, out: int):
        super().__init__()
        self.conv = ConvBnAct(4 * cin, out, 3)

    def forward(self, x):
        tl = x[..., ::2, ::2]
        bl = x[..., 1::2, ::2]
        tr = x[..., ::2, 1::2]
        br = x[..., 1::2, 1::2]
        return self.conv(torch.cat([tl, bl, tr, br], 1))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, out: int, shortcut: bool = True):
        super().__init__()
        self.conv1 = ConvBnAct(cin, out, 1)
        self.conv2 = ConvBnAct(out, out, 3)
        self.add = shortcut and cin == out

    def forward(self, x):
        h = self.conv2(self.conv1(x))
        return x + h if self.add else h


class CSPLayer(nn.Module):
    def __init__(self, cin: int, out: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        mid = out // 2
        self.main_conv = ConvBnAct(cin, mid, 1)
        self.short_conv = ConvBnAct(cin, mid, 1)
        self.blocks = nn.ModuleList(Bottleneck(mid, mid, shortcut) for _ in range(n))
        self.final_conv = ConvBnAct(2 * mid, out, 1)

    def forward(self, x):
        a = self.main_conv(x)
        b = self.short_conv(x)
        for blk in self.blocks:
            a = blk(a)
        return self.final_conv(torch.cat([a, b], 1))


class SPPBottleneck(nn.Module):
    """1x1 to out/2, max pools 5/9/13 at stride 1 (SAME, -inf padding),
    concatenated with their input, 1x1 to out."""

    def __init__(self, cin: int, out: int):
        super().__init__()
        self.conv1 = ConvBnAct(cin, out // 2, 1)
        self.conv2 = ConvBnAct(4 * (out // 2), out, 1)

    def forward(self, x):
        h = self.conv1(x)
        pools = [h] + [F.max_pool2d(h, k, 1, k // 2) for k in (5, 9, 13)]
        return self.conv2(torch.cat(pools, 1))


class CSPDarknet(nn.Module):
    """YOLOX-L backbone (width 1.0, depth 1.0): stem, stage1-4."""

    def __init__(self):
        super().__init__()
        self.stem = Focus(3, 64)
        self.stage1 = nn.Sequential(ConvBnAct(64, 128, 3, 2), CSPLayer(128, 128, 3))
        self.stage2 = nn.Sequential(ConvBnAct(128, 256, 3, 2), CSPLayer(256, 256, 9))
        self.stage3 = nn.Sequential(ConvBnAct(256, 512, 3, 2), CSPLayer(512, 512, 9))
        self.stage4 = nn.Sequential(ConvBnAct(512, 1024, 3, 2), SPPBottleneck(1024, 1024),
                                    CSPLayer(1024, 1024, 3, shortcut=False))

    def forward(self, x):
        x = self.stage1(self.stem(x))
        c3 = self.stage2(x)
        c4 = self.stage3(c3)
        c5 = self.stage4(c4)
        return c3, c4, c5


class _PAFPN(nn.Module):
    def __init__(self):
        super().__init__()
        self.reduce_layers = nn.ModuleList([ConvBnAct(1024, 512, 1), ConvBnAct(512, 256, 1)])
        self.top_down_blocks = nn.ModuleList([CSPLayer(1024, 512, 3, False),
                                              CSPLayer(512, 256, 3, False)])
        self.downsamples = nn.ModuleList([ConvBnAct(256, 256, 3, 2), ConvBnAct(512, 512, 3, 2)])
        self.bottom_up_blocks = nn.ModuleList([CSPLayer(512, 512, 3, False),
                                               CSPLayer(1024, 1024, 3, False)])
        self.out_convs = nn.ModuleList(ConvBnAct(c, 256, 1) for c in (256, 512, 1024))


class _YOLOXHead(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.multi_level_cls_convs = nn.ModuleList(
            nn.Sequential(ConvBnAct(256, 256, 3), ConvBnAct(256, 256, 3)) for _ in range(3))
        self.multi_level_reg_convs = nn.ModuleList(
            nn.Sequential(ConvBnAct(256, 256, 3), ConvBnAct(256, 256, 3)) for _ in range(3))
        self.multi_level_conv_cls = nn.ModuleList(nn.Conv2d(256, num_classes, 1) for _ in range(3))
        self.multi_level_conv_reg = nn.ModuleList(nn.Conv2d(256, 4, 1) for _ in range(3))
        self.multi_level_conv_obj = nn.ModuleList(nn.Conv2d(256, 1, 1) for _ in range(3))


def _upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOXL(nn.Module):
    """Full YOLOX-L: (B, 3, 640, 640) raw-pixel RGB -> (B, 8400, 85)."""

    def __init__(self, num_classes: int = 80):
        super().__init__()
        self.backbone = CSPDarknet()
        self.neck = _PAFPN()
        self.bbox_head = _YOLOXHead(num_classes)

    def forward(self, x):
        c3, c4, c5 = self.backbone(x)
        n, h = self.neck, self.bbox_head
        p5 = n.reduce_layers[0](c5)
        f4 = n.top_down_blocks[0](torch.cat([_upsample2(p5), c4], 1))
        p4 = n.reduce_layers[1](f4)
        f3 = n.top_down_blocks[1](torch.cat([_upsample2(p4), c3], 1))
        f4b = n.bottom_up_blocks[0](torch.cat([n.downsamples[0](f3), p4], 1))
        f5b = n.bottom_up_blocks[1](torch.cat([n.downsamples[1](f4b), p5], 1))
        outs = []
        for i, feat in enumerate((f3, f4b, f5b)):
            s = n.out_convs[i](feat)
            cls = h.multi_level_cls_convs[i](s)
            reg = h.multi_level_reg_convs[i](s)
            out = torch.cat([h.multi_level_conv_reg[i](reg),
                             torch.sigmoid(h.multi_level_conv_obj[i](reg)),
                             torch.sigmoid(h.multi_level_conv_cls[i](cls))], 1)
            outs.append(out.flatten(2).transpose(1, 2))
        return torch.cat(outs, 1)

    @classmethod
    def build(cls, device=None, seed: int = 0) -> "YOLOXL":
        """The published YOLOX-L in f32 on `device` (the card unless the
        caller asks for the CPU), seeded random weights and BN statistics."""
        return init_random_dwpose(cls().to(resolve_device(device)), seed)


# --------------------------------------------------------------- RTMPose
class _DepthwiseSeparable(nn.Module):
    """5x5 depthwise + 1x1 pointwise, each a ConvModule."""

    def __init__(self, cin: int, out: int, k: int = 5):
        super().__init__()
        self.depthwise_conv = ConvBnAct(cin, cin, k, groups=cin)
        self.pointwise_conv = ConvBnAct(cin, out, 1)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


class CSPNeXtBlock(nn.Module):
    """mmpose CSPNeXtBlock: 3x3 conv to out//2, then a depthwise-separable
    5x5 (depthwise + pointwise ConvModules, each with its own BN+SiLU)."""

    def __init__(self, cin: int, out: int, add_identity: bool = True):
        super().__init__()
        hidden = out // 2
        self.conv1 = ConvBnAct(cin, hidden, 3)
        self.conv2 = _DepthwiseSeparable(hidden, out)
        self.add = add_identity and cin == out

    def forward(self, x):
        h = self.conv2(self.conv1(x))
        return x + h if self.add else h


class ChannelAttention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.fc = nn.Conv2d(c, c, 1)

    def forward(self, x):
        return x * F.hardsigmoid(self.fc(x.mean((2, 3), keepdim=True)))


class CSPNeXtLayer(nn.Module):
    def __init__(self, cin: int, out: int, n: int, add_identity: bool = True):
        super().__init__()
        mid = out // 2
        self.main_conv = ConvBnAct(cin, mid, 1)
        self.short_conv = ConvBnAct(cin, mid, 1)
        self.blocks = nn.ModuleList(CSPNeXtBlock(mid, mid, add_identity) for _ in range(n))
        self.attention = ChannelAttention(2 * mid)
        self.final_conv = ConvBnAct(2 * mid, out, 1)

    def forward(self, x):
        a = self.main_conv(x)
        b = self.short_conv(x)
        for blk in self.blocks:
            a = blk(a)
        return self.final_conv(self.attention(torch.cat([a, b], 1)))


class ScaleNorm(nn.Module):
    """x / (||x|| * d**-0.5) * g: RTMCC head norm (mmpose ScaleNorm). The
    norm is written as sqrt(sum(x^2)), which exports to ops the ONNX
    executor runs (torch's vector norm exports as ReduceL2, which neither
    package's executor has)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x):
        norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)) * x.shape[-1] ** -0.5
        return x / norm.clamp_min(self.eps) * self.g


class Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))


def _rope_half(x: torch.Tensor) -> torch.Tensor:
    """Half-split rotary over the token axis (mmpose rtmcc_block.rope);
    x (..., n, 2, d) with the tokens third from the end."""
    n, d = x.shape[-3], x.shape[-1]
    half = d // 2
    freqs = 10000.0 ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] * freqs[None]
    sin = torch.sin(ang)[:, None, :].to(x.dtype)
    cos = torch.cos(ang)[:, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


class GAU(nn.Module):
    """Gated attention unit, self-attention mode (mmpose RTMCCBlock).

    SiLU on the whole uv projection before splitting, q/k from a shared
    base via per-head gamma/beta, relu^2 kernel scaled by sqrt(s), learned
    scalar residual scale. RTMPose configs ship pos_enc=False (no rope).
    """

    def __init__(self, hidden: int = 256, expansion: int = 2, s: int = 128,
                 pos_enc: bool = False):
        super().__init__()
        self.e, self.s, self.pos_enc = hidden * expansion, s, pos_enc
        self.ln = ScaleNorm()
        self.uv = nn.Linear(hidden, 2 * self.e + s, bias=False)
        self.gamma = nn.Parameter(torch.ones(2, s))
        self.beta = nn.Parameter(torch.zeros(2, s))
        self.o = nn.Linear(self.e, hidden, bias=False)
        self.res_scale = Scale()

    def forward(self, x):
        # x: (B, K, hidden)
        uv = F.silu(self.uv(self.ln(x)))
        u, v, base = torch.split(uv, [self.e, self.e, self.s], dim=-1)
        qk = base[..., None, :] * self.gamma + self.beta        # (B, K, 2, s)
        if self.pos_enc:
            qk = _rope_half(qk)
        q, k = qk[..., 0, :], qk[..., 1, :]
        attn = torch.einsum("bnd,bmd->bnm", q, k) / (self.s ** 0.5)
        attn = torch.square(F.relu(attn))
        o = self.o(u * torch.einsum("bnm,bme->bne", attn, v))
        return x * self.res_scale.scale + o


class _CSPNeXt(nn.Module):
    """CSPNeXt-L (arch P5: stages 128/3, 256/6, 512/6, 1024/3; the last
    stage has no block identity and inserts an SPP)."""

    def __init__(self):
        super().__init__()
        self.stem = nn.Sequential(ConvBnAct(3, 32, 3, 2), ConvBnAct(32, 32, 3),
                                  ConvBnAct(32, 64, 3))
        cin = 64
        for i, (ch, n, ident, spp) in enumerate(((128, 3, True, False), (256, 6, True, False),
                                                 (512, 6, True, False), (1024, 3, False, True))):
            layers = [ConvBnAct(cin, ch, 3, 2)]
            if spp:
                layers.append(SPPBottleneck(ch, ch))
            layers.append(CSPNeXtLayer(ch, ch, n, ident))
            setattr(self, f"stage{i + 1}", nn.Sequential(*layers))
            cin = ch

    def forward(self, x):
        x = self.stem(x)
        for i in range(1, 5):
            x = getattr(self, f"stage{i}")(x)
        return x


class _RTMCCHead(nn.Module):
    def __init__(self, num_keypoints: int, tokens: int, gau_hidden: int, wx: int, wy: int):
        super().__init__()
        self.final_layer = nn.Conv2d(1024, num_keypoints, 7, padding=3)
        self.mlp = nn.Sequential(ScaleNorm(), nn.Linear(tokens, gau_hidden, bias=False))
        self.gau = GAU(gau_hidden)
        self.cls_x = nn.Linear(gau_hidden, wx)
        self.cls_y = nn.Linear(gau_hidden, wy)


class RTMPose(nn.Module):
    """DW-LL whole-body: (B, 3, 384, 288) normalised crops ->
    (simcc_x (B, 133, 576), simcc_y (B, 133, 768)).

    CSPNeXt-L backbone + RTMCC/GAU head: a 7x7 conv to K channels, the
    spatial map flattened into K tokens, ScaleNorm + fc, the GAU, the SimCC
    fcs. `input_wh` sizes the token width ((H/32) * (W/32)) and the SimCC
    bins (input x split_ratio)."""

    def __init__(self, num_keypoints: int = 133, input_wh: Tuple[int, int] = (288, 384),
                 split_ratio: float = 2.0, gau_hidden: int = 256):
        super().__init__()
        w, h = input_wh
        for _ in range(5):  # five stride-2 ConvModules, each ceil(n / 2)
            w, h = -(-w // 2), -(-h // 2)
        self.backbone = _CSPNeXt()
        self.head = _RTMCCHead(num_keypoints, w * h, gau_hidden,
                               int(input_wh[0] * split_ratio), int(input_wh[1] * split_ratio))

    def forward(self, x):
        hd = self.head
        h = hd.final_layer(self.backbone(x))
        tokens = hd.mlp(h.flatten(2))
        tokens = hd.gau(tokens)
        return hd.cls_x(tokens), hd.cls_y(tokens)

    @classmethod
    def build(cls, device=None, seed: int = 0, **kwargs) -> "RTMPose":
        """The published RTMPose-L DW-LL in f32 on `device` (the card unless
        the caller asks for the CPU), seeded random weights and BN
        statistics."""
        return init_random_dwpose(cls(**kwargs).to(resolve_device(device)), seed)


@torch.no_grad()
def init_random_dwpose(model: nn.Module, seed: int) -> nn.Module:
    """Seeded weights that keep activations O(1) through the deep nets, in
    place: conv and linear weights N(0, 1 / fan_in), biases 0.1 N; BN
    weight 1 + 0.1 N, bias and running mean 0.1 N, running var U(0.5, 1.5);
    norm gains and the residual scale 1 + 0.1 N (distinct values: an ONNX
    export keeps one initializer of equal ones), GAU gamma N(0, 1), beta 0.
    Eval mode, no gradients."""
    model.eval().requires_grad_(False)
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(t, std=1.0, mean=0.0):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev) * std + mean)

    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            randn(mod.weight, 1.0 / math.sqrt(mod.weight[0].numel()))
            if mod.bias is not None:
                randn(mod.bias, 0.1)
        elif isinstance(mod, BatchNorm):
            randn(mod.weight, 0.1, 1.0)
            randn(mod.bias, 0.1)
            randn(mod.running_mean, 0.1)
            mod.running_var.copy_(torch.rand(mod.running_var.shape, generator=gen,
                                             device=dev) + 0.5)
        elif isinstance(mod, GAU):
            randn(mod.gamma)
            mod.beta.zero_()
        elif isinstance(mod, ScaleNorm):
            randn(mod.g, 0.1, 1.0)
        elif isinstance(mod, Scale):
            randn(mod.scale, 0.1, 1.0)
    return model
