"""ResNet-4 / 8 / 18 (paper Appendix A), port of ``repro.models.resnet``.

Parameters are the reference's tree: unstacked (one subtree per conv layer,
so FedPart's Appendix-A groups apply literally), HWIO conv weights, an
``(in, out)`` head.  The public functions take NHWC images, as the reference
does; inside, activations run NCHW (the NHWC input permuted, weights
permuted to OIHW per call) because that is what ``F.conv2d`` takes.

Three details that differ from torch's defaults and are kept here:

* ``padding="SAME"`` with stride 2 on an even input pads (0, 1), not
  torch's (1, 1) (``_conv``; the 1 × 1 stride-2 shortcut pads nothing);
* BatchNorm normalises with the *biased* batch variance, and the running
  moments follow ``0.9·old + 0.1·batch`` (not ``nn.BatchNorm2d``'s momentum
  convention, whose running variance is unbiased);
* blocks iterate in sorted order and a block's stride is 2 exactly when it
  has a shortcut conv (``sc_conv``).

BatchNorm running statistics (``mean_ema`` / ``var_ema``) are client-local;
``core.aggregation`` filters them from server averaging.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.tree import PyTree

BN_MOMENTUM = 0.9
BN_EPS = 1e-5

RESNET4 = {"stages": (1, 1), "channels": (8, 16), "name": "resnet4"}   # test-scale
RESNET8 = {"stages": (1, 1, 2), "channels": (16, 32, 64), "name": "resnet8"}
RESNET18 = {"stages": (2, 2, 2, 2), "channels": (64, 128, 256, 512), "name": "resnet18"}


# ---------------------------------------------------------------------------
# Init (He-normal convs, 0.01·N head — the reference's distributions, drawn
# from a torch.Generator: the numbers differ from jax.random's)
# ---------------------------------------------------------------------------

def conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int) -> PyTree:
    fan_in = kh * kw * cin
    w = torch.randn((kh, kw, cin, cout), generator=gen) * math.sqrt(2.0 / fan_in)
    return {"w": w}


def bn_init(c: int) -> PyTree:
    return {
        "scale": torch.ones(c),
        "bias": torch.zeros(c),
        "mean_ema": torch.zeros(c),
        "var_ema": torch.ones(c),
    }


def resnet_init(gen: torch.Generator, spec: dict, num_classes: int,
                in_channels: int = 3) -> PyTree:
    """CPU tensors drawn from ``gen``; the caller moves them to a device."""
    chans = spec["channels"]
    params: PyTree = {
        "stem": {"conv": conv_init(gen, 3, 3, in_channels, chans[0]),
                 "bn": bn_init(chans[0])},
        "blocks": {},
        "head": {
            "w": torch.randn((chans[-1], num_classes), generator=gen) * 0.01,
            "b": torch.zeros(num_classes),
        },
    }
    cin = chans[0]
    bidx = 0
    for stage, (n_blocks, cout) in enumerate(zip(spec["stages"], chans)):
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            blk: PyTree = {
                "conv1": conv_init(gen, 3, 3, cin, cout),
                "bn1": bn_init(cout),
                "conv2": conv_init(gen, 3, 3, cout, cout),
                "bn2": bn_init(cout),
            }
            if stride != 1 or cin != cout:
                blk["sc_conv"] = conv_init(gen, 1, 1, cin, cout)
                blk["sc_bn"] = bn_init(cout)
            params["blocks"][f"{bidx:02d}"] = blk
            cin = cout
            bidx += 1
    return params


# ---------------------------------------------------------------------------
# Primitives (NCHW activations, HWIO weights)
# ---------------------------------------------------------------------------

def _same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA ``padding="SAME"``: total ``(ceil(n/s)-1)·s + k - n``, the odd
    element on the high side."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(p: PyTree, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    w = p["w"]
    top, bottom = _same_pads(x.shape[2], w.shape[0], stride)
    left, right = _same_pads(x.shape[3], w.shape[1], stride)
    w = w.permute(3, 2, 0, 1)                      # HWIO -> OIHW
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def _bn(p: PyTree, x: torch.Tensor, train: bool) -> tuple[torch.Tensor, PyTree | None]:
    """Returns (y, stats_update); the update is detached, train mode only.
    In running-stat mode the moments stay in the graph, as in the
    reference (its DLG attacker observes their gradients too)."""
    if not train:
        c = (1, -1, 1, 1)
        y = (x - p["mean_ema"].view(c)) * torch.rsqrt(p["var_ema"].view(c) + BN_EPS)
        return y * p["scale"].view(c) + p["bias"].view(c), None
    y = F.batch_norm(x, None, None, p["scale"], p["bias"], training=True,
                     eps=BN_EPS)
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        upd = {
            "mean_ema": BN_MOMENTUM * p["mean_ema"] + (1 - BN_MOMENTUM) * mean,
            "var_ema": BN_MOMENTUM * p["var_ema"] + (1 - BN_MOMENTUM) * var,
        }
    return y, upd


def _trunk(params: PyTree, images: torch.Tensor, train: bool
           ) -> tuple[torch.Tensor, PyTree]:
    """NHWC images -> (NCHW final activation, BN stats updates)."""
    stats: PyTree = {"stem": {}, "blocks": {}}
    x = _conv(params["stem"]["conv"], images.permute(0, 3, 1, 2))
    x, upd = _bn(params["stem"]["bn"], x, train)
    if upd:
        stats["stem"]["bn"] = upd
    x = F.relu(x)
    for name in sorted(params["blocks"]):
        blk = params["blocks"][name]
        stride = 2 if "sc_conv" in blk else 1
        h = _conv(blk["conv1"], x, stride)
        h, u1 = _bn(blk["bn1"], h, train)
        h = F.relu(h)
        h = _conv(blk["conv2"], h)
        h, u2 = _bn(blk["bn2"], h, train)
        if "sc_conv" in blk:
            sc = _conv(blk["sc_conv"], x, stride)
            sc, u3 = _bn(blk["sc_bn"], sc, train)
        else:
            sc, u3 = x, None
        x = F.relu(h + sc)
        if train:
            bstats = {"bn1": u1, "bn2": u2}
            if u3 is not None:
                bstats["sc_bn"] = u3
            stats["blocks"][name] = bstats
    return x, stats


# ---------------------------------------------------------------------------
# Public (NHWC images)
# ---------------------------------------------------------------------------

def resnet_apply(params: PyTree, images: torch.Tensor, train: bool = True
                 ) -> tuple[torch.Tensor, PyTree]:
    """images: (B,H,W,C) -> (logits, BN stats updates pruned tree)."""
    x, stats = _trunk(params, images, train)
    x = x.mean(dim=(2, 3))
    logits = x @ params["head"]["w"] + params["head"]["b"]
    return logits, stats


def resnet_features(params: PyTree, images: torch.Tensor) -> torch.Tensor:
    """(B, C) penultimate features with BN in running-stat mode (MOON)."""
    x, _ = _trunk(params, images, train=False)
    return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# FedPart grouping (Appendix A): one group per conv(+BN), FC last.
# ---------------------------------------------------------------------------

def resnet_group_key(path: tuple[str, ...]) -> tuple:
    if path[0] == "stem":
        return ("conv", -1, 0)
    if path[0] == "head":
        return ("head",)
    if path[0] == "blocks":
        blk = int(path[1])
        part = path[2]
        if part in ("conv1", "bn1", "sc_conv", "sc_bn"):
            return ("conv", blk, 1)
        return ("conv", blk, 2)
    return ("misc", path[0])


def resnet_order_key(key: tuple) -> tuple:
    if key[0] == "conv":
        return (0, key[1], key[2])
    if key[0] == "misc":
        return (1, 0, 0)
    return (2, 0, 0)  # head last


def cls_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, labels[:, None].long())[:, 0]
    return (logz - gold).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()
