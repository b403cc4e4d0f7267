"""Plain PyTorch reference of ResNet-18 in its CIFAR form (He et al. 2016,
arXiv:1512.03385, section 4.2's 3 × 3 stem without max-pool; basic blocks
[2, 2, 2, 2] at 64 / 128 / 256 / 512 channels), in float32, from its
``config.json``.

As the repository's model defines it: convolutions without bias, HWIO
weights, XLA's ``SAME`` padding (a stride-2 3 × 3 convolution on an even
input pads one row and column after, none before; the stride-2 1 × 1
shortcut pads nothing); BatchNorm in training mode normalises with the
batch's biased variance (its running moments are client-local, never
trained or sent, and read by nothing here); a stage's first block strides
2 and has a 1 × 1 convolution + BatchNorm shortcut; global mean pool and a
linear head with bias.  Inputs are NHWC images.

Layer groups (Appendix A), shallow to deep: the stem conv with its
BatchNorm; per block, conv1 + bn1 (+ the shortcut), then conv2 + bn2; the
head.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.fedref import Leaf
from perfbench.synthetic import make_vision_dataset

BN_EPS = 1e-5


def blocks(cfg: dict) -> list[tuple[str, int, int, int]]:
    """(name, c_in, c_out, stride) of each basic block, in order."""
    out, cin, idx = [], cfg["channels"][0], 0
    for stage, (n, cout) in enumerate(zip(cfg["stages"], cfg["channels"])):
        for b in range(n):
            out.append((f"{idx:02d}", cin, cout, 2 if stage > 0 and b == 0 else 1))
            cin, idx = cout, idx + 1
    return out


def _conv_leaf(path, k, cin, cout, group):
    return Leaf(path, (k, k, cin, cout), group, std=math.sqrt(2.0 / (k * k * cin)))


def _bn_leaves(path, c, group):
    return [Leaf(f"{path}/scale", (c,), group, fill=1.0), Leaf(f"{path}/bias", (c,), group),
            Leaf(f"{path}/mean_ema", (c,), group, local_stat=True),
            Leaf(f"{path}/var_ema", (c,), group, fill=1.0, local_stat=True)]


def leaves(cfg: dict) -> list[Leaf]:
    c0, cin = cfg["channels"][0], cfg["in_channels"]
    out = [_conv_leaf("stem/conv/w", 3, cin, c0, 0), *_bn_leaves("stem/bn", c0, 0)]
    for i, (name, ci, co, stride) in enumerate(blocks(cfg)):
        g1, g2, pre = 1 + 2 * i, 2 + 2 * i, f"blocks/{name}"
        out += [_conv_leaf(f"{pre}/conv1/w", 3, ci, co, g1), *_bn_leaves(f"{pre}/bn1", co, g1),
                _conv_leaf(f"{pre}/conv2/w", 3, co, co, g2), *_bn_leaves(f"{pre}/bn2", co, g2)]
        if stride != 1 or ci != co:
            out += [_conv_leaf(f"{pre}/sc_conv/w", 1, ci, co, g1),
                    *_bn_leaves(f"{pre}/sc_bn", co, g1)]
    head = num_groups(cfg) - 1
    out += [Leaf("head/w", (cfg["channels"][-1], cfg["num_classes"]), head, std=0.01),
            Leaf("head/b", (cfg["num_classes"],), head)]
    return out


def num_groups(cfg: dict) -> int:
    return 2 + 2 * sum(cfg["stages"])


def make_data(cfg: dict, num_samples: int, seed: int):
    return make_vision_dataset(cfg["num_classes"], cfg["image_size"], cfg["in_channels"],
                               cfg["noise"], num_samples, seed)


def _conv(x, w, stride=1):
    k, n = w.shape[0], x.shape[2]
    total = max((-(-n // stride) - 1) * stride + k - n, 0)     # XLA "SAME"
    lo, hi = total // 2, total - total // 2
    return F.conv2d(F.pad(x, (lo, hi, lo, hi)), w.permute(3, 2, 0, 1), stride=stride)


def _bn(x, p, name):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    shape = (1, -1, 1, 1)
    return ((x - mean) / torch.sqrt(var + BN_EPS) * p[f"{name}/scale"].view(shape)
            + p[f"{name}/bias"].view(shape))


def logits(p: dict, cfg: dict, images: torch.Tensor) -> torch.Tensor:
    x = F.relu(_bn(_conv(images.permute(0, 3, 1, 2), p["stem/conv/w"]), p, "stem/bn"))
    for name, ci, co, stride in blocks(cfg):
        pre = f"blocks/{name}"
        h = F.relu(_bn(_conv(x, p[f"{pre}/conv1/w"], stride), p, f"{pre}/bn1"))
        h = _bn(_conv(h, p[f"{pre}/conv2/w"]), p, f"{pre}/bn2")
        if f"{pre}/sc_conv/w" in p:
            x = _bn(_conv(x, p[f"{pre}/sc_conv/w"], stride), p, f"{pre}/sc_bn")
        x = F.relu(h + x)
    return torch.matmul(x.mean(dim=(2, 3)), p["head/w"]) + p["head/b"]


def loss(p: dict, cfg: dict, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the batch."""
    return F.cross_entropy(logits(p, cfg, images), labels)
