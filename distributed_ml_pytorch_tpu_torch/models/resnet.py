"""ResNet-18/34/50/101 (counterpart of the JAX ``models/resnet.py``).

He et al. residual networks with GroupNorm in place of BatchNorm, as the JAX
models have them: the whole model stays a function of its parameters, so
every trainer and the DownPour flat vector take it without special cases.

- Public input NHWC, as the other port models; inside, NCHW in
  ``torch.channels_last`` (a permuted NHWC batch is already that memory).
- GroupNorm as flax's: ``group_size = min(32, C)`` (``num_groups = C //
  group_size``), epsilon 1e-6, statistics and affine in float32 and the
  output cast to the activation ``dtype``.
- Convolutions without bias; ``dtype`` is the activation dtype over float32
  parameters (bfloat16 as in JAX): each convolution runs on its cast weight,
  the residual adds and relus in ``dtype``, the global average pool sums in
  float32 and rounds to ``dtype`` (``jnp.mean``), ``classifier`` is a dense
  layer in ``dtype``, and the logits come back in float32.
- Modules are named as the flax ones (``stem_conv``, ``stem_norm``,
  ``stage{i}_block{j}`` holding ``conv1``, ``norm1`` … ``downsample``,
  ``norm_down``, and ``classifier``), so ``utils/serialization.py`` lays out
  the flat vector as ``ravel_pytree`` does and ``utils/interop.py`` carries
  flax trees both ways.

Stems: JAX picks one at call time (``stem="auto"``: the CIFAR 3×3/1 stem for
inputs of at most 64 rows, else the ImageNet 7×7/2 conv and 3×3/2 max pool).
A torch module needs its stem's weight before the first call, so
:func:`get_resnet` takes ``input_size`` (the images' height, default 32)
with ``stem="auto"``, or an explicit ``stem``; an ``"auto"`` model refuses
an input whose size would pick the other stem.

Weights are drawn as ``models/cnn.py`` draws them (seeded He-uniform
kernels, zero biases); GroupNorm scales 1 and biases 0, as flax's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from distributed_ml_pytorch_tpu_torch.models.cnn import _conv, _dense, _dtype, _nchw

GN_EPS = 1e-6  # flax nn.GroupNorm's default (torch's is 1e-5)

#: blocks a stage and the block of each ResNet (JAX ``get_resnet``)
CONFIGS = {
    "resnet18": ((2, 2, 2, 2), "basic"),
    "resnet34": ((3, 4, 6, 3), "basic"),
    "resnet50": ((3, 4, 6, 3), "bottleneck"),
    "resnet101": ((3, 4, 23, 3), "bottleneck"),
}
STEMS = ("auto", "cifar", "imagenet")


def stem_for(size: int) -> str:
    """The stem JAX's ``stem="auto"`` picks for inputs of ``size`` rows."""
    return "cifar" if size <= 64 else "imagenet"


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm(group_size=min(32, C), dtype=...)``."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__(channels // min(32, channels), channels, eps=GN_EPS)
        self.dtype = dtype

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(self.dtype)


def _conv2d(c_in: int, c_out: int, k: int, stride: int = 1) -> nn.Conv2d:
    # 3x3 and 7x7 convs pad by k // 2 (the JAX model's explicit padding); a
    # 1x1 conv pads nothing (flax's "SAME" at k = 1, any stride)
    return nn.Conv2d(c_in, c_out, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    """2×3×3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, c_in: int, features: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv2d(c_in, features, 3, stride)
        self.norm1 = GroupNorm(features, dtype)
        self.conv2 = _conv2d(features, features, 3)
        self.norm2 = GroupNorm(features, dtype)
        if stride != 1 or c_in != features:
            self.downsample = _conv2d(c_in, features, 1, stride)
            self.norm_down = GroupNorm(features, dtype)

    def forward(self, x):
        dt = self.dtype
        y = F.relu(self.norm1(_conv(self.conv1, x, dt)))
        y = self.norm2(_conv(self.conv2, y, dt))
        if hasattr(self, "downsample"):
            x = self.norm_down(_conv(self.downsample, x, dt))
        return F.relu(y + x)


class BottleneckBlock(nn.Module):
    """1×1 → 3×3 → 1×1 bottleneck with 4× expansion (ResNet-50/101)."""

    expansion = 4

    def __init__(self, c_in: int, features: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        out = features * self.expansion
        self.conv1 = _conv2d(c_in, features, 1)
        self.norm1 = GroupNorm(features, dtype)
        self.conv2 = _conv2d(features, features, 3, stride)
        self.norm2 = GroupNorm(features, dtype)
        self.conv3 = _conv2d(features, out, 1)
        self.norm3 = GroupNorm(out, dtype)
        if stride != 1 or c_in != out:
            self.downsample = _conv2d(c_in, out, 1, stride)
            self.norm_down = GroupNorm(out, dtype)

    def forward(self, x):
        dt = self.dtype
        y = F.relu(self.norm1(_conv(self.conv1, x, dt)))
        y = F.relu(self.norm2(_conv(self.conv2, y, dt)))
        y = self.norm3(_conv(self.conv3, y, dt))
        if hasattr(self, "downsample"):
            x = self.norm_down(_conv(self.downsample, x, dt))
        return F.relu(y + x)


class ResNet(nn.Module):
    """Residual network over NHWC inputs; stage ``i`` is ``64·2^i`` wide.

    ``stem`` is ``"cifar"`` or ``"imagenet"``; ``auto_size`` (the input size
    an ``"auto"`` stem was picked for) makes ``forward`` refuse an input
    that would pick the other one."""

    def __init__(self, stage_sizes, block: str = "basic", num_classes: int = 10,
                 stem: str = "cifar", dtype=torch.float32, auto_size: int = 0):
        super().__init__()
        if stem not in ("cifar", "imagenet"):
            raise ValueError(f"stem {stem!r}: cifar or imagenet")
        self.dtype = _dtype(dtype)
        self.stem, self.auto_size = stem, int(auto_size)
        self.stage_sizes = tuple(stage_sizes)
        cls = {"basic": BasicBlock, "bottleneck": BottleneckBlock}[block]
        self.stem_conv = _conv2d(3, 64, 7 if stem == "imagenet" else 3,
                                 2 if stem == "imagenet" else 1)
        self.stem_norm = GroupNorm(64, self.dtype)
        c = 64
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                blk = cls(c, 64 * 2 ** i, 2 if (i > 0 and j == 0) else 1, self.dtype)
                self.add_module(f"stage{i + 1}_block{j + 1}", blk)
                c = 64 * 2 ** i * cls.expansion
        self.classifier = nn.Linear(c, num_classes)

    def blocks(self):
        return [getattr(self, f"stage{i + 1}_block{j + 1}")
                for i, n in enumerate(self.stage_sizes) for j in range(n)]

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """``x``: (N, H, W, 3) NHWC (no dropout: ``generator`` unused).
        Float32 logits."""
        del generator
        if self.auto_size and stem_for(x.shape[1]) != self.stem:
            raise ValueError(
                f"this ResNet was built for {self.auto_size}-row inputs (the {self.stem} "
                f"stem); a {x.shape[1]}-row input picks the {stem_for(x.shape[1])} stem "
                "in JAX — build the model with that input_size")
        dt = self.dtype
        y = F.relu(self.stem_norm(_conv(self.stem_conv, _nchw(x.to(dt)), dt)))
        if self.stem == "imagenet":
            y = F.max_pool2d(y, 3, stride=2, padding=1)
        for blk in self.blocks():
            y = blk(y)
        y = y.mean(dim=(2, 3), dtype=torch.float32).to(dt)  # global average pool
        return _dense(self.classifier, y, dt).float()


def get_resnet(name: str, num_classes: int = 10, dtype=torch.float32, stem: str = "auto",
               input_size: int = 32) -> ResNet:
    """The ResNet ``name`` (``resnet18``, ``resnet34``, ``resnet50`` or
    ``resnet101``) on the host, weights not yet drawn (``models/cnn.
    get_model`` seeds and places it). ``stem="auto"`` picks the stem for
    ``input_size``-row inputs."""
    if name not in CONFIGS:
        raise ValueError(f"unknown resnet {name!r} (have {sorted(CONFIGS)})")
    if stem not in STEMS:
        raise ValueError(f"stem {stem!r}: one of {STEMS}")
    stages, block = CONFIGS[name]
    auto = stem == "auto"
    return ResNet(stages, block, num_classes=num_classes,
                  stem=stem_for(input_size) if auto else stem, dtype=dtype,
                  auto_size=input_size if auto else 0)
