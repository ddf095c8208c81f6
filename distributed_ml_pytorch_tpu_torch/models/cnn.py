"""LeNet and AlexNet for CIFAR-10 (counterpart of the JAX ``models/cnn.py``).

``nn.Module`` models whose public input is NHWC, as the JAX models take it.
Inside, convolutions run in ``torch.channels_last``: an NHWC batch permuted to
NCHW is already channels_last memory, so no copy is made, and a conv output's
``permute(0, 2, 3, 1)`` is a contiguous NHWC view for the fused epilogue
kernel. Flattening is in HWC order, as the JAX models flatten NHWC, so the
dense weights carry over with a transpose only (``utils/interop.py``).

- ``LeNet``: conv(3→6, k5, valid) → pool2 → relu, conv(6→16, k5, valid) →
  channel dropout → pool2 → relu, flatten(400) → fc120 → relu → dropout →
  fc84 → relu → fc10.
- ``AlexNet``: five convs (3→64 k11 s4 p5, 64→192 k5 p2, 192→384 k3 p1,
  384→256 k3 p1, 256→256 k3 p1) with three 2×2 max pools, then one
  ``Linear(256, num_classes)``.

``AlexNet(fused_epilogue=True)`` runs each relu→pool tail through the
``relu_pool2`` kernel (``ops/fused_conv.py``): a bit-identical forward and an
element-identical backward, so the flag changes kernels, never numerics.

Weights are initialised from an explicit ``torch.Generator`` seeded by
``seed``: He-uniform kernels (±sqrt(6/fan_in), torch's ``kaiming_uniform_``
for relu) and zero biases. The JAX models draw lecun-normal kernels; the two
packages' initial weights differ in their bits anyway (different generators),
and the parity tests carry weights across instead (``utils/interop.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from distributed_ml_pytorch_tpu_torch.device import resolve_device
from distributed_ml_pytorch_tpu_torch.ops.fused_conv import max_pool_2x2, relu_pool2


def init_he_uniform_(model: nn.Module, seed: int) -> nn.Module:
    """Seeded He-uniform initialisation of every conv and dense layer, in
    module order, drawn on the host (so every device gets the same bits)."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                bound = math.sqrt(6.0 / mod.weight[0].numel())
                mod.weight.copy_(torch.empty(mod.weight.shape).uniform_(
                    -bound, bound, generator=g))
                mod.bias.zero_()
    return model


def _dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator],
             mask_shape) -> torch.Tensor:
    """Inverted dropout with an explicit generator; ``mask_shape`` broadcasts
    (channel dropout keeps one draw per (n, c))."""
    keep = torch.rand(mask_shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class LeNet(nn.Module):
    """LeNet-5 variant (reference ``example/models.py:5-23``)."""

    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = float(dropout_rate)
        self.conv1 = nn.Conv2d(3, 6, 5)
        self.conv2 = nn.Conv2d(6, 16, 5)
        self.fc1 = nn.Linear(400, 120)
        self.fc2 = nn.Linear(120, 84)
        self.fc3 = nn.Linear(84, num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x``: (N, 32, 32, 3) NHWC float32; ``generator`` draws the dropout
        masks in training mode."""
        drop = self.training and self.dropout_rate > 0
        y = _nhwc(self.conv1(_nchw(x)))
        y = F.relu(max_pool_2x2(y))
        y = _nhwc(self.conv2(_nchw(y)))
        if drop:
            y = _dropout(y, self.dropout_rate, generator, (y.shape[0], 1, 1, y.shape[3]))
        y = F.relu(max_pool_2x2(y))
        y = y.reshape(y.shape[0], -1)  # HWC order: 5*5*16 = 400
        y = F.relu(self.fc1(y))
        if drop:
            y = _dropout(y, self.dropout_rate, generator, y.shape)
        y = F.relu(self.fc2(y))
        return self.fc3(y)


class AlexNet(nn.Module):
    """CIFAR-sized AlexNet (reference ``example/models.py:25-49``)."""

    def __init__(self, num_classes: int = 10, fused_epilogue: bool = False):
        super().__init__()
        self.fused_epilogue = bool(fused_epilogue)
        self.conv1 = nn.Conv2d(3, 64, 11, stride=4, padding=5)
        self.conv2 = nn.Conv2d(64, 192, 5, padding=2)
        self.conv3 = nn.Conv2d(192, 384, 3, padding=1)
        self.conv4 = nn.Conv2d(384, 256, 3, padding=1)
        self.conv5 = nn.Conv2d(256, 256, 3, padding=1)
        self.classifier = nn.Linear(256, num_classes)

    def _pool_tail(self, y: torch.Tensor) -> torch.Tensor:
        """relu → 2x2 pool of a conv output (NCHW shape, channels_last)."""
        v = _nhwc(y)
        m = relu_pool2(v) if self.fused_epilogue else max_pool_2x2(F.relu(v))
        return _nchw(m)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x``: (N, 32, 32, 3) NHWC float32 (no dropout: ``generator`` unused)."""
        del generator
        y = self._pool_tail(self.conv1(_nchw(x)))   # 32→8→4
        y = self._pool_tail(self.conv2(y))          # 4→2
        y = F.relu(self.conv3(y))
        y = F.relu(self.conv4(y))
        y = self._pool_tail(self.conv5(y))          # 2→1
        y = _nhwc(y).reshape(y.shape[0], -1)        # 256
        return self.classifier(y)


def get_model(name: str, num_classes: int = 10, fused_epilogue: bool = False,
              seed: int = 0, device="cuda") -> nn.Module:
    """Model registry keyed by the CLI ``--model`` flag: seeded, moved to
    ``device`` in ``channels_last``. ``fused_epilogue`` selects the
    ``relu_pool2`` kernel where the model has one (AlexNet)."""
    dev = resolve_device(device)
    name = name.lower()
    if name == "lenet":
        model = LeNet(num_classes=num_classes)
    elif name == "alexnet":
        model = AlexNet(num_classes=num_classes, fused_epilogue=fused_epilogue)
    else:
        raise ValueError(f"unknown model {name!r} (alexnet or lenet in this port)")
    init_he_uniform_(model, seed)
    return model.to(device=dev, memory_format=torch.channels_last)
