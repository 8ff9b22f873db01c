"""PoseResNet heatmap backbone, eval mode.

Port of ``lt_tpu/models/backbone.py``.

Parameter names follow the reference PyTorch code (``conv1``, ``bn1``,
``layerN.i.*``, ``deconv_layers.*``, ``final_layer``, the GAP confidence
heads' ``features.*`` / ``head.*``), so a state_dict converts to ``lt_tpu``
variables with ``lt_tpu.utils.torch_import``.  The convolutions are
PyTorch's own (cuDNN on the card): they are XLA convolutions, not Pallas
kernels, in ``lt_tpu``.  Input NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from lt_tpu_torch import resolve_device
from lt_tpu_torch.models.init import init_weights

BN_EPS = 1e-5

RESNET_SPEC = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample=None, caffe_style: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = downsample

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1; ``caffe_style`` strides the first 1x1."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample=None, caffe_style: bool = False):
        super().__init__()
        s1, s2 = (stride, 1) if caffe_style else (1, stride)
        self.conv1 = nn.Conv2d(inplanes, planes, 1, s1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, s2, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class GlobalAveragePoolingHead(nn.Module):
    """Confidence head: conv-BN-pool-relu x2, GAP, MLP, sigmoid."""

    def __init__(self, in_channels: int, n_classes: int):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(in_channels, 512, 3, 1, 1), _bn(512),
            nn.MaxPool2d(2), nn.ReLU(),
            nn.Conv2d(512, 256, 3, 1, 1), _bn(256),
            nn.MaxPool2d(2), nn.ReLU())
        self.head = nn.Sequential(
            nn.Linear(256, 512), nn.ReLU(), nn.Linear(512, 256), nn.ReLU(),
            nn.Linear(256, n_classes))

    def forward(self, x):
        for layer in self.features:
            # As lt_tpu: a 2x2 pool on a 1-pixel map is skipped, not NaN.
            if isinstance(layer, nn.MaxPool2d) and min(x.shape[2:]) < 2:
                continue
            x = layer(x)
        return torch.sigmoid(self.head(x.mean(dim=(2, 3))))


class PoseResNet(nn.Module):
    """ResNet trunk + 3 deconv layers + 1x1 heatmap head (eval mode).

    ``forward`` takes NCHW images and returns ``(heatmaps, features,
    alg_confidences, vol_confidences)``; a confidence is None unless its
    head is enabled.
    """

    def __init__(self, num_joints: int, num_layers: int = 152,
                 style: str = "simple", alg_confidences: bool = False,
                 vol_confidences: bool = False, device="cuda",
                 seed: int = 0):
        super().__init__()
        block_kind, layers = RESNET_SPEC[num_layers]
        block = BasicBlock if block_kind == "basic" else Bottleneck
        caffe = style == "caffe"
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(
                zip((64, 128, 256, 512), layers)):
            stride = 1 if stage == 0 else 2
            downsample = None
            if stride != 1 or inplanes != planes * block.expansion:
                downsample = nn.Sequential(
                    nn.Conv2d(inplanes, planes * block.expansion, 1, stride,
                              bias=False),
                    _bn(planes * block.expansion))
            mods = [block(inplanes, planes, stride, downsample, caffe)]
            inplanes = planes * block.expansion
            mods += [block(inplanes, planes, 1, None, caffe)
                     for _ in range(1, blocks)]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*mods))
        self.alg_confidences = (GlobalAveragePoolingHead(inplanes, num_joints)
                                if alg_confidences else None)
        self.vol_confidences = (GlobalAveragePoolingHead(inplanes, 32)
                                if vol_confidences else None)
        deconv = []
        for _ in range(3):
            deconv += [nn.ConvTranspose2d(inplanes, 256, 4, 2, 1, 0,
                                          bias=False), _bn(256), nn.ReLU()]
            inplanes = 256
        self.deconv_layers = nn.Sequential(*deconv)
        self.final_layer = nn.Conv2d(256, num_joints, 1, 1, 0)
        init_weights(self, seed)
        self.to(resolve_device(device)).eval()

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        alg_conf = (None if self.alg_confidences is None
                    else self.alg_confidences(x))
        vol_conf = (None if self.vol_confidences is None
                    else self.vol_confidences(x))
        features = self.deconv_layers(x)
        return self.final_layer(features), features, alg_conf, vol_conf
