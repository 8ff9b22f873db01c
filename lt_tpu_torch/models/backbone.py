"""PoseResNet heatmap backbone.

Port of ``lt_tpu/models/backbone.py``.  In training mode BatchNorm uses
batch statistics with flax's running-statistics update
(``models/batchnorm.py``), and ``remat`` recomputes each residual block's
activations in the backward (``torch.utils.checkpoint``), as ``lt_tpu``'s
``nn.remat`` does.

Parameter names follow the reference PyTorch code (``conv1``, ``bn1``,
``layerN.i.*``, ``deconv_layers.*``, ``final_layer``, the GAP confidence
heads' ``features.*`` / ``head.*``), so a state_dict converts to ``lt_tpu``
variables with ``lt_tpu.utils.torch_import``.  The convolutions are
PyTorch's own (cuDNN on the card): they are XLA convolutions, not Pallas
kernels, in ``lt_tpu``.  Input NCHW.

``compute_dtype=torch.bfloat16`` follows ``lt_tpu``'s bfloat16 compute, in
eval and in training (``torch.utils.checkpoint`` recomputes a remat block
under the forward's autocast state): parameters and BatchNorm statistics
stay float32, every convolution and transposed convolution runs in
bfloat16, the confidence
heads pool and run their MLP in float32, and heatmaps and features come
back as float32.  The forward runs under ``torch.autocast`` rather than on
cast copies of the modules: the float32 master weights stay the only
weights (a later optimizer step or ``load_state_dict`` needs no re-cast),
and autocast casts exactly what flax's ``nn.Conv(dtype=bfloat16)`` casts,
the input and the kernel of each convolution.  BatchNorm is outside
autocast's lists, so ``F.batch_norm`` gets the bfloat16 activation with its
float32 statistics and affine, normalizes in float32 and rounds the result
to bfloat16 once: flax's ``BatchNorm(dtype=x.dtype)`` promotes ``x - mean``
to float32 and casts its result to ``x.dtype`` the same way.
"""

from __future__ import annotations

import torch
from torch import nn

from lt_tpu_torch import compute_context, resolve_device
from lt_tpu_torch.models.batchnorm import BatchNorm, run_block
from lt_tpu_torch.models.init import init_weights

RESNET_SPEC = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample=None, caffe_style: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
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
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, s2, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
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
            nn.Conv2d(in_channels, 512, 3, 1, 1), BatchNorm(512),
            nn.MaxPool2d(2), nn.ReLU(),
            nn.Conv2d(512, 256, 3, 1, 1), BatchNorm(256),
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
        # As lt_tpu: under bfloat16 compute the pooling and the MLP are
        # float32 (float32 and float64 activations pass as they are).
        if x.dtype == torch.bfloat16:
            x = x.float()
        with torch.autocast(x.device.type, enabled=False):
            return torch.sigmoid(self.head(x.mean(dim=(2, 3))))


class PoseResNet(nn.Module):
    """ResNet trunk + 3 deconv layers + 1x1 heatmap head.

    ``forward`` takes NCHW images and returns ``(heatmaps, features,
    alg_confidences, vol_confidences)``; a confidence is None unless its
    head is enabled.
    """

    def __init__(self, num_joints: int, num_layers: int = 152,
                 style: str = "simple", alg_confidences: bool = False,
                 vol_confidences: bool = False, remat: bool = False,
                 device="cuda", seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat
        self.compute_dtype = compute_dtype
        block_kind, layers = RESNET_SPEC[num_layers]
        block = BasicBlock if block_kind == "basic" else Bottleneck
        caffe = style == "caffe"
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
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
                    BatchNorm(planes * block.expansion))
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
                                          bias=False),
                       BatchNorm(256), nn.ReLU()]
            inplanes = 256
        self.deconv_layers = nn.Sequential(*deconv)
        self.final_layer = nn.Conv2d(256, num_joints, 1, 1, 0)
        init_weights(self, seed)
        self.to(resolve_device(device)).eval()

    def forward(self, x):
        if self.compute_dtype == torch.float32:
            return self._forward(x)
        with compute_context(x, self.compute_dtype):
            heatmaps, features, alg_conf, vol_conf = self._forward(x)
        return heatmaps.float(), features.float(), alg_conf, vol_conf

    def _forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = run_block(block, x, self.remat)
        alg_conf = (None if self.alg_confidences is None
                    else self.alg_confidences(x))
        vol_conf = (None if self.vol_confidences is None
                    else self.vol_confidences(x))
        features = self.deconv_layers(x)
        return self.final_layer(features), features, alg_conf, vol_conf
