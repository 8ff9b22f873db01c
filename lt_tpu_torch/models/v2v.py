"""V2V voxel-to-voxel 3D hourglass, eval mode.

Port of ``lt_tpu/models/v2v.py``.

Parameter names follow the reference PyTorch code (``front_layers.0-3``,
``encoder_decoder.*``, ``back_layers.0-2``, ``output_layer``), so a
state_dict converts with ``lt_tpu.utils.torch_import.import_v2v``.

``V2VModel.forward`` takes and returns NDHWC volumes.  With
``use_kernels=True`` (the default) it runs the fused composition that the
JAX TPU path runs (``lt_tpu/models/v2v.py:554-741``), through the port's
kernel wrappers: the k=7 front conv through ``conv3d_mp``; front_res1..3 +
skip_res1 + its pool through ``res3d_chain_fused``; each encoder pair
through ``res3d_chain_fused(emit_pooled=True)``; encoder_res5, mid_res and
decoder_res5 through ``res3d_block_fused``; each decoder pair, and
decoder_upsample1 + skip1 + back_res + the k=1 back tail, through
``upsample_res3d_fused``.  BN is folded into the weights once per weight
version and device, not on every call.  ``use_kernels=False`` runs the
reference's unfused module graph (PyTorch Conv3d / BatchNorm3d) instead.
"""

from __future__ import annotations

import torch
from torch import nn

from lt_tpu_torch import resolve_device
from lt_tpu_torch.models.init import init_weights
from lt_tpu_torch.ops.kernels.conv3d import BN_EPS, fold_bn
from lt_tpu_torch.ops.kernels.conv_mp import conv3d_mp
from lt_tpu_torch.ops.kernels.res3d import (res3d_block_fused,
                                            res3d_chain_fused,
                                            upsample_res3d_fused)
from lt_tpu_torch.ops.kernels.updown import pack_upsample_weights


def _dhwio(w: torch.Tensor) -> torch.Tensor:
    """PyTorch Conv3d weight (O, I, kD, kH, kW) -> DHWIO."""
    return w.permute(2, 3, 4, 1, 0)


def _fold(conv: nn.Conv3d, bn: nn.BatchNorm3d):
    w, b = fold_bn(_dhwio(conv.weight), conv.bias, bn.weight, bn.bias,
                   bn.running_mean, bn.running_var, eps=bn.eps)
    return w.contiguous(), b.contiguous()


def _bn(c: int) -> nn.BatchNorm3d:
    return nn.BatchNorm3d(c, eps=BN_EPS)


class Basic3DBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, kernel_size: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv3d(in_planes, out_planes, kernel_size, 1,
                      (kernel_size - 1) // 2),
            _bn(out_planes), nn.ReLU())

    def forward(self, x):
        return self.block(x)

    def folded(self):
        """(w DHWIO, b) with BN folded in."""
        return _fold(self.block[0], self.block[1])


class Res3DBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.res_branch = nn.Sequential(
            nn.Conv3d(in_planes, out_planes, 3, 1, 1), _bn(out_planes),
            nn.ReLU(),
            nn.Conv3d(out_planes, out_planes, 3, 1, 1), _bn(out_planes))
        self.skip_con = (nn.Sequential() if in_planes == out_planes else
                         nn.Sequential(nn.Conv3d(in_planes, out_planes, 1),
                                       _bn(out_planes)))

    def forward(self, x):
        return torch.relu(self.res_branch(x) + self.skip_con(x))

    def folded(self):
        """(w1, b1, w2, b2), plus ((ws (Cin, C), bs),) for a projection."""
        rb = self.res_branch
        params = _fold(rb[0], rb[1]) + _fold(rb[3], rb[4])
        if len(self.skip_con):
            ws, bs = _fold(self.skip_con[0], self.skip_con[1])
            params += ((ws.reshape(ws.shape[-2:]).contiguous(), bs),)
        return params


class Upsample3DBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.ConvTranspose3d(in_planes, out_planes, 2, 2, 0, 0),
            _bn(out_planes), nn.ReLU())

    def forward(self, x):
        return self.block(x)

    def packed(self):
        """(w8 (Cin, 8*C), b8 (8*C,)) for ``upsample3d_2x``."""
        conv, bn = self.block[0], self.block[1]
        return pack_upsample_weights(
            conv.weight.permute(2, 3, 4, 1, 0), conv.bias, bn.weight,
            bn.bias, bn.running_mean, bn.running_var, eps=bn.eps)


class EncoderDecorder(nn.Module):
    """5-level hourglass (the reference's class name, typo included)."""

    def __init__(self):
        super().__init__()
        widths = {1: (32, 64), 2: (64, 128), 3: (128, 128), 4: (128, 128),
                  5: (128, 128)}
        for i, (cin, cout) in widths.items():
            setattr(self, f"encoder_res{i}", Res3DBlock(cin, cout))
        self.mid_res = Res3DBlock(128, 128)
        for i, (cin, cout) in widths.items():
            setattr(self, f"decoder_res{i}", Res3DBlock(cout, cout))
            setattr(self, f"decoder_upsample{i}", Upsample3DBlock(cout, cin))
            setattr(self, f"skip_res{i}", Res3DBlock(cin, cin))

    def forward(self, x):
        """Reference (unfused) graph, NCDHW."""
        skips = []
        for i in range(1, 6):
            skips.append(getattr(self, f"skip_res{i}")(x))
            x = torch.nn.functional.max_pool3d(x, 2)
            x = getattr(self, f"encoder_res{i}")(x)
        x = self.mid_res(x)
        for i in range(5, 0, -1):
            x = getattr(self, f"decoder_res{i}")(x)
            x = getattr(self, f"decoder_upsample{i}")(x) + skips[i - 1]
        return x


class V2VModel(nn.Module):
    """Front layers -> hourglass -> back layers -> 1x1x1 output conv.

    Input (B, X, Y, Z, C_in), output (B, X, Y, Z, output_channels), NDHWC.
    """

    def __init__(self, input_channels: int = 32, output_channels: int = 17,
                 use_kernels: bool = True, device="cuda", seed: int = 0):
        super().__init__()
        self.use_kernels = use_kernels
        self.front_layers = nn.Sequential(
            Basic3DBlock(input_channels, 16, 7), Res3DBlock(16, 32),
            Res3DBlock(32, 32), Res3DBlock(32, 32))
        self.encoder_decoder = EncoderDecorder()
        self.back_layers = nn.Sequential(
            Res3DBlock(32, 32), Basic3DBlock(32, 32, 1),
            Basic3DBlock(32, 32, 1))
        self.output_layer = nn.Conv3d(32, output_channels, 1)
        self._packed = None
        init_weights(self, seed)
        self.to(resolve_device(device)).eval()

    def _pack_key(self):
        tensors = list(self.parameters()) + list(self.buffers())
        return tuple(t._version for t in tensors) + (tensors[0].device,)

    @torch.no_grad()
    def packed_params(self) -> dict:
        """The folded / packed weights of the fused path, rebuilt only when
        a weight or the device changed since the last call."""
        key = self._pack_key()
        if self._packed is not None and self._packed[0] == key:
            return self._packed[1]
        ed = self.encoder_decoder
        p = {"front": self.front_layers[0].folded(),
             "front_chain": [self.front_layers[i].folded() for i in (1, 2, 3)]
             + [ed.skip_res1.folded()]}
        for name, mod in ed.named_children():
            p[name] = (mod.packed() if isinstance(mod, Upsample3DBlock)
                       else mod.folded())
        p["back_res"] = self.back_layers[0].folded()
        tail = []
        for blk in self.back_layers[1:]:
            w, b = blk.folded()
            tail.append((w.reshape(w.shape[-2:]).contiguous(), b, True))
        wo = _dhwio(self.output_layer.weight)
        tail.append((wo.reshape(wo.shape[-2:]).contiguous(),
                     self.output_layer.bias.contiguous(), False))
        p["tail"] = tail
        self._packed = (key, p)
        return p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("the port runs V2V in eval mode only")
        if not self.use_kernels:
            y = x.permute(0, 4, 1, 2, 3)
            y = self.back_layers(self.encoder_decoder(self.front_layers(y)))
            return self.output_layer(y).permute(0, 2, 3, 4, 1).contiguous()
        with torch.no_grad():
            return self._forward_fused(x.contiguous())

    def _forward_fused(self, x: torch.Tensor) -> torch.Tensor:
        p = self.packed_params()
        x = conv3d_mp(x, *p["front"], relu=True)
        skip1, x = res3d_chain_fused(x, p["front_chain"], emit_pooled=True)
        skips = [skip1]
        for i in range(1, 5):
            skip, x = res3d_chain_fused(
                x, [p[f"encoder_res{i}"], p[f"skip_res{i + 1}"]],
                emit_pooled=True)
            skips.append(skip)
        for name in ("encoder_res5", "mid_res", "decoder_res5"):
            x = res3d_block_fused(x, *p[name][:4])
        for i in range(5, 1, -1):
            x = upsample_res3d_fused(x, *p[f"decoder_upsample{i}"],
                                     skips[i - 1], [p[f"decoder_res{i - 1}"]])
        return upsample_res3d_fused(x, *p["decoder_upsample1"], skips[0],
                                    [p["back_res"]], tail=p["tail"])
