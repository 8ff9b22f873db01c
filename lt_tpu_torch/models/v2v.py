"""V2V voxel-to-voxel 3D hourglass.

Port of ``lt_tpu/models/v2v.py``.

Parameter names follow the reference PyTorch code (``front_layers.0-3``,
``encoder_decoder.*``, ``back_layers.0-2``, ``output_layer``), so a
state_dict converts with ``lt_tpu.utils.torch_import.import_v2v``.

``V2VModel.forward`` takes and returns NDHWC volumes.  ``use_kernels``
selects the eval path (``lt_tpu`` selects with ``LT_TPU_*`` environment
switches, ``lt_tpu/models/v2v.py:52-96``; the port reads no environment):

- ``"fused"`` (the default; ``True`` means the same): the fused
  composition that the JAX TPU path runs (``lt_tpu/models/v2v.py:554-741``),
  through the port's kernel wrappers: the k=7 front conv through
  ``conv3d_mp``; front_res1..3 + skip_res1 + its pool through
  ``res3d_chain_fused``; each encoder pair through
  ``res3d_chain_fused(emit_pooled=True)``; encoder_res5, mid_res and
  decoder_res5 through ``res3d_block_fused``; each decoder pair, and
  decoder_upsample1 + skip1 + back_res + the k=1 back tail, through
  ``upsample_res3d_fused``.
- ``"conv"``: ``lt_tpu``'s per-conv configuration
  (``LT_TPU_ENABLE_PALLAS_CONV3D`` with the whole-block kernels off,
  ``v2v.py:197-229``, ``:390-401``), in the reference's module order: the
  k=7 front conv through ``conv3d_mp``, every Res3D block as two
  ``conv3d_same`` calls with the projection skip as a folded 1x1x1 conv,
  pools through ``max_pool3d_2x``, upsamples through ``upsample3d_2x``, the
  k=1 back layers and the output layer as 1x1x1 convs (K2).
- ``False``: the reference's unfused module graph (PyTorch Conv3d and the
  shared ``models/batchnorm.BatchNorm``), the plain path.

BN is folded into the weights in float32 once per weight version, device
and compute dtype, not on every call; with ``compute_dtype=torch.bfloat16``
the eval kernel paths cast the folded weights to bfloat16 once there,
biases stay float32, and the volume enters and leaves the kernels as
bfloat16.  In
float32 on the card the folded convolution weights are split once there
into the bfloat16 parts that K2's float32 body takes
(``conv3d.split_bf16``), and the packed tree holds those parts.  The
module graph runs bfloat16 under ``torch.autocast`` (see
``models/backbone.py``).

Training always runs the unfused module graph under autograd, NCDHW, with
batch-statistics BatchNorm: ``lt_tpu`` gates its V2V Pallas kernels off in
training too (``lt_tpu/models/v2v.py:52-93``) and runs XLA convolutions.
``remat`` recomputes each block's activations in the backward
(``torch.utils.checkpoint`` restores the forward's autocast state for the
recompute).  In bfloat16 the graph trains under ``torch.autocast`` on the
float32 master weights: bfloat16 convolutions, BatchNorm with float32
statistics normalizing in the activation's type (``models/batchnorm.py``),
and the output leaves in float32, as ``lt_tpu``'s training output does
(``lt_tpu/models/v2v.py:742-748``).
"""

from __future__ import annotations

import torch
from torch import nn

from lt_tpu_torch import compute_context, resolve_device
from lt_tpu_torch.models.batchnorm import BatchNorm, run_block
from lt_tpu_torch.models.init import init_weights
from lt_tpu_torch.ops.kernels.conv3d import (conv3d_fused, conv3d_same,
                                             fold_bn, pointwise, split_bf16,
                                             split_parts)
from lt_tpu_torch.ops.kernels.conv_mp import conv3d_mp
from lt_tpu_torch.ops.kernels.res3d import (res3d_block_fused,
                                            res3d_chain_fused,
                                            upsample_res3d_fused)
from lt_tpu_torch.ops.kernels.updown import (max_pool3d_2x,
                                             pack_upsample_weights,
                                             upsample3d_2x)

KERNEL_PATHS = ("fused", "conv", False)


def kernel_path(use_kernels):
    """``use_kernels`` as one of :data:`KERNEL_PATHS` (``True`` -> 'fused')."""
    if use_kernels is True:
        return "fused"
    if use_kernels not in KERNEL_PATHS:
        raise ValueError(f"use_kernels must be one of {KERNEL_PATHS}, got "
                         f"{use_kernels!r}")
    return use_kernels


def _dhwio(w: torch.Tensor) -> torch.Tensor:
    """PyTorch Conv3d weight (O, I, kD, kH, kW) -> DHWIO."""
    return w.permute(2, 3, 4, 1, 0)


def _fold(conv: nn.Conv3d, bn: BatchNorm):
    w, b = fold_bn(_dhwio(conv.weight), conv.bias, bn.weight, bn.bias,
                   bn.running_mean, bn.running_var, eps=bn.eps)
    return w.contiguous(), b.contiguous()


class Basic3DBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, kernel_size: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv3d(in_planes, out_planes, kernel_size, 1,
                      (kernel_size - 1) // 2),
            BatchNorm(out_planes), nn.ReLU())

    def forward(self, x):
        return self.block(x)

    def folded(self):
        """(w DHWIO, b) with BN folded in."""
        return _fold(self.block[0], self.block[1])


class Res3DBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.res_branch = nn.Sequential(
            nn.Conv3d(in_planes, out_planes, 3, 1, 1), BatchNorm(out_planes),
            nn.ReLU(),
            nn.Conv3d(out_planes, out_planes, 3, 1, 1), BatchNorm(out_planes))
        self.skip_con = (nn.Sequential() if in_planes == out_planes else
                         nn.Sequential(nn.Conv3d(in_planes, out_planes, 1),
                                       BatchNorm(out_planes)))

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
            BatchNorm(out_planes), nn.ReLU())

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

    def __init__(self, remat: bool = False):
        super().__init__()
        self.remat = remat
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
        def run(name, y):
            return run_block(getattr(self, name), y, self.remat)

        skips = []
        for i in range(1, 6):
            skips.append(run(f"skip_res{i}", x))
            x = torch.nn.functional.max_pool3d(x, 2)
            x = run(f"encoder_res{i}", x)
        x = run("mid_res", x)
        for i in range(5, 0, -1):
            x = run(f"decoder_res{i}", x)
            x = run(f"decoder_upsample{i}", x) + skips[i - 1]
        return x


def _split_conv_weights(tree):
    """A packed float32 tree with every K2 weight (ndim >= 2; not the
    upsample's packed taps) replaced by its bfloat16 parts
    (``conv3d.split_bf16``, ``conv3d.split_parts`` of its k; the (Cin,
    Cout) weights are 1x1x1), which K2's float32 body takes whole."""
    if isinstance(tree, dict):
        return {k: v if k.startswith("decoder_upsample")
                else _split_conv_weights(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_split_conv_weights(v) for v in tree)
    if torch.is_tensor(tree) and tree.dim() >= 2:
        return split_bf16(tree, split_parts(1 if tree.dim() == 2 else
                                            tree.shape[0]))
    return tree


class V2VModel(nn.Module):
    """Front layers -> hourglass -> back layers -> 1x1x1 output conv.

    Input (B, X, Y, Z, C_in), output (B, X, Y, Z, output_channels), NDHWC.
    """

    def __init__(self, input_channels: int = 32, output_channels: int = 17,
                 use_kernels="fused", remat: bool = False,
                 device="cuda", seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_kernels = kernel_path(use_kernels)
        self.remat = remat
        self.compute_dtype = compute_dtype
        self.front_layers = nn.Sequential(
            Basic3DBlock(input_channels, 16, 7), Res3DBlock(16, 32),
            Res3DBlock(32, 32), Res3DBlock(32, 32))
        self.encoder_decoder = EncoderDecorder(remat)
        self.back_layers = nn.Sequential(
            Res3DBlock(32, 32), Basic3DBlock(32, 32, 1),
            Basic3DBlock(32, 32, 1))
        self.output_layer = nn.Conv3d(32, output_channels, 1)
        self._packed = None
        init_weights(self, seed)
        self.to(resolve_device(device)).eval()

    def _pack_key(self):
        tensors = list(self.parameters()) + list(self.buffers())
        return tuple(t._version for t in tensors) + (tensors[0].device,
                                                     self.compute_dtype)

    @torch.no_grad()
    def packed_params(self) -> dict:
        """The folded / packed weights of the kernel paths, rebuilt only
        when a weight, the device or the compute dtype changed since the
        last call.  Folded in float32; the weights are then cast to the
        compute dtype (in float32 on the card: split into their bfloat16
        parts), the biases stay float32."""
        key = self._pack_key()
        if self._packed is not None and self._packed[0] == key:
            return self._packed[1]
        p = self._cast_weights(self._fold_params())
        if self.compute_dtype == torch.float32 and key[-2].type == "cuda":
            p = _split_conv_weights(p)
        self._packed = (key, p)
        return p

    def _cast_weights(self, tree):
        """Cast every weight (ndim >= 2) of a packed tree to the compute
        dtype; biases (ndim 1) and flags stay as they are."""
        if self.compute_dtype == torch.float32:
            return tree
        if isinstance(tree, dict):
            return {k: self._cast_weights(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._cast_weights(v) for v in tree)
        if torch.is_tensor(tree) and tree.dim() >= 2:
            return tree.to(self.compute_dtype)
        return tree

    def _fold_params(self) -> dict:
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
        return p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, X, Y, Z, C_in) -> (B, X, Y, Z, output_channels), in the
        compute dtype in eval and in float32 in training."""
        if self.training or not self.use_kernels:
            with compute_context(x, self.compute_dtype):
                y = self._forward_modules(x)
            if self.training and y.dtype == torch.bfloat16:
                y = y.float()
            return y
        with torch.no_grad():
            if self.compute_dtype == torch.bfloat16:
                x = x.to(torch.bfloat16)
            x = x.contiguous()
            if self.use_kernels == "conv":
                return self._forward_conv(x)
            return self._forward_fused(x)

    def _forward_modules(self, x: torch.Tensor) -> torch.Tensor:
        y = x.permute(0, 4, 1, 2, 3)
        for mod in self.front_layers:
            y = run_block(mod, y, self.remat)
        y = self.encoder_decoder(y)
        for mod in self.back_layers:
            y = run_block(mod, y, self.remat)
        return self.output_layer(y).permute(0, 2, 3, 4, 1).contiguous()

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

    def _forward_conv(self, x: torch.Tensor) -> torch.Tensor:
        """The per-conv configuration: one kernel launch per layer of the
        reference's module graph, from the same folded weights."""
        p = self.packed_params()

        def res(x, prm):
            w1, b1, w2, b2 = prm[:4]
            skip = x
            if len(prm) == 5:
                ws, bs = prm[4]
                skip = conv3d_fused(x, pointwise(ws), bs)
            y = conv3d_same(x, w1, b1, relu=True)
            return conv3d_same(y, w2, b2, relu=True, residual=skip)

        x = conv3d_mp(x, *p["front"], relu=True)
        for prm in p["front_chain"][:3]:
            x = res(x, prm)
        skips = []
        for i in range(1, 6):
            skips.append(res(x, p[f"skip_res{i}"]))
            x = res(max_pool3d_2x(x), p[f"encoder_res{i}"])
        x = res(x, p["mid_res"])
        for i in range(5, 0, -1):
            x = res(x, p[f"decoder_res{i}"])
            x = upsample3d_2x(x, *p[f"decoder_upsample{i}"],
                              skip=skips[i - 1])
        x = res(x, p["back_res"])
        for wt, bt, relu in p["tail"]:
            x = conv3d_fused(x, pointwise(wt), bt, relu=relu)
        return x
