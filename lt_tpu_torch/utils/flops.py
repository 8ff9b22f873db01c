"""Analytic FLOP counts for the pipeline models (convention: FLOPs = 2*MACs).

The port's own copy of ``lt_tpu/utils/flops.py``, function for function
(the port imports nothing of ``lt_tpu``).  A fused multiply-add counts as
two FLOPs, and every convolution counts its dense taps: a 'same' conv's
boundary outputs count the taps that fall outside the volume too, as
``lt_tpu``'s count does (``chip_smoke.conv_flops`` counts only the taps
inside the volume, for the kernels' bounds).  ``tests/test_torch_flops.py``
holds each function to ``lt_tpu``'s, exactly.

    python -m lt_tpu_torch.utils.flops    # the flagship's GFLOP/frame
"""

from __future__ import annotations

from lt_tpu_torch.models.backbone import RESNET_SPEC


def _conv2d_macs(h, w, cin, cout, k, stride=1):
    return (h // stride) * (w // stride) * cin * cout * k * k


def pose_resnet_flops(num_layers: int, image_size: int,
                      num_joints: int = 17, with_head: bool = True,
                      with_confidences: bool = False) -> float:
    """FLOPs (= 2*MACs) of one PoseResNet forward on ONE image.

    Counts every conv in the trunk (models/backbone.py mirrors the
    torchvision layout of pose_resnet.py:184-318: stride on the 3x3 conv
    of a bottleneck), the 3-deconv head (256ch, k4 s2 — each output pixel
    receives k^2/s^2 = 4 taps), and the final 1x1 conv.  BN/ReLU
    elementwise ops are excluded (<1% of conv flops).
    """
    kind, counts = RESNET_SPEC[num_layers]
    h = w = image_size // 2          # stem k7 s2
    macs = _conv2d_macs(image_size, image_size, 3, 64, 7, 2)
    h //= 2                          # maxpool s2
    w //= 2

    cin = 64
    for li, n_blocks in enumerate(counts):
        planes = 64 * (2 ** li)
        stride = 1 if li == 0 else 2
        for b in range(n_blocks):
            s = stride if b == 0 else 1
            if kind == "basic":
                cout = planes
                macs += _conv2d_macs(h, w, cin, planes, 3, s)
                macs += _conv2d_macs(h // s, w // s, planes, planes, 3)
                if b == 0 and (s != 1 or cin != cout):
                    macs += _conv2d_macs(h, w, cin, cout, 1, s)
            else:
                cout = planes * 4
                macs += _conv2d_macs(h, w, cin, planes, 1)
                macs += _conv2d_macs(h, w, planes, planes, 3, s)
                macs += _conv2d_macs(h // s, w // s, planes, cout, 1)
                if b == 0 and (s != 1 or cin != cout):
                    macs += _conv2d_macs(h, w, cin, cout, 1, s)
            h //= s
            w //= s
            cin = cout

    trunk_out = cin  # layer4 output channels (2048 bottleneck / 512 basic)
    if with_head:
        # 3x [ConvTranspose2d 256ch k4 s2]: each output pixel sums
        # k^2 / s^2 = 4 taps -> MACs = out_h*out_w*4*cin*cout.
        for _ in range(3):
            h, w = h * 2, w * 2
            macs += h * w * 4 * cin * 256
            cin = 256
        macs += _conv2d_macs(h, w, 256, num_joints, 1)  # final_layer

    if with_confidences:
        # GlobalAveragePoolingHead (pose_resnet.py:140-174): two 1x1
        # convs at the layer4 resolution + a 3-layer MLP (negligible).
        hw = image_size // 32
        macs += _conv2d_macs(hw, hw, trunk_out, 512, 1)
        macs += _conv2d_macs(hw // 2, hw // 2, 512, 256, 1)
        macs += 256 * 512 + 512 * 256 + 256 * 32

    return 2.0 * macs


def _conv3d_macs(s, cin, cout, k, stride=1):
    return (s // stride) ** 3 * cin * cout * k ** 3


def _res3d_macs(s, cin, cout):
    """Res3DBlock (v2v.py:20-42): two k3 convs + 1x1 projection skip when
    widening."""
    m = _conv3d_macs(s, cin, cout, 3) + _conv3d_macs(s, cout, cout, 3)
    if cin != cout:
        m += _conv3d_macs(s, cin, cout, 1)
    return m


def v2v_flops(volume_size: int, output_channels: int = 17,
              input_channels: int = 32) -> float:
    """FLOPs (= 2*MACs) of one V2VModel forward on ONE volume
    (models/v2v.py, mirroring v2v.py:69-180)."""
    s = volume_size
    macs = _conv3d_macs(s, input_channels, 16, 7)        # front_basic k7
    macs += _res3d_macs(s, 16, 32)                       # front_res1
    macs += 2 * _res3d_macs(s, 32, 32)                   # front_res2/3
    macs += _res3d_macs(s, 32, 32)                       # skip_res1

    # Encoder: (res widen, skip) pairs at s/2, s/4, s/8, s/16.
    chans = [(32, 64), (64, 128), (128, 128), (128, 128)]
    for i, (cin, cout) in enumerate(chans):
        sz = s // (2 ** (i + 1))
        macs += _res3d_macs(sz, cin, cout)               # encoder_res{i+1}
        macs += _res3d_macs(sz, cout, cout)              # skip_res{i+2}
    deep = s // 32
    macs += 2 * _res3d_macs(deep, 128, 128)              # encoder_res5, mid

    # Decoder: res + [convT k2 s2: each output voxel receives exactly one
    # tap -> MACs = out_voxels * cin * cout].
    macs += _res3d_macs(deep, 128, 128)                  # decoder_res5
    for i, (cup, cres) in enumerate(
            [(128, 128), (128, 128), (128, 128), (64, 64)]):
        sz_out = s // (2 ** (4 - i))      # s/16, s/8, s/4, s/2
        cin = 128
        macs += sz_out ** 3 * cin * cup                  # upsample
        macs += _res3d_macs(sz_out, cup, cres)           # decoder_res
    macs += s ** 3 * 64 * 32                             # decoder_upsample1

    macs += _res3d_macs(s, 32, 32)                       # back_res
    macs += 2 * _conv3d_macs(s, 32, 32, 1)               # back_basic1/2
    macs += _conv3d_macs(s, 32, output_channels, 1)      # output_layer
    return 2.0 * macs


def unproject_flops(volume_size: int, n_views: int,
                    channels: int = 32) -> float:
    """Nominal FLOPs of the projective unprojection + softmax aggregation:
    per (voxel, view): a 3x4 projection (~24), bilinear weights (~10), a
    4-tap x C bilinear gather (2*4*C), and the cross-view softmax-weighted
    sum (~6*V per channel amortized ~ small).  Bandwidth-bound in practice;
    this is the arithmetic floor."""
    per_voxel_view = 24 + 10 + 2 * 4 * channels
    return volume_size ** 3 * n_views * (per_voxel_view + 4 * channels)


def vol_pipeline_flops(num_layers: int = 152, image_size: int = 384,
                       volume_size: int = 64, n_views: int = 4,
                       num_joints: int = 17) -> dict:
    """Per-FRAME (all views) analytic FLOPs of the volumetric pipeline."""
    backbone = n_views * pose_resnet_flops(num_layers, image_size,
                                           num_joints)
    hm = image_size // 4
    process = n_views * 2.0 * _conv2d_macs(hm, hm, 256, 32, 1)
    unproj = unproject_flops(volume_size, n_views)
    v2v = v2v_flops(volume_size, num_joints)
    softargmax = 8.0 * volume_size ** 3 * num_joints  # softmax+expectation
    total = backbone + process + unproj + v2v + softargmax
    return {"backbone": backbone, "process_features": process,
            "unproject": unproj, "v2v": v2v, "softargmax": softargmax,
            "total": total}


if __name__ == "__main__":
    f = vol_pipeline_flops()
    for k, v in f.items():
        print(f"{k:>18}: {v / 1e9:8.1f} GFLOP/frame")
