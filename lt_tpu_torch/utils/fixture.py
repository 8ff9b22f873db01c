"""The port's ``state_dict`` -> ``lt_tpu`` variables, and ``lt_tpu``'s
compact ``.npz`` format.

The inverse of ``utils/weights.py`` and the port's own copy of what
``lt_tpu/utils/torch_import.py`` does (``import_pose_resnet``,
``import_v2v``, ``import_algebraic_model``, ``import_volumetric_model``;
the port imports nothing of ``lt_tpu``): the PyTorch layouts become flax's
HWIO / DHWIO kernels, BatchNorm nests under ``BatchNorm_0``, and the trunk's
blocks after the first of each stage stack on a leading axis under
``layerN_rest/block`` (flax's ``nn.scan``).  :func:`save_npz` writes the
format of ``lt_tpu/utils/fixture.py``'s ``save_backbone_npz`` /
``save_model_npz``: flat ``params/...`` keys in float16, ``batch_stats/...``
in float32, ``np.savez_compressed``.  ``lt_tpu`` reads such a file as
``model.backbone.checkpoint`` or ``model.checkpoint``, and so does the
port (``weights.load_npz_variables``).

Layouts (PyTorch -> flax):
  Conv2d          (O, I, kH, kW)     -> (kH, kW, I, O)
  ConvTranspose2d (I, O, kH, kW)     -> (kH, kW, O, I)
  Conv3d          (O, I, kD, kH, kW) -> (kD, kH, kW, I, O)
  ConvTranspose3d (I, O, kD, kH, kW) -> (kD, kH, kW, O, I)
  Linear          (O, I)             -> (I, O)
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from lt_tpu_torch.models.backbone import RESNET_SPEC
from lt_tpu_torch.utils.weights import final_layer_for_joints


def as_numpy(sd) -> Dict[str, np.ndarray]:
    """A state_dict (tensors or arrays) -> numpy arrays on the host, in
    their own dtype, BatchNorm counters dropped."""
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v))
            for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def _kernel(w: np.ndarray) -> np.ndarray:
    """Any PyTorch (transposed) conv weight: the two channel axes swap and
    move behind the taps."""
    nd = w.ndim
    return np.ascontiguousarray(w.transpose(tuple(range(2, nd)) + (1, 0)))


def _set(tree: dict, path: Tuple[str, ...], value: np.ndarray):
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


class _Writer:
    """Accumulates params and batch_stats trees from a state_dict."""

    def __init__(self, sd):
        self.sd = sd
        self.params: dict = {}
        self.batch_stats: dict = {}

    def conv(self, name, path, bias: bool = False):
        _set(self.params, path + ("kernel",),
             _kernel(self.sd[f"{name}.weight"]))
        if bias:
            _set(self.params, path + ("bias",), self.sd[f"{name}.bias"])

    def bn(self, name, path):
        inner = path + ("BatchNorm_0",)
        _set(self.params, inner + ("scale",), self.sd[f"{name}.weight"])
        _set(self.params, inner + ("bias",), self.sd[f"{name}.bias"])
        _set(self.batch_stats, inner + ("mean",),
             self.sd[f"{name}.running_mean"])
        _set(self.batch_stats, inner + ("var",),
             self.sd[f"{name}.running_var"])

    def dense(self, name, path):
        _set(self.params, path + ("kernel",),
             np.ascontiguousarray(self.sd[f"{name}.weight"].T))
        _set(self.params, path + ("bias",), self.sd[f"{name}.bias"])

    def variables(self):
        return {"params": self.params, "batch_stats": self.batch_stats}


def _gap_head(w: _Writer, name: str, path: Tuple[str, ...]):
    """GlobalAveragePoolingHead: ``features.*`` / ``head.*``."""
    w.conv(f"{name}.features.0", path + ("conv1",), bias=True)
    w.bn(f"{name}.features.1", path + ("bn1",))
    w.conv(f"{name}.features.4", path + ("conv2",), bias=True)
    w.bn(f"{name}.features.5", path + ("bn2",))
    for i, fc in ((0, "fc1"), (2, "fc2"), (4, "fc3")):
        w.dense(f"{name}.head.{i}", path + (fc,))


def import_pose_resnet(sd, num_layers: int = 152, num_joints: int = 17,
                       prefix: str = "") -> dict:
    """PoseResNet variables from the entries of ``sd`` under ``prefix``
    (``"backbone."`` in a whole model's state_dict).  A final layer for
    another joint count is re-made as ``lt_tpu``'s importer makes it
    (``weights.final_layer_for_joints``)."""
    sd = as_numpy(sd)
    block_kind, layers = RESNET_SPEC[num_layers]
    n_convs = 2 if block_kind == "basic" else 3
    w = _Writer(sd)
    p = prefix
    w.conv(f"{p}conv1", ("conv1",))
    w.bn(f"{p}bn1", ("bn1",))
    for stage, blocks in enumerate(layers, start=1):
        first = f"{p}layer{stage}.0"
        for ci in range(1, n_convs + 1):
            w.conv(f"{first}.conv{ci}", (f"layer{stage}_0", f"conv{ci}"))
            w.bn(f"{first}.bn{ci}", (f"layer{stage}_0", f"bn{ci}"))
        if f"{first}.downsample.0.weight" in sd:
            w.conv(f"{first}.downsample.0",
                   (f"layer{stage}_0", "downsample_conv"))
            w.bn(f"{first}.downsample.1", (f"layer{stage}_0", "downsample_bn"))
        if blocks > 1:
            rest = (f"layer{stage}_rest", "block")
            names = [f"{p}layer{stage}.{i}" for i in range(1, blocks)]
            for ci in range(1, n_convs + 1):
                _set(w.params, rest + (f"conv{ci}", "kernel"), np.stack(
                    [_kernel(sd[f"{n}.conv{ci}.weight"]) for n in names]))
                inner = rest + (f"bn{ci}", "BatchNorm_0")
                for tree, leaf, entry in (
                        (w.params, "scale", "weight"),
                        (w.params, "bias", "bias"),
                        (w.batch_stats, "mean", "running_mean"),
                        (w.batch_stats, "var", "running_var")):
                    _set(tree, inner + (leaf,), np.stack(
                        [sd[f"{n}.bn{ci}.{entry}"] for n in names]))
    for i in range(3):
        w.conv(f"{p}deconv_layers.{3 * i}", (f"deconv{i}",))
        w.bn(f"{p}deconv_layers.{3 * i + 1}", (f"deconv_bn{i}",))
    fw, fb = sd[f"{p}final_layer.weight"], sd[f"{p}final_layer.bias"]
    if fw.shape[0] != num_joints:
        fw, fb = (t.numpy() for t in final_layer_for_joints(
            torch.from_numpy(fw), torch.from_numpy(fb), num_joints))
    _set(w.params, ("final_layer", "kernel"), _kernel(fw))
    _set(w.params, ("final_layer", "bias"), fb)
    for head in ("alg_confidences", "vol_confidences"):
        if f"{p}{head}.features.0.weight" in sd:
            _gap_head(w, f"{p}{head}", (head,))
    return w.variables()


def _res3d(w: _Writer, name: str, path: Tuple[str, ...]):
    w.conv(f"{name}.res_branch.0", path + ("conv1",), bias=True)
    w.bn(f"{name}.res_branch.1", path + ("bn1",))
    w.conv(f"{name}.res_branch.3", path + ("conv2",), bias=True)
    w.bn(f"{name}.res_branch.4", path + ("bn2",))
    if f"{name}.skip_con.0.weight" in w.sd:
        w.conv(f"{name}.skip_con.0", path + ("skip_conv",), bias=True)
        w.bn(f"{name}.skip_con.1", path + ("skip_bn",))


def _basic3d(w: _Writer, name: str, path: Tuple[str, ...]):
    w.conv(f"{name}.block.0", path + ("conv",), bias=True)
    w.bn(f"{name}.block.1", path + ("bn",))


def import_v2v(sd, prefix: str = "") -> dict:
    """V2VModel variables from the entries of ``sd`` under ``prefix``."""
    w = _Writer(as_numpy(sd))
    p = prefix
    _basic3d(w, f"{p}front_layers.0", ("front_basic",))
    for i in (1, 2, 3):
        _res3d(w, f"{p}front_layers.{i}", (f"front_res{i}",))
    ed, fed = f"{p}encoder_decoder.", ("encoder_decoder",)
    for i in range(1, 6):
        for kind in ("encoder_res", "skip_res", "decoder_res"):
            _res3d(w, f"{ed}{kind}{i}", fed + (f"{kind}{i}",))
        up = fed + (f"decoder_upsample{i}",)
        w.conv(f"{ed}decoder_upsample{i}.block.0", up, bias=True)
        w.bn(f"{ed}decoder_upsample{i}.block.1", up + ("bn",))
    _res3d(w, f"{ed}mid_res", fed + ("mid_res",))
    _res3d(w, f"{p}back_layers.0", ("back_res",))
    _basic3d(w, f"{p}back_layers.1", ("back_basic1",))
    _basic3d(w, f"{p}back_layers.2", ("back_basic2",))
    w.conv(f"{p}output_layer", ("output_layer",), bias=True)
    return w.variables()


def import_algebraic_model(sd, num_layers: int = 152,
                           num_joints: int = 17) -> dict:
    """AlgebraicTriangulationNet variables (the backbone) from its
    state_dict."""
    bb = import_pose_resnet(sd, num_layers, num_joints, prefix="backbone.")
    return {"params": {"backbone": bb["params"]},
            "batch_stats": {"backbone": bb["batch_stats"]}}


def import_volumetric_model(sd, num_layers: int = 152,
                            num_joints: int = 17) -> dict:
    """VolumetricTriangulationNet variables from its state_dict."""
    sd = as_numpy(sd)
    bb = import_pose_resnet(sd, num_layers, num_joints, prefix="backbone.")
    v2v = import_v2v(sd, prefix="volume_net.")
    w = _Writer(sd)
    w.conv("process_features.0", ("process_features",), bias=True)
    return {"params": {"backbone": bb["params"], "volume_net": v2v["params"],
                       "process_features": w.params["process_features"]},
            "batch_stats": {"backbone": bb["batch_stats"],
                            "volume_net": v2v["batch_stats"]}}


def _flatten(tree: dict, prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def save_npz(path: str, variables: dict) -> None:
    """``{"params": ..., "batch_stats": ...}`` as one compressed ``.npz``:
    the params in float16 (these files are fine-tuning inits and evaluation
    weights, not parity checkpoints), the batch statistics in float32 (a
    trained V2V's running variances overflow float16)."""
    flat = {k: v.astype(np.float16)
            for k, v in _flatten(variables["params"], "params").items()}
    flat.update({k: v.astype(np.float32) for k, v in
                 _flatten(variables["batch_stats"], "batch_stats").items()})
    np.savez_compressed(path, **flat)
