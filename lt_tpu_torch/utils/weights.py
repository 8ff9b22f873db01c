"""``lt_tpu`` (flax) variables -> the port's PyTorch ``state_dict``.

The inverse of ``lt_tpu/utils/torch_import.py``: it un-stacks the scanned
``layerN_rest/block/*`` trunk weights into ``layerN.i.*``, transposes the
flax HWIO / DHWIO kernels back to PyTorch layouts and unwraps the
``BatchNorm_0`` nesting.  It also reads the flat ``params/...`` /
``batch_stats/...`` ``.npz`` fixtures (its own copy of the format of
``lt_tpu/utils/fixture.py``), casting their float16 weights to float32,
and the reference's ``.pth`` state dicts, whose names are the port's
(:func:`load_pth`, :func:`load_strict`, :func:`load_backbone_pth`).

Layouts (flax -> PyTorch):
  Conv2d          (kH, kW, I, O)     -> (O, I, kH, kW)
  ConvTranspose2d (kH, kW, O, I)     -> (I, O, kH, kW)
  Conv3d          (kD, kH, kW, I, O) -> (O, I, kD, kH, kW)
  ConvTranspose3d (kD, kH, kW, O, I) -> (I, O, kD, kH, kW)
  Linear          (I, O)             -> (O, I)
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from lt_tpu_torch.models.backbone import RESNET_SPEC


def load_npz_variables(path: str) -> dict:
    """A flat ``.npz`` of ``params/...`` and ``batch_stats/...`` keys ->
    ``{"params": {...}, "batch_stats": {...}}`` nested float32 dicts."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key].astype(np.float32)
    return {"params": tree.get("params", {}),
            "batch_stats": tree.get("batch_stats", {})}


class _Reader:
    """Writes PyTorch entries from a flax (params, batch_stats) subtree."""

    def __init__(self, params, stats):
        self.params, self.stats = params, stats
        self.sd: Dict[str, torch.Tensor] = {}

    @staticmethod
    def _get(tree, path, index=None):
        for key in path:
            tree = tree[key]
        arr = np.asarray(tree)
        return arr if index is None else arr[index]

    def subtree(self, path):
        node = self.params
        for key in path:
            node = node[key]
        return node

    def _put(self, name, arr):
        self.sd[name] = torch.tensor(arr)   # a copy: never alias the source

    def conv(self, name, path, index=None, bias=False):
        """Conv / transposed conv, 2D or 3D: the last two flax axes swap
        and move to the front (the channel roles follow from the layout)."""
        k = self._get(self.params, path + ("kernel",), index)
        nd = k.ndim
        self._put(f"{name}.weight",
                  k.transpose((nd - 1, nd - 2) + tuple(range(nd - 2))))
        if bias:
            self._put(f"{name}.bias", self._get(self.params, path + ("bias",),
                                                index))

    def bn(self, name, path, index=None):
        inner = path + ("BatchNorm_0",)
        self._put(f"{name}.weight", self._get(self.params, inner + ("scale",),
                                              index))
        self._put(f"{name}.bias", self._get(self.params, inner + ("bias",),
                                            index))
        self._put(f"{name}.running_mean",
                  self._get(self.stats, inner + ("mean",), index))
        self._put(f"{name}.running_var",
                  self._get(self.stats, inner + ("var",), index))
        self.sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    def dense(self, name, path):
        self._put(f"{name}.weight",
                  self._get(self.params, path + ("kernel",)).T)
        self._put(f"{name}.bias", self._get(self.params, path + ("bias",)))


def _gap_head(r: _Reader, name: str, path):
    r.conv(f"{name}.features.0", path + ("conv1",), bias=True)
    r.bn(f"{name}.features.1", path + ("bn1",))
    r.conv(f"{name}.features.4", path + ("conv2",), bias=True)
    r.bn(f"{name}.features.5", path + ("bn2",))
    for i, fc in ((0, "fc1"), (2, "fc2"), (4, "fc3")):
        r.dense(f"{name}.head.{i}", path + (fc,))


def _pose_resnet(r: _Reader, num_layers: int, p: str, fp: tuple):
    block_kind, layers = RESNET_SPEC[num_layers]
    n_convs = 2 if block_kind == "basic" else 3
    r.conv(f"{p}conv1", fp + ("conv1",))
    r.bn(f"{p}bn1", fp + ("bn1",))
    for stage, blocks in enumerate(layers, start=1):
        first = fp + (f"layer{stage}_0",)
        for ci in range(1, n_convs + 1):
            r.conv(f"{p}layer{stage}.0.conv{ci}", first + (f"conv{ci}",))
            r.bn(f"{p}layer{stage}.0.bn{ci}", first + (f"bn{ci}",))
        if "downsample_conv" in r.subtree(first):
            r.conv(f"{p}layer{stage}.0.downsample.0",
                   first + ("downsample_conv",))
            r.bn(f"{p}layer{stage}.0.downsample.1",
                 first + ("downsample_bn",))
        rest = fp + (f"layer{stage}_rest", "block")
        for i in range(1, blocks):
            for ci in range(1, n_convs + 1):
                r.conv(f"{p}layer{stage}.{i}.conv{ci}", rest + (f"conv{ci}",),
                       index=i - 1)
                r.bn(f"{p}layer{stage}.{i}.bn{ci}", rest + (f"bn{ci}",),
                     index=i - 1)
    for i in range(3):
        r.conv(f"{p}deconv_layers.{3 * i}", fp + (f"deconv{i}",))
        r.bn(f"{p}deconv_layers.{3 * i + 1}", fp + (f"deconv_bn{i}",))
    if "final_layer" in r.subtree(fp):
        r.conv(f"{p}final_layer", fp + ("final_layer",), bias=True)
    for head in ("alg_confidences", "vol_confidences"):
        if head in r.subtree(fp):
            _gap_head(r, f"{p}{head}", fp + (head,))


def _res3d(r: _Reader, name: str, path):
    r.conv(f"{name}.res_branch.0", path + ("conv1",), bias=True)
    r.bn(f"{name}.res_branch.1", path + ("bn1",))
    r.conv(f"{name}.res_branch.3", path + ("conv2",), bias=True)
    r.bn(f"{name}.res_branch.4", path + ("bn2",))
    if "skip_conv" in r.subtree(path):
        r.conv(f"{name}.skip_con.0", path + ("skip_conv",), bias=True)
        r.bn(f"{name}.skip_con.1", path + ("skip_bn",))


def _basic3d(r: _Reader, name: str, path):
    r.conv(f"{name}.block.0", path + ("conv",), bias=True)
    r.bn(f"{name}.block.1", path + ("bn",))


def _v2v(r: _Reader, p: str, fp: tuple):
    _basic3d(r, f"{p}front_layers.0", fp + ("front_basic",))
    for i in (1, 2, 3):
        _res3d(r, f"{p}front_layers.{i}", fp + (f"front_res{i}",))
    ed, fed = f"{p}encoder_decoder.", fp + ("encoder_decoder",)
    for i in range(1, 6):
        for kind in ("encoder_res", "skip_res", "decoder_res"):
            _res3d(r, f"{ed}{kind}{i}", fed + (f"{kind}{i}",))
        up = fed + (f"decoder_upsample{i}",)
        r.conv(f"{ed}decoder_upsample{i}.block.0", up, bias=True)
        r.bn(f"{ed}decoder_upsample{i}.block.1", up + ("bn",))
    _res3d(r, f"{ed}mid_res", fed + ("mid_res",))
    _res3d(r, f"{p}back_layers.0", fp + ("back_res",))
    _basic3d(r, f"{p}back_layers.1", fp + ("back_basic1",))
    _basic3d(r, f"{p}back_layers.2", fp + ("back_basic2",))
    r.conv(f"{p}output_layer", fp + ("output_layer",), bias=True)


def volumetric_state_dict(variables: dict, num_layers: int
                          ) -> Dict[str, torch.Tensor]:
    """VolumetricTriangulationNet variables -> the port's state_dict."""
    r = _Reader(variables["params"], variables["batch_stats"])
    _pose_resnet(r, num_layers, "backbone.", ("backbone",))
    r.conv("process_features.0", ("process_features",), bias=True)
    _v2v(r, "volume_net.", ("volume_net",))
    return r.sd


def backbone_state_dict(variables: dict, num_layers: int
                        ) -> Dict[str, torch.Tensor]:
    """Backbone-only PoseResNet variables (a backbone ``.npz`` fixture,
    ``final_layer`` optional) -> ``backbone.*`` entries of the state_dict."""
    r = _Reader(variables["params"], variables["batch_stats"])
    _pose_resnet(r, num_layers, "backbone.", ())
    return r.sd


def algebraic_state_dict(variables: dict, num_layers: int
                         ) -> Dict[str, torch.Tensor]:
    """AlgebraicTriangulationNet variables (the backbone, with its
    ``alg_confidences`` head where the model has one) -> the port's
    state_dict."""
    r = _Reader(variables["params"], variables["batch_stats"])
    _pose_resnet(r, num_layers, "backbone.", ("backbone",))
    return r.sd


def ransac_state_dict(variables: dict, num_layers: int
                      ) -> Dict[str, torch.Tensor]:
    """RANSACTriangulationNet variables (its backbone) -> the port's
    state_dict."""
    return backbone_state_dict(
        {"params": variables["params"]["backbone"],
         "batch_stats": variables["batch_stats"].get("backbone", {})},
        num_layers)


def load_volumetric_npz(model: torch.nn.Module, path: str,
                        num_layers: int) -> None:
    """Load an ``lt_tpu`` whole-model ``.npz`` fixture into ``model``."""
    model.load_state_dict(volumetric_state_dict(load_npz_variables(path),
                                                num_layers))


def load_algebraic_npz(model: torch.nn.Module, path: str,
                       num_layers: int) -> None:
    """Load an ``lt_tpu`` whole-model ``.npz`` of the algebraic model into
    ``model``."""
    model.load_state_dict(algebraic_state_dict(load_npz_variables(path),
                                               num_layers))


def load_ransac_npz(model: torch.nn.Module, path: str,
                    num_layers: int) -> None:
    """Load an ``lt_tpu`` whole-model ``.npz`` of the RANSAC model (its
    backbone) into ``model``."""
    model.load_state_dict(ransac_state_dict(load_npz_variables(path),
                                            num_layers))


def load_backbone_npz(model: torch.nn.Module, path: str,
                      num_layers: int) -> None:
    """Load a backbone-only ``.npz`` (``tests/fixtures/
    backbone_rn18_synth.npz``'s format) into the backbone of an algebraic
    model without confidences or a RANSAC model: every entry must match."""
    model.load_state_dict(backbone_state_dict(load_npz_variables(path),
                                              num_layers))


# -- reference ``.pth`` state dicts ------------------------------------------

#: Entries a state dict may lack: PyTorch's BatchNorm counters (absent from
#: older reference checkpoints, never read in eval) and, for a backbone
#: alone, the confidence heads (absent from a pretrained pose network).
OPTIONAL_SUFFIX = "num_batches_tracked"
HEADS = ("alg_confidences.", "vol_confidences.")


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` state dict on the CPU: a ``state_dict`` entry
    unwrapped, DDP's ``module.`` stripped from every name."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in state:
        state = state["state_dict"]
    return {k.replace("module.", ""): v for k, v in state.items()}


def load_strict(module: torch.nn.Module, src: Dict[str, torch.Tensor],
                what: str, optional=()) -> List[str]:
    """Load ``src`` into ``module``: every entry of its state_dict must be
    in ``src`` with its shape, except BatchNorm counters and names that
    start with one of ``optional`` (those keep their values where absent).
    Raises naming what is missing or misshapen; returns the names of
    ``src`` that the module has no entry for."""
    state = module.state_dict()
    missing = [k for k in state if k not in src
               and not k.endswith(OPTIONAL_SUFFIX)
               and not k.startswith(tuple(optional))]
    bad = [f"{k} {tuple(src[k].shape)} != {tuple(v.shape)}"
           for k, v in state.items() if k in src and src[k].shape != v.shape]
    if missing or bad:
        raise ValueError(f"{what}: {len(missing)} entries missing "
                         f"{missing[:5]}, {len(bad)} of another shape "
                         f"{bad[:5]}")
    state.update({k: src[k].to(state[k].dtype) for k in state if k in src})
    module.load_state_dict(state)
    return sorted(set(src) - set(state))


def final_layer_for_joints(weight: torch.Tensor, bias: torch.Tensor,
                           num_joints: int):
    """A pretrained backbone's final layer for ``num_joints`` joints, as
    ``lt_tpu``'s ``import_pose_resnet`` (and the reference's pose_resnet)
    makes it: where the counts differ, Xavier-uniform filters from
    ``RandomState(0)`` with the first min(n) filters and biases copied."""
    if weight.shape[0] == num_joints:
        return weight, bias
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    fan_out = num_joints * weight.shape[2] * weight.shape[3]
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    new_w = np.random.RandomState(0).uniform(
        -limit, limit, (num_joints,) + tuple(weight.shape[1:]))
    new_w = torch.from_numpy(new_w.astype(np.float32)).to(weight.dtype)
    new_b = torch.zeros(num_joints, dtype=bias.dtype)
    n = min(num_joints, weight.shape[0])
    new_w[:n], new_b[:n] = weight[:n], bias[:n]
    return new_w, new_b


def load_backbone_pth(model: torch.nn.Module, sd: Dict[str, torch.Tensor],
                      num_joints: int) -> List[str]:
    """A pretrained pose network's state dict (names with or without
    ``backbone.``) into ``model.backbone``: every entry but the confidence
    heads must be there (:func:`load_strict`), the final layer adapted to
    ``num_joints`` (:func:`final_layer_for_joints`).  Returns the names
    left over."""
    prefix = ("backbone."
              if any(k.startswith("backbone.") for k in sd) else "")
    src = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if "final_layer.weight" in src:
        src["final_layer.weight"], src["final_layer.bias"] = (
            final_layer_for_joints(src["final_layer.weight"],
                                   src["final_layer.bias"], num_joints))
    return load_strict(model.backbone, src, "backbone weights", HEADS)
