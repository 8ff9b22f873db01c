"""``lt_tpu_torch.utils.weights`` is the inverse of
``lt_tpu.utils.torch_import``: flax tree -> port state_dict -> importer gives
back the flax tree, and port state_dict -> importer -> weights gives back
the state_dict.  No JAX computation is needed: the trees are numpy."""

import numpy as np
import pytest
import torch

from lt_tpu.utils.fixture import load_model_npz
from lt_tpu.utils.torch_import import import_volumetric_model
from lt_tpu_torch.models.triangulation import VolumetricTriangulationNet
from lt_tpu_torch.utils.weights import (load_npz_variables,
                                        volumetric_state_dict)

FIXTURE = "tests/fixtures/vol_rn18_synth.npz"


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _sd_numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def test_fixture_tree_round_trips_through_importer():
    tree = load_model_npz(FIXTURE)
    sd = volumetric_state_dict(tree, num_layers=18)
    back = import_volumetric_model(_sd_numpy(sd), num_layers=18,
                                   num_joints=17)
    ref = dict(_flatten(tree))
    got = dict(_flatten(back))
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))


@pytest.mark.parametrize("num_layers, method", [(18, "softmax"),
                                                (50, "conf")])
def test_port_state_dict_round_trips(num_layers, method):
    """Random port weights (bottleneck trunk and the GAP confidence head
    included) -> lt_tpu variables -> the same state_dict."""
    port = VolumetricTriangulationNet(num_layers=num_layers, volume_size=16,
                                      volume_aggregation_method=method,
                                      device="cpu", seed=7)
    sd = port.state_dict()
    tree = import_volumetric_model(_sd_numpy(sd), num_layers=num_layers,
                                   num_joints=17)
    back = volumetric_state_dict(tree, num_layers)
    assert sd.keys() == back.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_npz_reader_matches_lt_tpu_fixture_loader():
    ours, ref = load_npz_variables(FIXTURE), load_model_npz(FIXTURE)
    ref_flat = dict(_flatten(ref))
    got_flat = dict(_flatten(ours))
    assert ref_flat.keys() == got_flat.keys()
    for k, v in ref_flat.items():
        assert got_flat[k].dtype == np.float32
        np.testing.assert_array_equal(got_flat[k], v)


def test_backbone_fixture_round_trips_through_importer():
    """The backbone-only fixture (engine.train's model.backbone.checkpoint)
    -> backbone.* state_dict entries -> lt_tpu's importer gives back the
    fixture's tree."""
    from lt_tpu.utils.fixture import load_backbone_npz
    from lt_tpu.utils.torch_import import import_pose_resnet
    from lt_tpu_torch.utils.weights import backbone_state_dict

    path = "tests/fixtures/backbone_rn18_synth.npz"
    sd = backbone_state_dict(load_npz_variables(path), num_layers=18)
    assert all(k.startswith("backbone.") for k in sd)
    back = import_pose_resnet(_sd_numpy(sd), num_layers=18, num_joints=17,
                              prefix="backbone.")
    ref = dict(_flatten(load_backbone_npz(path)))
    got = dict(_flatten(back))
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))
