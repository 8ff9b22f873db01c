"""The two-stage volumetric recipe in the port against lt_tpu on the CPU.

- Stage 1 (lt_tpu_torch/engine/pretrain_2d.py) against
  benchmarks/pretrain_backbone_2d.py: the 2D ground truth and its Gaussian
  targets (1e-6), the learning rate at every update against optax's
  schedule (1e-9 relative; 0 at update 0), and two Adam updates of
  ResNet-18 from the same weights at 64^2 against the script's own step:
  in float64 on both sides, the loss, parameters and BatchNorm statistics
  at rtol 1e-4 (lt_tpu's step computed once per run); the port's float32
  update within relative L2 F32_GRAD_L2 of lt_tpu's float64 gradient.
- The writer (lt_tpu_torch/utils/fixture.py) against
  lt_tpu.utils.torch_import, leaf for leaf and bit for bit, and its .npz
  against lt_tpu.utils.fixture's, key for key; the round trip through
  weights.load_npz_variables gives back the float16-rounded weights and
  the float32 statistics.
- The entry point (lt_tpu_torch/two_stage.py) at its smallest size on the CPU:
  2 stage-1 steps and one stage-2 epoch of 8 samples; the backbone loads
  with every tensor and the losses are finite.  --resume and the polish
  are held by the arguments they pass to run.

benchmarks/pretrain_backbone_2d.py is imported with its call of
enable_compilation_cache made a no-op (:func:`_script`), so that JAX's
compilation cache stays as the rest of the run has it.  torch runs on 2
threads.

    JAX_PLATFORMS=cpu python -m tests.test_torch_two_stage MODEL_NPZ

evaluates an exported model.npz on vol_pretrain.yaml's held-out val with
lt_tpu's and the port's run(eval_only=True) and prints both MPJPEs
(within EVAL_MM of each other).
"""

import contextlib
import functools
import io
import json
import math
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lt_tpu.models.backbone import PoseResNet as JPoseResNet
from lt_tpu.utils import fixture as j_fixture
from lt_tpu.utils import torch_import
from lt_tpu_torch import two_stage
from lt_tpu_torch.data.batch import BatchIterator
from lt_tpu_torch.data.synthetic import SyntheticMultiViewDataset
from lt_tpu_torch.engine import checkpoint as ckpt
from lt_tpu_torch.engine import pretrain_2d
from lt_tpu_torch.models.backbone import PoseResNet
from lt_tpu_torch.models.triangulation import (AlgebraicTriangulationNet,
                                               VolumetricTriangulationNet)
from lt_tpu_torch.utils import cfg, fixture, weights
from tests.test_torch_train import SHARED, _lt_tpu_in_float64, _once_per_run

IMG = 64                # the compared stage-1 updates' image size
N_PAR = 20              # their schedule's length: warmup 2, lr 0 then 1e-3
STEP_RTOL = 1e-4        # float64 stage-1 updates vs lt_tpu's
# The port's float32 gradient vs lt_tpu's float64 one, relative L2 over the
# backbone.  Measured 3.9e-3; lt_tpu's own float32 gradient is as far
# (3.9e-3, one tensor 14 % of its largest element): at random weights the
# train-mode BatchNorms amplify float32 rounding, so that per-tensor
# float32 parity is out of reach and the update is held in float64.
F32_GRAD_L2 = 1e-2
EVAL_MM = 0.05          # the two packages' MPJPE of one .npz


@pytest.fixture(scope="module", autouse=True)
def shared_run_dir(tmp_path_factory):
    """tests/test_torch_train.py's shared run directory, so that lt_tpu's
    stage-1 updates are computed once per xdist run."""
    if "PYTEST_XDIST_WORKER" in os.environ:
        SHARED["dir"] = tmp_path_factory.getbasetemp().parent


@functools.lru_cache(maxsize=None)
def _script():
    """benchmarks/pretrain_backbone_2d.py, imported with
    lt_tpu.utils.cache.enable_compilation_cache made a no-op: the script
    turns on JAX's persistent compilation cache at a fixed path when it is
    imported."""
    from lt_tpu.utils import cache

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cache, "enable_compilation_cache", lambda *a, **k: None)
        from benchmarks import pretrain_backbone_2d
    return pretrain_backbone_2d


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batches(n_batches, image_size, batch_size=2):
    ds = SyntheticMultiViewDataset(n_samples=n_batches * batch_size,
                                   image_size=image_size, cache_images=True)
    it = BatchIterator(ds, batch_size, shuffle=True, seed=0, prefetch=0)
    return list(it.epoch(0))


def test_targets_and_positions_match_lt_tpu():
    """gt_2d_heatmap_px and the Gaussian targets of a seeded batch at the
    script's 128^2 within 1e-6 of benchmarks/pretrain_backbone_2d.py's;
    the targets are unnormalised (peak 1 at a joint on a pixel)."""
    jpb = _script()
    (batch,) = _batches(1, pretrain_2d.IMAGE_SIZE)
    uv = pretrain_2d.gt_2d_heatmap_px(batch)
    ref_uv = jpb.gt_2d_heatmap_px(batch)
    assert uv.shape == ref_uv.shape == (2, 4, 17, 2)
    assert np.abs(uv - ref_uv).max() <= 1e-6 * max(1.0, np.abs(ref_uv).max())
    hm = pretrain_2d.IMAGE_SIZE // pretrain_2d.HEATMAP_STRIDE
    uv_t, targets = pretrain_2d.batch_targets(batch, hm, "cpu")
    ref = np.asarray(jpb.make_targets(
        jnp.asarray(ref_uv.reshape(-1, 17, 2), jnp.float32), hm))
    assert tuple(targets.shape) == (8, 17, hm, hm)
    assert np.abs(targets.numpy().transpose(0, 2, 3, 1) - ref).max() <= 1e-6
    on_pixel = torch.tensor([[[3.0, 5.0]]])
    assert float(pretrain_2d.make_targets(on_pixel, 8)[0, 0, 5, 3]) == 1.0
    assert (pretrain_2d.IMAGE_SIZE, pretrain_2d.HEATMAP_STRIDE,
            pretrain_2d.SIGMA, pretrain_2d.POS_WEIGHT) == (
        jpb.IMAGE_SIZE, jpb.HEATMAP_STRIDE, jpb.SIGMA, jpb.POS_WEIGHT)


@pytest.mark.parametrize("n_steps", [600, 20, 2])
def test_learning_rate_matches_optax(n_steps):
    """The learning rate of every update 0..n within 1e-9 relative of the
    script's optax schedule (evaluated in float64); update 0's is 0 where
    the schedule warms up (n >= 10)."""
    with jax.enable_x64(True):
        sched = optax.warmup_cosine_decay_schedule(
            0.0, 2e-3, warmup_steps=min(100, n_steps // 10),
            decay_steps=n_steps, end_value=1e-5)
        ref = [float(sched(i)) for i in range(n_steps + 1)]
    got = [pretrain_2d.learning_rate(i, n_steps) for i in range(n_steps + 1)]
    assert (got[0] == 0.0) == (n_steps >= 10)    # no warmup below 10 steps
    for i, (g, r) in enumerate(zip(got, ref)):
        assert abs(g - r) <= 1e-9 * abs(r), (i, g, r)



def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _stage1_inputs(batch, dtype):
    """A batch's NHWC images, (N, J, 2) positions and NHWC targets for
    lt_tpu, in ``dtype``, built by the script's functions."""
    jpb = _script()
    images = jnp.asarray(batch["images"].reshape(-1, IMG, IMG, 3), dtype)
    uv = jnp.asarray(jpb.gt_2d_heatmap_px(batch).reshape(-1, 17, 2), dtype)
    return images, uv, jpb.make_targets(uv, IMG // jpb.HEATMAP_STRIDE)


def _lt_tpu_stage1():
    """lt_tpu's first two updates, built as
    benchmarks/pretrain_backbone_2d.py builds them (model, init, schedule
    of N_PAR steps, loss, step) at IMG^2, the step in float64: the float32
    initial variables and, after each update, (loss, params, batch_stats,
    Adam's first moments), all numpy; computed once per run
    (:func:`_once_per_run`)."""
    return _once_per_run("lt_tpu_stage1_updates", _lt_tpu_stage1_values)


@functools.lru_cache(maxsize=None)
def _lt_tpu_stage1_values():
    jpb = _script()
    batches = _batches(2, IMG)
    images0, _, _ = _stage1_inputs(batches[0], jnp.float32)
    variables = jax.jit(JPoseResNet(num_joints=17, num_layers=18).init,
                        static_argnums=2)(jax.random.PRNGKey(0), images0,
                                          True)
    after = []
    with _lt_tpu_in_float64():
        model = JPoseResNet(num_joints=17, num_layers=18,
                            compute_dtype=jnp.float64)
        var = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)
        params, bstats = var["params"], var["batch_stats"]
        sched = optax.warmup_cosine_decay_schedule(
            0.0, 2e-3, warmup_steps=min(100, N_PAR // 10),
            decay_steps=N_PAR, end_value=1e-5)
        tx = optax.adam(sched)
        opt_state = tx.init(params)

        def loss_fn(p, bs, images, targets):
            (heat, *_), mut = model.apply(
                {"params": p, "batch_stats": bs}, images, True,
                mutable=["batch_stats"])
            w = 1.0 + jpb.POS_WEIGHT * targets
            return jnp.mean(w * (heat - targets) ** 2), mut["batch_stats"]

        @jax.jit
        def step(p, bs, st, images, targets):
            (l, bs2), g = jax.value_and_grad(loss_fn, has_aux=True)(
                p, bs, images, targets)
            u, st = tx.update(g, st)
            return optax.apply_updates(p, u), bs2, st, l

        for batch in batches:
            images, _, targets = _stage1_inputs(batch, jnp.float64)
            params, bstats, opt_state, l = step(params, bstats, opt_state,
                                                images, targets)
            after.append((float(l), _tree_np(params), _tree_np(bstats),
                          _tree_np(opt_state[0].mu)))
    return _tree_np(variables), after


def _bb_names(variables):
    """Backbone variables -> the PoseResNet's state_dict names (numpy)."""
    return {k[len("backbone."):]: v.numpy() for k, v in
            weights.backbone_state_dict(variables, 18).items()}


@functools.lru_cache(maxsize=None)
def _port_stage1(dtype=torch.float64):
    """The port's two updates (pretrain_2d.train_step) in ``dtype`` from
    lt_tpu's initial weights on the same batches: the initial state_dict
    and, after each update, (loss, state_dict, Adam's first moments), all
    numpy."""
    variables, _ = _lt_tpu_stage1()
    net = PoseResNet(17, num_layers=18, device="cpu")
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in _bb_names(variables).items()})
    net.to(dtype)
    before = {k: v.clone().numpy() for k, v in net.state_dict().items()}
    optimizer = pretrain_2d.make_optimizer(net)
    hm = IMG // pretrain_2d.HEATMAP_STRIDE
    after = []
    for i, batch in enumerate(_batches(2, IMG)):
        uv, _ = pretrain_2d.batch_targets(batch, hm, "cpu")
        loss = pretrain_2d.train_step(
            net, optimizer, pretrain_2d.batch_images(batch, "cpu").to(dtype),
            pretrain_2d.make_targets(uv.to(dtype), hm),
            pretrain_2d.learning_rate(i, N_PAR))
        after.append((float(loss), {k: v.clone().numpy()
                                    for k, v in net.state_dict().items()},
                      {k: optimizer.state[p]["exp_avg"].clone().numpy()
                       for k, p in net.named_parameters()}))
    return before, after


def _max_rel(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_stage1_first_update_has_lr_zero(dtype):
    """Update 0 runs at learning rate 0, as optax's: every parameter keeps
    its initial value bit for bit on both sides, while the BatchNorm
    statistics move."""
    variables, ref_after = _lt_tpu_stage1()
    before, after = _port_stage1(dtype)
    _, ref_params, ref_stats, _ = ref_after[0]
    init = _bb_names(jax.tree_util.tree_map(np.float64, variables))
    ref0 = _bb_names({"params": ref_params, "batch_stats": ref_stats})
    _, state0, _ = after[0]
    for name, value in state0.items():
        if name.endswith("num_batches_tracked"):
            continue
        stat = name.endswith(("running_mean", "running_var"))
        assert np.array_equal(value, before[name]) != stat, name
        assert np.array_equal(ref0[name], init[name]) != stat, name


@pytest.mark.parametrize("update", [0, 1])
def test_stage1_update_matches_lt_tpu(update):
    """float64, after each of the two updates (the second at lr 1e-3): the
    loss, every parameter and every BatchNorm statistic within STEP_RTOL of
    lt_tpu's, relative to the tensor's largest element."""
    _, ref_after = _lt_tpu_stage1()
    _, after = _port_stage1()
    ref_loss, ref_params, ref_stats, _ = ref_after[update]
    loss, state, _ = after[update]
    assert abs(loss - ref_loss) <= STEP_RTOL * abs(ref_loss)
    ref = _bb_names({"params": ref_params, "batch_stats": ref_stats})
    assert set(ref) == set(state)
    for name, value in ref.items():
        if name.endswith("num_batches_tracked"):    # not a flax variable
            continue
        assert _max_rel(state[name], value) <= STEP_RTOL, (
            name, _max_rel(state[name], value))


def test_stage1_float32_update_within_rounding_of_lt_tpu():
    """The port's own dtype: its float32 update 0 against lt_tpu's float64
    one.  Loss within relative 1e-5; the gradient (Adam's first moment over
    0.1) within relative L2 F32_GRAD_L2 over all parameters, about twice
    what float32 rounding alone gives either package at random weights."""
    _, ref_after = _lt_tpu_stage1()
    _, after = _port_stage1(torch.float32)
    ref_loss, _, ref_stats, ref_mu = ref_after[0]
    loss, _, mu = after[0]
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    ref = _bb_names({"params": ref_mu, "batch_stats": ref_stats})
    num = sum(((mu[k] - ref[k]) ** 2).sum() for k in mu)
    den = sum((ref[k] ** 2).sum() for k in mu)
    assert np.sqrt(num / den) <= F32_GRAD_L2, np.sqrt(num / den)


def _assert_trees_equal(got, ref, path=()):
    """Two variable trees: the same keys at every level and every leaf
    bit for bit, in the same dtype."""
    assert isinstance(got, dict) and isinstance(ref, dict), path
    assert set(got) == set(ref), (path, sorted(set(got) ^ set(ref)))
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_trees_equal(got[k], ref[k], path + (k,))
        else:
            a, b = np.asarray(got[k]), np.asarray(ref[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (path, k)
            assert np.array_equal(a, b), (path, k)


def _sd_np(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@functools.lru_cache(maxsize=None)
def _vol_model():
    return VolumetricTriangulationNet(num_layers=18, volume_size=16,
                                      device="cpu", seed=3)


@pytest.mark.parametrize("case", ["vol", "alg", "resnet50_heads",
                                  "other_joints"])
def test_writer_matches_lt_tpu_importer(case):
    """fixture.import_* on a random port state_dict (tensors) equal
    lt_tpu.utils.torch_import's on the same entries as numpy, leaf for
    leaf and bit for bit: the volumetric and the algebraic model (with its
    confidence head), a ResNet-50 with both heads (the scanned bottleneck
    trunk), and a final layer re-made for 19 joints."""
    if case == "vol":
        sd = _vol_model().state_dict()
        got = fixture.import_volumetric_model(sd, 18, 17)
        ref = torch_import.import_volumetric_model(_sd_np(_vol_model()), 18,
                                                   17)
    elif case == "alg":
        net = AlgebraicTriangulationNet(num_layers=18, device="cpu", seed=4)
        got = fixture.import_algebraic_model(net.state_dict(), 18, 17)
        ref = torch_import.import_algebraic_model(_sd_np(net), 18, 17)
    elif case == "resnet50_heads":
        net = PoseResNet(17, num_layers=50, alg_confidences=True,
                         vol_confidences=True, device="cpu", seed=5)
        got = fixture.import_pose_resnet(net.state_dict(), 50, 17)
        ref = torch_import.import_pose_resnet(_sd_np(net), 50, 17)
    else:
        sd = _vol_model().state_dict()
        got = fixture.import_pose_resnet(sd, 18, 19, prefix="backbone.")
        ref = torch_import.import_pose_resnet(_sd_np(_vol_model()), 18, 19,
                                              prefix="backbone.")
        assert got["params"]["final_layer"]["bias"].shape == (19,)
    _assert_trees_equal(got, ref)


def test_npz_matches_lt_tpu_and_round_trips(tmp_path):
    """save_npz writes lt_tpu.utils.fixture.save_model_npz's file (same
    keys, dtypes and arrays: params float16, batch_stats float32), and
    weights.load_npz_variables + volumetric_state_dict read back every
    entry: the weights rounded to float16, the statistics unchanged.  (A
    backbone .npz: test_two_stage_smallest_run.)"""
    net = _vol_model()
    variables = fixture.import_volumetric_model(net.state_dict(), 18, 17)
    fixture.save_npz(str(tmp_path / "port.npz"), variables)
    j_fixture.save_model_npz(str(tmp_path / "lt_tpu.npz"),
                             variables["params"], variables["batch_stats"])
    with np.load(tmp_path / "port.npz") as got, \
            np.load(tmp_path / "lt_tpu.npz") as ref:
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            assert got[k].dtype == ref[k].dtype == (
                np.float16 if k.startswith("params/") else np.float32), k
            assert np.array_equal(got[k], ref[k]), k
    back = weights.volumetric_state_dict(
        weights.load_npz_variables(str(tmp_path / "port.npz")), 18)
    state = net.state_dict()
    assert set(back) == set(state)
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            continue
        want = (v if k.endswith(("running_mean", "running_var"))
                else v.half().float())
        assert torch.equal(back[k], want), k



def _run_main(argv):
    """two_stage.main(argv) on the CPU -> (its result, its printed lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = two_stage.main(argv + ["--device", "cpu"])
    return result, out.getvalue().splitlines()


def _records(exp_dir, tag):
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["tag"] == tag]


@pytest.fixture(scope="module")
def smallest_run(tmp_path_factory):
    """``python -m lt_tpu_torch.two_stage 2 1 8`` on the CPU: 2 stage-1
    steps, one stage-2 epoch of 8 samples (one step) and its val.  No
    tensorboard writer, as on the card: vol_pretrain.yaml's panels at step
    0 would take most of the run (tests/test_torch_observability.py holds
    them)."""
    out = str(tmp_path_factory.mktemp("two_stage"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorboardX", None)
        result, lines = _run_main(["2", "1", "8", "--out", out])
    return out, result, lines


def test_two_stage_smallest_run(smallest_run):
    """Stage 1 logs both steps and saves a checkpoint directory whose
    backbone.* entries init_model_state loads with every backbone tensor;
    stage 2 loads the exported .npz with every backbone tensor; the losses
    and the val metric are finite; model.npz loads into the port."""
    out, result, lines = smallest_run
    n_bb = len(_vol_model().backbone.state_dict())
    with open(os.path.join(out, "backbone2d", "metrics.jsonl")) as f:
        stage1 = [json.loads(x) for x in f]
    assert [r["step"] for r in stage1] == [0, 1]
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["argmax_err"])
               for r in stage1)
    loaded = [re.search(r"Loaded backbone weights from (.*): (\d+) tensors, "
                        r"(\d+) of its entries unused", x) for x in lines]
    loaded = [m for m in loaded if m]
    assert len(loaded) == 1
    assert loaded[0].groups() == (result["backbone_npz"], str(n_bb), "0")
    assert any(x.startswith("STAGE1 backbone fixture: ") for x in lines)

    config = cfg.load_config(two_stage.VOL_YAML, {
        "model.backbone.checkpoint": os.path.join(out, "backbone2d"),
        "model.backbone.init_weights": True})
    net = VolumetricTriangulationNet(num_layers=18, volume_size=32,
                                     device="cpu", seed=7)
    from lt_tpu_torch.engine.train import init_model_state
    assert init_model_state(config, net)["backbone"]["loaded"] == n_bb
    state = ckpt.load_model_state(ckpt.resolve_checkpoint_dir(
        os.path.join(out, "backbone2d")))
    assert {k for k in state if k.startswith("backbone.")} == {
        f"backbone.{k}" for k in net.backbone.state_dict()}

    (train,) = _records(result["vol_dir"], "train")
    assert all(math.isfinite(v) for k, v in train.items() if k != "tag")
    assert math.isfinite(result["stage2"])
    weights.load_volumetric_npz(net, os.path.join(result["vol_dir"],
                                                  "model.npz"), 18)


def _script_overrides(bb_npz, n_samples, vol_epochs):
    """The ``overrides`` dict that benchmarks/vol_two_stage.py passes to
    lt_tpu's run, evaluated from the script's source."""
    import ast

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", "vol_two_stage.py")
    tree = ast.parse(open(path).read())
    (node,) = [kw.value for n in ast.walk(tree) if isinstance(n, ast.Call)
               for kw in n.keywords if kw.arg == "overrides"]
    return eval(compile(ast.Expression(node), path, "eval"),
                {"bb_npz": bb_npz, "n_samples": n_samples,
                 "vol_epochs": vol_epochs})


def test_two_stage_overrides_are_the_scripts(monkeypatch, tmp_path):
    """Stage 2 passes vol_two_stage.py's overrides to run on VOL_YAML,
    exactly; --resume passes them with resume_dir and without loading the
    backbone (the train state holds it); the polish continues from the
    stage-2 directory's train state (model.checkpoint) on 2048 samples for
    30 epochs at CE weight 0.01, every other setting the recipe's.  run is
    replaced by a stand-in that records its arguments."""
    calls = []

    def fake_run(config_path, logdir, **kwargs):
        calls.append((config_path, kwargs))
        os.makedirs(os.path.join(logdir, f"exp{len(calls)}"))
        return 100.0

    monkeypatch.setattr(two_stage, "run", fake_run)
    monkeypatch.setattr(two_stage, "export_npz", lambda d: d + "/model.npz")
    bb = str(tmp_path / "backbone.npz")
    two_stage.stage2(bb, 100, 1024, str(tmp_path), device="cpu")
    two_stage.main(["--resume", "somewhere", "7", "100", "1024", "--out",
                    str(tmp_path), "--device", "cpu"])
    two_stage.main(["--polish", "stage2dir", "--out", str(tmp_path),
                    "--device", "cpu"])
    (path, first), (_, resumed), (_, polished) = calls
    assert path == two_stage.VOL_YAML
    assert path == "experiments/synthetic/vol_pretrain.yaml"
    assert first["overrides"] == _script_overrides(bb, 1024, 100)
    assert first["resume_dir"] is None and first["device"] == "cpu"
    assert resumed["resume_dir"] == "somewhere"
    assert resumed["overrides"] == {
        **_script_overrides(bb, 1024, 100),
        "model.backbone.init_weights": False,
        "model.backbone.checkpoint": ""}
    assert polished["overrides"] == {
        **_script_overrides(None, 2048, 30),
        "model.backbone.init_weights": False,
        "model.backbone.checkpoint": "",
        "opt.volumetric_ce_loss_weight": 0.01,
        "model.init_weights": True, "model.checkpoint": "stage2dir"}
    assert "resume_dir" not in polished or polished["resume_dir"] is None


def test_two_stage_defaults_to_the_card(monkeypatch, tmp_path):
    """Without CUDA, stage 1 and the entry point raise before any output."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pretrain_2d.main(2, str(tmp_path / "bb"))
    with pytest.raises(RuntimeError, match="cuda"):
        two_stage.main(["2", "1", "8", "--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def evaluate_both(npz, logdir):
    """An exported model.npz on VOL_YAML's held-out val (16 poses at
    sample_offset 1e6, the training recipe's ground-truth pelvis), with
    lt_tpu's and the port's run(eval_only=True) on the CPU: (lt_tpu's rel
    MPJPE, the port's), mm."""
    from lt_tpu.engine.train import run as j_run
    from lt_tpu_torch.engine.train import run

    overrides = {"model.init_weights": True, "model.checkpoint": npz,
                 "model.backbone.init_weights": False,
                 "model.use_gt_pelvis": True}
    ref = j_run(two_stage.VOL_YAML, os.path.join(logdir, "lt_tpu"),
                eval_only=True, overrides=overrides)
    got = run(two_stage.VOL_YAML, os.path.join(logdir, "port"),
              eval_only=True, overrides=overrides, device="cpu")
    return ref, got


if __name__ == "__main__":
    import tempfile

    from lt_tpu.utils.cache import honor_platform_env

    honor_platform_env()
    with tempfile.TemporaryDirectory() as tmp:
        ref, got = evaluate_both(sys.argv[1], tmp)
    print(json.dumps({"npz": sys.argv[1], "lt_tpu_mpjpe_rel_mm": ref,
                      "port_mpjpe_rel_mm": got, "diff_mm": abs(ref - got),
                      "limit_mm": EVAL_MM}))
