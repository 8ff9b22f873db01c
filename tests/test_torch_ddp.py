"""Data parallelism in lt_tpu_torch on the CPU: two gloo ranks, spawned
with a ``file://`` rendezvous under ``tmp_path`` (xdist workers never
share a port), torch on one thread each.

- The whole training step, float64: two steps of the 2-rank run equal two
  steps of the one-process run on the same global batch, weights and
  generator (loss and metrics, every gradient, the BatchNorm statistics,
  the parameters after Adam, the generator's state) within relative 1e-9,
  for the volumetric model ('softmax' with the fused unprojection and
  'conf', remat on) and the algebraic model; the second rank's samples are
  all invalid in two of the cases.  The volumetric model's V2V is cut to
  one block (conv, BatchNorm, ReLU, conv) at 16^3: a float64 step of the
  full V2V at its least volume, 32^3, takes 170 s on one CPU thread.
- Against lt_tpu on a 2-device mesh (float32, 1e-5), cheap jits only:
  BatchNorm in training (output, statistics, input gradient), the losses
  and metrics with uneven validity, and the rows each rank's iterator
  loads against lt_tpu's ``shard_batch`` shards.
- The CLI's ``run`` on alg_tiny.yaml, two steps and 8 validation poses,
  under 2 ranks and in one process: the first step's loss, the master's
  writes only, the 2-rank checkpoint resumed in one process, and the
  world-size rule.

No case compiles an lt_tpu training step.  JAX is imported inside the
tests that use it, so that the spawned ranks import torch only.
"""

import json
import os
import pathlib
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn

from lt_tpu_torch.data.batch import BatchIterator
from lt_tpu_torch.engine import checkpoint as ckpt
from lt_tpu_torch.engine import factory, steps
from lt_tpu_torch.engine.train import run
from lt_tpu_torch.models.batchnorm import BatchNorm, bn_fed_biases
from lt_tpu_torch.models.triangulation import VolumetricOutput
from lt_tpu_torch.parallel import mesh
from lt_tpu_torch.utils import cfg
from lt_tpu_torch.utils.example import example_train_batch

ROOT = pathlib.Path(__file__).resolve().parents[1]
VOL_YAML = str(ROOT / "experiments/human36m/train/human36m_vol_softmax.yaml")
ALG_YAML = str(ROOT / "experiments/synthetic/alg_tiny.yaml")
RANKS = 2
B, V, IMG, J, S = 4, 2, 32, 17, 16     # the global batch of the step cases
STEP_TOL = 1e-9
LT_TPU_TOL = 1e-5
#: (family, aggregation, rank 1's samples all invalid)
STEP_CASES = {"vol_softmax": ("vol", "softmax", True),
              "vol_conf": ("vol", "conf", False),
              "alg": ("alg", None, True)}
CLI_CUT = {"opt.n_iters_per_epoch": 2, "dataset.train.n_samples": 8,
           "image_shape": [64, 64],
           "dataset.val.n_samples": 6}     # one val batch of 8, padded


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


# ---------------------------------------------------------------------------
# Two ranks
# ---------------------------------------------------------------------------

def _rank_main(r, fn, out_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdzv",
                            rank=r, world_size=RANKS)
    try:
        fn(out_dir, *args)
    finally:
        dist.destroy_process_group()


def _run_ranks(fn, out_dir, *args, timeout=480.0):
    """``fn(out_dir, *args)`` in RANKS spawned processes of one gloo
    group; raises the first rank's error."""
    os.makedirs(out_dir, exist_ok=True)
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, str(out_dir), args), nprocs=RANKS, join=False,
        start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__}: ranks still running after "
                               f"{timeout} s")
    assert all(p.exitcode == 0 for p in ctx.processes)


# ---------------------------------------------------------------------------
# The whole step, float64
# ---------------------------------------------------------------------------

class _VolumeNet(nn.Module):
    """V2V cut to one block, channels-last in and out as V2V.  No bias:
    one before a BatchNorm or a softmax gets a gradient of 0 in exact
    arithmetic, which no relative error measures."""

    def __init__(self, num_joints):
        super().__init__()
        self.conv1 = nn.Conv3d(32, 8, 3, padding=1, bias=False)
        self.bn = BatchNorm(8)
        self.conv2 = nn.Conv3d(8, num_joints, 1, bias=False)

    def forward(self, x):
        x = x.permute(0, 4, 1, 2, 3)
        y = self.conv2(torch.relu(self.bn(self.conv1(x))))
        return y.permute(0, 2, 3, 4, 1)


def _step_setup(case):
    """(config, model, criterion, optimizer, the global batch) in
    float64, the same in every process."""
    family, method, uneven = STEP_CASES[case]
    if family == "vol":
        config = cfg.load_config(VOL_YAML, {
            "model.backbone.num_layers": 18, "model.volume_size": S,
            "model.backbone.init_weights": False, "opt.remat": True,
            "model.volume_aggregation_method": method})
    else:
        config = cfg.load_config(ALG_YAML, {
            "model.backbone.num_joints": J, "image_shape": [IMG, IMG],
            "opt.remat": True})
    model = factory.make_model(config, device="cpu", seed=3)
    if family == "vol":
        torch.manual_seed(0)
        model.volume_net = _VolumeNet(J)
    model.double()
    for name, p in model.named_parameters():
        if name in _zero_in_exact_arithmetic(model, family):
            p.requires_grad_(False)
    batch = example_train_batch(B, IMG, J, n_views=V, seed=5)
    del batch["rotation_thetas"]                  # drawn from the generator
    batch["keypoints_validity"][0, 3] = 0.0
    if uneven:
        batch["keypoints_validity"][B // RANKS:] = 0.0
    batch["keypoints_3d"][..., 3:] = batch["keypoints_validity"]
    batch = {k: torch.from_numpy(v).double() for k, v in batch.items()}
    return (config, model, factory.make_criterion(config),
            factory.make_optimizer(config, model), batch)


def _zero_in_exact_arithmetic(model, family):
    """The parameters whose gradient is 0 in exact arithmetic: biases that
    feed a BatchNorm and the algebraic heatmap layer's bias, whose
    per-joint shift the soft-argmax's softmax ignores.  Their gradients
    are rounding, which Adam turns into moves of up to lr a step, another
    on each side, and the next step's gradients then differ by more than
    rounding: the cases freeze them, as exact arithmetic leaves them."""
    zero = bn_fed_biases(model)
    if family == "alg":
        zero.add("backbone.final_layer.bias")
    return zero


def _two_steps(model, optimizer, criterion, config, batch, restart=None):
    """Two train steps; each step's metrics, gradients, Adam moments, state
    (parameters after Adam and BatchNorm statistics) and generator state.
    ``restart``: the parameters the second step starts from (the
    one-process run's after its first), so that each step is compared
    from the same weights: a first step's rounding, which Adam can
    amplify thousands of times (:func:`_adam_bound`), would otherwise
    carry into the second."""
    gen = torch.Generator().manual_seed(11)
    module = mesh.unwrap(model)
    out = []
    for k in range(2):
        if k == 1 and restart is not None:
            with torch.no_grad():
                for name, p in module.named_parameters():
                    p.copy_(restart[name])
        metrics = steps.train_step(model, optimizer, criterion, config,
                                   batch, gen)
        out.append({
            "metrics": metrics,
            "grads": {k: p.grad.clone() for k, p in module.named_parameters()
                      if p.grad is not None},
            "adam": {k: (optimizer.state[p]["exp_avg"].clone(),
                         optimizer.state[p]["exp_avg_sq"].clone())
                     for k, p in module.named_parameters()
                     if p in optimizer.state},
            "state": {k: v.clone() for k, v in module.state_dict().items()},
            "gen": gen.get_state()})
    return out


def _adam_bound(record, lr, step, eps=1e-8):
    """Per element, how far Adam's step ``step`` can move a parameter for
    gradients that differ by STEP_TOL of their tensor's largest (dg):
    lr dg (1 / (sqrt(v^) + eps) + |m^| / (sqrt(v^) + eps)^2), m^ and v^ the
    bias-corrected moments of ``record``.  For a gradient near eps that is
    thousands of times dg."""
    out = {}
    for k, (m, v) in record["adam"].items():
        dg = STEP_TOL * float(record["grads"][k].abs().max())
        mh = m / (1.0 - 0.9 ** step)
        vh = (v / (1.0 - 0.999 ** step)).sqrt() + eps
        out[k] = lr * dg * (1.0 / vh + mh.abs() / vh ** 2)
    return out


def _step_errors(case):
    """The one-process run of ``case`` (no collective: the model is not
    wrapped) and this rank's 2-rank run, compared step by step: for each
    step and part, the largest error over the tensors, relative to each
    tensor's largest element (for the parameters after Adam, the largest
    ratio of the difference to STEP_TOL of the tensor's largest element
    plus :func:`_adam_bound`); the generator states' equality; the names
    of the trained parameters."""
    config, model, criterion, opt, batch = _step_setup(case)
    ref = _two_steps(model, opt, criterion, config, batch)
    trained = sorted(ref[0]["adam"])
    config, model, criterion, opt, batch = _step_setup(case)
    net = mesh.data_parallel(model, torch.device("cpu"))
    got = _two_steps(net, opt, criterion, config, mesh.shard_batch(batch),
                     {k: v for k, v in ref[0]["state"].items()})
    errors = []
    for k, (g, e) in enumerate(zip(got, ref)):
        err = {"keys": all(g[p].keys() == e[p].keys()
                           for p in ("metrics", "grads", "adam", "state"))}
        err["metrics"] = max(_rel(g["metrics"][n], v)
                             for n, v in e["metrics"].items())
        err["grads"] = max(_rel(g["grads"][n], v)
                           for n, v in e["grads"].items())
        err["adam"] = max(max(_rel(g["adam"][n][0], m),
                              _rel(g["adam"][n][1], v))
                          for n, (m, v) in e["adam"].items())
        bound = _adam_bound(e, config.opt.lr, k + 1)
        err["params"] = max(float(((g["state"][n] - v).abs() / (
            STEP_TOL * v.abs().max() + bound[n])).max())
            for n, v in e["state"].items() if n in bound)
        err["buffers"] = max(_rel(g["state"][n], v)
                             for n, v in e["state"].items()
                             if n not in bound)
        err["gen"] = torch.equal(g["gen"], e["gen"])
        err["total_loss"] = e["metrics"]["total_loss"]
        errors.append(err)
    return {"steps": errors, "trained": trained}


def _ddp_rank_work(out_dir):
    """Every step case, both runs in this rank; then the BatchNorm and
    the losses for the comparisons with lt_tpu; then the CLI."""
    res = {case: _step_errors(case) for case in STEP_CASES}
    res["bn"] = _port_bn(mesh.shard_batch(_bn_inputs()[0]))
    res["losses"] = _port_losses(dist.group.WORLD)
    res["cli"] = _cli_rank_work(out_dir)
    torch.save(res, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))


@pytest.fixture(scope="module")
def ranks_dir(tmp_path_factory):
    """One spawn of the ranks for every case of the file."""
    out = tmp_path_factory.mktemp("ddp")
    _run_ranks(_ddp_rank_work, out)
    return out


@pytest.fixture(scope="module")
def ranks_out(ranks_dir):
    return [torch.load(ranks_dir / f"rank{r}.pt", weights_only=False)
            for r in range(RANKS)]


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_two_ranks_step_equals_one_process(ranks_out, case):
    """Both ranks, both steps: metrics, gradients, Adam's moments and the
    BatchNorm statistics within STEP_TOL of each tensor's largest element;
    the parameters after Adam within that plus what Adam's division by
    sqrt(v^) + eps makes of the gradients' difference (:func:`_adam_bound`);
    the generator's state equal."""
    config, model, *_ = _step_setup(case)
    trained = {k for k, p in model.named_parameters() if p.requires_grad}
    for rank_out in ranks_out:
        res = rank_out[case]
        assert set(res["trained"]) == trained
        for k, err in enumerate(res["steps"]):
            assert err["keys"] and err["gen"], (k, err)
            if STEP_CASES[case][2]:
                assert err["total_loss"] > 0.0
            for part in ("metrics", "grads", "adam", "buffers"):
                assert err[part] <= STEP_TOL, (k, part, err)
            assert err["params"] <= 1.0, (k, err)
    if STEP_CASES[case][0] == "vol":      # frozen: out of the reduction
        assert "backbone.final_layer.weight" not in trained


# ---------------------------------------------------------------------------
# Against lt_tpu on a 2-device mesh
# ---------------------------------------------------------------------------

def _bn_inputs():
    """x (N, C, H, W), the output's cotangent, and the BatchNorm's scale,
    bias, mean and var."""
    rng = np.random.RandomState(2)
    x = rng.normal(1.5, 2.0, (4, 3, 5, 6)).astype(np.float32)
    g = rng.normal(0.0, 1.0, x.shape).astype(np.float32)
    params = [rng.normal(1, 0.2, 3), rng.normal(0, 0.2, 3), rng.rand(3),
              rng.rand(3) + 0.5]
    return {"x": x, "g": g}, [p.astype(np.float32) for p in params]


def _port_bn(rows):
    _, (scale, bias, mean, var) = _bn_inputs()
    bn = BatchNorm(3).train()
    with torch.no_grad():
        for t, v in zip((bn.weight, bn.bias, bn.running_mean,
                         bn.running_var), (scale, bias, mean, var)):
            t.copy_(torch.from_numpy(v))
    if dist.is_initialized():
        bn.process_group = dist.group.WORLD
    x = torch.from_numpy(rows["x"]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(rows["g"])).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


def _lt_tpu_mesh_inputs(batch: dict):
    from lt_tpu.parallel import mesh as j_mesh

    m = j_mesh.make_mesh(RANKS)
    return j_mesh.shard_batch(batch, m)


def test_global_batchnorm_matches_lt_tpu(ranks_out):
    import jax
    import jax.numpy as jnp

    from lt_tpu.models.backbone import BatchNorm as JBatchNorm

    inputs, (scale, bias, mean, var) = _bn_inputs()
    sharded = _lt_tpu_mesh_inputs({k: np.moveaxis(v, 1, -1)
                                   for k, v in inputs.items()})
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean, "var": var}}}

    @jax.jit
    def f(x, g):
        def out(x):
            return JBatchNorm().apply(variables, x, train=True,
                                      mutable=["batch_stats"])

        (y, stats), vjp = jax.vjp(out, x)
        dx, = vjp((g, jax.tree_util.tree_map(jnp.zeros_like, stats)))
        return y, stats["batch_stats"]["BatchNorm_0"], dx

    y, stats, dx = jax.device_get(f(sharded["x"], sharded["g"]))
    y, dx = np.moveaxis(y, -1, 1), np.moveaxis(dx, -1, 1)
    n = len(y) // RANKS
    for r, got in enumerate(o["bn"] for o in ranks_out):
        rows = slice(r * n, (r + 1) * n)
        assert _rel(got["y"], y[rows]) <= LT_TPU_TOL
        assert _rel(got["dx"], dx[rows]) <= LT_TPU_TOL
        assert _rel(got["mean"], stats["mean"]) <= LT_TPU_TOL
        assert _rel(got["var"], stats["var"]) <= LT_TPU_TOL
    # The one-process BatchNorm of the same rows differs: the statistics
    # are global.
    alone = _port_bn({k: v[:n] for k, v in inputs.items()})
    assert _rel(alone["y"], y[:n]) > 1e-3


def _loss_inputs():
    """A volumetric output and batch (global, numpy) with the second
    rank's samples all invalid and one invalid joint on the first's."""
    rng = np.random.RandomState(4)
    b, j, s = 4, 17, 4
    kp_gt = rng.uniform(-500, 500, (b, j, 3)).astype(np.float32)
    validity = np.ones((b, j, 1), np.float32)
    validity[0, 5] = 0.0
    validity[b // RANKS:] = 0.0
    vols = rng.rand(b, j, s, s, s).astype(np.float32)
    vols /= vols.sum((2, 3, 4), keepdims=True)
    return {"keypoints_3d_pred": (kp_gt + rng.normal(0, 40, kp_gt.shape)
                                  ).astype(np.float32),
            "volumes": vols,
            "coord_volumes": rng.uniform(-600, 600, (b, s, s, s, 3)
                                         ).astype(np.float32),
            "base_points": rng.uniform(-500, 500, (b, 3)).astype(np.float32),
            "keypoints_3d": np.concatenate([kp_gt, validity], -1),
            "keypoints_validity": validity,
            "images": np.zeros((b, 2, 1, 1, 3), np.float32)}


def _port_losses(group, rows=None):
    """The port's metrics on this rank's rows of :func:`_loss_inputs`
    (``rows``: that batch's rows, normalized on their own)."""
    rows = {k: torch.from_numpy(v) for k, v in (
        rows or mesh.shard_batch(_loss_inputs())).items()}
    config = cfg.load_config(VOL_YAML)
    out = VolumetricOutput(rows["keypoints_3d_pred"], None, rows["volumes"],
                           None, rows["coord_volumes"], rows["base_points"])
    _, metrics = steps.compute_losses(factory.make_criterion(config), config,
                                      out, rows, group)
    values = mesh.all_sum(torch.stack(list(metrics.values())), group)
    return dict(zip(metrics, values.tolist()))


def test_global_losses_match_lt_tpu(ranks_out):
    import jax

    from lt_tpu.engine import steps as j_steps
    from lt_tpu.models import losses as j_losses
    from lt_tpu.models.triangulation import VolumetricOutput as JOut
    from lt_tpu.utils import cfg as j_cfg

    config = j_cfg.load_config(VOL_YAML)
    x = _lt_tpu_mesh_inputs(_loss_inputs())
    criterion = j_losses.make_criterion(config.opt.criterion)

    @jax.jit
    def f(x):
        out = JOut(x["keypoints_3d_pred"], None, x["volumes"], None,
                   x["coord_volumes"], x["base_points"])
        return j_steps.compute_losses("vol", criterion, config, out, x)[1]

    ref = jax.device_get(f(x))
    assert set(ref) == {"MAE", "volumetric_ce_loss", "base_point_l2",
                        "total_loss", "l2"}
    for got in (o["losses"] for o in ranks_out):
        assert got.keys() == ref.keys()
        for k, v in ref.items():
            assert _rel(got[k], v) <= LT_TPU_TOL, k
    # The mean of the ranks' own means is another loss.
    n = 4 // RANKS
    own = [_port_losses(None, {k: v[r * n:(r + 1) * n]
                               for k, v in _loss_inputs().items()})
           for r in range(RANKS)]
    assert _rel(np.mean([o["MAE"] for o in own]), ref["MAE"]) > 0.1


class _Indexed:
    """A dataset whose sample i is filled with i (tests/test_torch_data)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"images": [np.full((2, 2, 3), i + 0.25 * v, np.float32)
                           for v in range(3)],
                "view_valid": [True] * 3,
                "detections": [np.zeros(5, np.float32)] * 3,
                "proj_matrices": [np.eye(3, 4, dtype=np.float32)] * 3,
                "cameras_R": [np.eye(3, dtype=np.float32)] * 3,
                "cameras_t": [np.zeros((3, 1), np.float32)] * 3,
                "cameras_K": [np.eye(3, dtype=np.float32)] * 3,
                "keypoints_3d": np.full((2, 4), i, np.float32),
                "indexes": i}


@pytest.mark.parametrize("epoch", [0, 1])
def test_rank_rows_are_lt_tpus_shards(epoch):
    """Two batches of 4 with randomized view counts: rank r's rows are
    lt_tpu's shard on mesh device r, array for array."""
    import jax

    from lt_tpu.data import batch as j_batch
    from lt_tpu.parallel import mesh as j_mesh

    kw = dict(batch_size=4, shuffle=True, seed=3, randomize_n_views=True,
              min_n_views=1, max_n_views=2)
    ds = _Indexed(11)
    m = j_mesh.make_mesh(RANKS)
    ref = [j_mesh.shard_batch({k: v for k, v in b.items()}, m)
           for b in j_batch.BatchIterator(ds, prefetch=0, **kw).epoch(epoch)]
    assert len(ref) == 2
    for r in range(RANKS):
        got = list(BatchIterator(ds, rank=r, world_size=RANKS, prefetch=2,
                                 **kw).epoch(epoch))
        assert len(got) == len(ref)
        for g, e in zip(got, ref):
            assert g.keys() == e.keys()
            for k, arr in e.items():
                shard = next(s for s in arr.addressable_shards
                             if s.device == m.devices[r])
                np.testing.assert_array_equal(g[k], jax.device_get(
                    shard.data), err_msg=k)


def test_eval_rows_pad_the_tail():
    """A 10-sample eval split at batch 8 over 2 ranks: the tail's rows 2-7
    are copies of its last sample with index -1; rank 1 holds only
    copies."""
    ds = _Indexed(10)
    rows = [list(BatchIterator(ds, 8, shuffle=False, drop_last=False,
                               pad_last=True, rank=r, world_size=RANKS
                               ).epoch(0)) for r in range(RANKS)]
    assert [b["indexes"].tolist() for b in rows[0]] == [[0, 1, 2, 3],
                                                       [8, 9, -1, -1]]
    assert [b["indexes"].tolist() for b in rows[1]] == [[4, 5, 6, 7],
                                                       [-1, -1, -1, -1]]
    np.testing.assert_array_equal(rows[1][1]["keypoints_3d"],
                                  np.full((4, 2, 4), 9, np.float32))


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _cli_rank_work(out_dir):
    """alg_tiny.yaml's cut epoch from rank r's own log directory; then the
    world-size rule and an eval with ``data_parallel: false``.  Returns
    the metrics and the errors raised."""
    r = dist.get_rank()
    metric = run(ALG_YAML, os.path.join(out_dir, f"logs{r}"), max_epochs=1,
                 device="cpu", overrides=CLI_CUT)
    raised = []
    for over in ({"opt.batch_size": 3}, {"opt.val_batch_size": 5}):
        try:
            run(ALG_YAML, os.path.join(out_dir, f"bad{r}"), max_epochs=1,
                device="cpu", overrides={**CLI_CUT, **over})
        except ValueError as e:
            raised.append(str(e))
    # data_parallel: false: no DDP, every rank runs the whole batch, so a
    # val batch of 5 is no error; the master alone writes.
    off = run(ALG_YAML, os.path.join(out_dir, f"off{r}"), eval_only=True,
              device="cpu", overrides={**CLI_CUT, "data_parallel": False,
                                       "opt.val_batch_size": 5})
    return {"metric": metric, "raised": raised, "off": off}


def _experiment(logdir):
    exps = [p for p in pathlib.Path(logdir).iterdir() if p.is_dir()]
    assert len(exps) == 1, exps
    lines = [json.loads(x) for x in open(exps[0] / "metrics.jsonl")]
    return exps[0], lines


def test_cli_two_ranks(ranks_dir, ranks_out, tmp_path):
    outs = [o["cli"] for o in ranks_out]
    assert outs[0]["metric"] == outs[1]["metric"]   # every rank evaluates
    for o in outs:
        assert len(o["raised"]) == 2 and all(
            "divide the batch sizes" in e for e in o["raised"])
    assert not (ranks_dir / "logs1").exists()     # only the master writes
    assert not (ranks_dir / "bad0").exists()      # raised before any output
    assert outs[0]["off"] == outs[1]["off"] and np.isfinite(outs[0]["off"])
    assert not (ranks_dir / "off1").exists()
    _, off_lines = _experiment(ranks_dir / "off0")
    assert [x["batch_size"] for x in off_lines
            if x["tag"] == "val_batch"] == [5, 1]
    exp, lines = _experiment(ranks_dir / "logs0")
    assert (exp / "checkpoints" / "0000" / ckpt.STATE_FILE).is_file()
    assert (exp / "checkpoints" / "0000" / "metric.json").is_file()
    assert any((exp / "tb").iterdir())
    train = [x for x in lines if x["tag"] == "train"]
    assert [x["step"] for x in train] == [0, 1]
    assert all(x["batch_size"] == 4 for x in train)
    val = [x for x in lines if x["tag"] == "val_batch"]
    assert [x["batch_size"] for x in val] == [6]

    # The same cut epoch in one process: the first step's loss (later
    # steps at random weights amplify float32 rounding many-fold).
    run(ALG_YAML, str(tmp_path / "one"), max_epochs=1, device="cpu",
        overrides=CLI_CUT)
    _, lines1 = _experiment(tmp_path / "one")
    train1 = [x for x in lines1 if x["tag"] == "train"]
    assert _rel(train[0]["total_loss"], train1[0]["total_loss"]) <= 1e-5

    # The 2-rank checkpoint restored in one process (weights, optimizer,
    # generator and step): its weights give the keypoints the 2-rank eval
    # gathered with them.
    restore = {**CLI_CUT, "model.init_weights": True,
               "model.checkpoint": str(exp)}
    run(ALG_YAML, str(tmp_path / "eval"), eval_only=True, device="cpu",
        overrides=restore)
    exp_e, _ = _experiment(tmp_path / "eval")
    got, ref = (pickle.load(open(e / "checkpoints" / "0000" / "results.pkl",
                                 "rb")) for e in (exp_e, exp))
    np.testing.assert_array_equal(got["indexes"], ref["indexes"])
    assert _rel(got["keypoints_3d"], ref["keypoints_3d"]) <= 1e-5
