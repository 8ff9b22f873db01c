"""Training under volume-axis sharding in lt_tpu_torch on the CPU: two gloo
ranks, spawned once for the module with a ``file://`` rendezvous under
``tmp_path``, torch on one thread each.

The step is tests/test_torch_train.py's: the flagship recipe
(human36m_vol_softmax.yaml: MAE + 0.01 volumetric CE, scale 0.1, the fused
'softmax' path) cut to RN-18 at 64^2, 2 views, a 32^3 volume and batch 2,
from ``lt_tpu``'s float32-initialized weights.  Over 2 ranks V2V's levels
32^3 to 2^3 are split (slabs of 16, 8, 4, 2 and 1 planes) and the pool to
1^3 gathers the volume: encoder_res5, mid_res and decoder_res5 run whole.

- Against one process: the 2-rank float64 step against the port's
  one-process float64 step, run beside the ranks in a spawned process on
  one thread (the ranks' rounding),
  on both ranks: the loss and metrics, every gradient (its largest
  difference over its own largest element; a gradient that is 0 in exact
  arithmetic, a bias that feeds a BatchNorm, has no relative error of its
  own and is held to its optimizer group's largest), every BatchNorm
  running statistic, and the parameters after Adam (within that plus
  what Adam's division makes of the gradients' difference,
  tests/test_torch_ddp.py's rule), all at STEP_TOL; both ranks'
  parameters equal.
- Against ``lt_tpu``: the same step against ``lt_tpu``'s float64 step
  (tests/test_torch_train.py's ``_jax_step``, computed once per run and
  shared between the xdist workers) at that file's tolerances.
- The backward recomputes the rank's slab of samples with K5 and
  scatters it with K6 (their plain versions here), on the slab K1 filled.
- The collectives' backward: ``torch.autograd.gradcheck`` of a function
  of a replicated input through ``take_slab``, the halo exchange of a
  'same' convolution on slabs, ``gather_x`` and a sum over the group,
  with the input's gradient averaged over the group as the parameters'.
- 'conf' (the unfused path: K5 on the slab, the aggregation, K6 in the
  backward) in float32 against one process; ``remat: true`` on slabs is
  exact (equal to the step without it, the statistics moved once, the
  recompute repeating the forward's exchanges).
- BatchNorm: the levels V2V runs whole take their own statistics, and the
  backbone's BatchNorm never takes the slab group's.
- ``run`` trains experiments/synthetic/vol_tiny.yaml (cut to 2 views of
  64^2, one step an epoch) on two ranks: the first step's loss equals one
  process's, only the master writes, and the run resumes from its
  checkpoint.

While the spawned processes run, this process computes lt_tpu's weights
and its float64 step (shared with tests/test_torch_train.py through the
xdist run's directory), so that the file's wall time is the longest of
the three rather than their sum.

JAX is imported inside the parent's functions, so that the spawned
processes import torch only.
"""

import json
import os
import pathlib
import shutil
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn

from lt_tpu_torch.engine import factory, steps
from lt_tpu_torch.engine.train import run
from lt_tpu_torch.models import v2v
from lt_tpu_torch.models.batchnorm import BatchNorm, bn_fed_biases
from lt_tpu_torch.ops.kernels import unproject
from lt_tpu_torch.parallel import spatial
from lt_tpu_torch.parallel.spatial import SlabGroup
from lt_tpu_torch.utils import cfg
from lt_tpu_torch.utils.example import example_train_batch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAGSHIP_YAML = str(ROOT / "experiments/human36m/train/"
                    "human36m_vol_softmax.yaml")
VOL_TINY = str(ROOT / "experiments/synthetic/vol_tiny.yaml")
# tests/test_torch_train.py's SMALL, B, V, IMG, J.
SMALL = {"model.backbone.num_layers": 18, "model.volume_size": 32,
         "model.backbone.init_weights": False}
KEY = {"model.volume_axis_sharding": True}
B, V, IMG, J, S = 2, 2, 64, 17, 32
RANKS = 2
STEP_TOL = 1e-9
# The 'conf' step in float32 against one process: the loss relative, each
# optimizer group's gradient in relative L2 (tests/test_torch_train.py's
# F32_GRAD_L2, the float32 step's distance from float64).
CONF_LOSS_TOL, CONF_GRAD_L2 = 1e-5, 1e-2
CLI = {"opt.n_iters_per_epoch": 1, "dataset.train.n_samples": 4,
       "dataset.val.n_samples": 2, "opt.val_batch_size": 2,
       "image_shape": [IMG, IMG], "dataset.n_views": V}


@pytest.fixture(scope="module", autouse=True)
def shared_run_dir(tmp_path_factory):
    """tests/test_torch_train.py's shared run directory, so that lt_tpu's
    float64 step is computed once per xdist run for both files."""
    if "PYTEST_XDIST_WORKER" in os.environ:
        from tests.test_torch_train import SHARED

        SHARED["dir"] = tmp_path_factory.getbasetemp().parent


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(dtype=torch.float64):
    """tests/test_torch_train.py's ``_batch`` (one joint of sample 1
    invalid) as tensors."""
    batch = example_train_batch(B, IMG, J, n_views=V, seed=0)
    batch["keypoints_validity"][1, 3] = 0.0
    batch["keypoints_3d"][1, 3, 3] = 0.0
    return {k: torch.from_numpy(np.asarray(v, np.float32).copy()).to(dtype)
            for k, v in batch.items()}


def _record(model, optimizer, metrics, adam=False):
    """The step's metrics, gradients and state (and, with ``adam``,
    Adam's moments)."""
    out = {"metrics": metrics,
           "grads": {k: p.grad.clone() for k, p in model.named_parameters()
                     if p.grad is not None},
           "state": {k: v.clone() for k, v in model.state_dict().items()}}
    if adam:
        out["adam"] = {k: (optimizer.state[p]["exp_avg"].clone(),
                           optimizer.state[p]["exp_avg_sq"].clone())
                       for k, p in model.named_parameters()
                       if p in optimizer.state}
    return out


def _flagship_step(out_dir, sharded, observe=False):
    """One float64 step of the SMALL recipe from the saved weights, its
    volume split over the launch's ranks or not.  ``observe``: also which
    slab each of K1, K5 and K6 was called on, and whether each BatchNorm
    took the group's statistics."""
    config = cfg.load_config(FLAGSHIP_YAML, {**SMALL, **(KEY if sharded
                                                        else {})})
    model = factory.make_model(config, device="cpu")
    model.load_state_dict(torch.load(f"{out_dir}/weights.pt"))
    model.double()
    opt = factory.make_optimizer(config, model)
    seen, bn, saved, hooks = [], {}, {}, []
    if observe:
        for name in ("unproject_agg", "sample_views_t", "sample_views_grad_t"):
            fn = saved[name] = getattr(unproject, name)
            setattr(unproject, name,
                    lambda *a, _f=fn, _n=name, **k: seen.append(
                        (_n, k.get("slab"))) or _f(*a, **k))
        hooks = [m.register_forward_pre_hook(
            lambda m, a, name=name: bn.__setitem__(
                name, spatial.on_slabs() is not None))
            for name, m in model.named_modules() if isinstance(m, BatchNorm)]
    try:
        metrics = steps.train_step(model, opt, factory.make_criterion(config),
                                   config, _batch())
    finally:
        for name, fn in saved.items():
            setattr(unproject, name, fn)
        for h in hooks:
            h.remove()
    out = _record(model, opt, metrics, adam=not sharded)
    out.update(seen=seen, bn=bn)
    g = model.volume_axis_sharding
    if g is not None:
        out.update(stats=dict(g.stats), slab=g.slab(S))
    return out


def _conf_step(sharded, remat=False):
    """One float32 'conf' step (the unfused path) of the SMALL recipe from
    the port's seeded weights."""
    config = cfg.load_config(FLAGSHIP_YAML, {
        **SMALL, **(KEY if sharded else {}), "opt.remat": remat,
        "model.volume_aggregation_method": "conf"})
    model = factory.make_model(config, device="cpu", seed=3)
    opt = factory.make_optimizer(config, model)
    metrics = steps.train_step(model, opt, factory.make_criterion(config),
                               config, _batch(torch.float32))
    out = _record(model, opt, metrics)
    if model.volume_axis_sharding is not None:
        out["stats"] = dict(model.volume_axis_sharding.stats)
    return out


class _Replicated(torch.autograd.Function):
    """A replicated input whose gradient is averaged over the group, as
    ``SlabGroup.average_grads`` averages the parameters'."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        ctx.g._reduce(grad)
        return grad / ctx.g.ranks, None


def _gradcheck():
    """gradcheck, on every rank at once, of whole (replicated) -> this
    rank's slab -> a 'same' k = 3 convolution on slabs (one halo
    exchange) -> tanh -> the whole level (gather_x) and its sum over the
    group (all_reduce)."""
    g = SlabGroup(dist.group.WORLD, 8)
    gen = torch.Generator().manual_seed(5)
    whole = torch.randn((1, 2, 8, 3, 2), generator=gen, dtype=torch.float64,
                        requires_grad=True)
    torch.manual_seed(5)
    conv = nn.Conv3d(2, 3, 3, padding=1).double()

    def f(x):
        slab = g.take_slab(_Replicated.apply(x, g), dim=2)
        y = torch.tanh(v2v._slab_conv(conv, slab, g))
        return torch.cat([g.gather_x(y, dim=2).reshape(-1),
                          g.all_reduce((y * y).sum((2, 3, 4))).reshape(-1)])

    try:
        ok = torch.autograd.gradcheck(f, (whole,))
    except Exception as e:               # a mismatch: report it
        ok = repr(e)
    return {"gradcheck": ok, "stats": dict(g.stats)}


def _cli(out_dir, r):
    """One step and its eval, then one more epoch resumed from the
    checkpoint, on two ranks; each rank logs under its own directory."""
    logdir = f"{out_dir}/logs{r}"
    first = run(VOL_TINY, logdir, device="cpu", max_epochs=1,
                overrides={**CLI, **KEY})
    exp = [None]
    if r == 0:
        exp = [str(next(pathlib.Path(logdir).iterdir()))]
    dist.broadcast_object_list(exp, src=0)
    second = run(VOL_TINY, logdir, device="cpu", max_epochs=2,
                 resume_dir=exp[0], overrides={**CLI, **KEY})
    return {"metric": (first, second), "experiment": exp[0],
            "wrote": os.path.isdir(logdir) and sorted(os.listdir(logdir))}


def _remat(conf):
    """The remat step against the step without it (``conf``), here in the
    rank: whether metrics, gradients and state are equal, and both steps'
    collectives."""
    rem = _conf_step(True, True)
    return {"equal": rem["metrics"] == conf["metrics"] and all(
        torch.equal(rem[part][k], v) for part in ("grads", "state")
        for k, v in conf[part].items()), "stats": rem["stats"],
        "plain_stats": conf["stats"]}


def _weights(out_dir, timeout=600.0):
    """Wait for the parent to save lt_tpu's weights (it spawns the ranks
    first, then computes them)."""
    path = pathlib.Path(out_dir) / "weights.pt"
    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.5)


def _rank_main(r, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdzv",
                            rank=r, world_size=RANKS)
    try:
        # What needs no lt_tpu weights first, then the flagship step.
        res = {"conf": _conf_step(True)}
        res["remat"] = _remat(res["conf"])
        res["conf"].pop("state")
        res.update(gradcheck=_gradcheck(), cli=_cli(out_dir, r))
        _weights(out_dir)
        res["flagship"] = _flagship_step(out_dir, True, observe=True)
        torch.save(res, f"{out_dir}/rank{r}.pt")
    finally:
        dist.destroy_process_group()


def _one_process_main(_, out_dir):
    """The one-process references, on one thread as the ranks: the float64
    flagship step, the 'conf' step, the CLI run."""
    torch.set_num_threads(1)
    one = {"conf": _conf_step(False),
           "cli": run(VOL_TINY, f"{out_dir}/logs_one", device="cpu",
                      max_epochs=1, overrides=CLI)}
    _weights(out_dir)
    one["flagship"] = _flagship_step(out_dir, False)
    torch.save(one, f"{out_dir}/one.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks and a process of the one-process references spawned
    first; meanwhile here lt_tpu's weights saved for them and lt_tpu's
    float64 step (tests/test_torch_train.py's, shared with that file);
    then the ranks' and the references' results."""
    from tests.test_torch_train import _jax_step, _jax_variables

    from lt_tpu_torch.utils.weights import volumetric_state_dict

    out_dir = tmp_path_factory.mktemp("spatial_train")
    procs = [torch.multiprocessing.start_processes(
        fn, args=(str(out_dir),), nprocs=n, join=False, start_method="spawn")
        for fn, n in ((_rank_main, RANKS), (_one_process_main, 1))]
    try:
        torch.save(volumetric_state_dict(_jax_variables(), 18),
                   out_dir / "weights.tmp")
        os.replace(out_dir / "weights.tmp", out_dir / "weights.pt")
        _jax_step()
        deadline = time.monotonic() + 900.0
        for ctx in procs:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError("the spawned processes still run "
                                       "after 900 s")
    finally:
        for p in (p for ctx in procs for p in ctx.processes):
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for ctx in procs for p in ctx.processes)
    one = torch.load(out_dir / "one.pt", weights_only=False)
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
             for r in range(RANKS)]
    one["cli_records"] = _train_records(next((out_dir / "logs_one")
                                             .iterdir()))
    for rank in ranks:          # what the run wrote, read before it goes
        cli = rank["cli"]
        cli["records"] = _train_records(cli["experiment"])
        cli["resumed"] = [(_train_records(d), (d / "checkpoints" / "0001"
                                               / "state.pt").is_file())
                          for d in (out_dir / "logs0").iterdir()
                          if str(d) != cli["experiment"]]
    shutil.rmtree(out_dir)      # checkpoints and results: about 2 GB
    return {"one": one, "ranks": ranks}


def _rel(got, ref):
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return (got - ref).abs().max().item() / max(ref.abs().max().item(),
                                                1e-300)


def _group_scale(grads):
    """Each optimizer group's largest gradient."""
    return {grp: max(v.abs().max().item() for k, v in grads.items()
                     if k.startswith(grp + "."))
            for grp in factory.GROUPS}


def _zero_grads():
    """The parameters whose gradient is 0 in exact arithmetic: the biases
    that feed a BatchNorm and the output layer's bias (the soft-argmax is
    blind to a shift), so rounding alone, with no relative error of its
    own."""
    model = factory.make_model(cfg.load_config(FLAGSHIP_YAML, SMALL),
                               device="cpu")
    return bn_fed_biases(model) | {"volume_net.output_layer.bias"}


def _grad_tol(grads):
    """Per gradient, STEP_TOL of its own largest element (of its group's
    largest for those of :func:`_zero_grads`)."""
    scale, zero = _group_scale(grads), _zero_grads()
    return {k: STEP_TOL * (scale[k.split(".")[0]] if k in zero
                           else v.abs().max().item())
            for k, v in grads.items()}


def _adam_bound(ref, lrs, eps=1e-8):
    """Per parameter, how far Adam's first step at its group's learning
    rate (``lrs``) can move it for gradients that differ by their
    :func:`_grad_tol` (dg): lr dg (1 / (sqrt(v^) + eps) + |m^| /
    (sqrt(v^) + eps)^2), m^ and v^ the bias-corrected moments
    (tests/test_torch_ddp.py's rule)."""
    tol = _grad_tol(ref["grads"])
    out = {}
    for k, (m, v) in ref["adam"].items():
        mh, vh = m / 0.1, (v / 0.001).sqrt() + eps
        out[k] = lrs[k.split(".")[0]] * tol[k] * (1.0 / vh + mh.abs()
                                                   / vh ** 2)
    return out


# ---------------------------------------------------------------------------
# The flagship step, float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", range(RANKS))
def test_sharded_step_equals_one_process(ranks, r):
    got, ref = ranks["ranks"][r]["flagship"], ranks["one"]["flagship"]
    assert got["metrics"].keys() == ref["metrics"].keys()
    for name, v in ref["metrics"].items():
        assert abs(got["metrics"][name] - v) <= STEP_TOL * abs(v), name
    assert got["grads"].keys() == ref["grads"].keys()
    tol = _grad_tol(ref["grads"])
    for k, v in ref["grads"].items():
        err = (got["grads"][k] - v).abs().max().item()
        assert err <= tol[k], (k, err, tol[k])
    stats = [k for k in ref["state"] if k.endswith(("running_mean",
                                                    "running_var"))]
    assert len(stats) > 100
    for k in stats:
        assert _rel(got["state"][k], ref["state"][k]) <= STEP_TOL, k
    opt = cfg.load_config(FLAGSHIP_YAML).opt
    bound = _adam_bound(ref, {"backbone": opt.lr,
                              "process_features": opt.process_features_lr,
                              "volume_net": opt.volume_net_lr})
    for k, v in ref["state"].items():
        if k in bound:
            diff = (got["state"][k] - v).abs()
            assert bool((diff <= STEP_TOL * v.abs().max() + bound[k]).all()
                        ), k


def test_ranks_take_the_same_step(ranks):
    a, b = (rank["flagship"] for rank in ranks["ranks"])
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k


@pytest.mark.parametrize("r", range(RANKS))
def test_sharded_step_matches_lt_tpu(ranks, r):
    """tests/test_torch_train.py's tolerances: the loss within relative
    1e-5, each gradient within relative 1e-4 (those that are 0 in exact
    arithmetic within 1e-4 of their group's largest), the statistics
    within 1e-5."""
    from tests.test_torch_train import _by_name, _jax_step

    _, variables, ref_loss, grads, stats, _ = _jax_step()
    got = ranks["ranks"][r]["flagship"]
    assert abs(got["metrics"]["total_loss"] - ref_loss) <= 1e-5 * abs(
        ref_loss)
    ref = _by_name({"params": grads, "batch_stats": variables["batch_stats"]})
    fed = _zero_grads()
    scale = _group_scale({k: torch.from_numpy(np.asarray(v))
                          for k, v in ref.items() if k not in fed})
    for k, g in got["grads"].items():
        if k in fed:
            err = np.abs(g.numpy() - ref[k]).max()
            assert err <= 1e-4 * scale[k.split(".")[0]], k
        else:
            assert _rel(g, ref[k]) <= 1e-4, k
    ref_stats = _by_name({"params": variables["params"],
                          "batch_stats": stats})
    for k, v in ref_stats.items():
        if k.endswith(("running_mean", "running_var")):
            assert _rel(got["state"][k], v) <= 1e-5, k


@pytest.mark.parametrize("r", range(RANKS))
def test_backward_runs_k5_and_k6_on_the_rank_slab(ranks, r):
    """K1 fills the rank's slab; the backward recomputes that slab's
    samples with K5 and scatters them with K6."""
    got = ranks["ranks"][r]["flagship"]
    slab = (r * S // RANKS, S // RANKS)
    assert got["slab"] == slab
    assert got["seen"] == [("unproject_agg", slab), ("sample_views_t", slab),
                           ("sample_views_grad_t", slab)]


def test_collectives_of_the_step(ranks):
    """At 32^3 over 2 ranks: one exchange per k > 1 convolution of a split
    level in the forward and as many in the backward (35: V2V's 41 less
    the 1^3 level's 6), three gathers (the volume before the pool to 1^3;
    the volume and its coordinates for the CE) and two reduce-scatters
    (the coordinates need none), and the sums: two a split BatchNorm (44
    of V2V's 51: the 1^3 level's 6 and the upsample out of it run whole),
    the soft-argmax's (with a backward) and its maximum (without)."""
    for rank in ranks["ranks"]:
        stats = rank["flagship"]["stats"]
        assert stats["exchanges"] == stats["back_exchanges"] == 35
        assert stats["gathers"] == 3 and stats["back_gathers"] == 2
        assert stats["reductions"] == 2 * 44 + 2
        assert stats["back_reductions"] == 2 * 44 + 1
        assert stats["halo_bytes"] > 0


# ---------------------------------------------------------------------------
# The collectives' backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", range(RANKS))
def test_exchange_backward_passes_gradcheck(ranks, r):
    res = ranks["ranks"][r]["gradcheck"]
    assert res["gradcheck"] is True, res["gradcheck"]
    assert res["stats"]["back_exchanges"] > 0
    assert res["stats"]["back_gathers"] > 0


# ---------------------------------------------------------------------------
# 'conf' (the unfused path) and remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", range(RANKS))
def test_conf_step_on_slabs_matches_one_process(ranks, r):
    got, ref = ranks["ranks"][r]["conf"], ranks["one"]["conf"]
    loss, ref_loss = got["metrics"]["total_loss"], \
        ref["metrics"]["total_loss"]
    assert abs(loss - ref_loss) <= CONF_LOSS_TOL * abs(ref_loss)
    assert got["grads"].keys() == ref["grads"].keys()
    for grp in factory.GROUPS:
        names = [k for k in ref["grads"] if k.startswith(grp + ".")]
        num = sum(float(((got["grads"][k] - ref["grads"][k]) ** 2).sum())
                  for k in names)
        den = sum(float((ref["grads"][k] ** 2).sum()) for k in names)
        assert np.sqrt(num / den) <= CONF_GRAD_L2, grp


@pytest.mark.parametrize("r", range(RANKS))
def test_remat_on_slabs_is_exact(ranks, r):
    """remat: true on slabs recomputes each block's forward in the
    backward, its exchanges and reductions included: the step equals the
    step without remat bit for bit (loss, gradients, statistics,
    parameters), and the forward's exchanges are counted again by the
    recompute."""
    rem = ranks["ranks"][r]["remat"]
    assert rem["equal"]
    stats, plain = rem["stats"], rem["plain_stats"]
    assert stats["back_exchanges"] == plain["back_exchanges"]
    assert stats["exchanges"] > plain["exchanges"]


# ---------------------------------------------------------------------------
# BatchNorm's two traps
# ---------------------------------------------------------------------------

WHOLE_LEVELS = ("volume_net.encoder_decoder.encoder_res5.",
                "volume_net.encoder_decoder.mid_res.",
                "volume_net.encoder_decoder.decoder_res5.",
                "volume_net.encoder_decoder.decoder_upsample5.")


@pytest.mark.parametrize("r", range(RANKS))
def test_whole_levels_take_their_own_statistics(ranks, r):
    """The 1^3 level, which every rank holds whole, and the upsample out of
    it, which runs whole before its output is cut to the rank's planes,
    normalize with their own statistics (no sum over the ranks: 7
    BatchNorm layers); every other V2V BatchNorm with the group's, over
    the ranks' own planes."""
    bn = ranks["ranks"][r]["flagship"]["bn"]
    v2v_bn = {k: v for k, v in bn.items() if k.startswith("volume_net.")}
    whole = {k for k in v2v_bn if k.startswith(WHOLE_LEVELS)}
    assert len(v2v_bn) == 51 and len(whole) == 7
    for k, split in v2v_bn.items():
        assert split == (k not in whole), k


@pytest.mark.parametrize("r", range(RANKS))
def test_backbone_batchnorm_takes_no_slab_group(ranks, r):
    """The backbone runs the whole batch on every rank: none of its
    BatchNorm layers takes the group's statistics or a process group."""
    bn = ranks["ranks"][r]["flagship"]["bn"]
    backbone = {k: v for k, v in bn.items() if k.startswith("backbone.")}
    assert len(backbone) > 10 and not any(backbone.values())
    model = factory.make_model(cfg.load_config(FLAGSHIP_YAML, SMALL),
                               device="cpu")
    assert all(m.process_group is None for m in model.backbone.modules()
               if isinstance(m, BatchNorm))


# ---------------------------------------------------------------------------
# run
# ---------------------------------------------------------------------------

def _train_records(experiment):
    with open(pathlib.Path(experiment) / "metrics.jsonl") as f:
        return [rec for rec in map(json.loads, f) if rec["tag"] == "train"]


def test_run_trains_on_two_ranks_as_one_process(ranks):
    """The master's first step's loss equals one process's (float32, within
    1e-5), both ranks return the same metric, only the master writes, and
    the resumed run trains on from the checkpoint (step 1, epoch 1's
    checkpoint)."""
    (m0, exp0, wrote0), (m1, exp1, wrote1) = (
        (rank["cli"]["metric"], rank["cli"]["experiment"],
         rank["cli"]["wrote"]) for rank in ranks["ranks"])
    assert m0 == m1 and exp0 == exp1
    assert wrote0 and len(wrote0) == 2 and not wrote1
    got = ranks["ranks"][0]["cli"]["records"]
    ref = ranks["one"]["cli_records"]
    assert [rec["step"] for rec in got] == [rec["step"] for rec in ref] \
        == [0]
    assert abs(got[0]["total_loss"] - ref[0]["total_loss"]) <= 1e-5 * abs(
        ref[0]["total_loss"])
    ((records, checkpoint),) = ranks["ranks"][0]["cli"]["resumed"]
    assert [rec["step"] for rec in records] == [1] and checkpoint
