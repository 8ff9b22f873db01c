"""Volume-axis (spatial) sharding in lt_tpu_torch on the CPU: two gloo
ranks, spawned once for the module with a ``file://`` rendezvous under
``tmp_path``, torch on one thread each.

The geometry is ``lt_tpu``'s own test's (``tests/test_parallel.py``'s
spatial case): RN-18, 2 views of 64^2, 5 joints, a 32^3 volume, batch 1,
the "fused" path (the kernels' plain versions on the CPU), with seeded
random weights of ``lt_tpu``'s variable shapes (``jax.eval_shape`` of its
init, which takes 20 s to compile here; BatchNorm statistics not 0 and
1) moved through ``utils/weights.py``.  The
pelvis keypoints have 17 joints (``lt_tpu``'s test passes 5, and JAX
clamps the 'mpii' pelvis index 6 to 4; the port would raise).

- The port's 2-rank sharded forward against ``lt_tpu``'s on a 2-device
  mesh: keypoints rtol 1e-4, atol 1e-3 mm, ``lt_tpu``'s own tolerance
  between its sharded and unsharded forward.
- Against the port's unsharded forward (run once, here, on one thread
  as the ranks run): each rank's rows of V2V's output (relative 1e-5) and
  of the normalized volume, K1's slab equal to the cube's rows bit for
  bit, the slab of the coordinate volume likewise, the keypoints.
- ``SlabGroup``'s exchanges (``extend_x`` / ``crop_x`` / ``gather_x`` /
  ``take_slab``, one exchange of two slabs) on a seeded tensor, and the
  2-rank soft-argmax in float64 within 1e-12 of the whole volume's.
- The refusals: the gcd rule, in the model and in a training step and
  ``run`` (a world size that does not divide the volume: ROADMAP A8 (e)),
  and the "conv" and ``False`` paths.  Training under the key is
  tests/test_torch_spatial_train.py.
- ``run(eval_only=True)`` on experiments/synthetic/vol_tiny.yaml with
  ``model.volume_axis_sharding: true`` (one val batch of 2 at 64^2), two
  ranks against one process: the metric within 1e-3 mm, only the master
  writes.

JAX is imported inside the tests, so that the spawned ranks import torch
only.  Torch runs on 2 threads in this process, as in the other files
that spawn or train.
"""

import os
import pathlib
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lt_tpu_torch.engine.train import run
from lt_tpu_torch.models.triangulation import VolumetricTriangulationNet
from lt_tpu_torch.ops import heatmaps as hm_ops
from lt_tpu_torch.parallel import SlabGroup
from lt_tpu_torch.parallel.spatial import slab_group

ROOT = pathlib.Path(__file__).resolve().parents[1]
VOL_TINY = str(ROOT / "experiments/synthetic/vol_tiny.yaml")
RANKS = 2
S, J, V, IMAGE = 32, 5, 2, 64
KW = dict(num_joints=J, num_layers=18, volume_size=S, cuboid_side=2500.0,
          volume_aggregation_method="softmax", kind="mpii")
KP_RTOL, KP_ATOL_MM = 1e-4, 1e-3        # lt_tpu's sharded vs unsharded
V2V_REL = 1e-5
# One val batch of 2 poses at 64^2: the config's 8 poses at 128^2 cost
# each rank several seconds of V2V and backbone on its one thread.
CLI_OVERRIDES = {"dataset.val.n_samples": 2, "opt.val_batch_size": 2,
                 "image_shape": [64, 64]}


def _geometry():
    """lt_tpu's spatial test's batch: two cameras on a ring 3 m out looking
    at the origin, random images; 17 pelvis keypoints."""
    rng = np.random.RandomState(0)
    images = rng.randn(1, V, IMAGE, IMAGE, 3).astype(np.float32)
    proj = np.zeros((1, V, 3, 4), np.float32)
    for i in range(V):
        ang = 2 * np.pi * i / V + 0.3
        center = np.array([3000 * np.cos(ang), 3000 * np.sin(ang), 1200.0])
        z = -center / np.linalg.norm(center)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        rot = np.stack([x, np.cross(z, x), z])
        k = np.array([[IMAGE * 1.2, 0, IMAGE / 2],
                      [0, IMAGE * 1.2, IMAGE / 2], [0, 0, 1.0]])
        proj[:, i] = k @ np.hstack([rot, -rot @ center.reshape(3, 1)])
    pelvis = rng.uniform(-200, 200, (1, 17, 3)).astype(np.float32)
    return images, proj, pelvis


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rank_main(r, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdzv",
                            rank=r, world_size=RANKS)
    try:
        res = {}
        for part in (_forwards, _exchanges, _soft_argmax, _refusals, _cli):
            res.update(part(r, out_dir))
        torch.save(res, f"{out_dir}/rank{r}.pt")
    finally:
        dist.destroy_process_group()


def _forward(out_dir, group):
    """The model from the saved weights, its volume split over ``group``
    or not: its keypoints, K1's and V2V's outputs (hooks), normalized and
    coordinate volumes and, sharded, the rank's slab and collectives."""
    model = VolumetricTriangulationNet(**KW, device="cpu",
                                       volume_axis_sharding=group)
    model.load_state_dict(torch.load(f"{out_dir}/weights.pt"))
    seen = {}
    for mod in ("unproject", "volume_net"):
        getattr(model, mod).register_forward_hook(
            lambda m, a, out, mod=mod: seen.__setitem__(mod, out))
    out = model(*(torch.from_numpy(a) for a in _geometry()))
    seen.update(keypoints=out.keypoints_3d, volumes=out.volumes,
                coord_volumes=out.coord_volumes)
    if group is not None:
        seen["slab_of"] = model.volume_axis_sharding.slab(S)
        seen["stats"] = dict(model.volume_axis_sharding.stats)
    return seen


def _forwards(r, out_dir):
    return {"forward": _forward(out_dir, dist.group.WORLD)}


def _exchanges(r, out_dir):
    g = SlabGroup(dist.group.WORLD, S)
    gen = torch.Generator().manual_seed(7)
    whole = torch.randn((2, 8, 3, 2, 3), generator=gen)
    other = torch.randn((2, 4, 3, 2, 5), generator=gen)
    slab, slab2 = g.take_slab(whole), g.take_slab(other)
    res = {"take": torch.equal(slab, whole[:, 4 * r:4 * r + 4]),
           "gather": torch.equal(g.gather_x(slab), whole),
           "gather_dim2": torch.equal(
               g.gather_x(slab.transpose(1, 2), dim=2),
               whole.transpose(1, 2))}
    for reach in (0, 1, 3, 4):
        ext = g.extend_x(slab, reach)
        res[f"extend{reach}"] = torch.equal(ext, g.take_slab(whole, reach))
        res[f"crop{reach}"] = torch.equal(g.crop_x(ext, reach), slab)
    a, b = g.exchange([(slab, 2), (slab2, 1)])
    res["exchange_two"] = (torch.equal(a, g.take_slab(whole, 2))
                           and torch.equal(b, g.take_slab(other, 1)))
    res["halo_bytes"] = g.stats["halo_bytes"]
    return {"exchanges": res}


def _soft_argmax(r, out_dir):
    """The 2-rank soft-argmax in float64 against the whole volume's."""
    g = SlabGroup(dist.group.WORLD, S)
    gen = torch.Generator().manual_seed(3)
    vol = torch.randn((2, 8, 6, 4, J), generator=gen, dtype=torch.float64)
    coords = 1000.0 * torch.randn((2, 8, 6, 4, 3), generator=gen,
                                  dtype=torch.float64)
    res = {}
    for softmax in (True, False):
        ref = hm_ops.integrate_tensor_3d_with_coordinates_channels_last(
            vol, coords, softmax=softmax)
        got = hm_ops.integrate_tensor_3d_with_coordinates_channels_last(
            g.take_slab(vol), g.take_slab(coords), softmax=softmax, slabs=g)
        res[softmax] = (got, ref, g.slab(8))
    return {"soft_argmax": res}


def _refusals(r, out_dir):
    errors = {}

    def expect(name, exc, fn):
        try:
            fn()
        except exc as e:
            errors[name] = str(e)
        else:
            errors[name] = None

    expect("gcd", ValueError, lambda: SlabGroup(dist.group.WORLD, 33))
    for path in ("conv", False):
        expect(f"path {path}", NotImplementedError,
               lambda: VolumetricTriangulationNet(
                   **{**KW, "volume_size": 8}, use_kernels=path,
                   device="cpu", volume_axis_sharding=dist.group.WORLD))
    args = [torch.from_numpy(a) for a in _geometry()]
    expect("train", ValueError,
           lambda: VolumetricTriangulationNet(
               **{**KW, "volume_size": 9}, device="cpu",
               volume_axis_sharding=dist.group.WORLD).train()(
               *args, rotation_thetas=torch.zeros(1)))
    expect("run train", ValueError,
           lambda: run(VOL_TINY, f"{out_dir}/train_logs", device="cpu",
                       overrides={"model.volume_axis_sharding": True,
                                  "model.volume_size": 33}))
    return {"refusals": errors}


def _cli(r, out_dir):
    logdir = f"{out_dir}/logs{r}"
    metric = run(VOL_TINY, logdir, eval_only=True, device="cpu",
                 overrides={**CLI_OVERRIDES,
                            "model.volume_axis_sharding": True})
    return {"cli": (metric, os.path.isdir(logdir) and os.listdir(logdir))}


def _seeded_variables(shapes, seed=0):
    """numpy values for ``lt_tpu``'s variable shapes: kernels N(0, 1 /
    fan-in), BatchNorm scales 1 + N(0, 0.1), biases and means N(0, 0.1),
    variances U(0.5, 1.5)."""
    import jax

    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * rng.randn(*shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        return 0.1 * rng.randn(*shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: fill(p, x).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Seeded weights of lt_tpu's shapes, saved for the ranks; the ranks
    spawned while lt_tpu's 2-device sharded forward and the one-process
    CLI eval run here; each rank's results."""
    import jax
    import jax.numpy as jnp
    from lt_tpu.models.triangulation import VolumetricTriangulationNet as JVol
    from lt_tpu.parallel import mesh as jmesh
    from lt_tpu.parallel.spatial import volume_sharding

    from lt_tpu_torch.utils.weights import volumetric_state_dict

    out_dir = tmp_path_factory.mktemp("spatial")
    images, proj, pelvis = (jnp.asarray(a) for a in _geometry())
    model = JVol(**KW)
    variables = _seeded_variables(dict(jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "aug": jax.random.PRNGKey(1)},
        images, proj, pelvis))))
    torch.save(volumetric_state_dict(variables, 18), out_dir / "weights.pt")

    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(str(out_dir),), nprocs=RANKS, join=False,
        start_method="spawn")
    try:
        sharded = JVol(**KW, volume_axis_sharding=volume_sharding(
            jmesh.make_mesh(RANKS)))
        lt_kp = np.asarray(jax.jit(
            lambda vs, im, pm, pk: sharded.apply(
                vs, im, pm, pk, train=False).keypoints_3d)(
            variables, images, proj, pelvis))
        torch.set_num_threads(1)        # the ranks' rounding
        whole = _forward(out_dir, None)
        torch.set_num_threads(2)
        one = run(VOL_TINY, str(out_dir / "logs_one"), eval_only=True,
                  device="cpu", overrides=CLI_OVERRIDES)
        deadline = time.monotonic() + 300.0
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError("the ranks still run after 300 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in ctx.processes)
    return {"lt_tpu_keypoints": lt_kp, "one_process_metric": one,
            "whole": whole,
            "ranks": [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
                      for r in range(RANKS)]}


def _rel(got, ref):
    return ((got.double() - ref.double()).abs().max()
            / ref.double().abs().max()).item()


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", range(RANKS))
def test_sharded_forward_matches_lt_tpu_sharded(ranks, r):
    got = ranks["ranks"][r]["forward"]["keypoints"].numpy()
    np.testing.assert_allclose(got, ranks["lt_tpu_keypoints"],
                               rtol=KP_RTOL, atol=KP_ATOL_MM)


@pytest.mark.parametrize("r", range(RANKS))
def test_sharded_forward_matches_unsharded(ranks, r):
    """Each rank's rows of K1's volume (bit for bit), V2V's output and the
    normalized volume, the coordinate volume's slab (bit for bit), and the
    keypoints, against the unsharded forward on one thread."""
    whole, slab = ranks["whole"], ranks["ranks"][r]["forward"]
    x0, sx = slab["slab_of"]
    assert (x0, sx) == (r * S // RANKS, S // RANKS)
    assert torch.equal(slab["unproject"], whole["unproject"][:, x0:x0 + sx])
    assert torch.equal(slab["coord_volumes"],
                       whole["coord_volumes"][:, x0:x0 + sx])
    assert tuple(slab["volume_net"].shape) == (1, sx, S, S, J)
    assert _rel(slab["volume_net"],
                whole["volume_net"][:, x0:x0 + sx]) <= V2V_REL
    assert _rel(slab["volumes"], whole["volumes"][:, :, x0:x0 + sx]) <= V2V_REL
    np.testing.assert_allclose(slab["keypoints"].numpy(),
                               whole["keypoints"].numpy(), rtol=KP_RTOL,
                               atol=KP_ATOL_MM)


def test_sharded_forward_exchanges(ranks):
    """At 32^3 over 2 ranks the slabs are 16, 8, 4 on the way down; the
    encoder pair at 4^3 (reach 4 > 2) and every deeper call run whole after
    one gather; on the way up the calls out to 8^3, 16^3 and 32^3 exchange
    (the one out to 4^3 takes its rows of replicated inputs, and the one
    out to 2^3 runs whole): 4 + 3 exchanges, the soft-argmax's 2
    reductions."""
    for rank in ranks["ranks"]:
        stats = rank["forward"]["stats"]
        assert stats["exchanges"] == 7 and stats["gathers"] == 1
        assert stats["reductions"] == 2 and stats["halo_bytes"] > 0


@pytest.mark.parametrize("r", range(RANKS))
def test_exchanges_on_a_seeded_tensor(ranks, r):
    res = ranks["ranks"][r]["exchanges"]
    assert all(v for k, v in res.items() if k != "halo_bytes"), res
    # One neighbour each: 0 + 1 + 3 + 4 planes of (2, 3, 2, 3) float32,
    # then 2 of those and 1 of (2, 3, 2, 5).
    assert res["halo_bytes"] == 4 * (8 * 36 + 2 * 36 + 60)


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("r", range(RANKS))
def test_soft_argmax_reduces_over_ranks(ranks, r, softmax):
    (kp, vols), (kp_ref, vols_ref), (x0, sx) = \
        ranks["ranks"][r]["soft_argmax"][softmax]
    assert kp.dtype == torch.float64
    torch.testing.assert_close(kp, kp_ref, rtol=0,
                               atol=1e-12 * kp_ref.abs().max().item())
    torch.testing.assert_close(vols, vols_ref[:, :, x0:x0 + sx], rtol=0,
                               atol=1e-12 * vols_ref.abs().max().item())


@pytest.mark.parametrize("case, match", [
    ("gcd", "gcd"), ("path conv", "ROADMAP"), ("path False", "ROADMAP"),
    ("train", "ROADMAP"), ("run train", "ROADMAP")])
def test_refusals(ranks, case, match):
    for rank in ranks["ranks"]:
        msg = rank["refusals"][case]
        assert msg is not None, f"{case}: no error raised"
        assert match in msg


def test_cli_eval_two_ranks_matches_one_process(ranks):
    (m0, wrote0), (m1, wrote1) = (rank["cli"] for rank in ranks["ranks"])
    assert m0 == m1
    assert abs(m0 - ranks["one_process_metric"]) <= 1e-3
    assert wrote0 and not wrote1      # only the master writes


def test_one_rank_group_is_the_unsharded_model(tmp_path):
    """As lt_tpu's key does nothing on one device, a process group of one
    rank gives the unsharded model (no SlabGroup), and no group none."""
    assert slab_group(None, S) is None
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        model = VolumetricTriangulationNet(
            **{**KW, "volume_size": 8}, device="cpu",
            volume_axis_sharding=dist.group.WORLD)
        assert model.volume_axis_sharding is None
    finally:
        dist.destroy_process_group()
