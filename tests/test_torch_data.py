"""The port's data layer against lt_tpu's, on the CPU: the image utilities,
the native JPEG pipeline, BatchIterator's order, shards and prefetch, and
the Human3.6M and CMU Panoptic datasets and evaluators on small trees in
their on-disk layouts (``chip_smoke.write_h36m_tree`` /
``write_panoptic_tree``, 160^2 and 192 x 108 frames).

Geometry is held exactly and images bit for bit where both packages decode
with the same reader (each's copy of the native pipeline, or cv2);
evaluators within relative 1e-6; each decoder against cv2 within
``tests/test_native.py``'s limits.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from lt_tpu import native as j_native  # noqa: E402
from lt_tpu.data import batch as j_batch  # noqa: E402
from lt_tpu.data.cmu_panoptic import \
    CMUPanopticMultiViewDataset as JCMU  # noqa: E402
from lt_tpu.data.human36m import \
    Human36MMultiViewDataset as JH36M  # noqa: E402
from lt_tpu.engine.train import _partial_evaluate as j_partial  # noqa: E402
from lt_tpu.utils import img as j_img  # noqa: E402
from lt_tpu_torch import native  # noqa: E402
from lt_tpu_torch.data import batch  # noqa: E402
from lt_tpu_torch.data.cmu_panoptic import \
    CMUPanopticMultiViewDataset  # noqa: E402
from lt_tpu_torch.data.human36m import Human36MMultiViewDataset  # noqa: E402
from lt_tpu_torch.engine import train as engine  # noqa: E402
from lt_tpu_torch.utils import cfg  # noqa: E402
from lt_tpu_torch.utils import img  # noqa: E402

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

N_TEST, N_TRAIN, FRAME, SHAPE = 9, 5, 160, (64, 64)
CAMS = list(chip_smoke.PANOPTIC_CAMERAS)
H36M_YAML = "experiments/human36m/eval/human36m_vol_softmax.yaml"


@pytest.fixture(scope="module")
def h36m(tmp_path_factory):
    return chip_smoke.write_h36m_tree(tmp_path_factory.mktemp("h36m"),
                                      seed=0, frame=FRAME, n_test=N_TEST,
                                      n_train=N_TRAIN)


@pytest.fixture(scope="module")
def panoptic(tmp_path_factory):
    return chip_smoke.write_panoptic_tree(
        str(tmp_path_factory.mktemp("panoptic")), seed=1, size=(192, 108),
        n_frames=21, image_every=2)


def _h36m_kwargs(tree, **extra):
    return dict(h36m_root=tree["h36m_root"], labels_path=tree["labels_path"],
                image_shape=SHAPE, with_damaged_actions=True, scale_bbox=1.0,
                kind="human36m", undistort_images=True, **extra)


def _same_sample(a, b, images_exact=True):
    assert a["view_valid"] == b["view_valid"]
    assert a["indexes"] == b["indexes"]
    for key in ("detections", "cameras_R", "cameras_t", "cameras_K",
                "proj_matrices"):
        for x, y in zip(a[key], b[key]):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a["keypoints_3d"], b["keypoints_3d"])
    for key in ("pred_keypoints_3d",):
        assert (key in a) == (key in b)
        if key in a:
            np.testing.assert_array_equal(a[key], b[key])
    for x, y in zip(a["images"], b["images"]):
        assert (x is None) == (y is None)
        if x is not None and images_exact:
            np.testing.assert_array_equal(x, y)


def _flat(tree, prefix=()):
    """A nested dict of numbers as {path: value}."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, prefix + (key,)).items()}
    return {prefix: float(tree)}


def assert_same_metric(got, want, rel=1e-6):
    """Two evaluators' breakdowns: the same entries, each within ``rel``
    (NaN where the other has NaN)."""
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    keys = sorted(got)
    np.testing.assert_allclose([got[k] for k in keys],
                               [want[k] for k in keys], rtol=rel)


# -- utils/img.py ------------------------------------------------------------

@pytest.mark.parametrize("bbox", [(10, 20, 90, 100), (-10, -5, 50, 70),
                                  (100, 100, 200, 180), (0, 0, 120, 160)])
def test_crop_image_is_lt_tpus(bbox):
    image = np.random.RandomState(0).randint(0, 256, (120, 160, 3),
                                             np.uint8)
    np.testing.assert_array_equal(img.crop_image(image, bbox),
                                  j_img.crop_image(image, bbox))


@pytest.mark.parametrize("hw, shape", [((300, 300), (64, 64)),
                                       ((50, 60), (96, 96)),
                                       ((97, 53), (40, 70))])
def test_resize_image_is_lt_tpus(hw, shape):
    image = np.random.RandomState(1).randint(0, 256, hw + (3,), np.uint8)
    np.testing.assert_array_equal(img.resize_image(image, shape),
                                  j_img.resize_image(image, shape))


@pytest.mark.parametrize("bbox", [(10, 20, 90, 60), (5, 5, 25, 95),
                                  (10.5, 3.25, 80.0, 40.75)])
@pytest.mark.parametrize("scale", [1.0, 1.2, 1.5])
def test_bbox_math_is_lt_tpus(bbox, scale):
    assert img.get_square_bbox(bbox) == j_img.get_square_bbox(bbox)
    assert img.scale_bbox(bbox, scale) == j_img.scale_bbox(bbox, scale)


def test_normalization_is_lt_tpus():
    image = np.random.RandomState(2).randint(0, 256, (8, 9, 3), np.uint8)
    norm = img.normalize_image(image)
    np.testing.assert_array_equal(norm, j_img.normalize_image(image))
    np.testing.assert_array_equal(img.denormalize_image(norm),
                                  j_img.denormalize_image(norm))
    np.testing.assert_allclose(img.denormalize_image(norm), image, atol=1e-3)


# -- native/ -----------------------------------------------------------------

@pytest.fixture(scope="module")
def jpeg(tmp_path_factory):
    rng = np.random.RandomState(0)
    image = cv2.GaussianBlur(rng.randint(0, 255, (120, 160, 3)).astype(
        np.uint8), (0, 0), 3)
    path = str(tmp_path_factory.mktemp("jpeg") / "test.jpg")
    cv2.imwrite(path, image, [cv2.IMWRITE_JPEG_QUALITY, 98])
    return path


def test_native_builds_outside_the_package():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    root = Path(__file__).resolve().parents[1]
    assert native.lib_path().parent == root / "build" / "native"
    assert not list((root / "lt_tpu_torch" / "native").glob("*.so"))


def test_native_decode_is_lt_tpus_and_near_cv2(jpeg):
    got = native.decode_jpeg(jpeg)
    np.testing.assert_array_equal(got, j_native.decode_jpeg(jpeg))
    assert np.abs(got.astype(int) - cv2.imread(jpeg).astype(int)).mean() < 2


@pytest.mark.parametrize("bbox", [(-10, 20, 150, 180), (0, 0, 120, 120),
                                  (30, 10, 60, 40)])
@pytest.mark.parametrize("out", [(64, 64), (96, 96)])
def test_native_process_is_lt_tpus_and_near_cv2(jpeg, bbox, out):
    image = cv2.imread(jpeg)
    got = native.process_image(image, bbox, out)
    np.testing.assert_array_equal(got, j_native.process_image(image, bbox,
                                                              out))
    ref = img.normalize_image(img.resize_image(img.crop_image(image, bbox),
                                               out))
    assert np.abs(got - ref).mean() < 0.05 and np.abs(got - ref).max() < 0.6


def test_native_batch_fails_only_the_files_it_cannot_decode(jpeg, tmp_path):
    """A missing file and a PNG under a .jpg name fail their own entries
    (libjpeg's errors return; its default handler would end the process);
    the rest equal lt_tpu's loader's, whatever the thread."""
    png = str(tmp_path / "png.jpg")
    cv2.imwrite(str(tmp_path / "x.png"), cv2.imread(jpeg))
    Path(tmp_path / "x.png").rename(png)
    paths = [jpeg] * 6 + ["/nonexistent.jpg", png]
    boxes = np.tile(np.array([0, 0, 120, 120], np.int32), (8, 1))
    got, ok = native.NativeBatchLoader(n_threads=4).load(paths, boxes,
                                                         (48, 48))
    ref, ref_ok = j_native.NativeBatchLoader(n_threads=2).load(
        paths[:7], boxes[:7], (48, 48))
    assert ok.tolist() == [True] * 6 + [False, False]
    assert ref_ok.tolist() == ok[:7].tolist()
    np.testing.assert_array_equal(got[:6], ref[:6])
    assert native.decode_jpeg(png) is None


# -- data/batch.py -----------------------------------------------------------

class _Indexed:
    """A dataset of ``n`` one-view samples that carry their index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"images": [np.full((2, 2, 3), i, np.float32)] * 3,
                "view_valid": [True, True, i % 4 != 0],
                "detections": [np.zeros(5, np.float32)] * 3,
                "proj_matrices": [np.eye(3, 4, dtype=np.float32)] * 3,
                "cameras_R": [np.eye(3, dtype=np.float32)] * 3,
                "cameras_t": [np.zeros((3, 1), np.float32)] * 3,
                "cameras_K": [np.eye(3, dtype=np.float32)] * 3,
                "keypoints_3d": np.full((2, 4), i, np.float32),
                "indexes": i}


def _batches(it_cls, ds, epoch, **kw):
    out = []
    for b in it_cls(ds, **kw).epoch(epoch):
        out.append((b["indexes"].tolist(), b["view_mask"].tolist(),
                    b["images"][:, :, 0, 0, 0].tolist()))
    return out


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=True, seed=7),
    dict(batch_size=4, shuffle=False, drop_last=False),
    dict(batch_size=3, shuffle=True, seed=1, shard_id=1, num_shards=3),
    dict(batch_size=5, shuffle=True, seed=3, drop_last=False, num_shards=2),
    dict(batch_size=4, shuffle=True, seed=2, randomize_n_views=True,
         min_n_views=1, max_n_views=2)])
@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("epoch", [0, 1])
def test_batch_iterator_order_is_lt_tpus(kw, prefetch, epoch):
    ds = _Indexed(22)
    got = _batches(batch.BatchIterator, ds, epoch, prefetch=prefetch, **kw)
    ref = _batches(j_batch.BatchIterator, ds, epoch, prefetch=0, **kw)
    assert got == ref and got
    assert len(batch.BatchIterator(ds, **kw)) == len(
        j_batch.BatchIterator(ds, **kw))


def test_batch_iterator_shards_partition_an_epoch():
    ds = _Indexed(24)
    seen = [i for shard in range(3) for idx, _, _ in _batches(
        batch.BatchIterator, ds, 0, batch_size=2, seed=5, shard_id=shard,
        num_shards=3) for i in idx]
    assert sorted(seen) == list(range(24))


def test_batch_iterator_stops_its_producer_early():
    it = batch.BatchIterator(_Indexed(40), batch_size=2, prefetch=2)
    for i, _ in enumerate(it.epoch(0)):
        if i == 1:
            break
    assert len([b for b in it.epoch(0)]) == 20


# -- data/human36m.py --------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("native_loader", [True, False])
def test_h36m_samples_are_lt_tpus(h36m, train, native_loader):
    """Geometry exact; images bit for bit on the same reader (each
    package's native pipeline, or cv2); the test rows carry the
    predictions; one view of test row 3 is missing."""
    kw = _h36m_kwargs(h36m, train=train, test=not train,
                      use_native_loader=native_loader,
                      pred_results_path=None if train
                      else h36m["pred_results_path"])
    ds, ref = Human36MMultiViewDataset(**kw), JH36M(**kw)
    assert len(ds) == len(ref) == (N_TRAIN if train else N_TEST)
    assert ds.native_batches == native_loader == ref._fast_path
    assert ds.decoder.startswith("native" if native_loader else "cv2")
    for i in range(len(ds)):
        _same_sample(ds[i], ref[i])
    idxs = list(range(len(ds)))[::-1]
    for a, b in zip(ds.get_batch(idxs), ref.get_batch(idxs)):
        _same_sample(a, b)
    if not train:
        assert ds[3]["view_valid"] == [True, False, True, True]
    assert ds.fallbacks == 0


def test_h36m_native_batch_counts_its_fallbacks(h36m, tmp_path):
    """A frame libjpeg cannot decode (a PNG under its .jpg name, which
    cv2 reads by content) takes the cv2 path and is counted."""
    ds = Human36MMultiViewDataset(**_h36m_kwargs(h36m, test=True))
    _, tasks = ds._sample_meta(0)
    path = tasks[2][1]
    png = str(tmp_path / "frame.png")
    cv2.imwrite(png, cv2.imread(path))
    original = Path(path).read_bytes()
    try:
        Path(path).write_bytes(Path(png).read_bytes())
        got = ds.get_batch([0, 1])
        assert ds.fallbacks == 1
        cv2_ds = Human36MMultiViewDataset(**_h36m_kwargs(
            h36m, test=True, use_native_loader=False))
        np.testing.assert_array_equal(got[0]["images"][tasks[2][0]],
                                      cv2_ds[0]["images"][tasks[2][0]])
    finally:
        Path(path).write_bytes(original)


@pytest.mark.parametrize("extra", [
    dict(retain_every_n_frames_in_test=2),
    dict(ignore_cameras=[0, 2]),
    dict(crop=False),
    dict(scale_bbox=1.5),
    dict(image_shape=None, crop=False),
])
def test_h36m_options_are_lt_tpus(h36m, extra):
    kw = {**_h36m_kwargs(h36m, test=True, use_native_loader=False),
          **extra, "pred_results_path": h36m["pred_results_path"]}
    ds, ref = Human36MMultiViewDataset(**kw), JH36M(**kw)
    assert len(ds) == len(ref) and ds.n_views == ref.n_views
    for i in range(len(ds)):
        _same_sample(ds[i], ref[i])


def test_h36m_split_damaged_actions_and_paths_are_lt_tpus(h36m, tmp_path):
    """The reference's damaged S9 actions leave the test split unless
    asked for; ``undistort_images`` only changes the frames' directory."""
    labels = np.load(h36m["labels_path"], allow_pickle=True).item()
    labels["action_names"] = ["Greeting-2", "SittingDown-2", "Waiting-1",
                              "Walking-2"]
    path = str(tmp_path / "labels.npy")
    np.save(path, labels, allow_pickle=True)
    for damaged in (True, False):
        kw = dict(h36m_root=h36m["h36m_root"], labels_path=path, test=True,
                  with_damaged_actions=damaged, kind="human36m")
        ds, ref = Human36MMultiViewDataset(**kw), JH36M(**kw)
        np.testing.assert_array_equal(ds.labels["table"],
                                      ref.labels["table"])
        assert (len(ds) == N_TEST) == damaged
    for undistort in (True, False):
        kw = {**_h36m_kwargs(h36m, test=True), "undistort_images": undistort}
        ds, ref = Human36MMultiViewDataset(**kw), JH36M(**kw)
        assert ds._sample_meta(1)[1] == ref._sample_meta(1)[1]
        assert ("-undistorted" in ds._sample_meta(1)[1][0][1]) == undistort


@pytest.mark.parametrize("transfer", [None, "transfer_cmu_to_human36m",
                                      "transfer_human36m_to_human36m"])
def test_h36m_evaluate_is_lt_tpus(h36m, transfer):
    """The per-subject, per-action breakdown (trials merged; subjects with
    no frame NaN), absolute and relative, within relative 1e-6."""
    kw = _h36m_kwargs(h36m, test=True)
    ds, ref = Human36MMultiViewDataset(**kw), JH36M(**kw)
    pred = ds.labels["table"]["keypoints"] + np.random.RandomState(4).normal(
        0, 30, (N_TEST, 17, 3)).astype(np.float32)
    extra = {transfer: True} if transfer else {}
    got, want = ds.evaluate(pred, **extra), ref.evaluate(pred, **extra)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert_same_metric(got[1], want[1])
    for kind in got[1]:
        assert set(got[1][kind]) == {"Average", *chip_smoke.H36M_SUBJECTS}
        for actions in got[1][kind].values():
            assert set(actions) == {"Average", "Directions", "Walking"}
    assert math.isnan(got[1]["per_pose_error"]["S1"]["Average"])


@pytest.mark.parametrize("kind", ["human36m", "cmu", "coco"])
def test_partial_evaluate_is_lt_tpus(h36m, panoptic, kind):
    if kind == "cmu":
        ds = CMUPanopticMultiViewDataset(panoptic["panoptic_root"],
                                         ["171204_pose3"], CAMS, test=True,
                                         retain_every_n_frames=2)
    else:
        ds = Human36MMultiViewDataset(**_h36m_kwargs(h36m, test=True))
    idx = np.array([0, 2, 3, len(ds) - 1])
    gt = np.stack([ds.keypoints_world(int(i)) for i in idx])
    pred = gt + np.random.RandomState(5).normal(0, 25, gt.shape).astype(
        np.float32)
    got = engine._partial_evaluate(ds, pred, idx, kind=kind)
    want = j_partial(ds, pred, idx, kind=kind)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert_same_metric(got[1], want[1])


# -- data/cmu_panoptic.py ----------------------------------------------------

@pytest.mark.parametrize("cams, retain", [(CAMS, 2), (None, 4),
                                          (CAMS[::-1][:3], 2)])
def test_cmu_samples_and_evaluate_are_lt_tpus(panoptic, cams, retain):
    """HD cameras only, in the asked order; the empty scene skipped; cm to
    mm; the bbox of the projected joints; images bit for bit (both cv2);
    the evaluator within relative 1e-6."""
    kw = dict(panoptic_root=panoptic["panoptic_root"],
              sequences=["171204_pose3"], camera_names=cams, test=True,
              retain_every_n_frames=retain, image_shape=SHAPE)
    ds, ref = CMUPanopticMultiViewDataset(**kw), JCMU(**kw)
    assert len(ds) == len(ref) == len(range(0, 20, retain))
    assert [c["name"] for c in ds.cameras[0]] == [c["name"] for c in
                                                  ref.cameras[0]]
    np.testing.assert_array_equal(ds.table["keypoints"],
                                  ref.table["keypoints"])
    for i in range(len(ds)):
        _same_sample(ds[i], ref[i])
    assert ds.decoder.startswith("cv2")
    pred = ds.table["keypoints"][:, :, :3] + np.random.RandomState(6).normal(
        0, 20, (len(ds), 19, 3)).astype(np.float32)
    got, want = ds.evaluate(pred), ref.evaluate(pred)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert_same_metric(got[1], want[1])
    assert set(got[1]["per_pose_error"]["Average"]) == {"Average",
                                                        "171204_pose3"}


# -- engine: make_datasets ---------------------------------------------------

def test_make_datasets_reads_the_configs_as_lt_tpu(h36m, panoptic):
    config = cfg.load_config(H36M_YAML, {
        **chip_smoke.h36m_overrides(h36m), "image_shape": list(SHAPE)})
    train, val = engine.make_datasets(config, is_train=False)
    assert train is None and len(val) == N_TEST
    assert val.scale_bbox == 1.0 and val.undistort_images
    assert val.keypoints_3d_pred is not None and val.num_keypoints == 17
    config = cfg.load_config(
        "experiments/cmu_panoptic/eval/cmu_vol_softmax.yaml",
        {"dataset.val.panoptic_root": panoptic["panoptic_root"],
         "dataset.val.retain_every_n_frames": 2})
    _, val = engine.make_datasets(config, is_train=False)
    assert len(val) == 10 and val.scale_bbox == 1.2
    it = engine.make_iterator(val, config.dataset.val, 20, 42, train=False)
    assert it.num_workers == 4 and not it.shuffle and not it.drop_last


def test_make_datasets_refuses_an_unknown_kind():
    config = cfg.load_config(H36M_YAML, {"dataset.kind": "mpii"})
    with pytest.raises(NotImplementedError, match="mpii"):
        engine.make_datasets(config)
