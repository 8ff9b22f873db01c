"""Human3.6M multi-view dataset and its MPJPE evaluator (the port's own
copy of ``lt_tpu/data/human36m.py``).

Reads the reference's monolithic labels ``.npy`` (from its
``generate-labels-npy-multiview.py``): subject / action / frame indices,
17 x 3 world-mm keypoints, per-camera TLBR bboxes and per-(subject,
camera) R, t, K, dist.  Subjects S1, S5-S8 train, S9 and S11 test.  Each
view's frame is read (BGR, as ``cv2.imread``), cropped to its bbox with
zero padding, resized to ``image_shape``, ImageNet-normalized and given
channels last; K and the projection follow the crop and the resize.

Decoding: the native pipeline (``lt_tpu_torch.native``: libjpeg and the
fused crop / resize / normalize, a whole batch in one thread-pooled call)
where it builds, else cv2.  :attr:`decoder` says which and why; a JPEG
the native batch call cannot decode is read again on its own path and
counted in :attr:`fallbacks`.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from lt_tpu_torch import native as native_lib
from lt_tpu_torch.utils import img as img_utils

TRAIN_SUBJECTS = ["S1", "S5", "S6", "S7", "S8"]
TEST_SUBJECTS = ["S9", "S11"]
DAMAGED_ACTIONS = ("Greeting-2", "SittingDown-2", "Waiting-1")


def missing_view(sample: dict) -> None:
    """Append an empty view slot (no image, identity camera) to a sample."""
    sample["view_valid"].append(False)
    sample["images"].append(None)
    sample["detections"].append(np.zeros(5, np.float32))
    sample["cameras_R"].append(np.eye(3, dtype=np.float32))
    sample["cameras_t"].append(np.zeros((3, 1), np.float32))
    sample["cameras_K"].append(np.eye(3, dtype=np.float32))
    sample["proj_matrices"].append(np.eye(3, 4, dtype=np.float32))


def empty_sample() -> dict:
    return {"images": [], "detections": [], "cameras_R": [], "cameras_t": [],
            "cameras_K": [], "proj_matrices": [], "view_valid": []}


def first_error(text) -> str:
    """The first line of a build's output that names an error, else its
    last line."""
    lines = str(text).strip().splitlines() or [""]
    return next((x.strip() for x in lines if "error" in x), lines[-1])


def decoder_name(native, why_not: str = "") -> str:
    """The reader a dataset uses: the native pipeline, or cv2 and why."""
    if native is not None:
        return f"native libjpeg pipeline ({native.lib_path().name})"
    cv2 = img_utils.cv2
    version = "not installed" if cv2 is None else cv2.__version__
    return f"cv2 {version} ({why_not})"


class Human36MMultiViewDataset:
    """Multi-view Human3.6M over the reference's labels ``.npy``."""

    def __init__(self,
                 h36m_root: str,
                 labels_path: str,
                 pred_results_path: Optional[str] = None,
                 image_shape=(256, 256),
                 train: bool = False,
                 test: bool = False,
                 retain_every_n_frames_in_test: int = 1,
                 with_damaged_actions: bool = False,
                 scale_bbox: float = 1.5,
                 norm_image: bool = True,
                 kind: str = "mpii",
                 undistort_images: bool = False,
                 ignore_cameras=(),
                 crop: bool = True,
                 use_native_loader: bool = True):
        assert train or test, "need at least one of train/test"
        assert kind in ("mpii", "human36m")
        self.native = (native_lib if use_native_loader
                       and native_lib.available() else None)
        why_not = ("native pipeline not requested" if not use_native_loader
                   else "native pipeline unavailable: "
                   + first_error(native_lib.build_error()))
        self.decoder = decoder_name(self.native, why_not)
        self.fallbacks = 0
        self._batch_loader = None

        self.h36m_root = h36m_root
        self.image_shape = None if image_shape is None else tuple(image_shape)
        self.scale_bbox = scale_bbox
        self.norm_image = norm_image
        self.kind = kind
        self.undistort_images = undistort_images
        self.ignore_cameras = list(ignore_cameras)
        self.crop = crop
        # Per-sample loads read and decode files: BatchIterator's thread
        # pool pays off here.
        self.io_bound = True

        self.labels = np.load(labels_path, allow_pickle=True).item()
        n_cameras = len(self.labels["camera_names"])
        assert all(c in range(n_cameras) for c in self.ignore_cameras)

        subjects = self.labels["subject_names"]
        train_idx = [subjects.index(s) for s in TRAIN_SUBJECTS]
        test_idx = [subjects.index(s) for s in TEST_SUBJECTS]
        indices = []
        table = self.labels["table"]
        if train:
            mask = np.isin(table["subject_idx"], train_idx, assume_unique=True)
            indices.append(np.nonzero(mask)[0])
        if test:
            mask = np.isin(table["subject_idx"], test_idx, assume_unique=True)
            if not with_damaged_actions:
                mask_s9 = table["subject_idx"] == subjects.index("S9")
                damaged = [self.labels["action_names"].index(a)
                           for a in DAMAGED_ACTIONS]
                mask &= ~(mask_s9 & np.isin(table["action_idx"], damaged))
            indices.append(
                np.nonzero(mask)[0][::retain_every_n_frames_in_test])
        self.labels["table"] = table[np.concatenate(indices)]
        self.num_keypoints = 16 if kind == "mpii" else 17
        assert self.labels["table"]["keypoints"].shape[1] == 17, \
            "Use a newer labels file"

        self.keypoints_3d_pred = None
        if pred_results_path is not None:
            pred = np.load(pred_results_path, allow_pickle=True)
            kp = pred["keypoints_3d"][np.argsort(pred["indexes"])]
            self.keypoints_3d_pred = kp[::retain_every_n_frames_in_test]
            assert len(self.keypoints_3d_pred) == len(self), (
                f"{labels_path} has {len(self)} samples, but "
                f"{pred_results_path} has {len(self.keypoints_3d_pred)}")
        self.n_views = n_cameras - len(self.ignore_cameras)

    def __len__(self):
        return len(self.labels["table"])

    def _sample_meta(self, idx):
        """A sample without its pixels, and its ``(view slot, image path,
        bbox)`` loading tasks.  K and the projection follow the crop and
        the resize, which depend only on the bbox and ``image_shape``."""
        shot = self.labels["table"][idx]
        subject = self.labels["subject_names"][shot["subject_idx"]]
        action = self.labels["action_names"][shot["action_idx"]]
        sample, tasks = empty_sample(), []
        for camera_idx, camera_name in enumerate(self.labels["camera_names"]):
            if camera_idx in self.ignore_cameras:
                continue
            bbox = shot["bbox_by_camera_tlbr"][camera_idx][[1, 0, 3, 2]]
            if bbox[2] - bbox[0] == 0:  # an empty bbox: a missing view
                missing_view(sample)
                continue
            bbox = img_utils.scale_bbox(bbox, self.scale_bbox)
            image_path = os.path.join(
                self.h36m_root, subject, action,
                "imageSequence" + "-undistorted" * self.undistort_images,
                camera_name, "img_%06d.jpg" % (shot["frame_idx"] + 1))
            cam = self.labels["cameras"][shot["subject_idx"], camera_idx]
            R = np.array(cam["R"], np.float32)
            t = np.array(cam["t"], np.float32).reshape(3, 1)
            K = np.array(cam["K"], np.float32).copy()
            if self.crop:
                K[0, 2] -= bbox[0]
                K[1, 2] -= bbox[1]
                if self.image_shape is not None:
                    K[0] *= self.image_shape[1] / (bbox[2] - bbox[0])
                    K[1] *= self.image_shape[0] / (bbox[3] - bbox[1])
            tasks.append((len(sample["images"]), image_path, bbox))
            sample["images"].append(None)  # filled by the loading layer
            sample["detections"].append(
                np.array(list(bbox) + [1.0], np.float32))
            sample["cameras_R"].append(R)
            sample["cameras_t"].append(t)
            sample["cameras_K"].append(K)
            sample["proj_matrices"].append(
                (K @ np.hstack([R, t])).astype(np.float32))
            sample["view_valid"].append(True)

        kp = shot["keypoints"][:self.num_keypoints].astype(np.float32)
        sample["keypoints_3d"] = np.concatenate(
            [kp, np.ones((kp.shape[0], 1), np.float32)], axis=1)
        sample["indexes"] = idx
        if self.keypoints_3d_pred is not None:
            sample["pred_keypoints_3d"] = \
                self.keypoints_3d_pred[idx].astype(np.float32)
        return sample, tasks

    @property
    def native_batches(self) -> bool:
        """Whether the fused native pipeline covers this configuration
        (and :class:`BatchIterator` should call :meth:`get_batch`)."""
        return (self.native is not None and self.crop
                and self.image_shape is not None and self.norm_image)

    def _load_cv2(self, image_path, bbox):
        """The reference's path: read, crop, resize, normalize.  Returns
        the image and its (height, width) before the resize."""
        image = img_utils.read_image(image_path)
        if self.crop:
            image = img_utils.crop_image(image, bbox)
        dims = image.shape[:2]
        if self.image_shape is not None:
            image = img_utils.resize_image(image, self.image_shape)
        if self.norm_image:
            image = img_utils.normalize_image(image)
        return image, dims

    def _load_image(self, image_path, bbox):
        """One view's image: the native pipeline where it applies (a JPEG
        it cannot decode takes the cv2 path and counts as a fallback),
        else the cv2 path."""
        if self.native_batches:
            decoded = self.native.decode_jpeg(image_path)
            if decoded is not None:
                image = self.native.process_image(
                    decoded, bbox, self.image_shape, normalize=True)
                return image, (bbox[3] - bbox[1], bbox[2] - bbox[0])
            self.fallbacks += 1
        return self._load_cv2(image_path, bbox)

    def _fix_uncropped_intrinsics(self, sample, slot, dims):
        """crop=False with a resize: K scales by the frame's own size,
        which only the read image gives."""
        if self.crop or self.image_shape is None:
            return
        K = sample["cameras_K"][slot]
        K[0] *= self.image_shape[1] / dims[1]
        K[1] *= self.image_shape[0] / dims[0]
        R, t = sample["cameras_R"][slot], sample["cameras_t"][slot]
        sample["proj_matrices"][slot] = (
            K @ np.hstack([R, t])).astype(np.float32)

    def __getitem__(self, idx):
        """A sample: per-view lists (a missing view's slot empty) and
        ``view_valid`` flags for the static-shape collate."""
        sample, tasks = self._sample_meta(idx)
        for slot, image_path, bbox in tasks:
            image, dims = self._load_image(image_path, bbox)
            sample["images"][slot] = image
            self._fix_uncropped_intrinsics(sample, slot, dims)
        return sample

    def get_batch(self, idxs):
        """A batch of samples, every view decoded and processed in one
        thread-pooled native call where :attr:`native_batches`; a JPEG
        that call cannot decode takes the cv2 path (:attr:`fallbacks`)."""
        if not self.native_batches:
            return [self[int(i)] for i in idxs]
        if self._batch_loader is None:
            self._batch_loader = self.native.NativeBatchLoader()
        metas = [self._sample_meta(int(i)) for i in idxs]
        jobs = [(si, slot, path, bbox) for si, (_, tasks) in enumerate(metas)
                for slot, path, bbox in tasks]
        if jobs:
            out, ok = self._batch_loader.load(
                [j[2] for j in jobs], np.asarray([j[3] for j in jobs],
                                                 np.int32), self.image_shape)
            for (si, slot, path, bbox), image, good in zip(jobs, out, ok):
                if not good:
                    self.fallbacks += 1
                    image, _ = self._load_cv2(path, bbox)
                metas[si][0]["images"][slot] = image
        return [sample for sample, _ in metas]

    # -- evaluation ---------------------------------------------------------

    def keypoints_world(self, idx: int) -> np.ndarray:
        """(J, 3) world-mm ground truth from the labels table, no decode."""
        return self.labels["table"][idx]["keypoints"][
            :self.num_keypoints, :3].astype(np.float32)

    def evaluate_using_per_pose_error(self, per_pose_error):
        """Mean error per subject and per action, each action's two trials
        merged; ``Average`` over all.  A subject or action with no frame
        scores NaN."""
        table = self.labels["table"]

        def by_actions(mask=None):
            if mask is None:
                mask = np.ones_like(per_pose_error, dtype=bool)
            scores = {"Average": {
                "total_loss": per_pose_error[mask].sum(),
                "frame_count": int(np.count_nonzero(mask))}}
            for action_idx, name in enumerate(self.labels["action_names"]):
                err = per_pose_error[(table["action_idx"] == action_idx)
                                     & mask]
                scores[name] = {"total_loss": err.sum(),
                                "frame_count": len(err)}
            for base in [n[:-2] for n in self.labels["action_names"]
                         if n.endswith("-1")]:
                combined = {"total_loss": 0.0, "frame_count": 0}
                for trial in (1, 2):
                    name = f"{base}-{trial}"
                    combined["total_loss"] += scores[name]["total_loss"]
                    combined["frame_count"] += scores[name]["frame_count"]
                    del scores[name]
                scores[base] = combined
            return {k: (float("nan") if v["frame_count"] == 0
                        else float(v["total_loss"] / v["frame_count"]))
                    for k, v in scores.items()}

        subject_scores = {"Average": by_actions()}
        for subject_idx, name in enumerate(self.labels["subject_names"]):
            subject_scores[name] = by_actions(
                table["subject_idx"] == subject_idx)
        return subject_scores

    def evaluate(self, keypoints_3d_predicted,
                 transfer_cmu_to_human36m: bool = False,
                 transfer_human36m_to_human36m: bool = False):
        """MPJPE in mm, absolute and relative to the pelvis (joint 6; the
        first transferred joint under a transfer).  Returns ``(scalar,
        full)``, scalar the relative ``Average`` / ``Average``."""
        keypoints_gt = self.labels["table"]["keypoints"][
            :, :self.num_keypoints]
        keypoints_3d_predicted = np.asarray(keypoints_3d_predicted)
        if keypoints_3d_predicted.shape != keypoints_gt.shape:
            raise ValueError(
                f"`keypoints_3d_predicted` shape should be "
                f"{keypoints_gt.shape}, got {keypoints_3d_predicted.shape}")
        transfer = transfer_cmu_to_human36m or transfer_human36m_to_human36m
        if transfer:
            human36m_joints = [10, 11, 15, 14, 1, 4]
            cmu_joints = (human36m_joints if transfer_human36m_to_human36m
                          else [10, 8, 9, 7, 14, 13])
            keypoints_gt = keypoints_gt[:, human36m_joints]
            keypoints_3d_predicted = keypoints_3d_predicted[:, cmu_joints]

        per_pose_error = np.sqrt(
            ((keypoints_gt - keypoints_3d_predicted) ** 2).sum(2)).mean(1)
        root = 0 if transfer else 6
        gt_rel = keypoints_gt - keypoints_gt[:, root:root + 1]
        pred_rel = (keypoints_3d_predicted
                    - keypoints_3d_predicted[:, root:root + 1])
        per_pose_error_relative = np.sqrt(
            ((gt_rel - pred_rel) ** 2).sum(2)).mean(1)
        result = {
            "per_pose_error":
                self.evaluate_using_per_pose_error(per_pose_error),
            "per_pose_error_relative":
                self.evaluate_using_per_pose_error(per_pose_error_relative),
        }
        return (result["per_pose_error_relative"]["Average"]["Average"],
                result)
