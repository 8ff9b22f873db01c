"""CMU Panoptic Studio multi-view dataset and its MPJPE evaluator (the
port's own copy of ``lt_tpu/data/cmu_panoptic.py``).

Reads the public Panoptic toolbox layout::

    {root}/{sequence}/calibration_{sequence}.json
    {root}/{sequence}/hdPose3d_stage1_coco19/body3DScene_{frame:08d}.json
    {root}/{sequence}/hdImgs/{name}/{name}_{frame:08d}.jpg

and gives Human3.6M's sample dicts (:mod:`lt_tpu_torch.data.human36m`), so
the collate, the iterator and the engine take it unchanged.  Only HD
cameras are used; frames with no body are skipped; world units go from
centimetres to millimetres; poses are COCO19, whose confidence column
becomes the joint's validity (conf > 0); each view's bbox is the square
hull of the joints projected into it, scaled by ``scale_bbox``; lens
distortion is ignored.  Frames are read with cv2 (BGR).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from lt_tpu_torch.data.human36m import decoder_name, empty_sample, missing_view
from lt_tpu_torch.utils import img as img_utils

ROOT_JOINT = 2  # COCO19 bodyCenter (mid-hip)


def _load_calibration(path, camera_names=None):
    """The HD cameras of a toolbox calibration file (t in mm), in
    ``camera_names``' order where given."""
    with open(path) as f:
        calib = json.load(f)
    cams = []
    for cam in calib["cameras"]:
        if cam.get("type", "hd") != "hd":
            continue
        if camera_names is not None and cam["name"] not in camera_names:
            continue
        cams.append({
            "name": cam["name"],
            "K": np.array(cam["K"], np.float32),
            "R": np.array(cam["R"], np.float32),
            "t": np.array(cam["t"], np.float32).reshape(3, 1) * 10.0,
            "dist": np.array(cam.get("distCoef", [0] * 5), np.float32),
        })
    if camera_names is not None:
        order = {n: i for i, n in enumerate(camera_names)}
        cams.sort(key=lambda c: order[c["name"]])
    return cams


def _load_pose(path):
    """(19, 4) mm keypoints and validity of a scene's first body, or None
    for a frame with no body."""
    with open(path) as f:
        scene = json.load(f)
    bodies = scene.get("bodies", [])
    if not bodies:
        return None
    kp = np.array(bodies[0]["joints19"], np.float32).reshape(-1, 4)
    kp[:, :3] *= 10.0
    kp[:, 3] = (kp[:, 3] > 0).astype(np.float32)
    return kp


class CMUPanopticMultiViewDataset:
    """Single-person multi-view CMU Panoptic over the toolbox layout.

    Args:
      panoptic_root: the directory of the sequence folders.
      sequences: sequence names (e.g. ``["171204_pose1"]``).
      camera_names: HD camera names in view order; None takes every HD
        camera in the calibration file's order, at most ``n_views``.
      retain_every_n_frames: frame stride.
      image_shape, scale_bbox, norm_image, crop: as Human3.6M's.
    """

    def __init__(self,
                 panoptic_root: str,
                 sequences: Sequence[str],
                 camera_names: Optional[Sequence[str]] = None,
                 n_views: int = 4,
                 train: bool = False,
                 test: bool = False,
                 retain_every_n_frames: int = 1,
                 image_shape=(256, 256),
                 scale_bbox: float = 1.2,
                 norm_image: bool = True,
                 crop: bool = True):
        assert train or test, "need at least one of train/test"
        self.panoptic_root = panoptic_root
        self.sequence_names = list(sequences)
        self.image_shape = None if image_shape is None else tuple(image_shape)
        self.scale_bbox = scale_bbox
        self.norm_image = norm_image
        self.crop = crop
        self.io_bound = True
        self.num_keypoints = 19
        self.kind = "cmu"
        self.decoder = decoder_name(None, "the Panoptic reader's only path")

        self.cameras = []      # per sequence: its camera dicts
        frames = []            # (sequence index, frame, (19, 4) keypoints)
        for seq_idx, seq in enumerate(self.sequence_names):
            seq_dir = os.path.join(panoptic_root, seq)
            cams = _load_calibration(
                os.path.join(seq_dir, f"calibration_{seq}.json"),
                camera_names)
            if camera_names is None:
                cams = cams[:n_views]
            assert cams, f"no HD cameras found for {seq}"
            self.cameras.append(cams)
            pose_dir = os.path.join(seq_dir, "hdPose3d_stage1_coco19")
            for fname in sorted(os.listdir(pose_dir)):
                if not (fname.startswith("body3DScene_")
                        and fname.endswith(".json")):
                    continue
                kp = _load_pose(os.path.join(pose_dir, fname))
                if kp is not None:
                    frames.append((seq_idx, fname[len("body3DScene_"):
                                                  -len(".json")], kp))
        frames = frames[::retain_every_n_frames]
        self.table = {
            "sequence_idx": np.array([f[0] for f in frames], np.int64),
            "frame": [f[1] for f in frames],
            "keypoints": (np.stack([f[2] for f in frames])
                          if frames else np.zeros((0, 19, 4), np.float32)),
        }
        self.n_views = (len(camera_names) if camera_names is not None
                        else max(len(c) for c in self.cameras))

    def __len__(self):
        return len(self.table["frame"])

    def _image_path(self, seq: str, cam_name: str, frame: str) -> str:
        return os.path.join(self.panoptic_root, seq, "hdImgs", cam_name,
                            f"{cam_name}_{frame}.jpg")

    def _view_bbox(self, kp_mm, cam):
        """Square bbox (l, u, r, d) around the projected joints, scaled."""
        P = cam["K"] @ np.hstack([cam["R"], cam["t"]])
        pts = P @ np.vstack([kp_mm.T, np.ones((1, len(kp_mm)), np.float32)])
        uv = (pts[:2] / np.maximum(pts[2:], 1e-6)).T
        l, u = uv.min(0)
        r, d = uv.max(0)
        bbox = img_utils.get_square_bbox((l, u, r, d))
        return img_utils.scale_bbox(bbox, self.scale_bbox)

    def __getitem__(self, idx):
        seq_idx = int(self.table["sequence_idx"][idx])
        seq = self.sequence_names[seq_idx]
        frame = self.table["frame"][idx]
        kp = self.table["keypoints"][idx]
        sample = empty_sample()
        for cam in self.cameras[seq_idx]:
            image_path = self._image_path(seq, cam["name"], frame)
            if not os.path.exists(image_path):
                missing_view(sample)
                continue
            bbox = self._view_bbox(kp[:, :3], cam)
            K = cam["K"].copy()
            image = img_utils.read_image(image_path)
            if self.crop:
                image = img_utils.crop_image(image, bbox)
                K[0, 2] -= bbox[0]
                K[1, 2] -= bbox[1]
            h_before, w_before = image.shape[:2]
            if self.image_shape is not None:
                image = img_utils.resize_image(image, self.image_shape)
                K[0] *= self.image_shape[1] / w_before
                K[1] *= self.image_shape[0] / h_before
            if self.norm_image:
                image = img_utils.normalize_image(image)
            sample["images"].append(image)
            sample["detections"].append(
                np.array(list(bbox) + [1.0], np.float32))
            sample["cameras_R"].append(cam["R"])
            sample["cameras_t"].append(cam["t"])
            sample["cameras_K"].append(K)
            sample["proj_matrices"].append(
                (K @ np.hstack([cam["R"], cam["t"]])).astype(np.float32))
            sample["view_valid"].append(True)
        while len(sample["view_valid"]) < self.n_views:
            missing_view(sample)     # pad to n_views slots
        sample["keypoints_3d"] = kp.astype(np.float32)
        sample["indexes"] = idx
        return sample

    # -- evaluation ---------------------------------------------------------

    def keypoints_world(self, idx: int) -> np.ndarray:
        """(J, 3) world-mm ground truth from the table, no decode."""
        return self.table["keypoints"][idx][:, :3].astype(np.float32)

    def evaluate_using_per_pose_error(self, per_pose_error):
        """``Average`` and per-sequence mean errors."""
        scores = {"Average": float(per_pose_error.mean())
                  if len(per_pose_error) else float("nan")}
        for seq_idx, name in enumerate(self.sequence_names):
            err = per_pose_error[self.table["sequence_idx"] == seq_idx]
            scores[name] = float(err.mean()) if len(err) else float("nan")
        return scores

    def evaluate(self, keypoints_3d_predicted):
        """MPJPE in mm over the valid joints, absolute and relative to the
        bodyCenter.  Returns ``(scalar, full)``, scalar the relative
        ``Average``."""
        keypoints_gt = self.table["keypoints"][:, :, :3]
        valid = self.table["keypoints"][:, :, 3] > 0
        keypoints_3d_predicted = np.asarray(keypoints_3d_predicted)
        if keypoints_3d_predicted.shape != keypoints_gt.shape:
            raise ValueError(
                f"`keypoints_3d_predicted` shape should be "
                f"{keypoints_gt.shape}, got {keypoints_3d_predicted.shape}")

        def mpjpe(gt, pred):
            err = np.sqrt(((gt - pred) ** 2).sum(2))
            return (err * valid).sum(1) / np.maximum(valid.sum(1), 1)

        per_pose_error = mpjpe(keypoints_gt, keypoints_3d_predicted)
        gt_rel = keypoints_gt - keypoints_gt[:, ROOT_JOINT:ROOT_JOINT + 1]
        pred_rel = (keypoints_3d_predicted
                    - keypoints_3d_predicted[:, ROOT_JOINT:ROOT_JOINT + 1])
        result = {
            "per_pose_error": {"Average": self.evaluate_using_per_pose_error(
                per_pose_error)},
            "per_pose_error_relative": {
                "Average": self.evaluate_using_per_pose_error(
                    mpjpe(gt_rel, pred_rel))},
        }
        return (result["per_pose_error_relative"]["Average"]["Average"],
                result)
