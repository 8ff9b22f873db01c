"""Multi-view geometry: cameras, projection, DLT triangulation.

Port of ``lt_tpu/ops/geometry.py``.  The DLT's null vector is the
eigenvector of the smallest eigenvalue of the 4x4 normal matrix
``M = A^T A``, found by the same fixed 8-sweep cyclic Jacobi eigensolver as
``lt_tpu``'s, in the same rotation order: elementwise tensor ops over any
leading batch, differentiable, and with no result that the host must wait
for (``torch.linalg.eigh`` checks its result on the host).  ``method="svd"``
(``torch.linalg.svd`` of A) is kept for cross-checks.  Contractions are
explicit multiply-sums, so float32 stays full float32 on the card (no
TF32).  The homogeneous solution's sign is arbitrary; it cancels in the
division back to euclidean coordinates.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lt_tpu_torch import resolve_device


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over the last two axes as a multiply-sum (no TF32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


# ---------------------------------------------------------------------------
# Camera
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera: rotation ``R`` (..., 3, 3), translation ``t``
    (..., 3, 1), intrinsics ``K`` (..., 3, 3) and optional distortion
    ``dist`` (..., 5); every field may carry leading batch dims.  Crop and
    resize return new cameras."""

    R: torch.Tensor
    t: torch.Tensor
    K: torch.Tensor
    dist: Optional[torch.Tensor] = None

    @staticmethod
    def create(R, t, K, dist=None, device="cuda",
               dtype: torch.dtype = torch.float32) -> "Camera":
        """A camera of ``dtype`` tensors on ``device`` from array-likes."""
        dev = resolve_device(device)

        def tensor(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        R = tensor(R)
        return Camera(R=R, t=tensor(t).reshape(R.shape[:-2] + (3, 1)),
                      K=tensor(K), dist=None if dist is None else tensor(dist))

    @property
    def extrinsics(self) -> torch.Tensor:
        """[R | t] of shape (..., 3, 4)."""
        return torch.cat([self.R, self.t], dim=-1)

    @property
    def projection(self) -> torch.Tensor:
        """K @ [R | t] of shape (..., 3, 4)."""
        return _matmul(self.K, self.extrinsics)

    def update_after_crop(self, bbox) -> "Camera":
        """Shift the principal point for a (left, upper, right, lower) crop;
        ``bbox`` may carry leading batch dims."""
        bbox = torch.as_tensor(bbox, dtype=self.K.dtype, device=self.K.device)
        shift = torch.zeros_like(self.K)
        shift[..., 0, 2] = bbox[..., 0]
        shift[..., 1, 2] = bbox[..., 1]
        return dataclasses.replace(self, K=self.K - shift)

    def update_after_resize(self, image_shape, new_image_shape) -> "Camera":
        """Scale focal lengths and principal point for a resize; shapes are
        (height, width)."""
        height, width = image_shape
        new_height, new_width = new_image_shape
        sx, sy = new_width / width, new_height / height
        scale = torch.ones_like(self.K)
        scale[..., 0, 0] = sx
        scale[..., 0, 2] = sx
        scale[..., 1, 1] = sy
        scale[..., 1, 2] = sy
        return dataclasses.replace(self, K=self.K * scale)


# ---------------------------------------------------------------------------
# Homogeneous coordinates and projection
# ---------------------------------------------------------------------------


def euclidean_to_homogeneous(points: torch.Tensor) -> torch.Tensor:
    """(..., M) -> (..., M + 1) by appending ones."""
    ones = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                      device=points.device)
    return torch.cat([points, ones], dim=-1)


def homogeneous_to_euclidean(points: torch.Tensor) -> torch.Tensor:
    """(..., M + 1) -> (..., M) by dividing by the last coordinate."""
    return points[..., :-1] / points[..., -1:]


def project_points(proj_matrix: torch.Tensor, points_3d: torch.Tensor,
                   convert_back_to_euclidean: bool = True) -> torch.Tensor:
    """Project (..., N, 3) world points through (..., 3, 4) matrices.

    Leading dims broadcast.  The contraction is an explicit multiply-sum so
    it stays in full float32 on every device (no TF32).
    """
    homo = euclidean_to_homogeneous(points_3d)
    result = (homo[..., :, None, :] * proj_matrix[..., None, :, :]).sum(-1)
    if convert_back_to_euclidean:
        result = homogeneous_to_euclidean(result)
    return result


# ---------------------------------------------------------------------------
# Smallest eigenvector of a symmetric 4x4 by fixed-sweep cyclic Jacobi
# ---------------------------------------------------------------------------

_JACOBI_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _safe_half_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """0.5 * atan2(y, x), with zero value and zero gradient at the origin."""
    safe = (y.abs() + x.abs()) > 1e-30
    y_ = torch.where(safe, y, torch.zeros_like(y))
    x_ = torch.where(safe, x, torch.ones_like(x))
    return 0.5 * torch.atan2(y_, x_)


def _rotate(rows, p: int, q: int, c: torch.Tensor, s: torch.Tensor):
    """Rows (or columns) p, q of a list of (..., 4) vectors -> the Givens
    rotation's: (c r_p - s r_q, s r_p + c r_q)."""
    rp, rq = rows[p], rows[q]
    rows[p] = c * rp - s * rq
    rows[q] = s * rp + c * rq
    return rows


def _jacobi_sweep(A: torch.Tensor, V: torch.Tensor):
    """One cyclic sweep over the 6 off-diagonal pairs of (..., 4, 4) ``A``:
    A <- G^T A G (rows, then columns) and V <- V G, as ``lt_tpu`` orders
    them.  Rows and columns are rebuilt by stacking, not written in place,
    so autograd sees every step."""
    for p, q in _JACOBI_PAIRS:
        apq, app, aqq = A[..., p, q], A[..., p, p], A[..., q, q]
        theta = _safe_half_atan2(2.0 * apq, aqq - app)
        c = torch.cos(theta)[..., None]
        s = torch.sin(theta)[..., None]
        A = torch.stack(_rotate(list(A.unbind(-2)), p, q, c, s), dim=-2)
        A = torch.stack(_rotate(list(A.unbind(-1)), p, q, c, s), dim=-1)
        V = torch.stack(_rotate(list(V.unbind(-1)), p, q, c, s), dim=-1)
    return A, V


def smallest_eigenvector_sym4(M: torch.Tensor, n_sweeps: int = 8
                              ) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of symmetric (..., 4, 4)
    ``M`` (the first such index on ties): a fixed number of cyclic Jacobi
    sweeps, any batch dims, differentiable."""
    A = M
    V = torch.eye(4, dtype=M.dtype, device=M.device).expand(M.shape)
    for _ in range(n_sweeps):
        A, V = _jacobi_sweep(A, V)
    idx = A.diagonal(dim1=-2, dim2=-1).argmin(-1)
    return V.gather(-1, idx[..., None, None].expand(M.shape[:-1] + (1,)))[
        ..., 0]


# ---------------------------------------------------------------------------
# DLT triangulation
# ---------------------------------------------------------------------------


def dlt_design_matrix(proj_matrices: torch.Tensor, points: torch.Tensor,
                      confidences: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The weighted DLT system A (..., V, 2, 4): rows ``x P[2] - P[0]`` and
    ``y P[2] - P[1]`` of each view, times its confidence.

    Args:
      proj_matrices: (..., V, 3, 4).
      points: (..., V, 2) image points.
      confidences: optional (..., V) weights.
    """
    A = proj_matrices[..., 2:3, :] * points[..., :, None]
    A = A - proj_matrices[..., :2, :]
    if confidences is not None:
        A = A * confidences[..., None, None]
    return A


def triangulate_point_dlt(proj_matrices: torch.Tensor, points: torch.Tensor,
                          confidences: Optional[torch.Tensor] = None,
                          method: str = "jacobi") -> torch.Tensor:
    """Triangulate (..., 3) points from V views by confidence-weighted DLT.

    Args:
      proj_matrices: (..., V, 3, 4).
      points: (..., V, 2) pixel coordinates.
      confidences: optional (..., V).
      method: 'jacobi' (the normal matrix's fixed-sweep eigensolver) or
        'svd' (``torch.linalg.svd`` of A, for cross-checks).
    """
    A = dlt_design_matrix(proj_matrices, points, confidences)
    A = A.reshape(A.shape[:-3] + (-1, 4))                 # (..., 2V, 4)
    if method == "jacobi":
        M = (A[..., :, :, None] * A[..., :, None, :]).sum(-3)
        v = smallest_eigenvector_sym4(M)
    elif method == "svd":
        _, _, vh = torch.linalg.svd(A, full_matrices=False)
        v = -vh[..., 3, :]
    else:
        raise ValueError(f"Unknown method: {method}")
    return homogeneous_to_euclidean(v)


def triangulate_batch_dlt(proj_matrices: torch.Tensor, points: torch.Tensor,
                          confidences: Optional[torch.Tensor] = None,
                          method: str = "jacobi") -> torch.Tensor:
    """Batched DLT over (B, V, J, 2) points in one call.

    Args:
      proj_matrices: (B, V, 3, 4).
      points: (B, V, J, 2).
      confidences: optional (B, V, J).
    Returns:
      (B, J, 3).
    """
    pm = proj_matrices[:, None]                         # (B, 1, V, 3, 4)
    pts = points.transpose(1, 2)                        # (B, J, V, 2)
    conf = None if confidences is None else confidences.transpose(1, 2)
    return triangulate_point_dlt(pm, pts, conf, method=method)


def reprojection_error(keypoints_3d: torch.Tensor, keypoints_2d: torch.Tensor,
                       proj_matrices: torch.Tensor) -> torch.Tensor:
    """Half the euclidean reprojection error per (point, view).

    Args:
      keypoints_3d: (..., N, 3).
      keypoints_2d: (..., V, N, 2).
      proj_matrices: (..., V, 3, 4).
    Returns:
      (..., N, V).
    """
    projected = project_points(proj_matrices, keypoints_3d[..., None, :, :])
    err = 0.5 * ((keypoints_2d - projected) ** 2).sum(-1).sqrt()
    return err.transpose(-1, -2)


def triangulate_point_dlt_np(proj_matrices: np.ndarray,
                             points: np.ndarray) -> np.ndarray:
    """Host-side numpy DLT of one point from V views, by SVD."""
    n_views = len(proj_matrices)
    A = np.zeros((2 * n_views, 4))
    for j in range(n_views):
        A[j * 2 + 0] = (points[j][0] * proj_matrices[j][2, :]
                        - proj_matrices[j][0, :])
        A[j * 2 + 1] = (points[j][1] * proj_matrices[j][2, :]
                        - proj_matrices[j][1, :])
    _, _, vh = np.linalg.svd(A, full_matrices=False)
    p = vh[3, :]
    return p[:3] / p[3]
