"""Training panels: pose overlays, heatmap grids, volume projections.

The port's own copy of ``lt_tpu/utils/vis.py`` (the reference's
``mvn/utils/vis.py``): the same figures, pixel for pixel, as HWC uint8
arrays for tensorboard's ``add_image``.  Inputs are numpy arrays or
tensors in the port's layouts, which are ``lt_tpu``'s: images (B, V, H,
W, 3) normalized BGR, heatmaps (B, V, J, h, w), volumes (B, J, S, S, S).
Volumes are drawn as per-axis maximum-intensity projections, as in
``lt_tpu``.

Figures are drawn with matplotlib's object API on an Agg canvas: nothing
here selects a backend or keeps a figure open.  matplotlib is imported
where a figure is drawn, so that the module imports without it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lt_tpu_torch.utils.img import denormalize_image, resize_image

# Skeleton edge lists per keypoint convention (dataset facts).
CONNECTIVITY_DICT = {
    "cmu": [(0, 2), (0, 9), (1, 0), (1, 17), (2, 12), (3, 0), (4, 3), (5, 4),
            (6, 2), (7, 6), (8, 7), (9, 10), (10, 11), (12, 13), (13, 14),
            (15, 1), (16, 15), (17, 18)],
    "coco": [(0, 1), (0, 2), (1, 3), (2, 4), (5, 7), (7, 9), (6, 8), (8, 10),
             (11, 13), (13, 15), (12, 14), (14, 16), (5, 6), (5, 11),
             (6, 12), (11, 12)],
    "mpii": [(0, 1), (1, 2), (2, 6), (5, 4), (4, 3), (3, 6), (6, 7), (7, 8),
             (8, 9), (8, 12), (8, 13), (10, 11), (11, 12), (13, 14),
             (14, 15)],
    "human36m": [(0, 1), (1, 2), (2, 6), (5, 4), (4, 3), (3, 6), (6, 7),
                 (7, 8), (8, 16), (9, 16), (8, 12), (11, 12), (10, 11),
                 (8, 13), (13, 14), (14, 15)],
    "kth": [(0, 1), (1, 2), (5, 4), (4, 3), (6, 7), (7, 8), (11, 10),
            (10, 9), (2, 3), (3, 9), (2, 8), (9, 12), (8, 12), (12, 13)],
}

#: Vertex index pairs of the 12 edges of a cuboid (cuboid_vertices' order).
_CUBE_EDGES = [(0, 1), (0, 2), (1, 3), (2, 3),
               (4, 5), (4, 6), (5, 7), (6, 7),
               (0, 4), (1, 5), (2, 6), (3, 7)]


def _np(x) -> np.ndarray:
    """A tensor (any device, any type) or array -> numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        x = x.numpy()
    return np.asarray(x)


def _figure(figsize):
    """A figure on its own Agg canvas (no pyplot, no global backend)."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    fig = Figure(figsize=figsize)
    FigureCanvasAgg(fig)
    return fig


def _subplots(n_rows: int, n_cols: int, figsize):
    fig = _figure(figsize)
    return fig, fig.subplots(n_rows, n_cols, squeeze=False)


def fig_to_array(fig) -> np.ndarray:
    """The figure's pixels, (H, W, 3) uint8."""
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()


def _default_colors(n_edges: int):
    import matplotlib

    cmap = matplotlib.colormaps["hsv"]
    return [(np.array(cmap(i / max(1, n_edges))[:3]) * 255).astype(int)
            for i in range(n_edges)]


def draw_2d_pose(keypoints, ax, kind: str = "human36m",
                 point_size: int = 20, line_width: int = 2) -> None:
    """Joints and skeleton edges on a matplotlib axis."""
    connectivity = CONNECTIVITY_DICT.get(kind, [])
    keypoints = _np(keypoints)
    for (i, k) in connectivity:
        if i < len(keypoints) and k < len(keypoints):
            xs, ys = ([keypoints[i, 0], keypoints[k, 0]],
                      [keypoints[i, 1], keypoints[k, 1]])
            ax.plot(xs, ys, c="red", linewidth=line_width)
    ax.scatter(keypoints[:, 0], keypoints[:, 1], c="blue", s=point_size)


def draw_2d_pose_image(keypoints, image, kind: str = "human36m"
                       ) -> np.ndarray:
    """The skeleton drawn into a copy of an HWC uint8 image with cv2 (the
    image unchanged where cv2 is absent)."""
    out = np.ascontiguousarray(np.asarray(image, np.uint8).copy())
    keypoints = _np(keypoints)
    connectivity = CONNECTIVITY_DICT.get(kind, [])
    colors = _default_colors(len(connectivity))
    try:
        import cv2
    except ImportError:
        return out
    for e, (i, k) in enumerate(connectivity):
        p1 = tuple(int(v) for v in keypoints[i, :2])
        p2 = tuple(int(v) for v in keypoints[k, :2])
        cv2.line(out, p1, p2, tuple(int(c) for c in colors[e]), 2)
    for p in keypoints:
        cv2.circle(out, (int(p[0]), int(p[1])), 3, (255, 255, 255), -1)
    return out


def draw_3d_pose(keypoints, ax, kind: str = "human36m",
                 radius: Optional[float] = None) -> None:
    """The 3D skeleton on a 3D matplotlib axis."""
    connectivity = CONNECTIVITY_DICT.get(kind, [])
    keypoints = _np(keypoints)
    for (i, k) in connectivity:
        if i < len(keypoints) and k < len(keypoints):
            ax.plot(*[[keypoints[i, c], keypoints[k, c]] for c in range(3)],
                    c="red")
    ax.scatter(keypoints[:, 0], keypoints[:, 1], keypoints[:, 2],
               c="blue", s=10)
    if radius is not None:
        center = keypoints.mean(axis=0)
        for setter, c in ((ax.set_xlim, 0), (ax.set_ylim, 1),
                          (ax.set_zlim, 2)):
            setter(center[c] - radius, center[c] + radius)


def _project(proj_matrix, points_3d) -> np.ndarray:
    points_3d = _np(points_3d)
    homo = np.hstack([points_3d, np.ones((len(points_3d), 1))])
    uvw = homo @ _np(proj_matrix).T
    return uvw[:, :2] / uvw[:, 2:3]


def cuboid_vertices(position, sides) -> np.ndarray:
    """(8, 3) corners of the axis-aligned cuboid whose least corner is
    ``position`` and whose edges are ``sides`` long."""
    position = np.asarray(_np(position), np.float32)
    sides = np.asarray(_np(sides), np.float32)
    corners = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                        for z in (0, 1)], np.float32)
    return position[None] + corners * sides[None]


def draw_cuboid_2d(position, sides, proj_matrix, ax,
                   color: str = "cyan") -> None:
    """A world-space cuboid's wireframe projected into a view."""
    verts2d = _project(proj_matrix, cuboid_vertices(position, sides))
    for i, k in _CUBE_EDGES:
        ax.plot([verts2d[i, 0], verts2d[k, 0]],
                [verts2d[i, 1], verts2d[k, 1]], c=color, linewidth=1.0)


def visualize_batch(images, heatmaps, keypoints_2d, proj_matrices,
                    keypoints_3d_gt, keypoints_3d_pred,
                    kind: str = "human36m", confidences=None,
                    cuboids: Optional[tuple] = None,
                    batch_index: int = 0, size: int = 3,
                    max_n_cols: int = 10) -> np.ndarray:
    """One sample's grid, a row per diagnostic: the input views, the
    predicted 2D keypoints, the ground truth and the prediction projected
    (with the volumetric model's cuboid, ``cuboids`` = (least corners
    (B, 3), sides (3,))), and the confidences where given."""
    images = _np(images[batch_index])
    proj_matrices = _np(proj_matrices)
    n_views = min(images.shape[0], max_n_cols)
    n_rows = 4 + (1 if confidences is not None else 0)

    fig, axes = _subplots(n_rows, n_views, (n_views * size, n_rows * size))
    row_names = ["image", "pred 2d", "gt 3d proj", "pred 3d proj"]
    for v in range(n_views):
        display = denormalize_image(images[v]).astype(np.uint8)
        display = display[..., ::-1]  # BGR (the datasets') -> RGB

        axes[0][v].imshow(display)
        axes[1][v].imshow(display)
        if keypoints_2d is not None:
            draw_2d_pose(_np(keypoints_2d[batch_index, v]), axes[1][v], kind)
        axes[2][v].imshow(display)
        draw_2d_pose(_project(proj_matrices[batch_index, v],
                              keypoints_3d_gt[batch_index]), axes[2][v], kind)
        axes[3][v].imshow(display)
        draw_2d_pose(_project(proj_matrices[batch_index, v],
                              keypoints_3d_pred[batch_index]), axes[3][v],
                     kind)
        if cuboids is not None:
            positions, sides = cuboids
            draw_cuboid_2d(positions[batch_index], sides,
                           proj_matrices[batch_index, v], axes[3][v])
        if confidences is not None:
            conf = _np(confidences[batch_index, v])
            axes[4][v].bar(range(len(conf)), conf, color="green")
            axes[4][v].set_ylim(0, 1.0)
    for r in range(min(len(row_names), n_rows)):
        axes[r][0].set_ylabel(row_names[r], fontsize=12)
    for ax_row in axes:
        for ax in ax_row:
            ax.set_xticks([])
            ax.set_yticks([])
    fig.tight_layout()
    return fig_to_array(fig)


def visualize_heatmaps(images, heatmaps, kind: str = "human36m",
                       batch_index: int = 0, size: int = 2,
                       max_n_rows: int = 10, max_n_cols: int = 10
                       ) -> np.ndarray:
    """Each view's heatmaps, one joint a column, over the image."""
    images = _np(images[batch_index])
    hms = _np(heatmaps[batch_index])
    n_views = min(images.shape[0], max_n_rows)
    n_joints = min(hms.shape[1], max_n_cols - 1)

    fig, axes = _subplots(n_views, n_joints + 1,
                          ((n_joints + 1) * size, n_views * size))
    for v in range(n_views):
        display = denormalize_image(images[v]).astype(np.uint8)[..., ::-1]
        axes[v][0].imshow(display)
        for j in range(n_joints):
            hm = hms[v, j]
            hm_resized = resize_image(
                (255 * hm / (hm.max() + 1e-9)).astype(np.uint8),
                display.shape[:2])
            axes[v][j + 1].imshow(display)
            axes[v][j + 1].imshow(hm_resized, alpha=0.5, cmap="hot")
    for ax_row in axes:
        for ax in ax_row:
            ax.set_xticks([])
            ax.set_yticks([])
    fig.tight_layout()
    return fig_to_array(fig)


def visualize_volumes(images, volumes, proj_matrices,
                      kind: str = "human36m", batch_index: int = 0,
                      size: int = 2, max_n_rows: int = 1,
                      max_n_cols: int = 16) -> np.ndarray:
    """Each joint's volume as its maximum-intensity projection along each
    axis."""
    vols = _np(volumes[batch_index])
    n_joints = min(vols.shape[0], max_n_cols)

    fig, axes = _subplots(3, n_joints, (n_joints * size, 3 * size))
    for j in range(n_joints):
        for axis in range(3):
            axes[axis][j].imshow(vols[j].max(axis=axis), cmap="hot")
            axes[axis][j].set_xticks([])
            axes[axis][j].set_yticks([])
        axes[0][j].set_title(f"j{j}", fontsize=8)
    fig.tight_layout()
    return fig_to_array(fig)


def draw_voxels(voxels, ax=None, shape=(8, 8, 8)) -> Optional[np.ndarray]:
    """The voxels above their mean, subsampled to about ``shape``, as a 3D
    scatter: on ``ax``, or on a figure of its own whose pixels it
    returns."""
    voxels = _np(voxels)
    s = [max(1, voxels.shape[i] // shape[i]) for i in range(3)]
    small = voxels[::s[0], ::s[1], ::s[2]]
    fig = None
    if ax is None:
        fig = _figure(None)
        ax = fig.add_subplot(111, projection="3d")
    xx, yy, zz = np.nonzero(small > small.mean())
    ax.scatter(xx, yy, zz, c=small[xx, yy, zz], cmap="hot", alpha=0.5)
    return None if fig is None else fig_to_array(fig)
