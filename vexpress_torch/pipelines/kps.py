"""V-Kps rendering and retargeting (host-side numpy; cv2 for drawing). The
port's own copy of vexpress_tpu/pipelines/kps.py.

Reference: datasets/utils.py:5-38 (rasterizer) and pipelines/utils.py:90-182
(retarget geometry). These run on the host during preprocessing. cv2 is
imported inside the drawing function only, so the module imports where cv2
is missing.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

COLOR_LIST = [(255, 0, 0), (0, 255, 0), (0, 0, 255)]


def draw_kps_image(height: int, width: int, kps: Sequence, kps_type: str = "v") -> np.ndarray:
    if kps_type != "v":
        raise NotImplementedError(f"kps_type {kps_type} not implemented")
    return draw_v_kps_image(height, width, kps, COLOR_LIST)


def draw_v_kps_image(height: int, width: int, kps: Sequence, color_list) -> np.ndarray:
    """Two limb ellipses (eyes->nose) + three dots; 'V' conditioning image."""
    import cv2

    stick_width = 4
    limb_seq = np.array([[0, 2], [1, 2]])
    kps = np.asarray(kps)

    canvas = np.zeros((height, width, 3), dtype=np.uint8)
    for i in range(len(limb_seq)):
        index = limb_seq[i]
        color = color_list[index[0]]
        x = kps[index][:, 0]
        y = kps[index][:, 1]
        length = ((x[0] - x[1]) ** 2 + (y[0] - y[1]) ** 2) ** 0.5
        angle = int(math.degrees(math.atan2(y[0] - y[1], x[0] - x[1])))
        polygon = cv2.ellipse2Poly(
            (int(np.mean(x)), int(np.mean(y))), (int(length / 2), stick_width), angle, 0, 360, 1
        )
        cv2.fillConvexPoly(canvas, polygon, [int(float(c) * 0.6) for c in color])
    for idx_kp, kp in enumerate(kps):
        cv2.circle(canvas, (int(kp[0]), int(kp[1])), 4, color_list[idx_kp], -1)
    return canvas


# ----------------------------------------------------------------- retargeting


def compute_dist(x1, y1, x2, y2):
    return math.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)


def compute_ratio(kps) -> float:
    l_eye_x, l_eye_y = kps[0][0], kps[0][1]
    r_eye_x, r_eye_y = kps[1][0], kps[1][1]
    nose_x, nose_y = kps[2][0], kps[2][1]
    d_left = compute_dist(l_eye_x, l_eye_y, nose_x, nose_y)
    d_right = compute_dist(r_eye_x, r_eye_y, nose_x, nose_y)
    return d_left / (d_right + 1e-6)


def point_to_line_dist(point, line_points) -> float:
    point = np.asarray(point, dtype=np.float64)
    line_points = np.asarray(line_points, dtype=np.float64)
    line_vec = line_points[1] - line_points[0]
    point_vec = point - line_points[0]
    line_len = np.sqrt(np.sum(line_vec**2))
    line_norm = line_vec / line_len
    t = float(np.dot(line_norm, point_vec / line_len))
    t = min(max(t, 0.0), 1.0)
    nearest = line_points[0] + t * line_vec
    return float(np.sqrt(np.sum((point - nearest) ** 2)))


def get_face_size(kps):
    a, b, c = kps[0, :], kps[1, :], kps[2, :]
    ab_dist = math.sqrt((a[0] - b[0]) ** 2 + (a[1] - b[1]) ** 2)
    c_ab_dist = point_to_line_dist(c, [a, b])
    return ab_dist, c_ab_dist


def get_rescale_params(kps_ref, kps_target):
    kps_ref = np.asarray(kps_ref)
    kps_target = np.asarray(kps_target)
    ref_ab, ref_cab = get_face_size(kps_ref)
    tgt_ab, tgt_cab = get_face_size(kps_target)
    return ref_ab / tgt_ab, ref_cab / tgt_cab


def retarget_kps(ref_kps, tgt_kps_list, only_offset: bool = True) -> np.ndarray:
    """pipelines/utils.py:145-182 (offset vs naive retarget), incl. the
    reference's target-frame selection quirk (ratio_delta = tgt_ratio)."""
    ref_kps = np.asarray(ref_kps)
    tgt_kps_list = np.asarray(tgt_kps_list, dtype=np.float64)

    ref_ratio = compute_ratio(ref_kps)
    ratio_delta = 10000.0
    selected_idx = None
    for idx, tgt_kps in enumerate(tgt_kps_list):
        tgt_ratio = compute_ratio(tgt_kps)
        if math.fabs(tgt_ratio - ref_ratio) < ratio_delta:
            selected_idx = idx
            ratio_delta = tgt_ratio  # (sic) reference keeps the ratio, not the delta

    scale_width, scale_height = get_rescale_params(ref_kps, tgt_kps_list[selected_idx])

    rescaled = np.array(tgt_kps_list)
    rescaled[:, :, 0] *= scale_width
    rescaled[:, :, 1] *= scale_height

    if only_offset:
        nose_offset = rescaled[:, 2, :] - rescaled[0, 2, :]
        nose_offset = nose_offset[:, np.newaxis, :]
        ref_repeat = np.tile(ref_kps, (tgt_kps_list.shape[0], 1, 1)).astype(np.float64)
        ref_repeat[:, :, :] -= nose_offset / 2.0
        rescaled = ref_repeat
    else:
        nose_offset_x = rescaled[0, 2, 0] - ref_kps[2][0]
        nose_offset_y = rescaled[0, 2, 1] - ref_kps[2][1]
        rescaled[:, :, 0] -= nose_offset_x
        rescaled[:, :, 1] -= nose_offset_y
    return rescaled


def interpolate_kps_sequence(kps_sequence: np.ndarray, video_length: int) -> np.ndarray:
    """Temporal linear interpolation of a (T, 3, 2) kps sequence to
    video_length (inference.py:266-277, torch interpolate semantics)."""
    t_in = kps_sequence.shape[0]
    if t_in > video_length:
        kps_sequence = kps_sequence[:video_length]
        t_in = video_length
    flat = kps_sequence.reshape(t_in, -1).astype(np.float64)
    scale = t_in / video_length
    pos = np.clip((np.arange(video_length) + 0.5) * scale - 0.5, 0, t_in - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, t_in - 1)
    frac = (pos - lo)[:, None]
    out = flat[lo] * (1 - frac) + flat[hi] * frac
    return out.reshape(video_length, *kps_sequence.shape[1:])


def render_kps_sequence(height: int, width: int, kps_sequence: np.ndarray) -> np.ndarray:
    """-> (T, H, W, 3) uint8 conditioning images."""
    return np.stack([draw_kps_image(height, width, k) for k in kps_sequence])
