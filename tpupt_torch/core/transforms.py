"""L0 transforms: 4x4 matrices, quaternions, animated transforms.

Counterpart of the reference's `src/core/transform.{h,cpp}` (Transform,
transform.h:412; AnimatedTransform::Interpolate, transform.cpp:1144) and
`quaternion.*`. Used host-side (numpy) during scene flattening — device code
consumes the raw 4x4 arrays. All constructors mirror the .pbrt directives
(Translate/Scale/Rotate/LookAt, api.cpp:1230-1330).
"""

from __future__ import annotations

import numpy as np


class Transform:
    """4x4 affine transform + cached inverse (transform.h:412)."""

    __slots__ = ("m", "m_inv")

    def __init__(self, m=None, m_inv=None):
        self.m = np.eye(4, dtype=np.float64) if m is None else np.asarray(m, np.float64)
        self.m_inv = np.linalg.inv(self.m) if m_inv is None else np.asarray(m_inv, np.float64)

    def __mul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)

    def inverse(self) -> "Transform":
        return Transform(self.m_inv, self.m)

    def is_identity(self) -> bool:
        return np.allclose(self.m, np.eye(4))

    def swaps_handedness(self) -> bool:
        return np.linalg.det(self.m[:3, :3]) < 0.0

    def apply_point(self, p):
        p = np.asarray(p, np.float64)
        ph = self.m[:3, :3] @ p.T + self.m[:3, 3:4]
        w = self.m[3, :3] @ p.T + self.m[3, 3]
        return (ph / w).T

    def apply_vector(self, v):
        v = np.asarray(v, np.float64)
        return (self.m[:3, :3] @ v.T).T

    def apply_normal(self, n):
        n = np.asarray(n, np.float64)
        return (self.m_inv[:3, :3].T @ n.T).T

    # --- constructors mirroring .pbrt directives ---

    @staticmethod
    def translate(delta) -> "Transform":
        d = np.asarray(delta, np.float64)
        m = np.eye(4)
        m[:3, 3] = d
        mi = np.eye(4)
        mi[:3, 3] = -d
        return Transform(m, mi)

    @staticmethod
    def scale(s) -> "Transform":
        s = np.asarray(s, np.float64)
        m = np.diag([s[0], s[1], s[2], 1.0])
        mi = np.diag([1.0 / s[0], 1.0 / s[1], 1.0 / s[2], 1.0])
        return Transform(m, mi)

    @staticmethod
    def rotate(angle_deg: float, axis) -> "Transform":
        a = np.asarray(axis, np.float64)
        a = a / np.linalg.norm(a)
        s, c = np.sin(np.deg2rad(angle_deg)), np.cos(np.deg2rad(angle_deg))
        # Rodrigues rotation matrix (transform.cpp Rotate).
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        R = np.eye(3) + s * K + (1 - c) * (K @ K)
        m = np.eye(4)
        m[:3, :3] = R
        return Transform(m, m.T.copy())

    @staticmethod
    def look_at(eye, look, up) -> "Transform":
        """Camera-to-world (transform.cpp LookAt)."""
        eye, look, up = (np.asarray(x, np.float64) for x in (eye, look, up))
        dirv = look - eye
        dirv = dirv / np.linalg.norm(dirv)
        right = np.cross(up / np.linalg.norm(up), dirv)
        nr = np.linalg.norm(right)
        if nr < 1e-10:
            raise ValueError("LookAt: up vector parallel to viewing direction")
        right /= nr
        new_up = np.cross(dirv, right)
        c2w = np.eye(4)
        c2w[:3, 0] = right
        c2w[:3, 1] = new_up
        c2w[:3, 2] = dirv
        c2w[:3, 3] = eye
        return Transform(c2w)

    @staticmethod
    def perspective(fov_deg: float, near: float, far: float) -> "Transform":
        """Projective camera persp matrix (transform.cpp Perspective)."""
        persp = np.array(
            [
                [1, 0, 0, 0],
                [0, 1, 0, 0],
                [0, 0, far / (far - near), -far * near / (far - near)],
                [0, 0, 1, 0],
            ],
            dtype=np.float64,
        )
        inv_tan = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
        return Transform.scale([inv_tan, inv_tan, 1.0]) * Transform(persp)

    @staticmethod
    def orthographic(near: float, far: float) -> "Transform":
        return Transform.scale([1.0, 1.0, 1.0 / (far - near)]) * Transform.translate(
            [0.0, 0.0, -near]
        )


# --- quaternions (core/quaternion.*) ---


def quat_from_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z) (quaternion.cpp)."""
    t = np.trace(m[:3, :3])
    if t > 0.0:
        s = np.sqrt(t + 1.0)
        w = s / 2.0
        s = 0.5 / s
        return np.array(
            [w, (m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s, (m[1, 0] - m[0, 1]) * s]
        )
    i = int(np.argmax([m[0, 0], m[1, 1], m[2, 2]]))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt((m[i, i] - (m[j, j] + m[k, k])) + 1.0)
    q = np.zeros(4)
    q[1 + i] = s * 0.5
    s = 0.5 / s
    q[0] = (m[k, j] - m[j, k]) * s
    q[1 + j] = (m[j, i] + m[i, j]) * s
    q[1 + k] = (m[k, i] + m[i, k]) * s
    return q


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def quat_slerp(t: float, q0: np.ndarray, q1: np.ndarray) -> np.ndarray:
    cos_th = float(np.dot(q0, q1))
    if cos_th > 0.9995:
        q = (1 - t) * q0 + t * q1
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(cos_th, -1, 1))
    qperp = q1 - q0 * cos_th
    qperp /= np.linalg.norm(qperp)
    return q0 * np.cos(theta * t) + qperp * np.sin(theta * t)


def decompose(m: np.ndarray):
    """Decompose affine matrix into (T, R quaternion, S matrix) via polar
    decomposition iteration (transform.cpp AnimatedTransform::Decompose)."""
    T = m[:3, 3].copy()
    M = m[:3, :3].copy()
    R = M.copy()
    for _ in range(100):
        R_next = 0.5 * (R + np.linalg.inv(R.T))
        if np.max(np.abs(R_next - R)) < 1e-4:
            R = R_next
            break
        R = R_next
    S = np.linalg.inv(R) @ M
    return T, quat_from_matrix(np.vstack([np.hstack([R, np.zeros((3, 1))]), [[0, 0, 0, 1]]])), S


class AnimatedTransform:
    """Keyframed transform with slerp interpolation (transform.cpp:1144).

    Motion-blur support: `interpolate(t)` returns a Transform. The reference's
    tighter BoundPointMotion machinery is replaced by sampled-union bounds.
    """

    def __init__(self, start: Transform, start_time: float, end: Transform, end_time: float):
        self.start, self.end = start, end
        self.start_time, self.end_time = start_time, end_time
        self.animated = not np.allclose(start.m, end.m)
        if self.animated:
            self.T0, self.R0, self.S0 = decompose(start.m)
            self.T1, self.R1, self.S1 = decompose(end.m)
            if np.dot(self.R0, self.R1) < 0.0:
                self.R1 = -self.R1

    def interpolate(self, time: float) -> Transform:
        if not self.animated or time <= self.start_time:
            return self.start
        if time >= self.end_time:
            return self.end
        dt = (time - self.start_time) / (self.end_time - self.start_time)
        T = (1 - dt) * self.T0 + dt * self.T1
        R = quat_slerp(dt, self.R0, self.R1)
        S = (1 - dt) * self.S0 + dt * self.S1
        m = np.eye(4)
        m[:3, :3] = quat_to_matrix(R) @ S
        m[:3, 3] = T
        return Transform(m)

    def motion_bounds(self, lo, hi, n_steps: int = 16):
        """Union of transformed AABB corners over sampled times."""
        corners = np.array(
            [[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]], [lo[0], hi[1], lo[2]],
             [lo[0], lo[1], hi[2]], [hi[0], hi[1], lo[2]], [hi[0], lo[1], hi[2]],
             [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]]]
        )
        out_lo = np.full(3, np.inf)
        out_hi = np.full(3, -np.inf)
        for i in range(n_steps + 1):
            t = self.start_time + (self.end_time - self.start_time) * i / n_steps
            p = self.interpolate(t).apply_point(corners)
            out_lo = np.minimum(out_lo, p.min(0))
            out_hi = np.maximum(out_hi, p.max(0))
        return out_lo, out_hi
