"""SO(3)/SE(3) primitives in PyTorch (counterpart of ``superodom_tpu.geometry``).

Quaternions are ``(w, x, y, z)`` float tensors; every function broadcasts
over leading batch dimensions and is safe under ``torch.func`` transforms
(the smoother differentiates through them with ``jacfwd``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-8


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, one multiply or subtract per op (a fused
    cross kernel would round differently from the CUDA kernels)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a0*b0 + a1*b1) + a2*b2 over the last axis: the kernels' order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_mul(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Hamilton product q*p."""
    w1, x1, y1, z1 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:4]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    q = q / torch.clamp_min(n, _EPS)
    # canonical sign (w >= 0) so poses compare stably
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion q (broadcast over batch dims)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    u, v = torch.broadcast_tensors(u, v)
    w = w.expand(u.shape[:-1] + (1,))
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion, branch-free (Shepperd's method)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20],
                     dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21],
                     dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22],
                     dim=-1)
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4, 4]
    idx = idx[..., None, None].expand(idx.shape + (1, 4))
    return quat_normalize(torch.gather(cands, -2, idx)[..., 0, :])


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation with short-path selection and small-angle
    guard; ``t`` broadcasts against ``q0[..., 0]``."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)[..., None]
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.clamp(torch.abs(d), 0.0, 1.0 - 1e-7)
    theta = torch.acos(d)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-4
    safe_sin = torch.where(small, 1.0, sin_theta)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    w1 = torch.where(small, t, torch.sin(t * theta) / safe_sin)
    return quat_normalize(w0 * q0 + w1 * q1)


def quat_from_rpy(roll, pitch, yaw) -> torch.Tensor:
    """ZYX Euler angles to quaternion, matching tf2 setRPY."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )


def rpy_from_quat(q: torch.Tensor):
    """Quaternion to (roll, pitch, yaw), tf2 Matrix3x3::getRPY solution 1."""
    R = quat_to_matrix(q)
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    roll = torch.where(singular, torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
                       torch.atan2(R[..., 2, 1], R[..., 2, 2]))
    pitch = torch.atan2(-R[..., 2, 0], sy)
    yaw = torch.where(singular, 0.0, torch.atan2(R[..., 1, 0], R[..., 0, 0]))
    return roll, pitch, yaw


def quat_angle(q: torch.Tensor) -> torch.Tensor:
    """Rotation angle of q: 2*atan2(|vec|, |w|)."""
    return 2.0 * torch.atan2(torch.linalg.norm(q[..., 1:4], dim=-1),
                             torch.abs(q[..., 0]))


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Axis-angle vector -> quaternion (closed form, Taylor-guarded)."""
    theta_sq = torch.sum(omega * omega, dim=-1, keepdim=True)
    # +tiny keeps the sqrt differentiable at 0 for jacfwd
    theta = torch.sqrt(theta_sq + 1e-24)
    half = 0.5 * theta
    small = theta_sq < 1e-10
    imag = torch.where(small, 0.5 - theta_sq / 48.0,
                       torch.sin(half) / torch.where(small, 1.0, theta))
    return torch.cat([torch.cos(half), imag * omega], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> axis-angle vector."""
    q = quat_normalize(q)
    w = q[..., 0:1]
    v = q[..., 1:4]
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-24)
    angle = 2.0 * torch.atan2(n, w)
    small = n < 1e-8
    scale = torch.where(small, 2.0 / torch.clamp_min(w, _EPS),
                        angle / torch.where(small, 1.0, n))
    return scale * v


def se3_exp(xi: torch.Tensor):
    """se(3) twist [upsilon(3), omega(3)] -> (quat, trans), t = V(omega) ups."""
    ups = xi[..., 0:3]
    omega = xi[..., 3:6]
    q = so3_exp(omega)
    theta_sq = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq + 1e-24)
    small = theta_sq < 1e-10
    Om = skew(omega)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    # Om^2 = w w^T - theta^2 I in closed form (no matmul rounding)
    Om2 = omega[..., :, None] * omega[..., None, :] - theta_sq[..., None] * eye
    a = torch.where(small, 0.5,
                    (1.0 - torch.cos(theta)) / torch.where(small, 1.0, theta_sq))
    b = torch.where(small, 1.0 / 6.0,
                    (theta - torch.sin(theta))
                    / torch.where(small, 1.0, theta_sq * theta))
    V = eye + a[..., None] * Om + b[..., None] * Om2
    t = torch.sum(V * ups[..., None, :], dim=-1)
    return q, t


class Pose(NamedTuple):
    q: torch.Tensor  # quaternion (w, x, y, z)
    t: torch.Tensor  # translation (3,)

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "Pose":
        return Pose(quat_identity(dtype, device),
                    torch.zeros(3, dtype=dtype, device=device))

    def compose(self, other: "Pose") -> "Pose":
        """self * other (apply other first, then self)."""
        return Pose(quat_normalize(quat_mul(self.q, other.q)),
                    quat_rotate(self.q, other.t) + self.t)

    def inverse(self) -> "Pose":
        qinv = quat_conj(self.q)
        return Pose(qinv, -quat_rotate(qinv, self.t))

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        """Transform points [..., 3]."""
        return quat_rotate(self.q, pts) + self.t

    def normalize(self) -> "Pose":
        return Pose(quat_normalize(self.q), self.t)


def pose_interpolate(p0: Pose, p1: Pose, alpha) -> Pose:
    """Slerp rotation + lerp translation (reference
    featureExtraction.cpp:269-275)."""
    return Pose(quat_slerp(p0.q, p1.q, alpha),
                (1.0 - alpha) * p0.t + alpha * p1.t)


def pose_delta(a: Pose, b: Pose):
    """(translation norm, rotation angle) of a^-1 * b."""
    rel = a.inverse().compose(b)
    return torch.linalg.norm(rel.t, dim=-1), quat_angle(rel.q)


def apply_se3_update(pose: Pose, xi: torch.Tensor) -> Pose:
    """Left-multiplicative SE3 update: pose' = exp(xi) * pose."""
    dq, dt = se3_exp(xi)
    return Pose(quat_normalize(quat_mul(dq, pose.q)),
                quat_rotate(dq, pose.t) + dt)


def gravity_align_matrix(acc_mean: torch.Tensor) -> torch.Tensor:
    """Roll/pitch rotation whose *transpose* aligns the measured gravity
    direction with +Z (R^T @ acc_mean = (0, 0, |acc_mean|)):
    R = R_x(phi) @ R_y(theta) with theta = atan2(ax, sqrt(ay^2+az^2)),
    phi = atan2(-ay, az) (Imu::calculatePitchRollMatrix, reference
    imu_data.h:45-69)."""
    ax, ay, az = acc_mean[..., 0], acc_mean[..., 1], acc_mean[..., 2]
    theta = torch.atan2(ax, torch.sqrt(ay * ay + az * az))
    phi = torch.atan2(-ay, az)
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    zeros = torch.zeros_like(ct)
    ones = torch.ones_like(ct)
    R_y = torch.stack([torch.stack([ct, zeros, st], dim=-1),
                       torch.stack([zeros, ones, zeros], dim=-1),
                       torch.stack([-st, zeros, ct], dim=-1)], dim=-2)
    R_x = torch.stack([torch.stack([ones, zeros, zeros], dim=-1),
                       torch.stack([zeros, cp, -sp], dim=-1),
                       torch.stack([zeros, sp, cp], dim=-1)], dim=-2)
    return R_x @ R_y
