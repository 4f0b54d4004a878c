"""Inertial subsystem: preintegration and the fixed-lag smoother
(counterpart of ``superodom_tpu.inertial``).

The strapdown chain is a prefix product of quaternions; JAX runs it as a
``lax.associative_scan``, here it is a log-depth (Hillis-Steele) scan of
``ceil(log2 M)`` batched products.  Bias Jacobians of the preintegration
and the per-factor Jacobians of the smoother come from ``torch.func.jacfwd``
(vmapped over window lanes), as ``jax.jacfwd`` gives them in JAX.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import jacfwd, vmap

from odombench.reference.config import ImuConfig
from odombench.reference.frontend import ImuWindow
from odombench.reference.geometry import (
    Pose,
    gravity_align_matrix,
    quat_conj,
    quat_identity,
    quat_mul,
    quat_normalize,
    quat_rotate,
    so3_exp,
    so3_log,
)


class ImuInitState(NamedTuple):
    """Output of static initialization (reference Imu::imuInit,
    imu_data.h:71-160): measurement means, gravity, gyro bias and the
    gravity-alignment rotation composed with the laser extrinsic."""

    acc_mean: torch.Tensor  # f32[3]
    gyr_mean: torch.Tensor  # f32[3]
    acc_cov: torch.Tensor  # f32[3]
    gyr_cov: torch.Tensor  # f32[3]
    gravity: torch.Tensor  # f32[3] gravity vector in imu frame
    gyr_bias: torch.Tensor  # f32[3]
    R_gravity: torch.Tensor  # f32[3,3] roll/pitch gravity alignment
    R_imu_laser_gravity: torch.Tensor  # f32[3,3] R_gravity^-1 @ R_imu_laser
    ok: torch.Tensor  # bool


def imu_static_init(acc: torch.Tensor, gyr: torch.Tensor, mask: torch.Tensor,
                    R_imu_laser: torch.Tensor,
                    gravity_norm: float = 9.81) -> ImuInitState:
    """Masked-mean/covariance initialization over a ~1 s static buffer."""
    w = mask.to(acc.dtype)
    n = torch.clamp_min(torch.sum(w), 1.0)
    acc_mean = torch.sum(acc * w[:, None], dim=0) / n
    gyr_mean = torch.sum(gyr * w[:, None], dim=0) / n
    acc_cov = torch.sum(((acc - acc_mean) ** 2) * w[:, None], dim=0) \
        / torch.clamp_min(n - 1.0, 1.0)
    gyr_cov = torch.sum(((gyr - gyr_mean) ** 2) * w[:, None], dim=0) \
        / torch.clamp_min(n - 1.0, 1.0)
    gravity = (-acc_mean / torch.clamp_min(torch.linalg.norm(acc_mean), 1e-6)
               * gravity_norm)
    R_g = gravity_align_matrix(acc_mean)
    # reference: Roll_Pitch_Gravity^-1 * imu_laser_R
    R_ilg = R_g.T @ R_imu_laser
    return ImuInitState(
        acc_mean=acc_mean, gyr_mean=gyr_mean, acc_cov=acc_cov,
        gyr_cov=gyr_cov, gravity=gravity, gyr_bias=gyr_mean, R_gravity=R_g,
        R_imu_laser_gravity=R_ilg,
        ok=torch.sum(mask.to(torch.int32)) > 10)


class Preintegrated(NamedTuple):
    """Forster-style preintegrated IMU measurement over one interval."""

    dq: torch.Tensor  # f32[4]
    dv: torch.Tensor  # f32[3]
    dp: torch.Tensor  # f32[3]
    dt: torch.Tensor  # f32
    J_q_bg: torch.Tensor  # f32[3,3]
    J_v_ba: torch.Tensor
    J_v_bg: torch.Tensor
    J_p_ba: torch.Tensor
    J_p_bg: torch.Tensor
    ref_ba: torch.Tensor  # f32[3] biases the interval was integrated at
    ref_bg: torch.Tensor


def _prefix_scan(x: torch.Tensor, op) -> torch.Tensor:
    """Inclusive prefix scan of an associative ``op`` along dim 0 in
    ceil(log2 n) steps; ``op(a, b)`` combines an earlier part a with a later
    part b."""
    n = x.shape[0]
    d = 1
    while d < n:
        x = torch.cat([x[:d], op(x[:-d], x[d:])], dim=0)
        d *= 2
    return x


def _sample_dts(t, mask, dtype, rate=200.0):
    """Per-sample integration dt (imuPreintegration.cpp:258-264): the first
    valid sample takes one nominal period, gaps clamp to [1e-4, 0.5],
    invalid lanes contribute 0."""
    idx = torch.cumsum(mask.to(torch.int32), dim=0)
    first = mask & (idx == 1)
    neg = torch.full((1,), -3.4e38, dtype=dtype, device=t.device)
    run_max = torch.cummax(torch.where(mask, t, neg), dim=0).values
    prev_t = torch.cat([neg, run_max[:-1]])
    dt = torch.clamp(t - prev_t, 1e-4, 0.5)
    dt = torch.where(first, 1.0 / rate, dt)
    return torch.where(mask, dt, 0.0)


def _integrate_chain(t, acc, gyr, mask, ba, bg, dtype, q0=None,
                     gravity_w=None, v0=None, p0=None, rate=200.0):
    """Strapdown integration: Q_i = dq_1 * ... * dq_i by prefix product;
    velocities and positions by prefix sums (a_i rotated by the attitude
    BEFORE sample i).  With ``q0`` / ``gravity_w`` / ``v0`` / ``p0`` the
    chain starts from that state under gravity (the high-rate stream);
    without them it is the preintegrated delta.  Returns per-sample
    (q, v, p) and the dts."""
    dev = t.device
    dt = _sample_dts(t, mask, dtype, rate)
    a = acc - ba
    g = gyr - bg
    Q = quat_normalize(_prefix_scan(so3_exp(g * dt[:, None]), quat_mul))
    if q0 is not None:
        Q = quat_normalize(quat_mul(q0[None], Q))
        q_prev = torch.cat([q0[None], Q[:-1]], dim=0)
    else:
        q_prev = torch.cat([quat_identity(dtype, dev)[None], Q[:-1]], dim=0)
    acc_w = quat_rotate(q_prev, a)
    if gravity_w is not None:
        acc_w = acc_w + gravity_w[None]
    acc_w = torch.where(mask[:, None], acc_w, 0.0)
    v = torch.cumsum(acc_w * dt[:, None], dim=0)
    if v0 is not None:
        v = v + v0[None]
        v_prev = torch.cat([v0[None], v[:-1]], dim=0)
    else:
        v_prev = torch.cat([torch.zeros((1, 3), dtype=dtype, device=dev),
                            v[:-1]], dim=0)
    p = torch.cumsum(v_prev * dt[:, None] + 0.5 * acc_w * dt[:, None] ** 2,
                     dim=0)
    if p0 is not None:
        p = p + p0[None]
    return Q, v, p, dt


def preintegrate(imu: ImuWindow, ba: torch.Tensor, bg: torch.Tensor,
                 rate: float = 200.0) -> Preintegrated:
    """Preintegrate the masked IMU window at reference biases, with bias
    Jacobians by forward-mode autodiff of the integration itself."""
    dtype = imu.acc.dtype

    def f(b):
        Q, v, p, dt = _integrate_chain(imu.t, imu.acc, imu.gyr, imu.mask,
                                       b[:3], b[3:], dtype, rate=rate)
        q = Q[-1]
        out = (q, v[-1], p[-1], torch.sum(dt))
        return torch.cat([so3_log(q), v[-1], p[-1]]), out

    J, (q, v, p, dt) = jacfwd(f, has_aux=True)(torch.cat([ba, bg]))
    return Preintegrated(
        dq=q, dv=v, dp=p, dt=dt,
        J_q_bg=J[0:3, 3:6], J_v_ba=J[3:6, 0:3], J_v_bg=J[3:6, 3:6],
        J_p_ba=J[6:9, 0:3], J_p_bg=J[6:9, 3:6],
        ref_ba=ba, ref_bg=bg,
    )


class SmootherState(NamedTuple):
    """Fixed-lag window of navigation states at lidar keyframes, with the
    marginal prior of the states that fell off the window."""

    q: torch.Tensor  # f32[W,4] world<-imu orientation
    p: torch.Tensor  # f32[W,3]
    v: torch.Tensor  # f32[W,3]
    ba: torch.Tensor  # f32[W,3]
    bg: torch.Tensor  # f32[W,3]
    t: torch.Tensor  # f32[W] keyframe times
    meas_q: torch.Tensor  # f32[W,4] lidar pose measurement per keyframe
    meas_p: torch.Tensor  # f32[W,3]
    preint: Preintegrated  # stacked [W] (interval i-1 -> i; lane 0 unused)
    prior_q: torch.Tensor  # f32[4]
    prior_x: torch.Tensor  # f32[12] [p, v, ba, bg]
    prior_info: torch.Tensor  # f32[15,15]
    valid: torch.Tensor  # bool[W]
    key: torch.Tensor  # i32
    failed: torch.Tensor  # bool


def _stack_preint(w: int, dtype, device) -> Preintegrated:
    z3 = torch.zeros((w, 3), dtype=dtype, device=device)
    z33 = torch.zeros((w, 3, 3), dtype=dtype, device=device)
    return Preintegrated(
        dq=quat_identity(dtype, device)[None].repeat(w, 1), dv=z3, dp=z3,
        dt=torch.zeros((w,), dtype=dtype, device=device),
        J_q_bg=z33, J_v_ba=z33, J_v_bg=z33, J_p_ba=z33, J_p_bg=z33,
        ref_ba=z3, ref_bg=z3)


def _init_prior_info(cfg: ImuConfig, dtype, device) -> torch.Tensor:
    """Initial prior on the first window state: free pose, weak velocity,
    moderate biases."""
    diag = ([0.0] * 6 + [1.0 / cfg.init_vel_sigma ** 2] * 3
            + [1.0 / cfg.init_acc_bias_sigma ** 2] * 3
            + [1.0 / cfg.init_gyr_bias_sigma ** 2] * 3)
    return torch.diag(torch.tensor(np.asarray(diag, np.float32), dtype=dtype,
                                   device=device))


def smoother_init(cfg: ImuConfig, dtype=torch.float32,
                  device=None) -> SmootherState:
    w = cfg.window_size
    z3 = torch.zeros((w, 3), dtype=dtype, device=device)
    qid = quat_identity(dtype, device)[None].repeat(w, 1)
    return SmootherState(
        q=qid, p=z3, v=z3, ba=z3, bg=z3,
        t=torch.zeros((w,), dtype=dtype, device=device),
        meas_q=qid, meas_p=z3,
        preint=_stack_preint(w, dtype, device),
        prior_q=quat_identity(dtype, device),
        prior_x=torch.zeros((12,), dtype=dtype, device=device),
        prior_info=_init_prior_info(cfg, dtype, device),
        valid=torch.zeros((w,), dtype=torch.bool, device=device),
        key=torch.zeros((), dtype=torch.int32, device=device),
        failed=torch.zeros((), dtype=torch.bool, device=device),
    )


@functools.lru_cache(maxsize=8)
def _bias_cumsum_map_np(w: int):
    T = np.eye(w * 15, dtype=np.float32)
    for i in range(w):
        for j in range(i):
            for off in (9, 12):  # ba, bg sub-blocks of the 15-wide tangent
                T[i * 15 + off:i * 15 + off + 3,
                  j * 15 + off:j * 15 + off + 3] = np.eye(3)
    return T


def _bias_cumsum_map(w: int, dtype, device) -> torch.Tensor:
    """Map from (first bias, per-interval bias increments) to per-state
    bias tangents (identity on q/p/v blocks)."""
    return torch.tensor(_bias_cumsum_map_np(w), dtype=dtype, device=device)


def _imu_residuals(q_i, p_i, v_i, ba_i, bg_i, q_j, p_j, v_j,
                   pre: Preintegrated, gravity_w):
    """Preintegration residuals with first-order bias correction relative
    to the interval's own integration bias (the role of gtsam::ImuFactor)."""
    dba = ba_i - pre.ref_ba
    dbg = bg_i - pre.ref_bg
    dq_corr = quat_mul(pre.dq, so3_exp(pre.J_q_bg @ dbg))
    dv_corr = pre.dv + pre.J_v_ba @ dba + pre.J_v_bg @ dbg
    dp_corr = pre.dp + pre.J_p_ba @ dba + pre.J_p_bg @ dbg
    dt = pre.dt
    q_i_inv = quat_conj(q_i)
    r_q = so3_log(quat_mul(quat_conj(dq_corr), quat_mul(q_i_inv, q_j)))
    r_v = quat_rotate(q_i_inv, v_j - v_i - gravity_w * dt) - dv_corr
    r_p = quat_rotate(q_i_inv, p_j - p_i - v_i * dt
                      - 0.5 * gravity_w * dt * dt) - dp_corr
    return r_q, r_v, r_p


def propagate_state(state: SmootherState, cfg: ImuConfig,
                    pre: Preintegrated):
    """(q_pred, p_pred, v_pred) of the newest smoothed state propagated
    through a preintegrated interval."""
    gravity_w = torch.tensor([0.0, 0.0, -cfg.gravity], dtype=state.p.dtype,
                             device=state.p.device)
    q_pred = quat_normalize(quat_mul(state.q[-1], pre.dq))
    dt = pre.dt
    v_pred = state.v[-1] + gravity_w * dt + quat_rotate(state.q[-1], pre.dv)
    p_pred = (state.p[-1] + state.v[-1] * dt + 0.5 * gravity_w * dt * dt
              + quat_rotate(state.q[-1], pre.dp))
    return q_pred, p_pred, v_pred


def propagate_high_rate(state: SmootherState, cfg: ImuConfig,
                        imu: ImuWindow):
    """IMU-rate odometry: the window integrated forward from the latest
    smoothed state with its biases, under gravity (repropagate_imuodometry
    and the imuHandler's predict, imuPreintegration.cpp:339-367,565).
    Returns per-sample (poses, velocities, mask) over the window."""
    dtype = state.p.dtype
    gravity_w = torch.tensor([0.0, 0.0, -cfg.gravity], dtype=dtype,
                             device=state.p.device)
    qs, vs, ps, _ = _integrate_chain(
        imu.t, imu.acc, imu.gyr, imu.mask, state.ba[-1], state.bg[-1],
        dtype, q0=state.q[-1], gravity_w=gravity_w, v0=state.v[-1],
        p0=state.p[-1], rate=cfg.imu_rate)
    return Pose(qs, ps), vs, imu.mask


def _pose_prior_res(delta15, q0, p0, mq, mp, w):
    """Weighted lidar pose-prior residual on one state ([6])."""
    q = quat_normalize(quat_mul(q0, so3_exp(delta15[0:3])))
    p = p0 + delta15[3:6]
    r_q = so3_log(quat_mul(quat_conj(mq), q)) * w
    return torch.cat([r_q, (p - mp) * w])


def _pair_factor_res(delta30, xi, xj, pre_i, sig_vq, sig_vv, wpair, wba, wbg,
                     gravity_w):
    """Weighted IMU preintegration + bias random-walk residuals between
    consecutive window states ([15])."""
    qi0, pi0, vi0, bai0, bgi0 = xi
    qj0, pj0, vj0, baj0, bgj0 = xj
    di, dj = delta30[:15], delta30[15:]
    qi = quat_normalize(quat_mul(qi0, so3_exp(di[0:3])))
    qj = quat_normalize(quat_mul(qj0, so3_exp(dj[0:3])))
    bai, bgi = bai0 + di[9:12], bgi0 + di[12:15]
    baj, bgj = baj0 + dj[9:12], bgj0 + dj[12:15]
    r_q, r_v, r_p = _imu_residuals(qi, pi0 + di[3:6], vi0 + di[6:9], bai, bgi,
                                   qj, pj0 + dj[3:6], vj0 + dj[6:9], pre_i,
                                   gravity_w)
    return torch.cat([
        r_q * sig_vq * wpair,
        r_v * sig_vv * wpair,
        r_p * sig_vv * wpair,
        (baj - bai) * (wba * wpair),
        (bgj - bgi) * (wbg * wpair),
    ])


def _state_tangent15(q, p, v, ba, bg, prior_q, prior_x):
    """Tangent coordinates of a state around the marginal-prior mean."""
    return torch.cat([so3_log(quat_mul(quat_conj(prior_q), q)),
                      p - prior_x[0:3], v - prior_x[3:6], ba - prior_x[6:9],
                      bg - prior_x[9:12]])


# per-GN-iteration trust-region caps for [dq, dp, dv, dba, dbg]
_TRUST_CAPS = [0.5] * 3 + [2.0] * 3 + [12.0] * 3 + [0.2] * 3 + [0.1] * 3


def _scaled_solve(A, rhs, damp=1e-7):
    """Jacobi-scaled damped linear solve (the bias random-walk weights give
    raw systems a condition number an f32 solve cannot survive)."""
    d = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(A), 1e-8))
    As = A * d[:, None] * d[None, :] + damp * torch.eye(
        A.shape[0], dtype=A.dtype, device=A.device)
    b = d * rhs if rhs.ndim == 1 else d[:, None] * rhs
    b2 = b[:, None] if rhs.ndim == 1 else b
    # a singular system yields non-finite entries, which the callers zero
    # out
    x = torch.linalg.solve_ex(As, b2)[0]
    return d * x[:, 0] if rhs.ndim == 1 else d[:, None] * x


def _interval_weights(cfg, pre_dt):
    """IMU-factor weights from the preintegrated white-noise scale."""
    dt_ref = torch.clamp_min(pre_dt, 1e-2)
    sig_vq = 1.0 / (cfg.gyr_noise * torch.sqrt(dt_ref) + 1e-6)
    sig_vv = 1.0 / (cfg.acc_noise * torch.sqrt(dt_ref) + 1e-6)
    wba = 1.0 / torch.clamp_min(
        cfg.acc_bias_noise * torch.sqrt(torch.clamp_min(pre_dt, 1e-3)), 1e-9)
    wbg = 1.0 / torch.clamp_min(
        cfg.gyr_bias_noise * torch.sqrt(torch.clamp_min(pre_dt, 1e-3)), 1e-9)
    return sig_vq, sig_vv, wba, wbg


def _lane(tree, i):
    return type(tree)(*(a[i] for a in tree))


def _marginalize_oldest(state: SmootherState, cfg: ImuConfig, lidar_w,
                        gravity_w, dtype):
    """Schur-complement the oldest window state into a Gaussian prior on
    its successor (the finite-lag counterpart of the information ISAM2
    accumulates)."""
    dev = state.p.device
    z15 = torch.zeros((15,), dtype=dtype, device=dev)
    z30 = torch.zeros((30,), dtype=dtype, device=dev)
    pre1 = _lane(state.preint, 1)
    sig_vq, sig_vv, wba, wbg = _interval_weights(cfg, pre1.dt)
    xi = (state.q[0], state.p[0], state.v[0], state.ba[0], state.bg[0])
    xj = (state.q[1], state.p[1], state.v[1], state.ba[1], state.bg[1])
    one = torch.ones((), dtype=dtype, device=dev)

    def pair(d):
        return _pair_factor_res(d, xi, xj, pre1, sig_vq, sig_vv, one, wba, wbg,
                                gravity_w)

    def pr(d):
        return _pose_prior_res(d, state.q[0], state.p[0], state.meas_q[0],
                               state.meas_p[0], lidar_w)

    rp, Jp = pair(z30), jacfwd(pair)(z30)
    r6, J6 = pr(z15), jacfwd(pr)(z15)
    r0 = _state_tangent15(*xi, state.prior_q, state.prior_x)

    # the products and solves of ops.invariant: an instance's bits under
    # vmap do not depend on the batch
    H = torch.matmul(Jp.T, Jp)
    g = torch.matmul(Jp.T, rp)
    H = H.clone()
    H[:15, :15] += torch.matmul(J6.T, J6) + state.prior_info
    g = g.clone()
    g[:15] += torch.matmul(J6.T, r6) + torch.matmul(state.prior_info, r0)

    A, B, C = H[:15, :15], H[:15, 15:], H[15:, 15:]
    AinvB = _scaled_solve(A, B)
    Ainvg = _scaled_solve(A, g[:15])
    info = C - torch.matmul(B.T, AinvB)
    info = 0.5 * (info + info.T)
    gm = g[15:] - torch.matmul(B.T, Ainvg)

    caps = torch.tensor(_TRUST_CAPS, dtype=dtype, device=dev)
    delta = torch.clamp(-_scaled_solve(info, gm), -caps, caps)
    delta = torch.where(torch.isfinite(delta), delta, 0.0)
    q1 = quat_normalize(quat_mul(state.q[1], so3_exp(delta[0:3])))
    x1_old = torch.cat([state.p[1], state.v[1], state.ba[1], state.bg[1]])
    x1 = x1_old + delta[3:]

    # exponential forgetting bounds the weight of stale linearizations
    info = info * cfg.prior_forgetting
    scale = torch.clamp_max(
        1e6 / torch.clamp_min(torch.amax(torch.diagonal(info)), 1.0), 1.0)
    info = info * scale + 1e-6 * torch.eye(15, dtype=dtype, device=dev)
    bad = ~(torch.all(torch.isfinite(info)) & torch.all(torch.isfinite(x1)))
    info = torch.where(bad, _init_prior_info(cfg, dtype, dev), info)
    x1 = torch.where(bad, x1_old, x1)
    return q1, x1, info


def smoother_update(state: SmootherState, cfg: ImuConfig,
                    lidar_pose_imu: Pose, t_key, imu: ImuWindow,
                    pre: Preintegrated | None = None
                    ) -> Tuple[SmootherState, Pose]:
    """Shift in a new keyframe constrained by the lidar pose (IMU frame)
    and re-solve the window by dense GN; the state falling off the window
    is first marginalized into the carried prior."""
    W = cfg.window_size
    dtype, dev = state.p.dtype, state.p.device
    gravity_w = torch.tensor([0.0, 0.0, -cfg.gravity], dtype=dtype,
                             device=dev)
    lidar_w = torch.full((), 1.0 / cfg.lidar_correction_noise, dtype=dtype,
                         device=dev)
    if pre is None:
        pre = preintegrate(imu, state.ba[-1], state.bg[-1], rate=cfg.imu_rate)

    marg = state.valid[0] & state.valid[1]
    mq1, mx1, minfo = _marginalize_oldest(state, cfg, lidar_w, gravity_w,
                                          dtype)
    prior_q = torch.where(marg, mq1, state.prior_q)
    prior_x = torch.where(marg, mx1, state.prior_x)
    prior_info = torch.where(marg, minfo, state.prior_info)

    q_pred, p_pred, v_pred = propagate_state(state, cfg, pre)
    first = ~state.valid[-1]
    q_new = torch.where(first, lidar_pose_imu.q, q_pred)
    p_new = torch.where(first, lidar_pose_imu.t, p_pred)
    v_new = torch.where(first, torch.zeros(3, dtype=dtype, device=dev),
                        v_pred)

    def shift(arr, new):
        return torch.cat([arr[1:], new[None]], dim=0)

    st = SmootherState(
        q=shift(state.q, q_new),
        p=shift(state.p, p_new),
        v=shift(state.v, v_new),
        ba=shift(state.ba, state.ba[-1]),
        bg=shift(state.bg, state.bg[-1]),
        t=shift(state.t, torch.as_tensor(t_key, dtype=dtype, device=dev)),
        meas_q=shift(state.meas_q, lidar_pose_imu.q),
        meas_p=shift(state.meas_p, lidar_pose_imu.t),
        preint=Preintegrated(*(shift(a, n) for a, n in zip(state.preint, pre))),
        prior_q=prior_q,
        prior_x=prior_x,
        prior_info=prior_info,
        valid=shift(state.valid, torch.ones((), dtype=torch.bool,
                                            device=dev)),
        key=state.key + 1,
        failed=state.failed,
    )

    prior_w = st.valid.to(dtype) * lidar_w
    prior_gate = st.valid[0].to(dtype)
    sig_vq, sig_vv, w_bias_a, w_bias_g = _interval_weights(cfg, st.preint.dt)
    sig_vq = sig_vq[-1]
    sig_vv = sig_vv[-1]
    w_bias_a = st.valid.to(dtype) * w_bias_a
    w_bias_g = st.valid.to(dtype) * w_bias_g
    pair_valid = (st.valid[:-1] & st.valid[1:]).to(dtype)
    pre_pairs = Preintegrated(*(a[1:] for a in st.preint))
    z15 = torch.zeros((15,), dtype=dtype, device=dev)
    z30 = torch.zeros((30,), dtype=dtype, device=dev)
    T = _bias_cumsum_map(W, dtype, dev)
    caps = torch.tensor(_TRUST_CAPS, dtype=dtype, device=dev)

    def prior_factor(q0, p0, mq, mp, w):
        return (_pose_prior_res(z15, q0, p0, mq, mp, w),
                jacfwd(_pose_prior_res)(z15, q0, p0, mq, mp, w))

    def pair_factor(xi_, xj_, pre_, wp, wa, wg):
        return (_pair_factor_res(z30, xi_, xj_, pre_, sig_vq, sig_vv, wp, wa,
                                 wg, gravity_w),
                jacfwd(_pair_factor_res)(z30, xi_, xj_, pre_, sig_vq, sig_vv,
                                         wp, wa, wg, gravity_w))

    carry = (st.q, st.p, st.v, st.ba, st.bg)
    for _ in range(cfg.smoother_gn_iters):
        q_c, p_c, v_c, ba_c, bg_c = carry
        # block-sparse normal equations: per-factor Jacobians, vmapped
        r_pr, J_pr = vmap(prior_factor)(q_c, p_c, st.meas_q, st.meas_p,
                                        prior_w)  # [W,6], [W,6,15]
        xi = (q_c[:-1], p_c[:-1], v_c[:-1], ba_c[:-1], bg_c[:-1])
        xj = (q_c[1:], p_c[1:], v_c[1:], ba_c[1:], bg_c[1:])
        r_pair, J_pair = vmap(pair_factor)(xi, xj, pre_pairs, pair_valid,
                                           w_bias_a[1:], w_bias_g[1:])
        Hp = torch.einsum("wri,wrj->wij", J_pr, J_pr)  # [W,15,15]
        gp = torch.einsum("wri,wr->wi", J_pr, r_pr)
        Hq = torch.einsum("wri,wrj->wij", J_pair, J_pair)  # [W-1,30,30]
        gq = torch.einsum("wri,wr->wi", J_pair, r_pair)
        H = torch.block_diag(*Hp)
        g = gp.reshape(-1)
        # each pair's block added in place of an indexed write (vmap takes
        # no in-place write of a batched block into a fresh tensor): the
        # padding adds exact zeros, so every sum keeps its order and bits
        Hpair = torch.zeros((W * 15, W * 15), dtype=dtype, device=dev)
        gpair = torch.zeros((W * 15,), dtype=dtype, device=dev)
        for i in range(W - 1):
            pad = (i * 15, (W - 2 - i) * 15)
            Hpair = Hpair + F.pad(Hq[i], pad + pad)
            gpair = gpair + F.pad(gq[i], pad)
        H = H + Hpair
        g = g + gpair
        # marginal prior on the oldest state (J ~ identity in its tangent)
        r0 = _state_tangent15(q_c[0], p_c[0], v_c[0], ba_c[0], bg_c[0],
                              st.prior_q, st.prior_x)
        rest = (0, (W - 1) * 15)
        H = H + F.pad(prior_gate * st.prior_info, rest + rest)
        g = g + F.pad(prior_gate * torch.matmul(st.prior_info, r0), rest)
        # hierarchical bias reparametrization (see the JAX package)
        delta = torch.matmul(T, _scaled_solve(
            torch.matmul(torch.matmul(T.T, H), T), -torch.matmul(T.T, g)))
        delta = delta.reshape(W, 15)
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        delta = torch.clamp(delta, -caps, caps)
        carry = (
            quat_normalize(quat_mul(q_c, so3_exp(delta[:, 0:3]))),
            p_c + delta[:, 3:6],
            v_c + delta[:, 6:9],
            ba_c + delta[:, 9:12],
            bg_c + delta[:, 12:15],
        )
    q_f, p_f, v_f, ba_f, bg_f = carry

    # failure detection (imuPreintegration.cpp:398-417)
    failed = ((torch.linalg.norm(v_f[-1]) > cfg.max_velocity)
              | (torch.linalg.norm(ba_f[-1]) > cfg.max_acc_bias)
              | (torch.linalg.norm(bg_f[-1]) > cfg.max_gyr_bias))
    keep = ~failed

    def sel(new, fallback):
        return torch.where(keep, new, fallback)

    out = SmootherState(
        q=sel(q_f, st.meas_q),
        p=sel(p_f, st.meas_p),
        v=sel(v_f, torch.zeros_like(v_f)),
        ba=sel(ba_f, torch.zeros_like(ba_f)),
        bg=sel(bg_f, torch.zeros_like(bg_f)),
        t=st.t,
        meas_q=st.meas_q,
        meas_p=st.meas_p,
        preint=st.preint,
        prior_q=sel(st.prior_q, st.meas_q[0]),
        prior_x=sel(st.prior_x, torch.zeros((12,), dtype=dtype, device=dev)),
        prior_info=sel(st.prior_info, _init_prior_info(cfg, dtype, dev)),
        valid=st.valid,
        key=torch.where(failed, 0, st.key).to(torch.int32),
        failed=failed,
    )
    return out, Pose(out.q[-1], out.p[-1])
