// K1 and K4: control step — frame_skip PD + rigid-body physics substeps per
// env in ONE launch, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel built by make_control_step in
// learninghumanoidwalking_tpu/ops/substep_kernel.py (its pl.pallas_call at
// :1296), in two libraries built from this one source:
//   K1 flat floor: 8 contact slots, the (z, x, y) frame;
//   K4 motor hook (LHW_MOTOR 1, a second library, flat floor): the learned
//      motor dynamics of substep_kernel.py:1018-1106 (see "Motor" below).
// The terrain variants K2 (terrain boxes) and K3 (heightfield) have a
// source of their own, control_step_terrain.cu, with the Pallas kernel's
// Woodbury contact solve and a group of lanes per env.
// It computes what that kernel and its plain twin
// physics/batched.py::pd_substeps_batched compute; the plain PyTorch version
// in this package (physics/batched.py) is the reference it is held to.
//
// What bounds it: f32 FMA throughput. The step needs about 39k flops per
// env-substep at R=1 and 29k at R=5 (flops_per_env_substep in the wrapper,
// which counts the Woodbury contact solve of the Pallas kernel; bench.py:53
// traces that kernel at 47.1k and 30.1k). This kernel solves the contact
// system in the dense form of physics/batched.py, which takes more: FK, RNE
// bias forces, every R substeps a CRBA mass matrix and its Cholesky, then
// every substep a 3nc x 3nc soft-contact system, its Cholesky and four
// projected solves. A 25-substep launch reads and writes ~2.5 KB per env:
// ~300 flops per byte or more, far above the card's f32 ridge point (67 TFLOP/s
// over 3.35 TB/s = 20 flops per byte). The
// arithmetic is a long sequential program per env (small dense
// factorizations, branches on contact state, an iterative projection), so
// this first version runs ONE THREAD PER ENV: every env is independent, the
// batch gives tens of thousands of threads, and no synchronization is
// needed. The per-env working set (M and L at nv x nv, the contact
// Jacobian, the 3nc x 3nc system and its factor) does not fit in registers;
// it lives in thread-local memory, which the L1/L2 caches serve. That
// local-memory traffic, not the FMA rate, limits this version; moving the
// working set into registers and shared memory (a warp per env) is later
// work.
//
// The model is NOT compiled in: topology, offsets, inertias, actuators and
// contact slots arrive as runtime tables (ftab / itab) in device memory,
// staged into shared memory per block. Compile-time caps bound the table
// sizes (MAX_* below); the Python wrapper refuses larger models. Outer
// loops stay rolled so the build takes seconds.
//
// Layout: every per-env input and output is a trailing-batch block
// (rows, B), element (r, b) at r * B + b, so neighbouring threads touch
// neighbouring addresses. body_ipos is (3nb, B) and xfrc (6nb, B),
// body-major.
//
// Motor (K4). Every substep's PD torque passes through the learned motor
// hook of robots/motor.py before ctrl = tau / gear: per joint a rolling
// 25-slot history of (joint velocity, commanded torque), pushed every
// substep while count < 25 and then on even counts; once warm, a per-joint
// MLP (50 -> 32 -> 32 -> 1, tanh hidden layers, linear output, plus a skip
// weight times the newest pushed torque) gives the applied torque. The
// per-env histories (joint-major rows n * 25 + slot, oldest first) and the
// int32 substep count come in and go out as trailing-batch blocks. In the
// thread they are a ring buffer, so a push writes one slot a joint and
// moves nothing. The weights (32,664 floats, 130.7 KB at the default
// widths: more than the 48 KB of static shared memory, and staging them in
// dynamic shared memory would leave one 128-thread block an SM) stay in
// global memory: every thread of a warp reads the same weight at the same
// time, so the read-only path serves it as one broadcast. The net adds
// about 64.6k flops per env-substep past warmup (12 joints x 2656 FMAs plus
// the tanh), on top of the physics at R=1, which the reference pins for
// motor steps (substep_kernel.py:1366-1368); it stays FMA-bound, and runs
// one thread per env like K1 (the per-joint products on tensor cores are
// later work). tanhf, not a fast-math tanh.
//
// NaN must propagate (the env layer terminates non-finite envs), so every
// max/min/clamp below uses NaN-propagating helpers, never fmaxf/fminf.

#include <cuda_runtime.h>
#include <math.h>

#define LHW_TERRAIN 0  // the terrain build is control_step_terrain.cu
#ifndef LHW_MOTOR
#define LHW_MOTOR 0
#endif

#define MAX_B 16   // bodies (incl. world)
#define MAX_V 20   // dofs
#define MAX_Q (MAX_V + 1)
#define MAX_U 16   // actuators
#define MAX_C 8    // contact slots
#define MAX_T 0
#define MAX_HF 0
#define MAX_F 2    // distinct foot bodies carrying contact slots
#define MAX_R (3 * MAX_C)  // contact rows
#if LHW_MOTOR
#define MAX_H 25       // motor history slots (the reference's buffer length)
#define MAX_HID 64     // motor MLP hidden width
#define MAX_LAYERS 3   // motor MLP layers (hidden + output)
#endif

// ---- int table layout ----
#define I_NB 0
#define I_NV 1
#define I_NQ 2
#define I_NU 3
#define I_NC 4
#define I_NFOOT 5
#define I_NT 6
#define I_PARENT 8
#define I_JTYPE (I_PARENT + MAX_B)
#define I_QADR (I_JTYPE + MAX_B)
#define I_DADR (I_QADR + MAX_B)
#define I_DNUM (I_DADR + MAX_B)
#define I_DOFBODY (I_DNUM + MAX_B)
#define I_DOFKIND (I_DOFBODY + MAX_V)
#define I_DOFK (I_DOFKIND + MAX_V)
#define I_ACTOFDOF (I_DOFK + MAX_V)
#define I_ACTQ (I_ACTOFDOF + MAX_V)
#define I_ACTD (I_ACTQ + MAX_U)
#define I_SLOTFOOT (I_ACTD + MAX_U)
#define I_FOOTBODY (I_SLOTFOOT + MAX_C)
#define I_ANC (I_FOOTBODY + MAX_F)
#define N_ITAB (I_ANC + MAX_B * MAX_V)

// ---- float table layout ----
#define F_GRAV 0
#define F_IMPMIN 3
#define F_IMPDIFF 4
#define F_WIDTH 5
#define F_KREF 6
#define F_BREF 7
#define F_BPOS 8
#define F_BQUAT (F_BPOS + 3 * MAX_B)
#define F_JAXIS (F_BQUAT + 4 * MAX_B)
#define F_JPOS (F_JAXIS + 3 * MAX_B)
#define F_BINER (F_JPOS + 3 * MAX_B)
#define F_IQMAT (F_BINER + 3 * MAX_B)
#define F_BMASS0 (F_IQMAT + 9 * MAX_B)
#define F_ARM (F_BMASS0 + MAX_B)
#define F_GEAR (F_ARM + MAX_V)
#define F_CLO (F_GEAR + MAX_U)
#define F_CHI (F_CLO + MAX_U)
#define F_SGPOS (F_CHI + MAX_U)
#define F_SGROT (F_SGPOS + 3 * MAX_C)
#define F_SCORN (F_SGROT + 9 * MAX_C)
#define F_MU (F_SCORN + 3 * MAX_C)
#define N_FTAB (F_MU + MAX_C)

// joint types and dof kinds (physics/model.py codes)
#define J_FREE 0
#define J_HINGE 1
#define J_SLIDE 2
#define DOF_FREE_LIN 0
#define DOF_FREE_ANG 1
#define DOF_HINGE 2
#define DOF_SLIDE 3
// contact slot kinds: corner vs the z=0 plane, vs the plane at floor_z (static
// frame), vs the heightfield surface, vs the terrain-box SDF (tilted frames)
#define SLOT_FLAT 0
#define SLOT_FLOOR 1
#define SLOT_HFIELD 2
#define SLOT_BOX 3

#define THREADS 128

#include "control_step_math.cuh"
// Lower Cholesky in place (outer-product order of physics/linalg_small.py:
// diagonal clamped at eps, column divided by sqrt of the pivot).
__device__ void cholesky(float* a, int n, int ld) {
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    float d = sqrtf(pmax(a[j * ld + j], 1e-12f));
#pragma unroll 1
    for (int i = j; i < n; ++i) a[i * ld + j] = a[i * ld + j] / d;
#pragma unroll 1
    for (int k = j + 1; k < n; ++k) {
      float lk = a[k * ld + j];
#pragma unroll 1
      for (int i = k; i < n; ++i) a[i * ld + k] -= a[i * ld + j] * lk;
    }
  }
}

// Solve L L^T x = b in place (b -> x), L lower with leading dimension ld.
__device__ void cho_solve(const float* l, int n, int ld, float* b) {
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    float y = b[j] / l[j * ld + j];
    b[j] = y;
#pragma unroll 1
    for (int i = j + 1; i < n; ++i) b[i] -= l[i * ld + j] * y;
  }
#pragma unroll 1
  for (int j = n - 1; j >= 0; --j) {
    float x = b[j] / l[j * ld + j];
    b[j] = x;
#pragma unroll 1
    for (int i = 0; i < j; ++i) b[i] -= l[j * ld + i] * x;
  }
}

// Forward kinematics + rotation matrices of every body.
__device__ void fk(const float* sf, const int* si, const float* q, float* xpos, float* xquat, float* rmat) {
  const int nb = si[I_NB];
  xpos[0] = xpos[1] = xpos[2] = 0.f;
  xquat[0] = 1.f; xquat[1] = xquat[2] = xquat[3] = 0.f;
#pragma unroll 1
  for (int i = 1; i < nb; ++i) {
    const int p = si[I_PARENT + i];
    const int adr = si[I_QADR + i];
    float xpre[3], qpre[4], t[3];
    qrot(xquat + 4 * p, sf + F_BPOS + 3 * i, t);
    xpre[0] = xpos[3 * p] + t[0]; xpre[1] = xpos[3 * p + 1] + t[1]; xpre[2] = xpos[3 * p + 2] + t[2];
    qmul(xquat + 4 * p, sf + F_BQUAT + 4 * i, qpre);
    float* x = xpos + 3 * i;
    float* qq = xquat + 4 * i;
    const int jt = si[I_JTYPE + i];
    if (jt == J_FREE) {
      x[0] = q[adr]; x[1] = q[adr + 1]; x[2] = q[adr + 2];
      qq[0] = q[adr + 3]; qq[1] = q[adr + 4]; qq[2] = q[adr + 5]; qq[3] = q[adr + 6];
      qnormalize(qq);
    } else if (jt == J_HINGE) {
      const float* ax = sf + F_JAXIS + 3 * i;
      const float* anchor = sf + F_JPOS + 3 * i;
      float half = 0.5f * q[adr];
      float s = sinf(half);
      float qj[4] = {cosf(half), ax[0] * s, ax[1] * s, ax[2] * s};
      qmul(qpre, qj, qq);
      float a1[3], a2[3];
      qrot(qpre, anchor, a1);
      qrot(qq, anchor, a2);
      x[0] = xpre[0] + a1[0] - a2[0];
      x[1] = xpre[1] + a1[1] - a2[1];
      x[2] = xpre[2] + a1[2] - a2[2];
    } else if (jt == J_SLIDE) {
      const float* ax = sf + F_JAXIS + 3 * i;
      qq[0] = qpre[0]; qq[1] = qpre[1]; qq[2] = qpre[2]; qq[3] = qpre[3];
      x[0] = xpre[0] + ax[0] * q[adr]; x[1] = xpre[1] + ax[1] * q[adr]; x[2] = xpre[2] + ax[2] * q[adr];
    } else {
      qq[0] = qpre[0]; qq[1] = qpre[1]; qq[2] = qpre[2]; qq[3] = qpre[3];
      x[0] = xpre[0]; x[1] = xpre[1]; x[2] = xpre[2];
    }
  }
#pragma unroll 1
  for (int i = 0; i < nb; ++i) qmat(xquat + 4 * i, rmat + 9 * i);
}

// Per-dof screw axes S (nv x 6: angular, linear at the world origin).
__device__ void motion_subspace(const float* sf, const int* si, const float* xpos, const float* rmat, float* s) {
  const int nv = si[I_NV];
#pragma unroll 1
  for (int d = 0; d < nv; ++d) {
    const int b = si[I_DOFBODY + d];
    const int kind = si[I_DOFKIND + d];
    const int k = si[I_DOFK + d];
    const float* r = rmat + 9 * b;
    float* sd = s + 6 * d;
    if (kind == DOF_FREE_LIN) {
      sd[0] = sd[1] = sd[2] = 0.f;
      sd[3] = (k == 0) ? 1.f : 0.f; sd[4] = (k == 1) ? 1.f : 0.f; sd[5] = (k == 2) ? 1.f : 0.f;
    } else if (kind == DOF_FREE_ANG) {
      float axis[3] = {r[k], r[3 + k], r[6 + k]};
      sd[0] = axis[0]; sd[1] = axis[1]; sd[2] = axis[2];
      cross3(xpos + 3 * b, axis, sd + 3);
    } else {
      const float* a = sf + F_JAXIS + 3 * b;
      float aw[3];
      for (int c = 0; c < 3; ++c) aw[c] = a[0] * r[3 * c] + a[1] * r[3 * c + 1] + a[2] * r[3 * c + 2];
      sd[0] = aw[0]; sd[1] = aw[1]; sd[2] = aw[2];
      if (kind == DOF_HINGE) {
        const float* pl = sf + F_JPOS + 3 * b;
        float anchor[3];
        for (int c = 0; c < 3; ++c)
          anchor[c] = xpos[3 * b + c] + (pl[0] * r[3 * c] + pl[1] * r[3 * c + 1] + pl[2] * r[3 * c + 2]);
        cross3(anchor, aw, sd + 3);
      } else {
        sd[3] = aw[0]; sd[4] = aw[1]; sd[5] = aw[2];
        sd[0] = sd[1] = sd[2] = 0.f;
      }
    }
  }
}

// Body spatial velocities: cvel_i = cvel_parent + sum of own S_d qvel_d.
__device__ void body_velocities(const int* si, const float* s, const float* v, float* cvel) {
  const int nb = si[I_NB];
  for (int c = 0; c < 6; ++c) cvel[c] = 0.f;
#pragma unroll 1
  for (int i = 1; i < nb; ++i) {
    const int p = si[I_PARENT + i];
    for (int c = 0; c < 6; ++c) cvel[6 * i + c] = cvel[6 * p + c];
    const int adr = si[I_DADR + i], num = si[I_DNUM + i];
#pragma unroll 1
    for (int d = adr; d < adr + num; ++d)
      for (int c = 0; c < 6; ++c) cvel[6 * i + c] += s[6 * d + c] * v[d];
  }
}

// Spatial inertia (compact: mass m, first moment h = m c, rotational inertia
// about the world origin ibar, 3x3) times a motion vector (w, v0):
// (ibar w + h x v0, m v0 - h x w).
__device__ __forceinline__ void inertia_apply(const float* in, const float* mv, float* out) {
  const float m = in[0];
  const float* h = in + 1;
  const float* ib = in + 4;
  float hv[3], hw[3];
  cross3(h, mv + 3, hv);
  cross3(h, mv, hw);
  for (int r = 0; r < 3; ++r) {
    out[r] = ib[3 * r] * mv[0] + ib[3 * r + 1] * mv[1] + ib[3 * r + 2] * mv[2] + hv[r];
    out[3 + r] = m * mv[3 + r] - hw[r];
  }
}

#define NINER 13  // compact inertia record: m, h(3), ibar(9)

#if LHW_MOTOR
// Applied torque of joint n from its histories qdh, cth (MAX_H slots each;
// logical slot h, oldest first, at ring index (head + h) % MAX_H), through
// its MLP. Weights mw: per layer l, w_l (nu, d_l, d_{l+1}) then b_l
// (nu, d_{l+1}), row-major as robots/motor.py stacks them; then skip (nu).
// dims: d_0 = 2 MAX_H, ..., d_nl = 1.
__device__ float motor_net(const float* __restrict__ mw, int nu, int nl, const int* dims, int n, const float* qdh,
                           const float* cth, int head) {
  float x[2 * MAX_H > MAX_HID ? 2 * MAX_H : MAX_HID], y[MAX_HID];
#pragma unroll 1
  for (int h = 0; h < MAX_H; ++h) {
    int r = head + h;
    if (r >= MAX_H) r -= MAX_H;
    x[h] = qdh[r];
    x[MAX_H + h] = cth[r];
  }
  int off = 0;
#pragma unroll 1
  for (int l = 0; l < nl; ++l) {
    const int din = dims[l], dout = dims[l + 1];
    const float* w = mw + off + n * din * dout;
    const float* bias = mw + off + nu * din * dout + n * dout;
#pragma unroll 1
    for (int o = 0; o < dout; ++o) {
      float acc = __ldg(bias + o);
#pragma unroll 1
      for (int i = 0; i < din; ++i) acc += x[i] * __ldg(w + i * dout + o);
      y[o] = (l < nl - 1) ? tanhf(acc) : acc;
    }
    for (int o = 0; o < dout; ++o) x[o] = y[o];
    off += nu * din * dout + nu * dout;
  }
  const int newest = (head == 0) ? MAX_H - 1 : head - 1;
  return __ldg(mw + off + n) * cth[newest] + x[0];
}
#endif


extern "C" __global__ void __launch_bounds__(THREADS) control_step_kernel(
    int batch, int frame_skip, int reuse, int settle, float dt,
    const float* __restrict__ ftab, const int* __restrict__ itab,
    const float* __restrict__ qpos_in, const float* __restrict__ qvel_in,
    const float* __restrict__ target, const float* __restrict__ kp_in,
    const float* __restrict__ kd_in, const float* __restrict__ bemf_in,
    const float* __restrict__ damping_in, const float* __restrict__ frictionloss_in,
    const float* __restrict__ body_mass_in, const float* __restrict__ body_ipos_in,
    const float* __restrict__ xfrc_in,
#if LHW_MOTOR
    const float* __restrict__ motor_w, int motor_layers, int motor_hid0, int motor_hid1,
    const float* __restrict__ qd_hist_in, const float* __restrict__ ct_hist_in, const int* __restrict__ count_in,
    float* __restrict__ qd_hist_out, float* __restrict__ ct_hist_out, int* __restrict__ count_out,
#endif
    float* __restrict__ qpos_out, float* __restrict__ qvel_out, float* __restrict__ qacc_out,
    float* __restrict__ act_out, float* __restrict__ cforce_out, float* __restrict__ cdist_out,
    float* __restrict__ cmask_out, float* __restrict__ cpos_out, float* __restrict__ cnormal_out,
    float* __restrict__ xpos_out, float* __restrict__ xquat_out, float* __restrict__ cvel_out) {
  __shared__ float sf[N_FTAB];
  __shared__ int si[N_ITAB];
  for (int k = threadIdx.x; k < N_FTAB; k += blockDim.x) sf[k] = ftab[k];
  for (int k = threadIdx.x; k < N_ITAB; k += blockDim.x) si[k] = itab[k];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int B = batch;
  const int nb = si[I_NB], nv = si[I_NV], nq = si[I_NQ], nu = si[I_NU], nc = si[I_NC];
  const int nfoot = si[I_NFOOT];
  const int nr = 3 * nc;

  // per-env inputs
  float q[MAX_Q], v[MAX_V];
  float tgt[MAX_U], kp[MAX_U], kd[MAX_U], bemf[MAX_U];
  float damp[MAX_V], fric[MAX_V], bmass[MAX_B], bipos[3 * MAX_B], xf[6 * MAX_B];
  for (int r = 0; r < nq; ++r) q[r] = qpos_in[r * B + b];
  for (int r = 0; r < nv; ++r) {
    v[r] = qvel_in[r * B + b];
    damp[r] = damping_in[r * B + b];
    fric[r] = frictionloss_in[r * B + b];
  }
  for (int r = 0; r < nu; ++r) {
    tgt[r] = target[r * B + b];
    kp[r] = kp_in[r * B + b];
    kd[r] = kd_in[r * B + b];
    bemf[r] = bemf_in[r * B + b];
  }
  for (int r = 0; r < nb; ++r) bmass[r] = body_mass_in[r * B + b];
  for (int r = 0; r < 3 * nb; ++r) bipos[r] = body_ipos_in[r * B + b];
  for (int r = 0; r < 6 * nb; ++r) xf[r] = xfrc_in[r * B + b];

  // per-env working set (thread-local memory)
  float xpos[3 * MAX_B], xquat[4 * MAX_B], rmat[9 * MAX_B];
  float s[6 * MAX_V], cvel[6 * MAX_B];
  float iner[NINER * MAX_B];   // per-body compact spatial inertia; composite at refresh
  float acc[6 * MAX_B], gsub[6 * MAX_B];
  float qfrc[MAX_V], qacc_s[MAX_V], qacc[MAX_V], act[MAX_U];
  float lm[MAX_V * MAX_V];     // M + armature + dt*damping, then its Cholesky (lagged)
  float basis[MAX_F * 6 * MAX_V];  // foot-body jacobian rows (lagged)
  float jc[MAX_R * MAX_V], minvjt[MAX_R * MAX_V];
  float am[MAX_R * MAX_R], la[MAX_R * MAX_R];
  float cw[3 * MAX_C], cdist[MAX_C], cmask[MAX_C];
  float bvec[MAX_R], force[MAX_R], tmp[MAX_R];

  const float impmin = sf[F_IMPMIN], impdiff = sf[F_IMPDIFF], width = sf[F_WIDTH];
  const float kref = sf[F_KREF], bref = sf[F_BREF];
#if LHW_MOTOR
  // motor histories as ring buffers (joint n's slots at n * MAX_H), the
  // ring index of the oldest slot, and the substep count
  float qdh[MAX_U * MAX_H], cth[MAX_U * MAX_H];
#pragma unroll 1
  for (int r = 0; r < nu * MAX_H; ++r) {
    qdh[r] = qd_hist_in[r * B + b];
    cth[r] = ct_hist_in[r * B + b];
  }
  int m_head = 0;
  int m_count = count_in[b];
  int m_dims[MAX_LAYERS + 1];
  m_dims[0] = 2 * MAX_H;
  for (int l = 1; l < motor_layers; ++l) m_dims[l] = (l == 1) ? motor_hid0 : motor_hid1;
  m_dims[motor_layers] = 1;
#endif

#pragma unroll 1
  for (int sub = 0; sub < frame_skip; ++sub) {
    const bool refresh = (sub % reuse) == 0;
#if LHW_MOTOR
    // warm: the command passes through; push: every substep while warm,
    // then on even counts (the oldest slot is dropped, the newest written)
    const bool m_warm = m_count < MAX_H;
    const bool m_push = m_warm || (m_count % 2) == 0;
    const int m_next = m_push ? ((m_head + 1 == MAX_H) ? 0 : m_head + 1) : m_head;
#endif

    // ---- PD torque -> actuator force (ctrlrange clamp, gear) ----
#pragma unroll 1
    for (int a = 0; a < nu; ++a) {
      float gear = sf[F_GEAR + a];
      float ctrl = 0.f;
      if (!settle) {
        float qa = q[si[I_ACTQ + a]], va = v[si[I_ACTD + a]];
        float tau = kp[a] * (tgt[a] - qa) - kd[a] * va - bemf[a] * va;
#if LHW_MOTOR
        if (m_push) {
          qdh[a * MAX_H + m_head] = va;
          cth[a * MAX_H + m_head] = tau;
        }
        if (!m_warm) tau = motor_net(motor_w, nu, motor_layers, m_dims, a, qdh + a * MAX_H, cth + a * MAX_H, m_next);
#endif
        ctrl = tau / gear;
      }
      float lo = sf[F_CLO + a], hi = sf[F_CHI + a];
      if (ctrl < lo) ctrl = lo;
      if (ctrl > hi) ctrl = hi;
      act[a] = gear * ctrl;
    }
#if LHW_MOTOR
    if (!settle) {  // settle substeps take no motor model
      m_head = m_next;
      ++m_count;
    }
#endif

    // ---- kinematics ----
    fk(sf, si, q, xpos, xquat, rmat);
    motion_subspace(sf, si, xpos, rmat, s);
    body_velocities(si, s, v, cvel);

    // ---- spatial inertias with mass / CoM randomization ----
#pragma unroll 1
    for (int i = 1; i < nb; ++i) {
      const float* r = rmat + 9 * i;
      const float* iq = sf + F_IQMAT + 9 * i;
      float rot[9];
      for (int rr = 0; rr < 3; ++rr)
        for (int cc = 0; cc < 3; ++cc)
          rot[3 * rr + cc] = r[3 * rr] * iq[cc] + r[3 * rr + 1] * iq[3 + cc] + r[3 * rr + 2] * iq[6 + cc];
      const float m = bmass[i];
      const float ratio = m / sf[F_BMASS0 + i];
      float dg[3];
      for (int k = 0; k < 3; ++k) dg[k] = sf[F_BINER + 3 * i + k] * ratio;
      float com[3];
      for (int c = 0; c < 3; ++c)
        com[c] = xpos[3 * i + c] + (r[3 * c] * bipos[3 * i] + r[3 * c + 1] * bipos[3 * i + 1] + r[3 * c + 2] * bipos[3 * i + 2]);
      const float c2 = com[0] * com[0] + com[1] * com[1] + com[2] * com[2];
      float* in = iner + NINER * i;
      in[0] = m;
      in[1] = m * com[0]; in[2] = m * com[1]; in[3] = m * com[2];
      for (int rr = 0; rr < 3; ++rr)
        for (int cc = 0; cc < 3; ++cc) {
          float icom = rot[3 * rr] * dg[0] * rot[3 * cc] + rot[3 * rr + 1] * dg[1] * rot[3 * cc + 1] +
                       rot[3 * rr + 2] * dg[2] * rot[3 * cc + 2];
          // ibar = icom - m skew(c)^2 = icom - m (c c^T - |c|^2 I)
          in[4 + 3 * rr + cc] = icom - m * (com[rr] * com[cc] - (rr == cc ? c2 : 0.f));
        }
    }

    // ---- RNE bias forces and applied wrenches, as S_d . subtree sums ----
    acc[0] = acc[1] = acc[2] = 0.f;
    acc[3] = -sf[F_GRAV]; acc[4] = -sf[F_GRAV + 1]; acc[5] = -sf[F_GRAV + 2];
#pragma unroll 1
    for (int i = 1; i < nb; ++i) {
      const int p = si[I_PARENT + i];
      float vj[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      const int adr = si[I_DADR + i], num = si[I_DNUM + i];
#pragma unroll 1
      for (int d = adr; d < adr + num; ++d)
        for (int c = 0; c < 6; ++c) vj[c] += s[6 * d + c] * v[d];
      const float* cv = cvel + 6 * i;
      float t1[3], t2[3], t3[3];
      cross3(cv, vj, t1);
      cross3(cv, vj + 3, t2);
      cross3(cv + 3, vj, t3);
      for (int c = 0; c < 3; ++c) {
        acc[6 * i + c] = acc[6 * p + c] + t1[c];
        acc[6 * i + 3 + c] = acc[6 * p + 3 + c] + t2[c] + t3[c];
      }
    }
#pragma unroll 1
    for (int i = 0; i < 6 * nb; ++i) gsub[i] = 0.f;
#pragma unroll 1
    for (int i = nb - 1; i >= 1; --i) {
      const float* in = iner + NINER * i;
      const float* cv = cvel + 6 * i;
      float ia[6], iv[6], fc[6], t1[3], t2[3];
      inertia_apply(in, acc + 6 * i, ia);
      inertia_apply(in, cv, iv);
      // cvel x* (I cvel) = (w x n + v0 x f, w x f)
      cross3(cv, iv, t1);
      cross3(cv + 3, iv + 3, t2);
      for (int c = 0; c < 3; ++c) fc[c] = t1[c] + t2[c];
      cross3(cv, iv + 3, fc + 3);
      // applied wrench about the origin: (xpos x force + torque, force)
      const float* w = xf + 6 * i;
      float mom[3];
      cross3(xpos + 3 * i, w, mom);
      float* g = gsub + 6 * i;
      for (int c = 0; c < 3; ++c) {
        g[c] += (mom[c] + w[3 + c]) - (ia[c] + fc[c]);
        g[3 + c] += w[c] - (ia[3 + c] + fc[3 + c]);
      }
      const int p = si[I_PARENT + i];
      if (p > 0)
        for (int c = 0; c < 6; ++c) gsub[6 * p + c] += g[c];
    }
#pragma unroll 1
    for (int d = 0; d < nv; ++d) {
      const float* g = gsub + 6 * si[I_DOFBODY + d];
      const float* sd = s + 6 * d;
      float f = sd[0] * g[0] + sd[1] * g[1] + sd[2] * g[2] + sd[3] * g[3] + sd[4] * g[4] + sd[5] * g[5];
      const int a = si[I_ACTOFDOF + d];
      if (a >= 0) f += act[a];
      f += -fric[d] * tanhf(v[d] / 0.02f);
      f += -damp[d] * v[d];
      qfrc[d] = f;
    }

    // ---- refresh: CRBA mass matrix, its Cholesky, contact basis ----
    if (refresh) {
#pragma unroll 1
      for (int i = nb - 1; i >= 1; --i) {
        const int p = si[I_PARENT + i];
        if (p > 0)
          for (int c = 0; c < NINER; ++c) iner[NINER * p + c] += iner[NINER * i + c];
      }
#pragma unroll 1
      for (int d = 0; d < nv; ++d) {
        const int bd = si[I_DOFBODY + d];
        float fd[6];
        inertia_apply(iner + NINER * bd, s + 6 * d, fd);
#pragma unroll 1
        for (int e = 0; e <= d; ++e) {
          float val = 0.f;
          if (si[I_ANC + bd * MAX_V + e]) {
            const float* se = s + 6 * e;
            val = se[0] * fd[0] + se[1] * fd[1] + se[2] * fd[2] + se[3] * fd[3] + se[4] * fd[4] + se[5] * fd[5];
          }
          lm[d * MAX_V + e] = val;
        }
        lm[d * MAX_V + d] += sf[F_ARM + d] + dt * damp[d];
      }
      cholesky(lm, nv, MAX_V);
#pragma unroll 1
      for (int f = 0; f < nfoot; ++f) {
        const int fbody = si[I_FOOTBODY + f];
#pragma unroll 1
        for (int k = 0; k < 6; ++k)
#pragma unroll 1
          for (int d = 0; d < nv; ++d)
            basis[(f * 6 + k) * MAX_V + d] = si[I_ANC + fbody * MAX_V + d] ? s[6 * d + k] : 0.f;
      }
    }

    for (int d = 0; d < nv; ++d) qacc_s[d] = qfrc[d];
    cho_solve(lm, nv, MAX_V, qacc_s);

    // ---- contacts: 4 bottom corners per foot box, one slot per kind ----
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      const int f = si[I_SLOTFOOT + c];
      const int bi = si[I_FOOTBODY + f];
      const float* r = rmat + 9 * bi;
      const float* gl = sf + F_SGPOS + 3 * c;
      const float* gr = sf + F_SGROT + 9 * c;
      const float* cl = sf + F_SCORN + 3 * c;
      float gpos[3], rg[9];
      for (int rr = 0; rr < 3; ++rr) {
        gpos[rr] = xpos[3 * bi + rr] + (r[3 * rr] * gl[0] + r[3 * rr + 1] * gl[1] + r[3 * rr + 2] * gl[2]);
        for (int cc = 0; cc < 3; ++cc)
          rg[3 * rr + cc] = r[3 * rr] * gr[cc] + r[3 * rr + 1] * gr[3 + cc] + r[3 * rr + 2] * gr[6 + cc];
      }
      for (int rr = 0; rr < 3; ++rr)
        cw[3 * c + rr] = gpos[rr] + (rg[3 * rr] * cl[0] + rg[3 * rr + 1] * cl[1] + rg[3 * rr + 2] * cl[2]);
      cdist[c] = cw[3 * c + 2];
      cmask[c] = (cdist[c] < 0.f) ? 1.f : 0.f;
      // contact rows through the lagged basis (v_point = lin - p x ang per
      // dof); static frame rows (z, x, y)
      const float* ang = basis + (f * 6) * MAX_V;
      const float* lin = basis + (f * 6 + 3) * MAX_V;
      const float px = cw[3 * c], py = cw[3 * c + 1], pz = cw[3 * c + 2];
#pragma unroll 1
      for (int d = 0; d < nv; ++d) {
        const float a0 = ang[d], a1 = ang[MAX_V + d], a2 = ang[2 * MAX_V + d];
        const float jx = lin[d] - (py * a2 - pz * a1);
        const float jy = lin[MAX_V + d] - (pz * a0 - px * a2);
        const float jz = lin[2 * MAX_V + d] - (px * a1 - py * a0);
        jc[(3 * c) * MAX_V + d] = jz;
        jc[(3 * c + 1) * MAX_V + d] = jx;
        jc[(3 * c + 2) * MAX_V + d] = jy;
      }
    }

    // ---- A = Jc M^-1 Jc^T through the lagged factor ----
#pragma unroll 1
    for (int i = 0; i < nr; ++i) {
      float* mi = minvjt + i * MAX_V;
      for (int d = 0; d < nv; ++d) mi[d] = jc[i * MAX_V + d];
      cho_solve(lm, nv, MAX_V, mi);
    }
#pragma unroll 1
    for (int i = 0; i < nr; ++i)
#pragma unroll 1
      for (int j = 0; j < nr; ++j) {
        float acc_ = 0.f;
#pragma unroll 1
        for (int d = 0; d < nv; ++d) acc_ += jc[i * MAX_V + d] * minvjt[j * MAX_V + d];
        am[i * MAX_R + j] = acc_;
      }

    // ---- soft-constraint impedance, reference acceleration, regularizer ----
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      const float pen = pmin(cdist[c], 0.f);
      const float imp = impmin + impdiff * pmin(pmax(-pen / width, 0.f), 1.f);
      const float rreg = (1.f - imp) / pmax(imp, 1e-6f);
      const float m = cmask[c];
#pragma unroll 1
      for (int f = 0; f < 3; ++f) {
        const int i = 3 * c + f;
        float vel = 0.f, a0 = 0.f;
        for (int d = 0; d < nv; ++d) {
          vel += jc[i * MAX_V + d] * v[d];
          a0 += jc[i * MAX_V + d] * qacc_s[d];
        }
        float aref = -bref * vel;
        if (f == 0) aref = aref - kref * imp * pen;
        tmp[i] = rreg * pmax(am[i * MAX_R + i], 1e-8f);  // r_diag
        bvec[i] = (aref - a0) * m;
      }
    }
#pragma unroll 1
    for (int i = 0; i < nr; ++i) {
      const float mi = cmask[i / 3];
#pragma unroll 1
      for (int j = 0; j < nr; ++j) {
        float val = am[i * MAX_R + j] * (mi * cmask[j / 3]);
        if (i == j) val += 1.f - mi + tmp[i] * mi;
        am[i * MAX_R + j] = val;
        la[i * MAX_R + j] = val;
      }
    }
    cholesky(la, nr, MAX_R);

    // ---- projected refinement on the friction cones ----
    const float* mu = sf + F_MU;
#pragma unroll 1
    for (int it = 0; it < 4; ++it) {
      if (it == 0) {
        for (int i = 0; i < nr; ++i) tmp[i] = bvec[i];
      } else {
#pragma unroll 1
        for (int i = 0; i < nr; ++i) {
          float r_ = 0.f;
          for (int j = 0; j < nr; ++j) r_ += am[i * MAX_R + j] * force[j];
          tmp[i] = bvec[i] - r_;
        }
      }
      cho_solve(la, nr, MAX_R, tmp);
      if (it > 0)
        for (int i = 0; i < nr; ++i) tmp[i] = force[i] + tmp[i];
#pragma unroll 1
      for (int c = 0; c < nc; ++c) {
        const float fn = pmax(tmp[3 * c], 0.f);
        const float f1 = tmp[3 * c + 1], f2 = tmp[3 * c + 2];
        const float ftn = sqrtf(f1 * f1 + f2 * f2) + 1e-9f;
        const float scale = pmin((mu[c] * fn) / ftn, 1.f);
        const float m = cmask[c];
        force[3 * c] = fn * m;
        force[3 * c + 1] = (f1 * scale) * m;
        force[3 * c + 2] = (f2 * scale) * m;
      }
    }

    // ---- constraint force back to joint space; semi-implicit Euler ----
#pragma unroll 1
    for (int d = 0; d < nv; ++d) {
      float f = 0.f;
      for (int i = 0; i < nr; ++i) f += jc[i * MAX_V + d] * force[i];
      qacc[d] = f;
    }
    cho_solve(lm, nv, MAX_V, qacc);
#pragma unroll 1
    for (int d = 0; d < nv; ++d) {
      qacc[d] = qacc_s[d] + qacc[d];
      v[d] = pmin(pmax(v[d] + dt * qacc[d], -1e4f), 1e4f);
    }
#pragma unroll 1
    for (int i = 1; i < nb; ++i) {
      const int jt = si[I_JTYPE + i];
      const int qa = si[I_QADR + i], da = si[I_DADR + i];
      if (jt == J_HINGE || jt == J_SLIDE) {
        q[qa] = q[qa] + dt * v[da];
      } else if (jt == J_FREE) {
        for (int c = 0; c < 3; ++c) q[qa + c] = q[qa + c] + dt * v[da + c];
        const float* om = v + da + 3;
        const float angle = sqrtf(om[0] * om[0] + om[1] * om[1] + om[2] * om[2]) * dt;
        const float half = 0.5f * angle;
        // 0.5 dt sinc(half / pi) = 0.5 dt sin(half) / half
        const float sc = (half == 0.f) ? 0.5f * dt : 0.5f * dt * (sinf(half) / half);
        float dq[4] = {cosf(half), sc * om[0], sc * om[1], sc * om[2]};
        float qn[4];
        qmul(q + qa + 3, dq, qn);
        qnormalize(qn);
        for (int c = 0; c < 4; ++c) q[qa + 3 + c] = qn[c];
      }
    }
  }

  // ---- outputs: state, last-substep extras, final FK caches ----
  for (int r = 0; r < nq; ++r) qpos_out[r * B + b] = q[r];
  for (int r = 0; r < nv; ++r) {
    qvel_out[r * B + b] = v[r];
    qacc_out[r * B + b] = qacc[r];
  }
  for (int r = 0; r < nu; ++r) act_out[r * B + b] = act[r];
  for (int c = 0; c < nc; ++c) {
    cdist_out[c * B + b] = cdist[c];
    cmask_out[c * B + b] = cmask[c];
    for (int k = 0; k < 3; ++k) {
      cforce_out[(3 * c + k) * B + b] = force[3 * c + k];
      cpos_out[(3 * c + k) * B + b] = cw[3 * c + k];
      cnormal_out[(3 * c + k) * B + b] = (k == 2) ? 1.f : 0.f;
    }
  }
  fk(sf, si, q, xpos, xquat, rmat);
  motion_subspace(sf, si, xpos, rmat, s);
  body_velocities(si, s, v, cvel);
  for (int r = 0; r < 3 * nb; ++r) xpos_out[r * B + b] = xpos[r];
  for (int r = 0; r < 4 * nb; ++r) xquat_out[r * B + b] = xquat[r];
  for (int r = 0; r < 6 * nb; ++r) cvel_out[r * B + b] = cvel[r];
#if LHW_MOTOR
#pragma unroll 1
  for (int n = 0; n < nu; ++n)
#pragma unroll 1
    for (int h = 0; h < MAX_H; ++h) {
      int r = m_head + h;
      if (r >= MAX_H) r -= MAX_H;
      qd_hist_out[(n * MAX_H + h) * B + b] = qdh[n * MAX_H + r];
      ct_hist_out[(n * MAX_H + h) * B + b] = cth[n * MAX_H + r];
    }
  count_out[b] = m_count;
#endif
}

#if LHW_MOTOR
#define LHW_LAYOUT_MOTOR(X) X(LHW_MOTOR) X(MAX_H) X(MAX_HID) X(MAX_LAYERS)
#else
#define LHW_LAYOUT_MOTOR(X)
#endif

// Table layout for the Python side, which builds the tables from it and
// keeps no copy: caps, table sizes, every offset and the dof-kind codes, as
// (name, value) pairs (the motor build adds LHW_MOTOR and its caps).
#define LHW_LAYOUT(X)                                                                          \
  X(LHW_TERRAIN) X(MAX_B) X(MAX_V) X(MAX_Q) X(MAX_U) X(MAX_C) X(MAX_T) X(MAX_HF) X(MAX_F)     \
  X(N_FTAB) X(N_ITAB)                                                                          \
  X(I_NB) X(I_NV) X(I_NQ) X(I_NU) X(I_NC) X(I_NFOOT) X(I_NT) X(I_PARENT) X(I_JTYPE) X(I_QADR) \
  X(I_DADR) X(I_DNUM) X(I_DOFBODY) X(I_DOFKIND) X(I_DOFK) X(I_ACTOFDOF) X(I_ACTQ) X(I_ACTD)   \
  X(I_SLOTFOOT) X(I_FOOTBODY) X(I_ANC) LHW_LAYOUT_MOTOR(X)                                  \
  X(F_GRAV) X(F_IMPMIN) X(F_IMPDIFF) X(F_WIDTH) X(F_KREF) X(F_BREF) X(F_BPOS) X(F_BQUAT)      \
  X(F_JAXIS) X(F_JPOS) X(F_BINER) X(F_IQMAT) X(F_BMASS0) X(F_ARM) X(F_GEAR) X(F_CLO) X(F_CHI) \
  X(F_SGPOS) X(F_SGROT) X(F_SCORN) X(F_MU)                                                     \
  X(DOF_FREE_LIN) X(DOF_FREE_ANG) X(DOF_HINGE) X(DOF_SLIDE)                                  \
  X(SLOT_FLAT) X(SLOT_FLOOR) X(SLOT_HFIELD) X(SLOT_BOX)

extern "C" int lhw_control_step_layout(const char** names, int* values, int n) {
#define LHW_NAME(x) #x,
#define LHW_VALUE(x) x,
  static const char* const keys[] = {LHW_LAYOUT(LHW_NAME)};
  static const int vals[] = {LHW_LAYOUT(LHW_VALUE)};
#undef LHW_NAME
#undef LHW_VALUE
  const int count = (int)(sizeof(vals) / sizeof(vals[0]));
  for (int k = 0; k < count && k < n; ++k) {
    names[k] = keys[k];
    values[k] = vals[k];
  }
  return count;
}

#if LHW_MOTOR
#define LHW_MOTOR_ARGS                                                                                    \
  const void *motor_w, int motor_layers, int motor_hid0, int motor_hid1, const void *qd_hist,             \
      const void *ct_hist, const void *count, void *qd_hist_out, void *ct_hist_out, void *count_out,
#else
#define LHW_MOTOR_ARGS
#endif

// Launch on the caller's stream; returns cudaGetLastError() (0 = launched).
// Both builds take the terrain arguments of the terrain build's entry and
// ignore them, so the three libraries share one signature up to the
// build's own arguments. The motor build alone takes the motor arguments
// (before the stream): the stacked weights, the layer count and the two
// hidden widths, the histories (nu * MAX_H, B) and the int32 count (1, B)
// in and out.
extern "C" int lhw_control_step(
    int batch, int frame_skip, int reuse, int settle, float dt,
    const void* ftab, const void* itab,
    const void* qpos, const void* qvel, const void* target, const void* kp, const void* kd,
    const void* bemf, const void* damping, const void* frictionloss, const void* body_mass,
    const void* body_ipos, const void* xfrc,
    int hf_h, int hf_w, const void* terrain_pos, const void* terrain_size, const void* terrain_cos,
    const void* terrain_sin, const void* floor_z, const void* hfield, const void* hf_x0y0,
    const void* hf_cell,
    void* qpos_out, void* qvel_out, void* qacc_out, void* act_out, void* cforce, void* cdist,
    void* cmask, void* cpos, void* cnormal, void* xpos, void* xquat, void* cvel, LHW_MOTOR_ARGS void* stream) {
  if (batch <= 0) return 0;
  dim3 block(THREADS);
  dim3 grid((batch + THREADS - 1) / THREADS);
  control_step_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      batch, frame_skip, reuse, settle, dt, (const float*)ftab, (const int*)itab,
      (const float*)qpos, (const float*)qvel, (const float*)target, (const float*)kp,
      (const float*)kd, (const float*)bemf, (const float*)damping, (const float*)frictionloss,
      (const float*)body_mass, (const float*)body_ipos, (const float*)xfrc,
#if LHW_MOTOR
      (const float*)motor_w, motor_layers, motor_hid0, motor_hid1, (const float*)qd_hist, (const float*)ct_hist,
      (const int*)count, (float*)qd_hist_out, (float*)ct_hist_out, (int*)count_out,
#endif
      (float*)qpos_out, (float*)qvel_out, (float*)qacc_out, (float*)act_out, (float*)cforce,
      (float*)cdist, (float*)cmask, (float*)cpos, (float*)cnormal, (float*)xpos, (float*)xquat,
      (float*)cvel);
  return (int)cudaGetLastError();
}
