// K1-K6: control step — frame_skip PD + rigid-body physics substeps per
// env in ONE launch, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel built by make_control_step in
// learninghumanoidwalking_tpu/ops/substep_kernel.py (its pl.pallas_call at
// :1296) in its six variants, from four builds of this one source:
//   flat (LHW_TERRAIN 0): K1, the flat floor, 8 contact slots, the (z, x, y)
//     frame; the factorization reused over groups of R substeps;
//   terrain (LHW_TERRAIN 1, the default): K2 (terrain boxes) and K3
//     (heightfield), 16 contact slots, a per-slot kind table (flat / floor /
//     hfield / box, the Pallas slot kinds of substep_kernel.py:176-210),
//     per-env terrain inputs, tilted contact frames and the contact normals
//     as output; R=1;
//   motor (LHW_TERRAIN 0, LHW_MOTOR 1): K4, the flat floor at R=1 plus the
//     learned motor hook of substep_kernel.py:1036-1102 (see "Motor" below);
//   terrain + motor (LHW_TERRAIN 1, LHW_MOTOR 1): K5 (terrain boxes) and K6
//     (heightfield) with the motor hook, the terrain build's contacts and
//     K4's nets, the histories in the env's fixed region before its terrain
//     (make_control_step with terrain and motor=, substep_kernel.py:1331,
//     :1360-1375). It
// computes what that kernel and its plain twin
// physics/batched.py::pd_substeps_batched compute; the plain PyTorch
// version in this package (physics/batched.py, the dense contact solve, and
// robots/motor.py) is the reference it is held to. The reference pins R=1
// on terrain and with the motor hook (substep_kernel.py:1360-1368).
//
// The contact solve is the Pallas kernel's (substep_kernel.py:508-535,
// 696-890), not the dense 3nc x 3nc one: every contact row is a 6-term
// combination of its foot's 6 basis rows B (the foot body's motion
// subspace masked to its ancestor dofs), so with Y = L^-1 B and the 12x12
// Gram G = Y^T Y the masked system is A = Cm G Cm^T + D. With LG =
// chol(G + 1e-8 I) and Chat = Cm LG (its rows touch LG's rows of their own
// foot only; LG couples the feet through the floating base, so foot 0's
// rows have 6 nonzero columns and foot 1's 12), the Woodbury identity
//   A^-1 r = D^-1 r - D^-1 Chat K^-1 Chat^T D^-1 r,  K = I + Chat^T D^-1 Chat
// applies A^-1 through a 12x12 factor, and A f = Chat (Chat^T f) + D f.
// The projection onto the friction cones runs the plain version's 4 sweeps
// (one projection and 3 refinements; the Pallas kernel runs 3). The force
// maps back to joint space through 12 basis accumulators, B^T w.
// Two choices keep it as close to float64 as the plain version's dense
// solve, where the Pallas kernel's form alone lost up to 10x more (the
// rule's qacc limit failed in 2 of 4096 jvrc_step envs on a CPU build):
// K, its factor and the sweeps' vectors are float64 (see K below), and
// the basis's linear part is taken about the foot body rather than the
// world origin (basis_at). In the flat build G and LG's factorization are
// float64 too (a 5-dof leg leaves G near singular; see the refresh); the
// terrain, motor and terrain + motor builds, which run JVRC's 6-dof legs
// only, keep them float32 (the wrapper refuses a shorter leg in the terrain
// + motor build). Factors keep their diagonal's reciprocals, so
// the solves multiply instead of divide (float64 division is slow).
//
// Factorization reuse (the flat build at R > 1: physics/batched.py's
// contract, the Pallas substep's): every R-th substep refreshes CRBA, M's
// factor, the basis (S masked to the feet's ancestor dofs, about the foot
// origins of that substep), Y, G and LG; the other substeps recompute FK,
// S, the velocities, the bias forces and the contacts, and form the
// contact coefficients (from each point's offset to its foot's origin AT
// THE REFRESH, so that with the lagged basis the row is the plain
// version's), Chat, D and K afresh, and map the force back through the
// lagged basis and factor. What a refresh leaves for its group (M's factor,
// G, LG, the lagged S and foot origins) lives outside the scratch union.
//
// What bounds it on this card: f32 operations (flops_per_env_substep in the
// wrapper counts this form: ~57k flops per env-substep for 20 boxes and 16
// slots, ~43k for a 16x16 heightfield, ~29k on the flat floor at R=5 and
// ~39k at R=1, plus ~71k for the motor nets; ~300 flops a byte moved, far
// above the card's ridge point of 20). The arithmetic is a long chain of
// small dependent steps per env (tree recursions over 15 bodies, 18x18 and
// 12x12 factorizations, an iterative projection), so the design is about
// keeping that chain out of device memory and spreading each step over
// lanes:
//  - ONE ENV PER GROUP OF GRP LANES (a power of two, LHW_G, at most a warp).
//    Independent rows (dofs, bodies, keys, Gram and K entries, contact
//    slots, box-SDF pairs, motor joints) are spread over the group; the tree
//    recursions (FK) run level by level; sums across lanes use
//    __shfl_xor_sync inside the group, and __syncwarp on the group's mask
//    orders its shared-memory steps. Every helper collapses to the serial
//    loop at GRP = 1.
//  - THE WORKING SET IN SHARED MEMORY, not thread-local memory: each env
//    owns a fixed region (offsets E_* from the caps below; 8.75 KB on
//    terrain, 7.6 KB flat, 10.7 KB with the motor histories on the flat
//    floor, 11.95 KB with them on terrain) plus its
//    terrain, in dynamic shared memory (above 48 KB by opt-in). It holds the
//    kinematics, M's factor, the basis solves Y, G and LG, Chat, K and its
//    factor; the dynamics, refresh, contact phases and motor nets reuse one
//    scratch union (W_*). The vectors a lane owns stay in registers: its
//    actuators' PD inputs, its dofs' damping and friction, its bodies' mass,
//    CoM and applied wrench, and for its contact slots the basis
//    coefficients, D, the right-hand side and the force.
//  - THE TERRAIN staged once per launch: the block's envs are a contiguous
//    column range of the (rows, B) terrain inputs, copied with cp.async into
//    shared memory (8 nt + 1 floats for the boxes, H W + 5 for a
//    heightfield), not re-read from global memory every substep. The flat
//    floor stages none.
// The launch plan (envs per block, the per-env stride, the dynamic shared
// bytes, the grid) is the wrapper's (ops/substep_kernel.py::launch_plan).
// Tensor cores are not used: the physics must stay f32 (TF32 keeps about 3
// decimal digits against the 1e-4 relative rule the kernel is held to), and
// the per-env matrices are 12x12 and 12x18, far below a useful MMA tile.
//
// Motor (K4). Every substep's PD torque passes through the learned motor
// hook of robots/motor.py before ctrl = tau / gear: per joint a rolling
// 25-slot history of (joint velocity, commanded torque), pushed every
// substep while count < 25 and then on even counts; once warm, a per-joint
// MLP (50 -> 32 -> 32 -> 1, tanh hidden layers, linear output, plus a skip
// weight times the newest pushed torque) gives the applied torque. The
// histories sit in the env's shared region as rings with one head (a push
// writes one slot a joint and moves nothing); they come in and go out as
// joint-major trailing-batch blocks (rows n * 25 + slot, oldest first), the
// int32 substep count as (1, B). The owning lanes push; then the whole
// group runs the joints' nets in turn (group_motor_net), each lane a share
// of a layer's units, so that a warp's load of the weights touches one
// cache line (with a lane per joint it touched 12, one L1 wavefront each,
// and the nets took 50 of the 92 ms of a B=32768 launch on the card). The
// weights (32,664 floats, 130.7 KB at the default widths) stay in global
// memory and are read through the read-only cache, from L2: staging each
// joint's 10.9 KB in shared memory for the whole block (cp.async, two
// buffers) made the nets faster but cost as much in block-wide barriers
// (PERF.md). FMAs in float32 and tanhf, not a fast tanh; no tensor cores
// (TF32 keeps about 3 digits against the rule's 1e-4).
//
// A thread gathers what a TPU lane cannot, so each bilinear heightfield
// sample reads only the 4 nodes around it (the Pallas kernel contracts tent
// weights over the whole grid; the weights elsewhere are zero). The box SDF
// keeps the Pallas rule: among the penetrated boxes the shallowest
// penetration wins, the first of equals; boxes resting on the floor are
// columns (no bottom face).
//
// The model is NOT compiled in: topology, offsets, inertias, actuators,
// contact slots and their kinds arrive as runtime tables (ftab / itab),
// staged into shared memory per block; compile-time caps bound them and the
// wrapper refuses larger models. Every per-env input and output is a
// trailing-batch block (rows, B), element (r, b) at r * B + b. Terrain
// inputs: box pos and half-size (3nt, B), box-major, cos/sin of the yaw
// (nt, B), floor_z (1, B), the heightfield (H*W, B) row-major with its node
// [0, 0] at x0y0 (2, B) and spacing cell (2, B).

#include <cuda_runtime.h>
#include <math.h>

#include "control_step_math.cuh"

#ifndef LHW_TERRAIN
#define LHW_TERRAIN 1  // 1: the terrain build (K2, K3); 0: the flat floor (K1, K4)
#endif
#ifndef LHW_MOTOR
#define LHW_MOTOR 0    // 1: the motor hook (K4; with LHW_TERRAIN, K5 and K6)
#endif
#ifndef LHW_G
#define LHW_G 16  // lanes per env (a power of two, at most 32)
#endif
#define GRP LHW_G
#define LHW_TPB 192  // most threads a block (the launch plan keeps to it); with
                     // two blocks an SM, 170 registers a thread
#if GRP < 1 || GRP > 32 || (GRP & (GRP - 1)) != 0
#error "LHW_G must be a power of two from 1 to 32"
#endif

#define MAX_B 16    // bodies (incl. world)
#define MAX_V 20    // dofs
#define MAX_Q (MAX_V + 1)
#define MAX_U 16    // actuators
#if LHW_TERRAIN
#define MAX_C 16    // contact slots: floor/hfield + box per foot corner
#define MAX_T 32    // terrain boxes per env
#define MAX_HF 1024 // heightfield nodes per env
#else
#define MAX_C 8     // contact slots: the flat floor per foot corner
#define MAX_T 0
#define MAX_HF 0
#endif
#define MAX_F 2     // distinct foot bodies carrying contact slots
#if LHW_MOTOR
#define MAX_H 25       // motor history slots (the reference's buffer length)
#define MAX_HID 64     // motor MLP hidden width
#define MAX_LAYERS 3   // motor MLP layers (hidden + output)
#endif
#define MAX_K (6 * MAX_F)  // contact basis keys
#define TRI(n) ((n) * ((n) + 1) / 2)  // packed lower triangle; row i at TRI(i)

// items of each kind a lane owns (item k of a lane: lane + k * GRP)
#define APL ((MAX_U + GRP - 1) / GRP)
#define DPL ((MAX_V + GRP - 1) / GRP)
#define BPL ((MAX_B + GRP - 1) / GRP)
#define SPL ((MAX_C + GRP - 1) / GRP)

// ---- int table layout ----
#define I_NB 0
#define I_NV 1
#define I_NQ 2
#define I_NU 3
#define I_NC 4
#define I_NFOOT 5
#define I_NT 6
#define I_NLEV 7    // depth levels of bodies 1..nb-1
#define I_NBOX 8    // box slots
#define I_PARENT 9
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
#define I_SLOTKIND (I_SLOTFOOT + MAX_C)
#define I_BOXSLOT (I_SLOTKIND + MAX_C)  // the box slots, in slot order
#define I_FOOTBODY (I_BOXSLOT + MAX_C)
#define I_ANC (I_FOOTBODY + MAX_F)       // [body][dof]: dof on the body's path to the root
#define I_BANC (I_ANC + MAX_B * MAX_V)   // [body]: bit mask of its ancestors and itself
#define I_LEVEL (I_BANC + MAX_B)         // NLEV + 1 starts into BORDER
#define I_BORDER (I_LEVEL + MAX_B + 1)   // bodies 1..nb-1 by depth
#define N_ITAB (I_BORDER + MAX_B)

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

#define NINER 13  // compact inertia record: m, h(3), ibar(9)

// ---- per-env shared region (floats), fixed part ----
#define E_Q 0
#define E_V (E_Q + MAX_Q)
#define E_XPOS (E_V + MAX_V)
#define E_XQUAT (E_XPOS + 3 * MAX_B)
#define E_RMAT (E_XQUAT + 4 * MAX_B)
#define E_S (E_RMAT + 9 * MAX_B)       // [dof][6] screw axes (angular, linear)
#define E_CVEL (E_S + 6 * MAX_V)
#define E_ACT (E_CVEL + 6 * MAX_B)
#define E_QFRC (E_ACT + MAX_U)         // smooth force, then consumed by its solve
#define E_QACCS (E_QFRC + MAX_V)       // smooth acceleration
#define E_QCON (E_QACCS + MAX_V)       // constraint force, then its acceleration
#define E_TMPV (E_QCON + MAX_V)        // triangular-solve scratch
#define E_LRD (E_TMPV + MAX_V)         // 1 / diagonal of M's factor
#define E_L (E_LRD + MAX_V)            // M's factor, packed
#define E_G (E_L + TRI(MAX_V))         // basis Gram, packed, without the jitter
#define E_LG (E_G + TRI(MAX_K))        // chol(G + 1e-8 I), packed
#define E_U (E_LG + TRI(MAX_K))        // basis . qvel (MAX_K), basis . qacc_smooth (MAX_K)
#define E_CW (E_U + 2 * MAX_K)         // contact points (3 per slot)
#define E_CN (E_CW + 3 * MAX_C)        // contact normals
#define E_CDIST (E_CN + 3 * MAX_C)
#define E_DINV ((E_CDIST + MAX_C + 1) & ~1)  // D^-1 per contact row, float64 (even offset)
#define E_WORK (E_DINV + 2 * 3 * MAX_C)   // even: the union holds doubles
// scratch union: dynamics (INER, MC, GF, GSUB), then the composite inertias
// (ICOMP over MC..GSUB, INER still read), then M (MW over INER), then the
// basis solves (Y, GW over MW), then the contact system (CHAT; KW and LK in
// float64, at even offsets)
#define CHAT_LD (MAX_K + 1)  // odd row stride: a lane's rows fall in distinct banks
#define W_INER 0
#define W_MC (W_INER + NINER * MAX_B)
#define W_GF (W_MC + 6 * MAX_B)
#define W_GSUB (W_GF + 6 * MAX_B)
#define W_ICOMP (W_GF)
#define W_MW 0
#define W_Y 0
#define W_GW (W_Y + MAX_K * MAX_V)
#define W_GRD (W_GW + TRI(MAX_K))      // LG's reciprocal diagonal (unused)
#define W_CHAT 0
#define W_KW ((W_CHAT + 3 * MAX_C * CHAT_LD + 1) & ~1)
#define W_LK (W_KW + 2 * TRI(MAX_K))
#define W_LKRD (W_LK + 2 * TRI(MAX_K))  // LK's reciprocal diagonal
#define W_SIZE (W_LKRD + 2 * MAX_K)
#if LHW_MOTOR
// the motor nets (before the dynamics, at the start of a substep): a
// joint's first hidden layer, then its inputs
#define W_NET 0
static_assert(W_NET + MAX_HID + 2 * MAX_H <= W_SIZE, "motor scratch past the union");
#endif
#if LHW_TERRAIN
#if LHW_MOTOR
// the motor histories as rings, then the terrain (past SM_FIXED)
#define E_QDH (E_WORK + W_SIZE)        // [joint][slot] joint velocities
#define E_CTH (E_QDH + MAX_U * MAX_H)  // [joint][slot] commanded torques
#define SM_FIXED (E_CTH + MAX_U * MAX_H)
#else
#define SM_FIXED (E_WORK + W_SIZE)
#endif
// the terrain follows SM_FIXED: 8 nt box floats, H W + 4 heightfield floats, floor_z
#else
// the flat floor stages no terrain; what a refresh leaves for the substeps
// of its reuse group (besides M's factor, G and LG above) sits past the
// union: the motion subspace S and the foot bodies' origins it was taken
// at (the lagged basis: basis_at and corner_offset read them in place of
// E_S and E_XPOS, so a contact's row is the plain version's, the current
// point against the lagged basis); with the motor hook, the histories as
// rings
#define E_SREF (E_WORK + W_SIZE)
#define E_OREF (E_SREF + 6 * MAX_V)      // [body][3], the foot bodies' only
#if LHW_MOTOR
#define E_QDH (E_OREF + 3 * MAX_B)     // [joint][slot] joint velocities
#define E_CTH (E_QDH + MAX_U * MAX_H)  // [joint][slot] commanded torques
#define SM_FIXED (E_CTH + MAX_U * MAX_H)
#else
#define SM_FIXED (E_OREF + 3 * MAX_B)
#endif
#endif
static_assert(TRI(MAX_V) <= W_ICOMP, "MW overlaps ICOMP");
static_assert(W_ICOMP + NINER * MAX_B <= W_SIZE && W_GSUB + 6 * MAX_B <= W_SIZE, "dynamics scratch past the union");
static_assert(W_GRD + MAX_K <= W_SIZE, "basis scratch past the union");
static_assert(E_DINV % 2 == 0 && E_WORK % 2 == 0 && W_KW % 2 == 0 && W_LK % 2 == 0, "float64 arrays at odd offsets");
#if !LHW_TERRAIN && !LHW_MOTOR
static_assert(W_KW >= W_Y + MAX_K * MAX_V, "G's float64 factorization overlaps Y");
#endif

#if LHW_TERRAIN && LHW_MOTOR
#define LHW_KERNEL control_step_terrain_motor_kernel
#elif LHW_TERRAIN
#define LHW_KERNEL control_step_terrain_kernel
#elif LHW_MOTOR
#define LHW_KERNEL control_step_motor_kernel
#else
#define LHW_KERNEL control_step_flat_kernel
#endif

// ---- group helpers ----
#if defined(__CUDA_ARCH__)
#define GROUP_MASK ((GRP == 32) ? 0xffffffffu : (((1u << GRP) - 1u) << ((threadIdx.x & 31u) & ~(unsigned)(GRP - 1))))
#else
#define GROUP_MASK 0xffffffffu
#endif

// Orders the group's shared-memory steps. Call where every lane of the group
// arrives (never inside a lane-dependent branch or loop).
__device__ __forceinline__ void group_sync() {
#if GRP > 1
  __syncwarp(GROUP_MASK);
#endif
}

// Sum over the group, the same value in every lane (a + b == b + a exactly,
// so the butterfly gives every lane the same bits). Uniform call sites only.
template <class T>
__device__ __forceinline__ T group_sum(T x) {
#pragma unroll
  for (int o = GRP / 2; o > 0; o >>= 1) x += __shfl_xor_sync(GROUP_MASK, x, o, GRP);
  return x;
}

// cp.async of one float, global -> shared (a plain copy on the host)
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// Packed-triangle entry p -> (row r, column c <= r).
__device__ __forceinline__ void tri_rc(int p, int& r, int& c) {
  r = 0;
  while (TRI(r + 1) <= p) ++r;
  c = p - TRI(r);
}

// Lower Cholesky of the packed n x n matrix a into l (outer-product order of
// physics/linalg_small.py: diagonal clamped at eps, column scaled by
// 1 / sqrt of the pivot, rank-1 update of the trailing rows), and the
// reciprocals of l's diagonal into rd, which the solves multiply by. The
// group splits each column's rows; a is overwritten. One group_sync per
// column: a step reads column j of a and writes only columns > j.
__device__ __forceinline__ float clamp_sqrt(float x) { return sqrtf(pmax(x, 1e-12f)); }
__device__ __forceinline__ double clamp_sqrt(double x) { return sqrt((x > 1e-12 || x != x) ? x : 1e-12); }

template <class T>
__device__ __forceinline__ void group_cholesky(T* a, T* l, T* rd, int n, int lane) {
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const T r = T(1) / clamp_sqrt(a[TRI(j) + j]);
#pragma unroll 1
    for (int i = j + lane; i < n; i += GRP) {
      const T lij = a[TRI(i) + j] * r;
      l[TRI(i) + j] = lij;
      if (i == j) rd[j] = T(1) / lij;
#pragma unroll 1
      for (int k = j + 1; k <= i; ++k) a[TRI(i) + k] -= lij * (a[TRI(k) + j] * r);
    }
    group_sync();
  }
}

// Solve L L^T x = b for one vector, L packed with its diagonal's reciprocals
// rd; b is consumed, tmp is scratch, x may alias b. The group splits each
// step's updates.
__device__ __forceinline__ void group_cho_solve(const float* l, const float* rd, int n, float* b, float* tmp, float* x,
                                                int lane) {
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const float y = b[j] * rd[j];
    if (lane == 0) tmp[j] = y;
#pragma unroll 1
    for (int i = j + 1 + lane; i < n; i += GRP) b[i] -= l[TRI(i) + j] * y;
    group_sync();
  }
#pragma unroll 1
  for (int j = n - 1; j >= 0; --j) {
    const float xj = tmp[j] * rd[j];
    if (lane == 0) x[j] = xj;
#pragma unroll 1
    for (int i = lane; i < j; i += GRP) tmp[i] -= l[TRI(j) + i] * xj;
    group_sync();
  }
}

// Solve LK LK^T w = v in registers (every lane the same; LK packed with its
// diagonal's reciprocals rd, n <= MAX_K).
template <class T>
__device__ __forceinline__ void reg_cho_solve(const T* lk, const T* rd, int n, T* v) {
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    if (j < n) {
      const T y = v[j] * rd[j];
      v[j] = y;
#pragma unroll
      for (int i = j + 1; i < MAX_K; ++i)
        if (i < n) v[i] -= lk[TRI(i) + j] * y;
    }
  }
#pragma unroll
  for (int j = MAX_K - 1; j >= 0; --j) {
    if (j < n) {
      const T x = v[j] * rd[j];
      v[j] = x;
#pragma unroll
      for (int i = 0; i < j; ++i) v[i] -= lk[TRI(j) + i] * x;
    }
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

// jnp.sign: 0 at 0 (copysignf would give +-1 and a corner at lx = 0 a normal
// the reference does not give it)
__device__ __forceinline__ float sgn(float x) { return (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f); }

// Bilinear sample of one env's staged heightfield (H*W floats) at
// fractional node indices u in [0, W-1], v in [0, H-1]: the tent weights
// max(0, 1 - |i - u|) of the reference, read at the 2x2 nodes around (u, v)
// where they are non-zero; W first, then H. The index is clamped to W-2 /
// H-2, so u = W-1 reads nodes W-2 (weight 0) and W-1 (weight 1) and never
// past the row. A NaN index reads node 0; its NaN weights carry on.
__device__ __forceinline__ float hf_sample(const float* hf, int hh, int ww, float u, float v) {
  int j0 = (u == u) ? (int)floorf(u) : 0;
  int i0 = (v == v) ? (int)floorf(v) : 0;
  j0 = j0 < 0 ? 0 : (j0 > ww - 2 ? ww - 2 : j0);
  i0 = i0 < 0 ? 0 : (i0 > hh - 2 ? hh - 2 : i0);
  const float wu0 = pmax(0.f, 1.f - fabsf((float)j0 - u)), wu1 = pmax(0.f, 1.f - fabsf((float)(j0 + 1) - u));
  const float wv0 = pmax(0.f, 1.f - fabsf((float)i0 - v)), wv1 = pmax(0.f, 1.f - fabsf((float)(i0 + 1) - v));
  const int r0 = i0 * ww + j0, r1 = r0 + ww;
  const float row0 = wu0 * hf[r0] + wu1 * hf[r0 + 1];
  const float row1 = wu0 * hf[r1] + wu1 * hf[r1 + 1];
  return wv0 * row0 + wv1 * row1;
}

// Tangents of the contact frame from its unit normal (engine
// frame_from_normal): t1 horizontal where the normal leans enough, else x.
__device__ __forceinline__ void frame_tangents(const float* n, float* t1, float* t2) {
  const float h2 = n[0] * n[0] + n[1] * n[1];
  const float h = sqrtf(pmax(h2, 1e-12f));
  const bool horiz = h2 > 0.25f;
  t1[0] = horiz ? -n[1] / h : 1.f;
  t1[1] = horiz ? n[0] / h : 0.f;
  t1[2] = 0.f;
  cross3(n, t1, t2);
}

// Forward kinematics, level by level (a level's bodies on the group's
// lanes), with every body's rotation matrix; body 0 stays at the origin.
__device__ __forceinline__ void group_fk(const float* sf, const int* si, const float* q, float* xpos, float* xquat,
                                         float* rmat, int lane) {
  const int nlev = si[I_NLEV];
#pragma unroll 1
  for (int lv = 0; lv < nlev; ++lv) {
#pragma unroll 1
    for (int idx = si[I_LEVEL + lv] + lane; idx < si[I_LEVEL + lv + 1]; idx += GRP) {
      const int i = si[I_BORDER + idx];
      const int p = si[I_PARENT + i];
      const int adr = si[I_QADR + i];
      float xpre[3], qpre[4], t[3];
      qrot(xquat + 4 * p, sf + F_BPOS + 3 * i, t);
      xpre[0] = xpos[3 * p] + t[0]; xpre[1] = xpos[3 * p + 1] + t[1]; xpre[2] = xpos[3 * p + 2] + t[2];
      qmul(xquat + 4 * p, sf + F_BQUAT + 4 * i, qpre);
      float x[3], qq[4];
      const int jt = si[I_JTYPE + i];
      if (jt == J_FREE) {
        x[0] = q[adr]; x[1] = q[adr + 1]; x[2] = q[adr + 2];
        qq[0] = q[adr + 3]; qq[1] = q[adr + 4]; qq[2] = q[adr + 5]; qq[3] = q[adr + 6];
        qnormalize(qq);
      } else if (jt == J_HINGE) {
        const float* ax = sf + F_JAXIS + 3 * i;
        const float* anchor = sf + F_JPOS + 3 * i;
        const float half = 0.5f * q[adr];
        const float s = sinf(half);
        const float qj[4] = {cosf(half), ax[0] * s, ax[1] * s, ax[2] * s};
        qmul(qpre, qj, qq);
        float a1[3], a2[3];
        qrot(qpre, anchor, a1);
        qrot(qq, anchor, a2);
        x[0] = xpre[0] + a1[0] - a2[0];
        x[1] = xpre[1] + a1[1] - a2[1];
        x[2] = xpre[2] + a1[2] - a2[2];
      } else if (jt == J_SLIDE) {
        // the axis in the parent frame, as fk_b and the motion subspace take it
        const float* ax = sf + F_JAXIS + 3 * i;
        const float d[3] = {ax[0] * q[adr], ax[1] * q[adr], ax[2] * q[adr]};
        float a1[3];
        qrot(qpre, d, a1);
        qq[0] = qpre[0]; qq[1] = qpre[1]; qq[2] = qpre[2]; qq[3] = qpre[3];
        x[0] = xpre[0] + a1[0]; x[1] = xpre[1] + a1[1]; x[2] = xpre[2] + a1[2];
      } else {
        qq[0] = qpre[0]; qq[1] = qpre[1]; qq[2] = qpre[2]; qq[3] = qpre[3];
        x[0] = xpre[0]; x[1] = xpre[1]; x[2] = xpre[2];
      }
      for (int c = 0; c < 3; ++c) xpos[3 * i + c] = x[c];
      for (int c = 0; c < 4; ++c) xquat[4 * i + c] = qq[c];
      qmat(qq, rmat + 9 * i);
    }
    group_sync();
  }
}

// Per-dof screw axes S (nv x 6: angular, linear at the world origin).
__device__ __forceinline__ void group_motion_subspace(const float* sf, const int* si, const float* xpos,
                                                      const float* rmat, float* s, int lane) {
  const int nv = si[I_NV];
#pragma unroll 1
  for (int d = lane; d < nv; d += GRP) {
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
  group_sync();
}

// Body spatial velocity: the sum of S_d qvel_d over the dofs on the body's
// path to the root, root first (the order of the recursion
// cvel_i = cvel_parent + own S_d qvel_d).
__device__ __forceinline__ void body_velocity(const int* si, const float* s, const float* v, int i, float* cv) {
  const int nv = si[I_NV];
  for (int c = 0; c < 6; ++c) cv[c] = 0.f;
#pragma unroll 1
  for (int d = 0; d < nv; ++d)
    if (si[I_ANC + i * MAX_V + d])
      for (int c = 0; c < 6; ++c) cv[c] += s[6 * d + c] * v[d];
}

// The contact frame rows of slot c: (n, t1, t2) from its normal on the
// heightfield and terrain boxes, else the static (z, x, y) frame.
__device__ __forceinline__ void slot_frame(const int* si, const float* cn, int c, float e[3][3]) {
  const int kind = si[I_SLOTKIND + c];
  if (kind == SLOT_HFIELD || kind == SLOT_BOX) {
    for (int rr = 0; rr < 3; ++rr) e[0][rr] = cn[3 * c + rr];
    frame_tangents(e[0], e[1], e[2]);
  } else {
    for (int f = 0; f < 3; ++f)
      for (int rr = 0; rr < 3; ++rr) e[f][rr] = 0.f;
    e[0][2] = 1.f; e[1][0] = 1.f; e[2][1] = 1.f;
  }
}

// Slot c's contact point relative to its foot body's origin.
__device__ __forceinline__ void corner_offset(const int* si, const float* cw, const float* xpos, int c, float* p) {
  const float* o = xpos + 3 * si[I_FOOTBODY + si[I_SLOTFOOT + c]];
  for (int rr = 0; rr < 3; ++rr) p[rr] = cw[3 * c + rr] - o[rr];
}

// The contact row along e at point p (relative to the basis's origin) as 6
// coefficients on its foot's basis keys (S_ang xyz, S_lin xyz):
// row = e . S_lin - (e x p) . S_ang.
__device__ __forceinline__ void row_coef(const float* e, const float* p, float* cf) {
  cf[3] = e[0]; cf[4] = e[1]; cf[5] = e[2];
  cf[0] = -(e[1] * p[2] - e[2] * p[1]);
  cf[1] = -(e[2] * p[0] - e[0] * p[2]);
  cf[2] = -(e[0] * p[1] - e[1] * p[0]);
}

// The basis row of key kk at dof d: foot kk / 6's motion subspace row
// kk % 6, masked to the foot's ancestor dofs, with its linear part taken
// about the foot body's origin o (S_lin - o x S_ang) rather than the world
// origin. The rows, A and the solve are the same; the coefficients then
// carry the corner's offset p - o from the foot (~0.1 m), not its world
// position, so the Gram G = Y^T Y does not mix world-scale lever arms that
// the contact rows cancel again (fewer digits lost in float32).
__device__ __forceinline__ float basis_at(const int* si, const float* s, const float* xpos, int kk, int d) {
  const int fbody = si[I_FOOTBODY + kk / 6];
  if (!si[I_ANC + fbody * MAX_V + d]) return 0.f;
  const int k = kk % 6;
  const float* sd = s + 6 * d;
  if (k < 3) return sd[k];
  const float* o = xpos + 3 * fbody;
  const int k1 = (k + 1) % 3, k2 = (k + 2) % 3;  // (o x a)_k for k = 3..5
  return sd[k] - (o[k1] * sd[k2] - o[k2] * sd[k1]);
}

#if LHW_MOTOR
// Input i of a joint's net: its 25 joint velocities, then its 25 commanded
// torques, oldest first (ring index (head + slot) % MAX_H).
__device__ __forceinline__ float motor_input(const float* qdh, const float* cth, int head, int i) {
  const float* h = (i < MAX_H) ? qdh : cth;
  int r = head + (i < MAX_H ? i : i - MAX_H);
  if (r >= MAX_H) r -= MAX_H;
  return h[r];
}

// Applied torque of joint n through its MLP, computed by the whole group:
// skip * the newest commanded torque + the net of its histories (rings qdh,
// cth, the oldest slot at ring index head). Weights mw: per layer l, w_l
// (nu, d_l, d_{l+1}) then b_l (nu, d_{l+1}), row-major as robots/motor.py
// stacks them; then skip (nu). dims: d_0 = 2 MAX_H, hidden widths, d_nl = 1.
// The inputs go to xbuf in their order first. Lane j computes units j,
// j + GRP, ... of each hidden layer, one at a time with one accumulator, so
// for each input the group reads a contiguous run of the weight row (one
// cache line, through the read-only cache; the other env of the warp reads
// the same line) and the inputs are broadcast from shared memory; the loop
// over the inputs is unrolled so that ten loads are in flight. A unit sums
// its bias, then its inputs in turn (the reference's order). The first of
// two hidden layers goes to hbuf; the last hidden layer folds into the
// output in the lanes, whose partial sums meet in a butterfly. Every lane
// returns the torque. tanhf, not a fast tanh. hbuf holds MAX_HID + 2 MAX_H
// floats of shared memory. Call where the whole group arrives.
__device__ float group_motor_net(const float* __restrict__ mw, int nu, int nl, const int* dims, int n, const float* qdh,
                                 const float* cth, int head, float* hbuf, int lane) {
  const int last = nl - 1;  // the output layer (one unit)
  float* const xbuf = hbuf + MAX_HID;  // the inputs in their order
  for (int i = lane; i < dims[0]; i += GRP) xbuf[i] = motor_input(qdh, cth, head, i);
  group_sync();
  int off = 0, off_out = 0;
#pragma unroll 1
  for (int l = 0; l < last; ++l) off_out += nu * dims[l] * dims[l + 1] + nu * dims[l + 1];
  const float* w_out = mw + off_out + n * dims[last];
  float part = 0.f;
  if (last == 0) {
#pragma unroll 1
    for (int i = lane; i < dims[0]; i += GRP) part += xbuf[i] * __ldg(w_out + i);
  }
#pragma unroll 1
  for (int l = 0; l < last; ++l) {
    const int din = dims[l], dout = dims[l + 1];
    const float* w = mw + off + n * din * dout;
    const float* bias = mw + off + nu * din * dout + n * dout;
    const float* x = (l == 0) ? xbuf : hbuf;
#pragma unroll 1
    for (int o = lane; o < dout; o += GRP) {
      float acc = __ldg(bias + o);
#pragma unroll 10
      for (int i = 0; i < din; ++i) acc += x[i] * __ldg(w + i * dout + o);
      const float t = tanhf(acc);
      if (l == last - 1) part += t * __ldg(w_out + o);
      else hbuf[o] = t;
    }
    if (l < last - 1) group_sync();
    off += nu * din * dout + nu * dout;
  }
  const float out = __ldg(mw + off_out + nu * dims[last] + n) + group_sum(part);
  group_sync();  // hbuf and xbuf are read before the next joint writes them
  const int newest = (head == 0) ? MAX_H - 1 : head - 1;
  return __ldg(mw + off_out + nu * dims[last] + nu + n) * cth[newest] + out;
}
#endif

extern "C" __global__ void __launch_bounds__(LHW_TPB, 2) LHW_KERNEL(
    int batch, int frame_skip, int settle, float dt, int epb, int env_stride,
#if !LHW_TERRAIN
    int reuse,
#endif
#if LHW_MOTOR
    const float* __restrict__ motor_w, int motor_layers, int motor_hid0, int motor_hid1,
    const float* __restrict__ qd_hist_in, const float* __restrict__ ct_hist_in, const int* __restrict__ count_in,
    float* __restrict__ qd_hist_out, float* __restrict__ ct_hist_out, int* __restrict__ count_out,
#endif
    const float* __restrict__ ftab, const int* __restrict__ itab,
    const float* __restrict__ qpos_in, const float* __restrict__ qvel_in,
    const float* __restrict__ target, const float* __restrict__ kp_in,
    const float* __restrict__ kd_in, const float* __restrict__ bemf_in,
    const float* __restrict__ damping_in, const float* __restrict__ frictionloss_in,
    const float* __restrict__ body_mass_in, const float* __restrict__ body_ipos_in,
    const float* __restrict__ xfrc_in,
    int hf_h, int hf_w,
    const float* __restrict__ terrain_pos, const float* __restrict__ terrain_size,
    const float* __restrict__ terrain_cos, const float* __restrict__ terrain_sin,
    const float* __restrict__ floor_z_in, const float* __restrict__ hfield,
    const float* __restrict__ hf_x0y0, const float* __restrict__ hf_cell,
    float* __restrict__ qpos_out, float* __restrict__ qvel_out, float* __restrict__ qacc_out,
    float* __restrict__ act_out, float* __restrict__ cforce_out, float* __restrict__ cdist_out,
    float* __restrict__ cmask_out, float* __restrict__ cpos_out, float* __restrict__ cnormal_out,
    float* __restrict__ xpos_out, float* __restrict__ xquat_out, float* __restrict__ cvel_out) {
  __shared__ float sf[N_FTAB];
  __shared__ int si[N_ITAB];
  extern __shared__ double env_smem_raw[];  // 8-byte aligned: the envs' regions hold doubles
  float* const env_smem = (float*)env_smem_raw;
  for (int k = threadIdx.x; k < N_FTAB; k += blockDim.x) sf[k] = ftab[k];
  for (int k = threadIdx.x; k < N_ITAB; k += blockDim.x) si[k] = itab[k];
  __syncthreads();

  const int B = batch;
  const int b0 = blockIdx.x * epb;
#if LHW_TERRAIN
  const int nt = si[I_NT];
  const int hw = (hfield != nullptr) ? hf_h * hf_w : 0;
  // the terrain region: boxes (pos 3nt, size 3nt, cos nt, sin nt), the
  // heightfield (H*W nodes, x0, y0, cell x, cell y), floor_z
  const int t_hf = 8 * nt, t_fz = t_hf + (hw ? hw + 4 : 0);
  {
    const int rows = t_fz + 1;
#pragma unroll 1
    for (int k = threadIdx.x; k < rows * epb; k += blockDim.x) {
      const int r = k / epb, e = k - r * epb, col = b0 + e;
      if (col >= B) continue;
      const float* src;
      if (r < 3 * nt) src = terrain_pos + r * B;
      else if (r < 6 * nt) src = terrain_size + (r - 3 * nt) * B;
      else if (r < 7 * nt) src = terrain_cos + (r - 6 * nt) * B;
      else if (r < t_hf) src = terrain_sin + (r - 7 * nt) * B;
      else if (r < t_fz) {
        const int h = r - t_hf;
        src = (h < hw) ? hfield + h * B : ((h < hw + 2) ? hf_x0y0 + (h - hw) * B : hf_cell + (h - hw - 2) * B);
      } else {
        src = floor_z_in;
      }
      copy_async4(env_smem + e * env_stride + SM_FIXED + r, src + col);
    }
    copy_async_wait();
  }
  __syncthreads();
#endif

  const int lane = threadIdx.x % GRP;
  const int b = b0 + (int)threadIdx.x / GRP;
  if (b >= B) return;  // the ragged edge: the whole group leaves
  float* env = env_smem + ((int)threadIdx.x / GRP) * env_stride;
  float* const q = env + E_Q;
  float* const v = env + E_V;
  float* const xpos = env + E_XPOS;
  float* const xquat = env + E_XQUAT;
  float* const rmat = env + E_RMAT;
  float* const s = env + E_S;
  float* const cvel = env + E_CVEL;
  float* const act = env + E_ACT;
  float* const lm = env + E_L;
  float* const lrd = env + E_LRD;
  float* const gram = env + E_G;
  float* const lg = env + E_LG;
  float* const u = env + E_U;
  float* const cw = env + E_CW;
  float* const cn = env + E_CN;
  float* const cdist = env + E_CDIST;
  double* const dinv = (double*)(env + E_DINV);
  float* const work = env + E_WORK;
#if LHW_TERRAIN
  const float* const terr = env + SM_FIXED;
#else
  float* const sref = env + E_SREF;
  float* const oref = env + E_OREF;
#endif

  const int nb = si[I_NB], nv = si[I_NV], nq = si[I_NQ], nu = si[I_NU], nc = si[I_NC];
  const int nk = 6 * si[I_NFOOT];
  const float impmin = sf[F_IMPMIN], impdiff = sf[F_IMPDIFF], width = sf[F_WIDTH];
  const float kref = sf[F_KREF], bref = sf[F_BREF];
#if LHW_TERRAIN
  const float fz = terr[t_fz];
#endif

  // per-env state into shared memory; constant inputs into the owning lanes
  for (int r = lane; r < nq; r += GRP) q[r] = qpos_in[r * B + b];
  for (int r = lane; r < nv; r += GRP) v[r] = qvel_in[r * B + b];
  if (lane == 0) {
    xpos[0] = xpos[1] = xpos[2] = 0.f;
    xquat[0] = 1.f; xquat[1] = xquat[2] = xquat[3] = 0.f;
    qmat(xquat, rmat);
    for (int c = 0; c < 6; ++c) cvel[c] = 0.f;
  }
  float r_tgt[APL], r_kp[APL], r_kd[APL], r_bemf[APL];
  float r_damp[DPL], r_fric[DPL], r_qacc[DPL];
  float r_bmass[BPL], r_bipos[BPL][3], r_xf[BPL][6];
#pragma unroll
  for (int k = 0; k < APL; ++k) {
    const int a = lane + k * GRP;
    r_tgt[k] = r_kp[k] = r_kd[k] = r_bemf[k] = 0.f;
    if (a < nu) {
      r_tgt[k] = target[a * B + b];
      r_kp[k] = kp_in[a * B + b];
      r_kd[k] = kd_in[a * B + b];
      r_bemf[k] = bemf_in[a * B + b];
    }
  }
#pragma unroll
  for (int k = 0; k < DPL; ++k) {
    const int d = lane + k * GRP;
    r_damp[k] = r_fric[k] = r_qacc[k] = 0.f;
    if (d < nv) {
      r_damp[k] = damping_in[d * B + b];
      r_fric[k] = frictionloss_in[d * B + b];
    }
  }
#pragma unroll
  for (int k = 0; k < BPL; ++k) {
    const int i = lane + k * GRP;
    r_bmass[k] = 0.f;
    for (int c = 0; c < 3; ++c) r_bipos[k][c] = 0.f;
    for (int c = 0; c < 6; ++c) r_xf[k][c] = 0.f;
    if (i < nb) {
      r_bmass[k] = body_mass_in[i * B + b];
      for (int c = 0; c < 3; ++c) r_bipos[k][c] = body_ipos_in[(3 * i + c) * B + b];
      for (int c = 0; c < 6; ++c) r_xf[k][c] = xfrc_in[(6 * i + c) * B + b];
    }
  }
  // the force of the owned contact rows (the last substep's is an output)
  float r_force[SPL][3];
#pragma unroll
  for (int k = 0; k < SPL; ++k) r_force[k][0] = r_force[k][1] = r_force[k][2] = 0.f;
#if LHW_MOTOR
  // the motor histories into their rings (the oldest slot at ring index
  // m_head), each joint's by the lane that owns it; the substep count and
  // the ring head are the same in every lane of the group
  float* const qdh = env + E_QDH;
  float* const cth = env + E_CTH;
#pragma unroll
  for (int k = 0; k < APL; ++k) {
    const int a = lane + k * GRP;
    if (a < nu)
#pragma unroll 1
      for (int h = 0; h < MAX_H; ++h) {
        qdh[a * MAX_H + h] = qd_hist_in[(a * MAX_H + h) * B + b];
        cth[a * MAX_H + h] = ct_hist_in[(a * MAX_H + h) * B + b];
      }
  }
  int m_head = 0;
  int m_count = count_in[b];
  int m_dims[MAX_LAYERS + 1];
  m_dims[0] = 2 * MAX_H;
  for (int l = 1; l < motor_layers; ++l) m_dims[l] = (l == 1) ? motor_hid0 : motor_hid1;
  m_dims[motor_layers] = 1;
#endif
  group_sync();

  const float* mu = sf + F_MU;
#if LHW_TERRAIN
  const int nbox = si[I_NBOX];
#endif

#pragma unroll 1
  for (int sub = 0; sub < frame_skip; ++sub) {
#if !LHW_TERRAIN
    const bool refresh = (sub % reuse) == 0;
#endif
#if LHW_MOTOR
    // warm: the command passes through; push: every substep while warm,
    // then on even counts (the oldest slot is dropped, the newest written)
    const bool m_warm = m_count < MAX_H;
    const bool m_push = m_warm || (m_count % 2) == 0;
    const int m_next = m_push ? ((m_head + 1 == MAX_H) ? 0 : m_head + 1) : m_head;
#endif
    // ---- PD torque (through the motor hook) -> actuator force (ctrlrange
    // clamp, gear) ----
#if LHW_MOTOR
    // the owning lanes push their joints' histories; once warm the group
    // runs the joints' nets in turn, and each owning lane keeps its torque
    float r_tau[APL];
#pragma unroll
    for (int k = 0; k < APL; ++k) {
      const int a = lane + k * GRP;
      r_tau[k] = 0.f;
      if (a < nu && !settle) {
        const float qa = q[si[I_ACTQ + a]], va = v[si[I_ACTD + a]];
        r_tau[k] = r_kp[k] * (r_tgt[k] - qa) - r_kd[k] * va - r_bemf[k] * va;
        if (m_push) {
          qdh[a * MAX_H + m_head] = va;
          cth[a * MAX_H + m_head] = r_tau[k];
        }
      }
    }
    if (!settle && !m_warm) {
      group_sync();
#pragma unroll 1
      for (int n = 0; n < nu; ++n) {
        const float t = group_motor_net(motor_w, nu, motor_layers, m_dims, n, qdh + n * MAX_H, cth + n * MAX_H, m_next,
                                        work + W_NET, lane);
#pragma unroll
        for (int k = 0; k < APL; ++k)
          if (n == lane + k * GRP) r_tau[k] = t;
      }
    }
#pragma unroll
    for (int k = 0; k < APL; ++k) {
      const int a = lane + k * GRP;
      if (a < nu) {
        const float gear = sf[F_GEAR + a];
        float ctrl = settle ? 0.f : r_tau[k] / gear;
        const float lo = sf[F_CLO + a], hi = sf[F_CHI + a];
        if (ctrl < lo) ctrl = lo;
        if (ctrl > hi) ctrl = hi;
        act[a] = gear * ctrl;
      }
    }
    if (!settle) {  // settle substeps take no motor model
      m_head = m_next;
      ++m_count;
    }
#else
#pragma unroll
    for (int k = 0; k < APL; ++k) {
      const int a = lane + k * GRP;
      if (a < nu) {
        const float gear = sf[F_GEAR + a];
        float ctrl = 0.f;
        if (!settle) {
          const float qa = q[si[I_ACTQ + a]], va = v[si[I_ACTD + a]];
          const float tau = r_kp[k] * (r_tgt[k] - qa) - r_kd[k] * va - r_bemf[k] * va;
          ctrl = tau / gear;
        }
        const float lo = sf[F_CLO + a], hi = sf[F_CHI + a];
        if (ctrl < lo) ctrl = lo;
        if (ctrl > hi) ctrl = hi;
        act[a] = gear * ctrl;
      }
    }
#endif

    // ---- kinematics ----
    group_fk(sf, si, q, xpos, xquat, rmat, lane);
    group_motion_subspace(sf, si, xpos, rmat, s, lane);

    // ---- per body: velocity, spatial inertia with mass / CoM
    // randomization, and the velocity-product term of its acceleration ----
    float* const iner = work + W_INER;
    float* const mc = work + W_MC;
    float* const gf = work + W_GF;
    float* const gsub = work + W_GSUB;
#pragma unroll
    for (int k = 0; k < BPL; ++k) {
      const int i = lane + k * GRP;
      if (i >= 1 && i < nb) {
        float cv[6];
        body_velocity(si, s, v, i, cv);
        for (int c = 0; c < 6; ++c) cvel[6 * i + c] = cv[c];
        const float* r = rmat + 9 * i;
        const float* iq = sf + F_IQMAT + 9 * i;
        float rot[9];
        for (int rr = 0; rr < 3; ++rr)
          for (int cc = 0; cc < 3; ++cc)
            rot[3 * rr + cc] = r[3 * rr] * iq[cc] + r[3 * rr + 1] * iq[3 + cc] + r[3 * rr + 2] * iq[6 + cc];
        const float m = r_bmass[k];
        const float ratio = m / sf[F_BMASS0 + i];
        float dg[3];
        for (int c = 0; c < 3; ++c) dg[c] = sf[F_BINER + 3 * i + c] * ratio;
        float com[3];
        for (int c = 0; c < 3; ++c)
          com[c] = xpos[3 * i + c] + (r[3 * c] * r_bipos[k][0] + r[3 * c + 1] * r_bipos[k][1] + r[3 * c + 2] * r_bipos[k][2]);
        const float c2 = com[0] * com[0] + com[1] * com[1] + com[2] * com[2];
        float* in = iner + NINER * i;
        in[0] = m;
        in[1] = m * com[0]; in[2] = m * com[1]; in[3] = m * com[2];
        for (int rr = 0; rr < 3; ++rr)
          for (int cc = 0; cc < 3; ++cc) {
            const float icom = rot[3 * rr] * dg[0] * rot[3 * cc] + rot[3 * rr + 1] * dg[1] * rot[3 * cc + 1] +
                               rot[3 * rr + 2] * dg[2] * rot[3 * cc + 2];
            // ibar = icom - m skew(c)^2 = icom - m (c c^T - |c|^2 I)
            in[4 + 3 * rr + cc] = icom - m * (com[rr] * com[cc] - (rr == cc ? c2 : 0.f));
          }
        // cvel x (own S_d qvel_d): (w x vj_w, w x vj_v + v0 x vj_w)
        float vj[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        const int adr = si[I_DADR + i], num = si[I_DNUM + i];
#pragma unroll 1
        for (int d = adr; d < adr + num; ++d)
          for (int c = 0; c < 6; ++c) vj[c] += s[6 * d + c] * v[d];
        float t1[3], t2[3], t3[3];
        cross3(cv, vj, t1);
        cross3(cv, vj + 3, t2);
        cross3(cv + 3, vj, t3);
        for (int c = 0; c < 3; ++c) {
          mc[6 * i + c] = t1[c];
          mc[6 * i + 3 + c] = t2[c] + t3[c];
        }
      }
    }
    group_sync();

    // ---- RNE: acc_i = -g + the terms of the path root..i, in that order
    // (the recursion acc_i = acc_parent + term_i); then the body's force:
    // applied wrench about the origin minus I acc + cvel x* (I cvel) ----
#pragma unroll
    for (int k = 0; k < BPL; ++k) {
      const int i = lane + k * GRP;
      if (i >= 1 && i < nb) {
        float ac[6] = {0.f, 0.f, 0.f, -sf[F_GRAV], -sf[F_GRAV + 1], -sf[F_GRAV + 2]};
        const int banc = si[I_BANC + i];
#pragma unroll 1
        for (int j = 1; j <= i; ++j)
          if ((banc >> j) & 1)
            for (int c = 0; c < 6; ++c) ac[c] += mc[6 * j + c];
        const float* in = iner + NINER * i;
        const float* cv = cvel + 6 * i;
        float ia[6], iv[6], fc[6], t1[3], t2[3];
        inertia_apply(in, ac, ia);
        inertia_apply(in, cv, iv);
        // cvel x* (I cvel) = (w x n + v0 x f, w x f)
        cross3(cv, iv, t1);
        cross3(cv + 3, iv + 3, t2);
        for (int c = 0; c < 3; ++c) fc[c] = t1[c] + t2[c];
        cross3(cv, iv + 3, fc + 3);
        float mom[3];
        cross3(xpos + 3 * i, r_xf[k], mom);
        for (int c = 0; c < 3; ++c) {
          gf[6 * i + c] = (mom[c] + r_xf[k][3 + c]) - (ia[c] + fc[c]);
          gf[6 * i + 3 + c] = r_xf[k][c] - (ia[3 + c] + fc[3 + c]);
        }
      }
    }
    group_sync();
    // subtree sums of the body forces, in body order
#pragma unroll
    for (int k = 0; k < BPL; ++k) {
      const int i = lane + k * GRP;
      if (i >= 1 && i < nb) {
        float g6[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
        for (int j = i; j < nb; ++j)
          if ((si[I_BANC + j] >> i) & 1)
            for (int c = 0; c < 6; ++c) g6[c] += gf[6 * j + c];
        for (int c = 0; c < 6; ++c) gsub[6 * i + c] = g6[c];
      }
    }
    group_sync();
    float* const qfrc = env + E_QFRC;
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      const int d = lane + k * GRP;
      if (d < nv) {
        const float* g = gsub + 6 * si[I_DOFBODY + d];
        const float* sd = s + 6 * d;
        float f = sd[0] * g[0] + sd[1] * g[1] + sd[2] * g[2] + sd[3] * g[3] + sd[4] * g[4] + sd[5] * g[5];
        const int a = si[I_ACTOFDOF + d];
        if (a >= 0) f += act[a];
        f += -r_fric[k] * tanhf(v[d] / 0.02f);
        f += -r_damp[k] * v[d];
        qfrc[d] = f;
      }
    }
    group_sync();

    // ---- refresh (every substep on terrain, every reuse-th on the flat
    // floor): composite inertias, CRBA mass matrix + armature + dt damping,
    // its Cholesky ----
#if !LHW_TERRAIN
    if (refresh) {
#endif
    float* const icomp = work + W_ICOMP;
#pragma unroll
    for (int k = 0; k < BPL; ++k) {
      const int i = lane + k * GRP;
      if (i >= 1 && i < nb) {
        float ic[NINER];
        for (int c = 0; c < NINER; ++c) ic[c] = 0.f;
#pragma unroll 1
        for (int j = i; j < nb; ++j)
          if ((si[I_BANC + j] >> i) & 1)
            for (int c = 0; c < NINER; ++c) ic[c] += iner[NINER * j + c];
        for (int c = 0; c < NINER; ++c) icomp[NINER * i + c] = ic[c];
      }
    }
    group_sync();
    float* const mw = work + W_MW;
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      const int d = lane + k * GRP;
      if (d < nv) {
        const int bd = si[I_DOFBODY + d];
        float fd[6];
        inertia_apply(icomp + NINER * bd, s + 6 * d, fd);
#pragma unroll 1
        for (int e = 0; e <= d; ++e) {
          float val = 0.f;
          if (si[I_ANC + bd * MAX_V + e]) {
            const float* se = s + 6 * e;
            val = se[0] * fd[0] + se[1] * fd[1] + se[2] * fd[2] + se[3] * fd[3] + se[4] * fd[4] + se[5] * fd[5];
          }
          mw[TRI(d) + e] = val;
        }
        mw[TRI(d) + d] += sf[F_ARM + d] + dt * r_damp[k];
      }
    }
    group_sync();
    group_cholesky(mw, lm, lrd, nv, lane);
#if !LHW_TERRAIN
    }
#endif
    float* const qaccs = env + E_QACCS;
    float* const tmpv = env + E_TMPV;
    group_cho_solve(lm, lrd, nv, qfrc, tmpv, qaccs, lane);

#if LHW_TERRAIN
    // ---- contact basis: Y = L^-1 B (forward substitutions), the basis
    // dots with qvel and qacc_smooth, the Gram G = Y^T Y and LG ----
    float* const y = work + W_Y;
#pragma unroll 1
    for (int kk = lane; kk < nk; kk += GRP) {
      float* yk = y + kk * MAX_V;
#pragma unroll 1
      for (int d = 0; d < nv; ++d) yk[d] = basis_at(si, s, xpos, kk, d);
#pragma unroll 1
      for (int j = 0; j < nv; ++j) {
        const float yj = yk[j] * lrd[j];
        yk[j] = yj;
#pragma unroll 1
        for (int i = j + 1; i < nv; ++i) yk[i] -= lm[TRI(i) + j] * yj;
      }
    }
#pragma unroll 1
    for (int t = lane; t < 2 * nk; t += GRP) {
      const int kk = t < nk ? t : t - nk;
      const float* x = t < nk ? v : qaccs;
      float acc = 0.f;
#pragma unroll 1
      for (int d = 0; d < nv; ++d) acc += basis_at(si, s, xpos, kk, d) * x[d];
      u[(t < nk ? 0 : MAX_K) + kk] = acc;
    }
    group_sync();
    float* const gw = work + W_GW;
#pragma unroll 1
    for (int p = lane; p < TRI(nk); p += GRP) {
      int r, c;
      tri_rc(p, r, c);
      const float* ya = y + c * MAX_V;
      const float* yb = y + r * MAX_V;
      float acc = 0.f;
#pragma unroll 1
      for (int d = 0; d < nv; ++d) acc += ya[d] * yb[d];
      gram[p] = acc;
      gw[p] = (r == c) ? acc + 1e-8f : acc;  // G is SPD (independent basis rows through M^-1)
    }
    group_sync();
    group_cholesky(gw, lg, work + W_GRD, nk, lane);
#else
    // ---- contact basis, at a refresh: the lagged basis (S and the foot
    // origins of this substep), Y = L^-1 B (forward substitutions), the Gram
    // G = Y^T Y and LG; every substep: the basis dots with qvel and
    // qacc_smooth through the lagged basis ----
    if (refresh) {
      for (int r = lane; r < 6 * nv; r += GRP) sref[r] = s[r];
      for (int r = lane; r < nk / 2; r += GRP) {
        const int o = 3 * si[I_FOOTBODY + r / 3] + r % 3;
        oref[o] = xpos[o];
      }
      group_sync();
      float* const y = work + W_Y;
#pragma unroll 1
      for (int kk = lane; kk < nk; kk += GRP) {
        float* yk = y + kk * MAX_V;
#pragma unroll 1
        for (int d = 0; d < nv; ++d) yk[d] = basis_at(si, sref, oref, kk, d);
#pragma unroll 1
        for (int j = 0; j < nv; ++j) {
          const float yj = yk[j] * lrd[j];
          yk[j] = yj;
#pragma unroll 1
          for (int i = j + 1; i < nv; ++i) yk[i] -= lm[TRI(i) + j] * yj;
        }
      }
      group_sync();
#if LHW_MOTOR
      float* const gw = work + W_GW;
#pragma unroll 1
      for (int p = lane; p < TRI(nk); p += GRP) {
        int r, c;
        tri_rc(p, r, c);
        const float* ya = y + c * MAX_V;
        const float* yb = y + r * MAX_V;
        float acc = 0.f;
#pragma unroll 1
        for (int d = 0; d < nv; ++d) acc += ya[d] * yb[d];
        gram[p] = acc;
        gw[p] = (r == c) ? acc + 1e-8f : acc;  // G is SPD (independent basis rows through M^-1)
      }
      group_sync();
      group_cholesky(gw, lg, work + W_GRD, nk, lane);
#else
      // G and its factor in float64 (in the contact system's K, LK and LK's
      // diagonal, free until the contacts): with 5-dof legs (Unitree H1) a
      // foot's basis rows come close to dependent in some poses: G's least
      // pivot fell to ~1e-8 of its largest diagonal entry, below float32's
      // resolution, float32 rounding made it negative, and the clamped
      // pivot blew the factor up (~1e9) and the env with it. From float32
      // Y, G in float64 stays SPD. LG is kept in float32.
      double* const gwd = (double*)(work + W_KW);
      double* const lgd = (double*)(work + W_LK);
#pragma unroll 1
      for (int p = lane; p < TRI(nk); p += GRP) {
        int r, c;
        tri_rc(p, r, c);
        const float* ya = y + c * MAX_V;
        const float* yb = y + r * MAX_V;
        double acc = 0.0;
#pragma unroll 1
        for (int d = 0; d < nv; ++d) acc += (double)ya[d] * yb[d];
        gram[p] = (float)acc;
        gwd[p] = (r == c) ? acc + 1e-8 : acc;  // G is SPD (independent basis rows through M^-1)
      }
      group_sync();
      group_cholesky(gwd, lgd, (double*)(work + W_LKRD), nk, lane);
      for (int p = lane; p < TRI(nk); p += GRP) lg[p] = (float)lgd[p];
      group_sync();
#endif
    }
#pragma unroll 1
    for (int t = lane; t < 2 * nk; t += GRP) {
      const int kk = t < nk ? t : t - nk;
      const float* x = t < nk ? v : qaccs;
      float acc = 0.f;
#pragma unroll 1
      for (int d = 0; d < nv; ++d) acc += basis_at(si, sref, oref, kk, d) * x[d];
      u[(t < nk ? 0 : MAX_K) + kk] = acc;
    }
    group_sync();
#endif

    // ---- contacts: corner points, distances, normals ----
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int c = lane + k * GRP;
      if (c < nc) {
        const int bi = si[I_FOOTBODY + si[I_SLOTFOOT + c]];
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
        float p[3];
        for (int rr = 0; rr < 3; ++rr) {
          p[rr] = gpos[rr] + (rg[3 * rr] * cl[0] + rg[3 * rr + 1] * cl[1] + rg[3 * rr + 2] * cl[2]);
          cw[3 * c + rr] = p[rr];
        }
#if LHW_TERRAIN
        const int kind = si[I_SLOTKIND + c];
        float nrm[3] = {0.f, 0.f, 1.f};
        float dist;
        if (kind == SLOT_FLAT) {
          dist = p[2];
        } else if (kind == SLOT_FLOOR) {
          dist = p[2] - fz;
        } else if (kind == SLOT_HFIELD) {
          // vertical gap to the bilinear surface, scaled onto its normal
          // (central differences at +-0.25 cell over the clip-shrunk span)
          const float* hf = terr + t_hf;
          const float hx0 = hf[hw], hy0 = hf[hw + 1], hcx = hf[hw + 2], hcy = hf[hw + 3];
          const float wmax = (float)(hf_w - 1), hmax = (float)(hf_h - 1);
          const float uu = pmin(pmax((p[0] - hx0) / hcx, 0.f), wmax);
          const float vv = pmin(pmax((p[1] - hy0) / hcy, 0.f), hmax);
          const float up = pmin(pmax(uu + 0.25f, 0.f), wmax), um = pmin(pmax(uu - 0.25f, 0.f), wmax);
          const float vp = pmin(pmax(vv + 0.25f, 0.f), hmax), vm = pmin(pmax(vv - 0.25f, 0.f), hmax);
          const float h = hf_sample(hf, hf_h, hf_w, uu, vv);
          const float dh_dx = (hf_sample(hf, hf_h, hf_w, up, vv) - hf_sample(hf, hf_h, hf_w, um, vv)) / ((up - um) * hcx);
          const float dh_dy = (hf_sample(hf, hf_h, hf_w, uu, vp) - hf_sample(hf, hf_h, hf_w, uu, vm)) / ((vp - vm) * hcy);
          const float nn = sqrtf(dh_dx * dh_dx + dh_dy * dh_dy + 1.f);
          nrm[0] = -dh_dx / nn; nrm[1] = -dh_dy / nn; nrm[2] = 1.f / nn;
          dist = (p[2] - (fz + h)) * nrm[2];
        } else {
          dist = 0.f;  // box slots: the pair search below
        }
        if (kind != SLOT_BOX) {
          cdist[c] = dist;
          for (int rr = 0; rr < 3; ++rr) cn[3 * c + rr] = nrm[rr];
        }
#else
        cdist[c] = p[2];  // the z = 0 plane, its normal z
        cn[3 * c] = 0.f; cn[3 * c + 1] = 0.f; cn[3 * c + 2] = 1.f;
#endif
      }
    }
    group_sync();
#if LHW_TERRAIN
    // terrain-box SDF (substep_kernel.py:625-686) over the (box slot, box)
    // pairs: lps lanes share a slot, each takes every lps-th box, and the
    // lanes' bests meet in a butterfly (the deeper score wins, the lower box
    // of equals). The winner's least-penetrated axis gives the normal.
    if (nbox > 0) {
      int lps = 1;
      while (2 * lps * nbox <= GRP) lps *= 2;
      const int spp = GRP / lps;  // box slots a pass
      const float* tpos = terr;
      const float* tsize = terr + 3 * nt;
      const float* tcos = terr + 6 * nt;
      const float* tsin = terr + 7 * nt;
#pragma unroll 1
      for (int s0 = 0; s0 < nbox; s0 += spp) {
        const int bs = s0 + lane / lps, sub_l = lane % lps;
        float best = -1e9f, bn0 = 0.f, bn1 = 0.f, bn2 = 1.f;
        int bt = MAX_T;
        if (bs < nbox) {
          const int c = si[I_BOXSLOT + bs];
          const float qx = cw[3 * c], qy = cw[3 * c + 1], qz = cw[3 * c + 2];
#pragma unroll 1
          for (int t = sub_l; t < nt; t += lps) {
            const float dx = qx - tpos[3 * t], dy = qy - tpos[3 * t + 1];
            const float tz = tpos[3 * t + 2];
            const float lz = qz - tz;
            const float c_ = tcos[t], s_ = tsin[t];
            const float lx = c_ * dx + s_ * dy;
            const float ly = -s_ * dx + c_ * dy;
            const float szh = tsize[3 * t + 2];
            const float ex = fabsf(lx) - tsize[3 * t];
            const float ey = fabsf(ly) - tsize[3 * t + 1];
            const bool resting = (tz - szh) <= fz + 1e-4f;
            const float ez = resting ? lz - szh : fabsf(lz) - szh;
            if (ex < 0.f && ey < 0.f && ez < 0.f) {
              const float pen = fmaxf(fmaxf(ex, ey), ez);
              if (pen > best) {
                best = pen;
                bt = t;
                const bool is_z = (ez >= ex) && (ez >= ey);
                const bool is_x = ex >= ey;
                bn0 = is_z ? 0.f : (is_x ? sgn(lx) * c_ : -sgn(ly) * s_);
                bn1 = is_z ? 0.f : (is_x ? sgn(lx) * s_ : sgn(ly) * c_);
                bn2 = is_z ? (resting ? 1.f : sgn(lz)) : 0.f;
              }
            }
          }
        }
#pragma unroll
        for (int o = 1; o < GRP; o <<= 1) {
          if (o >= lps) break;
          const float ob = __shfl_xor_sync(GROUP_MASK, best, o, GRP);
          const int ot = __shfl_xor_sync(GROUP_MASK, bt, o, GRP);
          const float o0 = __shfl_xor_sync(GROUP_MASK, bn0, o, GRP);
          const float o1 = __shfl_xor_sync(GROUP_MASK, bn1, o, GRP);
          const float o2 = __shfl_xor_sync(GROUP_MASK, bn2, o, GRP);
          if (ob > best || (ob == best && ot < bt)) {
            best = ob; bt = ot; bn0 = o0; bn1 = o1; bn2 = o2;
          }
        }
        if (bs < nbox && sub_l == 0) {
          const int c = si[I_BOXSLOT + bs];
          cdist[c] = (best > -1e8f) ? best : 1e3f;
          cn[3 * c] = bn0; cn[3 * c + 1] = bn1; cn[3 * c + 2] = bn2;
        }
      }
      group_sync();
    }
#endif

    // ---- contact rows through the basis (the owned slots, in registers):
    // 6 coefficients on the foot's keys (row_coef); impedance, reference
    // acceleration, D, b and the rows of Chat ----
    float r_d[SPL][3], r_b[SPL][3], r_mask[SPL];
    double r_dinv[SPL][3];
    int r_kend[SPL];
    float* const chat = work + W_CHAT;
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int c = lane + k * GRP;
      r_mask[k] = 0.f;
      r_kend[k] = 0;
      for (int f = 0; f < 3; ++f) {
        r_d[k][f] = 1.f; r_b[k][f] = 0.f; r_dinv[k][f] = 1.0;
      }
      if (c < nc) {
        const int base = 6 * si[I_SLOTFOOT + c];
        r_kend[k] = base + 6;
        const float dist = cdist[c];
        const float m = (dist < 0.f) ? 1.f : 0.f;
        r_mask[k] = m;
        float e[3][3], prel[3];
        slot_frame(si, cn, c, e);
#if LHW_TERRAIN
        corner_offset(si, cw, xpos, c, prel);
#else
        corner_offset(si, cw, oref, c, prel);
#endif
        const float pen = pmin(dist, 0.f);
        const float imp = impmin + impdiff * pmin(pmax(-pen / width, 0.f), 1.f);
        const float rreg = (1.f - imp) / pmax(imp, 1e-6f);
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          float cf[6];
          row_coef(e[f], prel, cf);
          float vel = 0.f, a0 = 0.f, adiag = 0.f;
#pragma unroll
          for (int mm = 0; mm < 6; ++mm) {
            vel += cf[mm] * u[base + mm];
            a0 += cf[mm] * u[MAX_K + base + mm];
#pragma unroll
            for (int nn = 0; nn < 6; ++nn) {
              const int r_ = base + (mm > nn ? mm : nn), c_ = base + (mm > nn ? nn : mm);
              adiag += cf[mm] * cf[nn] * gram[TRI(r_) + c_];
            }
          }
          float aref = -bref * vel;
          if (f == 0) aref = aref - kref * imp * pen;
          const float rdiag = rreg * pmax(adiag, 1e-8f);
          r_d[k][f] = m * rdiag + (1.f - m);
          r_dinv[k][f] = 1.0 / (double)r_d[k][f];
          r_b[k][f] = (aref - a0) * m;
          dinv[3 * c + f] = r_dinv[k][f];
          // Chat row: mask * sum_m coef_m LG[base + m][kk] (LG lower: kk <= base + m)
          float* ch = chat + (3 * c + f) * CHAT_LD;
#pragma unroll 1
          for (int kk = 0; kk < base + 6; ++kk) {
            float acc = 0.f;
#pragma unroll
            for (int mm = 0; mm < 6; ++mm)
              if (kk <= base + mm) acc += cf[mm] * lg[TRI(base + mm) + kk];
            ch[kk] = acc * m;
          }
        }
      }
    }
    group_sync();
    // K = I + Chat^T D^-1 Chat (rows of foot f reach columns < 6 f + 6) and
    // LK, in float64, as the sweeps' vectors below: Woodbury's
    // D^-1 r - D^-1 Chat K^-1 Chat^T D^-1 r cancels where D is small beside
    // Chat Chat^T (active rows: D = (1 - imp) / imp a_diag, ~0.05-0.1 of it),
    // which amplifies float32 rounding in K and in those vectors 10-20x, past
    // the plain version's dense solve; in float64 the kernel's error falls
    // below it again. The H100 runs float64 at half its float32 rate; this is
    // 78 entries of K and ~150 FMAs a lane and sweep.
    double* const kw = (double*)(work + W_KW);
    double* const lk = (double*)(work + W_LK);
#pragma unroll 1
    for (int p = lane; p < TRI(nk); p += GRP) {
      int r, c;
      tri_rc(p, r, c);
      double acc = 0.0;
#pragma unroll 1
      for (int i = 0; i < 3 * nc; ++i) {
        if (6 * si[I_SLOTFOOT + i / 3] + 6 <= r) continue;
        const float* ch = chat + i * CHAT_LD;
        acc += (double)ch[c] * ch[r] * dinv[i];
      }
      kw[p] = (r == c) ? acc + 1.0 : acc;
    }
    group_sync();
    double* const lkrd = (double*)(work + W_LKRD);
    group_cholesky(kw, lk, lkrd, nk, lane);

    // ---- projected refinement on the friction cones: f = P(A^-1 b), then
    // 3 times f = P(f + A^-1 (b - A f)); the residual and the Woodbury
    // vectors in float64 (see K above) ----
#pragma unroll 1
    for (int it = 0; it < 4; ++it) {
      double rv[SPL][3];
#pragma unroll
      for (int k = 0; k < SPL; ++k)
        for (int f = 0; f < 3; ++f) rv[k][f] = r_b[k][f];
      if (it > 0) {
        // r = b - A f, A f = Chat (Chat^T f) + D f
        double t[MAX_K];
#pragma unroll
        for (int kk = 0; kk < MAX_K; ++kk) t[kk] = 0.0;
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          const int c = lane + k * GRP;
          if (c < nc)
#pragma unroll
            for (int f = 0; f < 3; ++f) {
              const float* ch = chat + (3 * c + f) * CHAT_LD;
#pragma unroll
              for (int kk = 0; kk < MAX_K; ++kk)
                if (kk < r_kend[k]) t[kk] += (double)ch[kk] * r_force[k][f];
            }
        }
#pragma unroll
        for (int kk = 0; kk < MAX_K; ++kk) t[kk] = group_sum(t[kk]);
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          const int c = lane + k * GRP;
          if (c < nc)
#pragma unroll
            for (int f = 0; f < 3; ++f) {
              const float* ch = chat + (3 * c + f) * CHAT_LD;
              double acc = (double)r_d[k][f] * r_force[k][f];
#pragma unroll
              for (int kk = 0; kk < MAX_K; ++kk)
                if (kk < r_kend[k]) acc += (double)ch[kk] * t[kk];
              rv[k][f] = r_b[k][f] - acc;
            }
        }
      }
      // A^-1 r through the Woodbury identity
      double w[MAX_K], uu[SPL][3];
#pragma unroll
      for (int kk = 0; kk < MAX_K; ++kk) w[kk] = 0.0;
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const int c = lane + k * GRP;
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          uu[k][f] = rv[k][f] * r_dinv[k][f];
          if (c < nc) {
            const float* ch = chat + (3 * c + f) * CHAT_LD;
#pragma unroll
            for (int kk = 0; kk < MAX_K; ++kk)
              if (kk < r_kend[k]) w[kk] += (double)ch[kk] * uu[k][f];
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < MAX_K; ++kk) w[kk] = group_sum(w[kk]);
      reg_cho_solve(lk, lkrd, nk, w);
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const int c = lane + k * GRP;
        if (c < nc) {
          double x[3];
#pragma unroll
          for (int f = 0; f < 3; ++f) {
            const float* ch = chat + (3 * c + f) * CHAT_LD;
            double acc = 0.0;
#pragma unroll
            for (int kk = 0; kk < MAX_K; ++kk)
              if (kk < r_kend[k]) acc += (double)ch[kk] * w[kk];
            x[f] = uu[k][f] - acc * r_dinv[k][f];
            if (it > 0) x[f] = r_force[k][f] + x[f];
          }
          const float fn = pmax((float)x[0], 0.f);
          const float f1 = (float)x[1], f2 = (float)x[2];
          const float ftn = sqrtf(f1 * f1 + f2 * f2) + 1e-9f;
          const float scale = pmin((mu[c] * fn) / ftn, 1.f);
          const float m = r_mask[k];
          r_force[k][0] = fn * m;
          r_force[k][1] = (f1 * scale) * m;
          r_force[k][2] = (f2 * scale) * m;
        }
      }
    }

    // ---- constraint force back to joint space, Jc^T f = B^T w with the 12
    // basis accumulators w_k = sum_i coef_ik f_i (the coefficients computed
    // anew rather than kept live through the sweeps); semi-implicit Euler ----
    float wb[MAX_K];
#pragma unroll
    for (int kk = 0; kk < MAX_K; ++kk) wb[kk] = 0.f;
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int c = lane + k * GRP;
      if (c < nc) {
        const int foot = si[I_SLOTFOOT + c];
        float e[3][3], prel[3];
        slot_frame(si, cn, c, e);
#if LHW_TERRAIN
        corner_offset(si, cw, xpos, c, prel);
#else
        corner_offset(si, cw, oref, c, prel);
#endif
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          float cf[6];
          row_coef(e[f], prel, cf);
#pragma unroll
          for (int ft = 0; ft < MAX_F; ++ft)
#pragma unroll
            for (int mm = 0; mm < 6; ++mm)
              if (ft == foot) wb[6 * ft + mm] += cf[mm] * r_force[k][f];
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < MAX_K; ++kk) wb[kk] = group_sum(wb[kk]);
    float* const qcon = env + E_QCON;
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      const int d = lane + k * GRP;
      if (d < nv) {
        float f = 0.f;
#pragma unroll
        for (int kk = 0; kk < MAX_K; ++kk)
#if LHW_TERRAIN
          if (kk < nk) f += basis_at(si, s, xpos, kk, d) * wb[kk];
#else
          if (kk < nk) f += basis_at(si, sref, oref, kk, d) * wb[kk];
#endif
        qcon[d] = f;
      }
    }
    group_sync();
    group_cho_solve(lm, lrd, nv, qcon, tmpv, qcon, lane);
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      const int d = lane + k * GRP;
      if (d < nv) {
        r_qacc[k] = qaccs[d] + qcon[d];
        v[d] = pmin(pmax(v[d] + dt * r_qacc[k], -1e4f), 1e4f);
      }
    }
    group_sync();
#pragma unroll
    for (int k = 0; k < BPL; ++k) {
      const int i = lane + k * GRP;
      if (i >= 1 && i < nb) {
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
          const float dq[4] = {cosf(half), sc * om[0], sc * om[1], sc * om[2]};
          float qn[4];
          qmul(q + qa + 3, dq, qn);
          qnormalize(qn);
          for (int c = 0; c < 4; ++c) q[qa + 3 + c] = qn[c];
        }
      }
    }
    group_sync();
  }

  // ---- outputs: state, last-substep extras, final FK caches ----
  for (int r = lane; r < nq; r += GRP) qpos_out[r * B + b] = q[r];
  for (int r = lane; r < nv; r += GRP) qvel_out[r * B + b] = v[r];
#pragma unroll
  for (int k = 0; k < DPL; ++k) {
    const int d = lane + k * GRP;
    if (d < nv) qacc_out[d * B + b] = r_qacc[k];
  }
  for (int r = lane; r < nu; r += GRP) act_out[r * B + b] = act[r];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int c = lane + k * GRP;
    if (c < nc) {
      cdist_out[c * B + b] = cdist[c];
      cmask_out[c * B + b] = (cdist[c] < 0.f) ? 1.f : 0.f;
      for (int f = 0; f < 3; ++f) {
        cforce_out[(3 * c + f) * B + b] = r_force[k][f];
        cpos_out[(3 * c + f) * B + b] = cw[3 * c + f];
        cnormal_out[(3 * c + f) * B + b] = cn[3 * c + f];
      }
    }
  }
  group_fk(sf, si, q, xpos, xquat, rmat, lane);
  group_motion_subspace(sf, si, xpos, rmat, s, lane);
#pragma unroll
  for (int k = 0; k < BPL; ++k) {
    const int i = lane + k * GRP;
    if (i >= 1 && i < nb) body_velocity(si, s, v, i, cvel + 6 * i);
  }
  group_sync();
  for (int r = lane; r < 3 * nb; r += GRP) xpos_out[r * B + b] = xpos[r];
  for (int r = lane; r < 4 * nb; r += GRP) xquat_out[r * B + b] = xquat[r];
  for (int r = lane; r < 6 * nb; r += GRP) cvel_out[r * B + b] = cvel[r];
#if LHW_MOTOR
  // the histories out, oldest first, each joint's by its lane
#pragma unroll
  for (int k = 0; k < APL; ++k) {
    const int a = lane + k * GRP;
    if (a < nu)
#pragma unroll 1
      for (int h = 0; h < MAX_H; ++h) {
        int r = m_head + h;
        if (r >= MAX_H) r -= MAX_H;
        qd_hist_out[(a * MAX_H + h) * B + b] = qdh[a * MAX_H + r];
        ct_hist_out[(a * MAX_H + h) * B + b] = cth[a * MAX_H + r];
      }
  }
  if (lane == 0) count_out[b] = m_count;
#endif
}

// Table layout for the Python side, which builds the tables and the launch
// plan from it and keeps no copy: caps, lanes per env, the most threads a
// block, table sizes, every offset, the dof-kind and slot-kind codes, and
// the floats of an env's fixed shared region, as (name, value) pairs; the
// flat-floor builds add the offsets of the lagged basis, the motor builds
// (K4; K5 and K6) LHW_MOTOR, its caps and the offsets of its histories.
#define LHW_LAYOUT_COMMON(X)                                                                     \
  X(LHW_TERRAIN) X(LHW_G) X(LHW_TPB) X(MAX_B) X(MAX_V) X(MAX_Q) X(MAX_U) X(MAX_C) X(MAX_T)       \
  X(MAX_HF) X(MAX_F) X(N_FTAB) X(N_ITAB) X(SM_FIXED)                                             \
  X(I_NB) X(I_NV) X(I_NQ) X(I_NU) X(I_NC) X(I_NFOOT) X(I_NT) X(I_NLEV) X(I_NBOX) X(I_PARENT)     \
  X(I_JTYPE) X(I_QADR) X(I_DADR) X(I_DNUM) X(I_DOFBODY) X(I_DOFKIND) X(I_DOFK) X(I_ACTOFDOF)     \
  X(I_ACTQ) X(I_ACTD) X(I_SLOTFOOT) X(I_SLOTKIND) X(I_BOXSLOT) X(I_FOOTBODY) X(I_ANC) X(I_BANC)  \
  X(I_LEVEL) X(I_BORDER)                                                                         \
  X(F_GRAV) X(F_IMPMIN) X(F_IMPDIFF) X(F_WIDTH) X(F_KREF) X(F_BREF) X(F_BPOS) X(F_BQUAT)        \
  X(F_JAXIS) X(F_JPOS) X(F_BINER) X(F_IQMAT) X(F_BMASS0) X(F_ARM) X(F_GEAR) X(F_CLO) X(F_CHI)   \
  X(F_SGPOS) X(F_SGROT) X(F_SCORN) X(F_MU)                                                       \
  X(DOF_FREE_LIN) X(DOF_FREE_ANG) X(DOF_HINGE) X(DOF_SLIDE)                                    \
  X(SLOT_FLAT) X(SLOT_FLOOR) X(SLOT_HFIELD) X(SLOT_BOX)
#if LHW_TERRAIN && LHW_MOTOR
#define LHW_LAYOUT(X) LHW_LAYOUT_COMMON(X) X(LHW_MOTOR) X(MAX_H) X(MAX_HID) X(MAX_LAYERS) X(E_QDH) X(E_CTH)
#elif LHW_TERRAIN
#define LHW_LAYOUT(X) LHW_LAYOUT_COMMON(X)
#elif LHW_MOTOR
#define LHW_LAYOUT(X) LHW_LAYOUT_COMMON(X) X(E_SREF) X(E_OREF) X(LHW_MOTOR) X(MAX_H) X(MAX_HID) X(MAX_LAYERS) X(E_QDH) X(E_CTH)
#else
#define LHW_LAYOUT(X) LHW_LAYOUT_COMMON(X) X(E_SREF) X(E_OREF)
#endif

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

// Launch on the caller's stream; returns the CUDA error (0 = launched). The
// signature is the same in every build up to the build's own arguments: the
// motor build's (the stacked weights, the layer count and the two hidden
// widths, the histories (nu * MAX_H, B) and the int32 count (1, B) in and
// out; the terrain + motor build the same), then the launch plan, before the
// stream: envs a block and the floats of an env's shared region (even, at least SM_FIXED, plus its terrain on
// terrain), from the wrapper's launch_plan. On terrain floor_z is required,
// the box blocks when the model has terrain boxes and the heightfield blocks
// (hf_h, hf_w >= 2) when it has heightfield slots; the flat-floor builds
// ignore the terrain arguments. reuse must be 1 on terrain and with the
// motor hook (the reference pins R=1 there); the flat floor refreshes every
// reuse-th substep. Opts into the dynamic shared memory above 48 KB; a
// refused launch (too much shared memory, too many threads) returns its
// error.
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
    void* cmask, void* cpos, void* cnormal, void* xpos, void* xquat, void* cvel,
#if LHW_MOTOR
    const void* motor_w, int motor_layers, int motor_hid0, int motor_hid1, const void* qd_hist,
    const void* ct_hist, const void* count, void* qd_hist_out, void* ct_hist_out, void* count_out,
#endif
    int envs_per_block, int env_stride, void* stream) {
  if (batch <= 0) return 0;
#if LHW_TERRAIN
  if (reuse != 1 || envs_per_block < 1 || envs_per_block * GRP > LHW_TPB || env_stride < SM_FIXED + 1 || env_stride % 2)
    return (int)cudaErrorInvalidValue;
#else
  if (reuse < 1 || (LHW_MOTOR && reuse != 1) || envs_per_block < 1 || envs_per_block * GRP > LHW_TPB ||
      env_stride < SM_FIXED || env_stride % 2)
    return (int)cudaErrorInvalidValue;
#endif
  const int smem = envs_per_block * env_stride * (int)sizeof(float);
  const cudaError_t set = cudaFuncSetAttribute(LHW_KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return (int)set;
  dim3 block(envs_per_block * GRP);
  dim3 grid((batch + envs_per_block - 1) / envs_per_block);
  LHW_KERNEL<<<grid, block, smem, (cudaStream_t)stream>>>(
      batch, frame_skip, settle, dt, envs_per_block, env_stride,
#if !LHW_TERRAIN
      reuse,
#endif
#if LHW_MOTOR
      (const float*)motor_w, motor_layers, motor_hid0, motor_hid1, (const float*)qd_hist, (const float*)ct_hist,
      (const int*)count, (float*)qd_hist_out, (float*)ct_hist_out, (int*)count_out,
#endif
      (const float*)ftab, (const int*)itab,
      (const float*)qpos, (const float*)qvel, (const float*)target, (const float*)kp,
      (const float*)kd, (const float*)bemf, (const float*)damping, (const float*)frictionloss,
      (const float*)body_mass, (const float*)body_ipos, (const float*)xfrc,
      hf_h, hf_w, (const float*)terrain_pos, (const float*)terrain_size, (const float*)terrain_cos,
      (const float*)terrain_sin, (const float*)floor_z, (const float*)hfield, (const float*)hf_x0y0,
      (const float*)hf_cell,
      (float*)qpos_out, (float*)qvel_out, (float*)qacc_out, (float*)act_out, (float*)cforce,
      (float*)cdist, (float*)cmask, (float*)cpos, (float*)cnormal, (float*)xpos, (float*)xquat,
      (float*)cvel);
  return (int)cudaGetLastError();
}
