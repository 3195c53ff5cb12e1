// Device helpers of control_step_lanes.cu (K1-K4): NaN-propagating max/min (never
// fmaxf/fminf: the env layer terminates non-finite envs, so NaN must
// propagate), 3-vector cross product and the quaternion algebra of
// physics/batched.py (w, x, y, z order).

__device__ __forceinline__ float pmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float pmin(float a, float b) { return (a < b || a != a) ? a : b; }

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void qmul(const float* a, const float* b, float* o) {
  float w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  float x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  float y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  float z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

// v + w t + qv x t, t = 2 qv x v
__device__ __forceinline__ void qrot(const float* q, const float* v, float* o) {
  float t[3], c[3];
  cross3(q + 1, v, t);
  t[0] *= 2.f; t[1] *= 2.f; t[2] *= 2.f;
  cross3(q + 1, t, c);
  o[0] = v[0] + q[0] * t[0] + c[0];
  o[1] = v[1] + q[0] * t[1] + c[1];
  o[2] = v[2] + q[0] * t[2] + c[2];
}

__device__ __forceinline__ void qnormalize(float* q) {
  float n = pmax(sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), 1e-12f);
  q[0] /= n; q[1] /= n; q[2] /= n; q[3] /= n;
}

__device__ __forceinline__ void qmat(const float* q, float* r) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  r[0] = 1 - 2 * (y * y + z * z); r[1] = 2 * (x * y - w * z); r[2] = 2 * (x * z + w * y);
  r[3] = 2 * (x * y + w * z); r[4] = 1 - 2 * (x * x + z * z); r[5] = 2 * (y * z - w * x);
  r[6] = 2 * (x * z - w * y); r[7] = 2 * (y * z + w * x); r[8] = 1 - 2 * (x * x + y * y);
}
