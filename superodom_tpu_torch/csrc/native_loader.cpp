// Native host runtime for superodom_tpu: the data-loader side of the
// framework, replacing the reference's C++ ingestion path (PCL point
// decoding, featureExtraction.cpp sensor handlers, MapRingBuffer.h) with a
// small dependency-free C++17 library exposed over a C ABI (consumed via
// ctypes; see superodom_tpu/native/__init__.py).
//
// Components:
//   * so_decode_points  — generic packed-record point decoder (the role of
//     pcl::fromROSMsg over PointCloud2 layouts): arbitrary per-field byte
//     offsets/types, one pass, branch-free inner loop.
//   * so_synth_ring_time — VLP ring-id + column/laser timing model
//     (reference assignTimeforPointCloud, featureExtraction.cpp:646-708).
//   * so_imu_buffer_*   — time-indexed bounded IMU buffer with window
//     extraction + scan/IMU synchronization check (reference
//     container/MapRingBuffer.h + synchronize_measurements,
//     featureExtraction.cpp:171-217).
//   * so_voxel_downsample — hash-grid thinning for large prior maps before
//     device upload (the role of pcl::VoxelGrid at map-load time).
//
// Build: see Makefile (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <map>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// generic packed point decoder
// ---------------------------------------------------------------------------

// field type tags (subset of sensor_msgs/PointField)
enum SoFieldType : int32_t {
  SO_F32 = 0,
  SO_F64 = 1,
  SO_I8 = 2,
  SO_U8 = 3,
  SO_I16 = 4,
  SO_U16 = 5,
  SO_I32 = 6,
  SO_U32 = 7,
};

static inline double read_field(const uint8_t* p, int32_t type) {
  switch (type) {
    case SO_F32: { float v; std::memcpy(&v, p, 4); return v; }
    case SO_F64: { double v; std::memcpy(&v, p, 8); return v; }
    case SO_I8:  { int8_t v; std::memcpy(&v, p, 1); return v; }
    case SO_U8:  { uint8_t v; std::memcpy(&v, p, 1); return v; }
    case SO_I16: { int16_t v; std::memcpy(&v, p, 2); return v; }
    case SO_U16: { uint16_t v; std::memcpy(&v, p, 2); return v; }
    case SO_I32: { int32_t v; std::memcpy(&v, p, 4); return v; }
    case SO_U32: { uint32_t v; std::memcpy(&v, p, 4); return v; }
  }
  return 0.0;
}

// Decode n packed records of `stride` bytes.  offsets/types describe the
// x, y, z, time, ring, intensity fields; offset < 0 means "absent" (output
// zero-filled).  time_scale converts the raw time value to seconds (e.g.
// 1e-9 for nanosecond stamps).  Returns the number of finite points kept;
// non-finite xyz rows are dropped (the reference's std::isfinite gates).
int64_t so_decode_points(const uint8_t* data, int64_t n, int64_t stride,
                         const int64_t* offsets, const int32_t* types,
                         double time_scale,
                         float* xyz_out, float* t_out, int32_t* ring_out,
                         float* intensity_out) {
  const int64_t ox = offsets[0], oy = offsets[1], oz = offsets[2];
  const int64_t ot = offsets[3], oring = offsets[4], oint = offsets[5];
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* rec = data + i * stride;
    const float x = static_cast<float>(read_field(rec + ox, types[0]));
    const float y = static_cast<float>(read_field(rec + oy, types[1]));
    const float z = static_cast<float>(read_field(rec + oz, types[2]));
    if (!std::isfinite(x) || !std::isfinite(y) || !std::isfinite(z)) continue;
    xyz_out[3 * m + 0] = x;
    xyz_out[3 * m + 1] = y;
    xyz_out[3 * m + 2] = z;
    t_out[m] = ot >= 0
                   ? static_cast<float>(read_field(rec + ot, types[3]) * time_scale)
                   : 0.0f;
    ring_out[m] = oring >= 0
                      ? static_cast<int32_t>(read_field(rec + oring, types[4]))
                      : 0;
    intensity_out[m] =
        oint >= 0 ? static_cast<float>(read_field(rec + oint, types[5])) : 0.0f;
    ++m;
  }
  return m;
}

// ---------------------------------------------------------------------------
// VLP ring/time synthesis (reference featureExtraction.cpp:646-708)
// ---------------------------------------------------------------------------

int64_t so_synth_ring_time(const float* xyz, int64_t n, int32_t n_scan_lines,
                           double column_time, double laser_time,
                           float* xyz_out, float* t_out, int32_t* ring_out) {
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
    const double angle =
        std::atan2((double)z, std::sqrt((double)x * x + (double)y * y)) *
        180.0 / M_PI;
    int scan_id = 0;
    bool ok = true;
    if (n_scan_lines == 16) {
      scan_id = (int)((angle + 15.0) / 2.0 + 0.5);
      ok = scan_id >= 0 && scan_id < 16;
    } else if (n_scan_lines == 32) {
      scan_id = (int)((angle + 92.0 / 3.0) * 3.0 / 4.0);
      ok = scan_id >= 0 && scan_id < 32;
    } else if (n_scan_lines == 64) {
      scan_id = angle >= -8.83 ? (int)((2.0 - angle) * 3.0 + 0.5)
                               : 32 + (int)((-8.83 - angle) * 2.0 + 0.5);
      ok = angle <= 2.0 && angle >= -24.33 && scan_id >= 0 && scan_id <= 50;
    } else {
      ok = false;
    }
    if (!ok) continue;
    xyz_out[3 * m + 0] = x;
    xyz_out[3 * m + 1] = y;
    xyz_out[3 * m + 2] = z;
    t_out[m] = (float)(column_time * (double)(i / n_scan_lines) +
                       laser_time * (double)(i % n_scan_lines));
    ring_out[m] = scan_id;
    ++m;
  }
  return m;
}

// ---------------------------------------------------------------------------
// IMU ring buffer + conditioning + orientation chain + scan synchronization
// ---------------------------------------------------------------------------

// 3-vector / quaternion helpers (double; quaternions are wxyz)
static inline void v_cross(const double* a, const double* b, double* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}
static inline void m_mulv(const double* R, const double* v, double* o) {
  for (int i = 0; i < 3; ++i)
    o[i] = R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2];
}
static inline void q_mul(const double* a, const double* b, double* o) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}
static inline void q_normalize(double* q) {
  const double n =
      std::sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  if (n > 0) for (int i = 0; i < 4; ++i) q[i] /= n;
}
static inline void so3_expq(const double* w, double* q) {
  const double th = std::sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
  if (th < 1e-12) {
    q[0] = 1.0; q[1] = 0.5 * w[0]; q[2] = 0.5 * w[1]; q[3] = 0.5 * w[2];
  } else {
    const double s = std::sin(0.5 * th) / th;
    q[0] = std::cos(0.5 * th);
    q[1] = s * w[0]; q[2] = s * w[1]; q[3] = s * w[2];
  }
  q_normalize(q);
}

struct SoImuBuffer {
  struct Sample {
    double t;
    float acc[3];
    float gyr[3];  // bias-subtracted once static init has run
    float q[4];    // integrated world<-body orientation (wxyz)
  };
  std::map<double, Sample> samples;  // time-indexed, like MapRingBuffer
  size_t capacity;
  // conditioning (the role of imuConverter, imuPreintegration.cpp:486-541):
  // rotate raw samples into the laser axes and transport the accelerometer
  // to the laser origin via the lever arm
  bool has_extrinsics = false;
  double R_li[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};  // imu -> laser rotation
  double t_il[3] = {0, 0, 0};  // laser origin in the imu frame
  double imu_rate = 200.0;
  double prev_raw_gyr[3] = {0, 0, 0};
  bool has_prev_raw = false;
  // orientation chain (updateImuOrientation, featureExtraction.cpp:574-583)
  double q_last[4] = {1, 0, 0, 0};
  double gyr_last[3] = {0, 0, 0};
  double t_last = -1.0;
  double bias[3] = {0, 0, 0};
  bool initialized = false;  // static init performed
};

void* so_imu_buffer_new(int64_t capacity) {
  auto* b = new SoImuBuffer();
  b->capacity = static_cast<size_t>(capacity);
  return b;
}

void so_imu_buffer_free(void* h) { delete static_cast<SoImuBuffer*>(h); }

// R_li: row-major imu->laser rotation; t_il: laser origin in the imu frame.
void so_imu_buffer_set_conditioning(void* h, const double* R_li,
                                    const double* t_il, double imu_rate) {
  auto* b = static_cast<SoImuBuffer*>(h);
  std::memcpy(b->R_li, R_li, 9 * sizeof(double));
  std::memcpy(b->t_il, t_il, 3 * sizeof(double));
  b->imu_rate = imu_rate;
  b->has_extrinsics = true;
}

// Condition one raw sample into the laser frame: gyr' = R_li w,
// acc' = R_li (a + dw/dt x t_il + w x (w x t_il)) — rigid-body transport of
// the accelerometer to the laser origin (lever arm as in
// imuPreintegration.cpp:511, with consistent frames).
static void so_condition(SoImuBuffer* b, const float* acc_in,
                         const float* gyr_in, double* acc_out,
                         double* gyr_out) {
  double a[3] = {acc_in[0], acc_in[1], acc_in[2]};
  double w[3] = {gyr_in[0], gyr_in[1], gyr_in[2]};
  if (!b->has_extrinsics) {
    std::memcpy(acc_out, a, 24);
    std::memcpy(gyr_out, w, 24);
    return;
  }
  double alpha[3] = {0, 0, 0};
  if (b->has_prev_raw)
    for (int i = 0; i < 3; ++i)
      alpha[i] = (w[i] - b->prev_raw_gyr[i]) * b->imu_rate;
  std::memcpy(b->prev_raw_gyr, w, 24);
  b->has_prev_raw = true;
  double tmp1[3], tmp2[3];
  v_cross(alpha, b->t_il, tmp1);          // dw/dt x r
  v_cross(w, b->t_il, tmp2);              // w x r
  double tmp3[3];
  v_cross(w, tmp2, tmp3);                 // w x (w x r)
  for (int i = 0; i < 3; ++i) a[i] += tmp1[i] + tmp3[i];
  m_mulv(b->R_li, a, acc_out);
  m_mulv(b->R_li, w, gyr_out);
}

// Advance the gyro orientation chain by one sample (trapezoid on rates).
static void so_chain_step(SoImuBuffer* b, double t, const double* gyr_c,
                          double* q_out) {
  double dt = b->t_last < 0 ? 1.0 / b->imu_rate : t - b->t_last;
  if (dt < 0.0) dt = 0.0;
  if (dt > 0.5) dt = 0.5;
  double w[3];
  for (int i = 0; i < 3; ++i)
    w[i] = dt * 0.5 * (gyr_c[i] + b->gyr_last[i]);
  double dq[4], q[4];
  so3_expq(w, dq);
  q_mul(b->q_last, dq, q);
  q_normalize(q);
  std::memcpy(b->q_last, q, 32);
  std::memcpy(b->gyr_last, gyr_c, 24);
  b->t_last = t;
  std::memcpy(q_out, q, 32);
}

void so_imu_buffer_add(void* h, double t, const float* acc, const float* gyr) {
  auto* b = static_cast<SoImuBuffer*>(h);
  double acc_c[3], gyr_c[3];
  so_condition(b, acc, gyr, acc_c, gyr_c);
  for (int i = 0; i < 3; ++i) gyr_c[i] -= b->bias[i];
  double q[4];
  so_chain_step(b, t, gyr_c, q);
  SoImuBuffer::Sample s;
  s.t = t;
  for (int i = 0; i < 3; ++i) {
    s.acc[i] = static_cast<float>(acc_c[i]);
    s.gyr[i] = static_cast<float>(gyr_c[i]);
  }
  for (int i = 0; i < 4; ++i) s.q[i] = static_cast<float>(q[i]);
  b->samples[t] = s;
  while (b->samples.size() > b->capacity)  // evict oldest (MapRingBuffer.h:39)
    b->samples.erase(b->samples.begin());
}

// Static initialization over the buffered samples in [first, first+window]
// (Imu::imuInit, imu_data.h:71-160): gyro bias from the mean rate, gravity
// roll/pitch alignment from the mean specific force.  Subtracts the bias
// from every stored sample and re-integrates the orientation chain from the
// gravity-aligned seed.  out = acc_mean[3], gyr_bias[3], q0[4] (wxyz).
// Returns 1 on success (>= 10 samples in the window), 0 otherwise.
int32_t so_imu_buffer_static_init(void* h, double window_sec,
                                  double* out) {
  auto* b = static_cast<SoImuBuffer*>(h);
  if (b->samples.size() < 10) return 0;
  const double t0 = b->samples.begin()->first;
  double acc_mean[3] = {0, 0, 0}, gyr_mean[3] = {0, 0, 0};
  int64_t n = 0;
  for (const auto& [t, s] : b->samples) {
    if (t > t0 + window_sec) break;
    for (int i = 0; i < 3; ++i) {
      acc_mean[i] += s.acc[i];
      gyr_mean[i] += s.gyr[i];
    }
    ++n;
  }
  if (n < 10) return 0;
  for (int i = 0; i < 3; ++i) {
    acc_mean[i] /= n;
    gyr_mean[i] /= n;
  }
  // gravity roll/pitch (calculatePitchRollMatrix, imu_data.h:45-69):
  // R = Rx(phi) Ry(theta) with R^T acc_mean = (0,0,|a|); the world seed is
  // R_w_l = R^T so that gravity maps to +z in the world frame.
  const double theta = std::atan2(
      acc_mean[0], std::sqrt(acc_mean[1] * acc_mean[1] +
                             acc_mean[2] * acc_mean[2]));
  const double phi = std::atan2(-acc_mean[1], acc_mean[2]);
  const double ct = std::cos(theta), st = std::sin(theta);
  const double cp = std::cos(phi), sp = std::sin(phi);
  // R = Rx(phi) @ Ry(theta); q0 from R^T
  const double R[9] = {ct, 0, st,
                       sp * st, cp, -sp * ct,
                       -cp * st, sp, cp * ct};
  // quaternion from R^T (transpose = inverse rotation)
  const double Rt[9] = {R[0], R[3], R[6], R[1], R[4], R[7], R[2], R[5], R[8]};
  double q0[4];
  {
    const double tr = Rt[0] + Rt[4] + Rt[8];
    if (tr > 0) {
      double s = std::sqrt(tr + 1.0) * 2;
      q0[0] = 0.25 * s;
      q0[1] = (Rt[7] - Rt[5]) / s;
      q0[2] = (Rt[2] - Rt[6]) / s;
      q0[3] = (Rt[3] - Rt[1]) / s;
    } else if (Rt[0] > Rt[4] && Rt[0] > Rt[8]) {
      double s = std::sqrt(1.0 + Rt[0] - Rt[4] - Rt[8]) * 2;
      q0[0] = (Rt[7] - Rt[5]) / s;
      q0[1] = 0.25 * s;
      q0[2] = (Rt[1] + Rt[3]) / s;
      q0[3] = (Rt[2] + Rt[6]) / s;
    } else if (Rt[4] > Rt[8]) {
      double s = std::sqrt(1.0 + Rt[4] - Rt[0] - Rt[8]) * 2;
      q0[0] = (Rt[2] - Rt[6]) / s;
      q0[1] = (Rt[1] + Rt[3]) / s;
      q0[2] = 0.25 * s;
      q0[3] = (Rt[5] + Rt[7]) / s;
    } else {
      double s = std::sqrt(1.0 + Rt[8] - Rt[0] - Rt[4]) * 2;
      q0[0] = (Rt[3] - Rt[1]) / s;
      q0[1] = (Rt[2] + Rt[6]) / s;
      q0[2] = (Rt[5] + Rt[7]) / s;
      q0[3] = 0.25 * s;
    }
    q_normalize(q0);
  }
  // subtract bias everywhere, re-integrate the chain from the seed
  for (int i = 0; i < 3; ++i) b->bias[i] += gyr_mean[i];
  std::memcpy(b->q_last, q0, 32);
  for (int i = 0; i < 3; ++i) b->gyr_last[i] = 0.0;
  b->t_last = -1.0;
  for (auto& [t, s] : b->samples) {
    double gyr_c[3];
    for (int i = 0; i < 3; ++i) {
      s.gyr[i] = static_cast<float>(s.gyr[i] - gyr_mean[i]);
      gyr_c[i] = s.gyr[i];
    }
    double q[4];
    so_chain_step(b, t, gyr_c, q);
    for (int i = 0; i < 4; ++i) s.q[i] = static_cast<float>(q[i]);
  }
  b->initialized = true;
  for (int i = 0; i < 3; ++i) out[i] = acc_mean[i];
  for (int i = 0; i < 3; ++i) out[3 + i] = gyr_mean[i];
  for (int i = 0; i < 4; ++i) out[6 + i] = q0[i];
  return 1;
}

int64_t so_imu_buffer_size(void* h) {
  return static_cast<int64_t>(static_cast<SoImuBuffer*>(h)->samples.size());
}

// Synchronization check (featureExtraction.cpp:171-217): 1 if the buffer
// fully covers [t0, t1] (one sample at-or-before t0 and one after t1),
// 0 if not yet coverable (wait), -1 if the scan predates the buffer (drop).
int32_t so_imu_buffer_sync(void* h, double t0, double t1) {
  auto* b = static_cast<SoImuBuffer*>(h);
  if (b->samples.empty()) return 0;
  const double first = b->samples.begin()->first;
  const double last = b->samples.rbegin()->first;
  if (first > t0) return -1;
  if (last <= t1) return 0;
  return 1;
}

// Extract (at most max_out) samples covering [t0, t1] inclusive of one
// sample before t0 and one after t1; evenly decimated when over capacity.
// q_out (wxyz per sample) may be null.  Returns the number written.
int64_t so_imu_buffer_window(void* h, double t0, double t1, int64_t max_out,
                             double* t_out, float* acc_out, float* gyr_out,
                             float* q_out) {
  auto* b = static_cast<SoImuBuffer*>(h);
  if (b->samples.empty()) return 0;
  auto lo = b->samples.upper_bound(t0);
  if (lo != b->samples.begin()) --lo;
  auto hi = b->samples.upper_bound(t1);
  if (hi != b->samples.end()) ++hi;

  std::vector<const SoImuBuffer::Sample*> sel;
  for (auto it = lo; it != hi; ++it) sel.push_back(&it->second);
  const int64_t n = static_cast<int64_t>(sel.size());
  if (n == 0) return 0;

  const int64_t out_n = n <= max_out ? n : max_out;
  for (int64_t k = 0; k < out_n; ++k) {
    const int64_t idx =
        n <= max_out ? k : (k * (n - 1)) / (out_n - 1 > 0 ? out_n - 1 : 1);
    const auto* s = sel[static_cast<size_t>(idx)];
    t_out[k] = s->t;
    std::memcpy(acc_out + 3 * k, s->acc, 12);
    std::memcpy(gyr_out + 3 * k, s->gyr, 12);
    if (q_out) std::memcpy(q_out + 4 * k, s->q, 16);
  }
  return out_n;
}

// Drop samples older than t (MapRingBuffer::clean).
void so_imu_buffer_clean(void* h, double t) {
  auto* b = static_cast<SoImuBuffer*>(h);
  b->samples.erase(b->samples.begin(), b->samples.lower_bound(t));
}

// ---------------------------------------------------------------------------
// host-side voxel downsample (prior-map loading)
// ---------------------------------------------------------------------------

int64_t so_voxel_downsample(const float* xyz, int64_t n, double res,
                            float* xyz_out) {
  struct Key {
    int32_t x, y, z;
    bool operator==(const Key& o) const {
      return x == o.x && y == o.y && z == o.z;
    }
  };
  struct KeyHash {
    size_t operator()(const Key& k) const {
      // murmur-style mix; see ops/voxel.py for why plain XOR is unsafe
      uint32_t h = (uint32_t)k.x * 73856093u + (uint32_t)k.y * 19349663u +
                   (uint32_t)k.z * 83492791u;
      h ^= h >> 16; h *= 0x85ebca6bu; h ^= h >> 13;
      h *= 0xc2b2ae35u; h ^= h >> 16;
      return h;
    }
  };
  struct Acc {
    double sx = 0, sy = 0, sz = 0;
    int64_t c = 0;
  };
  std::unordered_map<Key, Acc, KeyHash> cells;
  cells.reserve(static_cast<size_t>(n / 2));
  const double inv = 1.0 / res;
  for (int64_t i = 0; i < n; ++i) {
    const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
    if (!std::isfinite(x) || !std::isfinite(y) || !std::isfinite(z)) continue;
    Key k{(int32_t)std::floor(x * inv), (int32_t)std::floor(y * inv),
          (int32_t)std::floor(z * inv)};
    auto& a = cells[k];
    a.sx += x; a.sy += y; a.sz += z; ++a.c;
  }
  int64_t m = 0;
  for (const auto& [k, a] : cells) {
    xyz_out[3 * m + 0] = (float)(a.sx / a.c);
    xyz_out[3 * m + 1] = (float)(a.sy / a.c);
    xyz_out[3 * m + 2] = (float)(a.sz / a.c);
    ++m;
  }
  return m;
}

}  // extern "C"
