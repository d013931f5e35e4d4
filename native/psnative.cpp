// psnative — native runtime support for particlesystem_tpu.
//
// The reference's runtime is native C++ (the Unicorn/pmlib scheduler plus the
// host orchestration in source/code/src/particleSystem.cpp).  The device compute
// path here is JAX/XLA/Pallas; this library supplies the host-side runtime
// pieces that stay native:
//
//   * a lock-free SPSC ring buffer for double-buffered async frame readback
//     (the render-loop path of BASELINE config 5: the sim loop publishes
//     frames, a render/IO consumer drains them, neither ever blocks the
//     device queue),
//   * monotonic timers for per-phase metrics (the reference samples
//     getCurrentTimeInSecs around each stage, particleSystem.cpp:1846-1927),
//   * a vectorizable C implementation of the emitter-scene oracle step so
//     large trajectory-validation runs don't crawl through numpy.
//
// Pure C ABI; loaded from Python with ctypes (utils/native.py).

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// timers
// ---------------------------------------------------------------------------

double ps_now() {
  using clock = std::chrono::steady_clock;
  return std::chrono::duration<double>(clock::now().time_since_epoch())
      .count();
}

// ---------------------------------------------------------------------------
// SPSC ring buffer (single producer, single consumer)
// ---------------------------------------------------------------------------

struct PsRing {
  size_t frame_bytes;
  size_t depth;
  std::vector<uint8_t> data;
  std::atomic<uint64_t> head{0};  // written by producer
  std::atomic<uint64_t> tail{0};  // written by consumer
};

void* ps_ring_create(size_t frame_bytes, size_t depth) {
  PsRing* r = new PsRing();
  r->frame_bytes = frame_bytes;
  r->depth = depth;
  r->data.resize(frame_bytes * depth);
  return r;
}

void ps_ring_destroy(void* ring) { delete static_cast<PsRing*>(ring); }

// Returns 1 on success, 0 if the ring is full (frame dropped — the render
// consumer is behind; the sim never blocks).
int ps_ring_try_push(void* ring, const void* frame, size_t nbytes) {
  PsRing* r = static_cast<PsRing*>(ring);
  if (nbytes > r->frame_bytes) return 0;
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->depth) return 0;  // full
  std::memcpy(&r->data[(head % r->depth) * r->frame_bytes], frame, nbytes);
  r->head.store(head + 1, std::memory_order_release);
  return 1;
}

// Returns 1 on success, 0 if empty.
int ps_ring_try_pop(void* ring, void* out, size_t nbytes) {
  PsRing* r = static_cast<PsRing*>(ring);
  if (nbytes > r->frame_bytes) return 0;
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  if (head == tail) return 0;  // empty
  std::memcpy(out, &r->data[(tail % r->depth) * r->frame_bytes], nbytes);
  r->tail.store(tail + 1, std::memory_order_release);
  return 1;
}

size_t ps_ring_fill(void* ring) {
  PsRing* r = static_cast<PsRing*>(ring);
  return static_cast<size_t>(r->head.load(std::memory_order_acquire) -
                             r->tail.load(std::memory_order_acquire));
}

// ---------------------------------------------------------------------------
// emitter-scene oracle step (mirrors cpu_ref/oracle_emitter.py /
// models/emitter.step_core — keep all three in lockstep)
// ---------------------------------------------------------------------------

struct PsPlane {
  float px, py, pz;    // point
  float nx, ny, nz;    // unit normal
  float restitution;
  float friction;
};

struct PsSphere {
  float cx, cy, cz;
  float radius;
  float restitution;
  float friction;
};

static inline void respond_plane(float& px, float& py, float& pz, float& vx,
                                 float& vy, float& vz, const PsPlane& pl) {
  float d = (px - pl.px) * pl.nx + (py - pl.py) * pl.ny + (pz - pl.pz) * pl.nz;
  if (d < 0.0f) {
    px -= pl.nx * d;
    py -= pl.ny * d;
    pz -= pl.nz * d;
    float vn = vx * pl.nx + vy * pl.ny + vz * pl.nz;
    if (vn < 0.0f) {
      float mu1 = 1.0f - pl.friction;
      float e = pl.restitution;
      vx = (vx - pl.nx * vn) * mu1 - pl.nx * vn * e;
      vy = (vy - pl.ny * vn) * mu1 - pl.ny * vn * e;
      vz = (vz - pl.nz * vn) * mu1 - pl.nz * vn * e;
    }
  }
}

static inline void respond_sphere(float& px, float& py, float& pz, float& vx,
                                  float& vy, float& vz, const PsSphere& sp) {
  float dx = px - sp.cx, dy = py - sp.cy, dz = pz - sp.cz;
  float dist = std::sqrt(dx * dx + dy * dy + dz * dz);
  float depth = sp.radius - dist;
  if (depth > 0.0f) {
    float safe = dist > 1e-20f ? dist : 1e-20f;
    float nx = dx / safe, ny = dy / safe, nz = dz / safe;
    px += nx * depth;
    py += ny * depth;
    pz += nz * depth;
    float vn = vx * nx + vy * ny + vz * nz;
    if (vn < 0.0f) {
      float mu1 = 1.0f - sp.friction;
      float e = sp.restitution;
      vx = (vx - nx * vn) * mu1 - nx * vn * e;
      vy = (vy - ny * vn) * mu1 - ny * vn * e;
      vz = (vz - nz * vn) * mu1 - nz * vn * e;
    }
  }
}

// SoA arrays length n; alive is uint8.  Integrates alive rows only
// (dead rows frozen), then ages and flips alive where age1 > life.
void ps_emitter_step(float* pos, float* vel, float* age, float* life,
                     uint8_t* alive, int64_t n, float dt, float gx, float gy,
                     float gz, float wx, float wy, float wz, float drag,
                     const PsPlane* planes, int n_planes,
                     const PsSphere* spheres, int n_spheres) {
  for (int64_t i = 0; i < n; ++i) {
    if (!alive[i]) continue;
    float px = pos[3 * i], py = pos[3 * i + 1], pz = pos[3 * i + 2];
    float vx = vel[3 * i], vy = vel[3 * i + 1], vz = vel[3 * i + 2];
    float ax = gx, ay = gy, az = gz;
    if (drag != 0.0f) {
      ax += (wx - vx) * drag;
      ay += (wy - vy) * drag;
      az += (wz - vz) * drag;
    }
    vx += ax * dt;
    vy += ay * dt;
    vz += az * dt;
    px += vx * dt;
    py += vy * dt;
    pz += vz * dt;
    for (int p = 0; p < n_planes; ++p)
      respond_plane(px, py, pz, vx, vy, vz, planes[p]);
    for (int s = 0; s < n_spheres; ++s)
      respond_sphere(px, py, pz, vx, vy, vz, spheres[s]);
    float a1 = age[i] + dt;
    pos[3 * i] = px;
    pos[3 * i + 1] = py;
    pos[3 * i + 2] = pz;
    vel[3 * i] = vx;
    vel[3 * i + 1] = vy;
    vel[3 * i + 2] = vz;
    age[i] = a1;
    if (a1 > life[i]) alive[i] = 0;
  }
}

}  // extern "C"
