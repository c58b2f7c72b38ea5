// Host frame ingest for the serving path of hmd_ego_pose_tpu_torch: I420 and
// NV12 (BT.601 limited range) to RGB8, and a single-producer single-consumer
// frame ring.
//
// The functions are the JAX package's (hmd_ego_pose_tpu/native/frameio.cpp)
// character for character, and serving/frameio.py builds them with the same
// compiler flags, so on one host the two packages decode the same bits.  The
// warp functions of that file live in warp.cpp here.
//
// Exposed via a C ABI for ctypes:
//   i420_to_rgb(y, u, v, h, w, stride_y, stride_uv, out)
//   nv12_to_rgb(y, uv, h, w, stride_y, stride_uv, out)
//   ring_*: single-producer single-consumer frame ring buffer.
//
// Build: g++ -O3 -march=native -shared -fPIC frameio.cpp -o libframeio.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t clamp_u8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// BT.601 limited-range YUV -> RGB (matches OpenCV's default cvtColor)
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  const int c = y - 16;
  const int d = u - 128;
  const int e = v - 128;
  rgb[0] = clamp_u8((298 * c + 409 * e + 128) >> 8);
  rgb[1] = clamp_u8((298 * c - 100 * d - 208 * e + 128) >> 8);
  rgb[2] = clamp_u8((298 * c + 516 * d + 128) >> 8);
}

}  // namespace

extern "C" {

void i420_to_rgb(const uint8_t* y_plane, const uint8_t* u_plane,
                 const uint8_t* v_plane, int height, int width, int stride_y,
                 int stride_uv, uint8_t* out_rgb) {
  for (int row = 0; row < height; ++row) {
    const uint8_t* yrow = y_plane + row * stride_y;
    const uint8_t* urow = u_plane + (row / 2) * stride_uv;
    const uint8_t* vrow = v_plane + (row / 2) * stride_uv;
    uint8_t* orow = out_rgb + row * width * 3;
    for (int col = 0; col < width; ++col) {
      yuv_to_rgb(yrow[col], urow[col / 2], vrow[col / 2], orow + col * 3);
    }
  }
}

void nv12_to_rgb(const uint8_t* y_plane, const uint8_t* uv_plane, int height,
                 int width, int stride_y, int stride_uv, uint8_t* out_rgb) {
  for (int row = 0; row < height; ++row) {
    const uint8_t* yrow = y_plane + row * stride_y;
    const uint8_t* uvrow = uv_plane + (row / 2) * stride_uv;
    uint8_t* orow = out_rgb + row * width * 3;
    for (int col = 0; col < width; ++col) {
      const int c2 = (col / 2) * 2;
      yuv_to_rgb(yrow[col], uvrow[c2], uvrow[c2 + 1], orow + col * 3);
    }
  }
}

// ---------------------------------------------------------------------------
// SPSC frame ring buffer: producer = network receive thread, consumer =
// batching dispatcher.  Lock-free; drops the oldest frame when full (live
// streaming wants freshness over completeness).
// ---------------------------------------------------------------------------

struct FrameRing {
  uint8_t* storage;
  int64_t frame_bytes;
  int64_t capacity;
  std::atomic<int64_t> head;  // next write slot
  std::atomic<int64_t> tail;  // next read slot
};

void* ring_create(int64_t frame_bytes, int64_t capacity) {
  auto* ring = new FrameRing();
  ring->storage =
      static_cast<uint8_t*>(std::malloc(frame_bytes * capacity));
  if (ring->storage == nullptr) {
    delete ring;
    return nullptr;
  }
  ring->frame_bytes = frame_bytes;
  ring->capacity = capacity;
  ring->head.store(0);
  ring->tail.store(0);
  return ring;
}

void ring_destroy(void* handle) {
  auto* ring = static_cast<FrameRing*>(handle);
  if (ring != nullptr) {
    std::free(ring->storage);
    delete ring;
  }
}

// Push a frame; returns 1 on success, 0 if it overwrote the oldest frame.
int ring_push(void* handle, const uint8_t* frame) {
  auto* ring = static_cast<FrameRing*>(handle);
  int64_t head = ring->head.load(std::memory_order_relaxed);
  int64_t tail = ring->tail.load(std::memory_order_acquire);
  int dropped = 0;
  if (head - tail >= ring->capacity) {
    // full: advance tail (drop oldest)
    ring->tail.store(tail + 1, std::memory_order_release);
    dropped = 1;
  }
  std::memcpy(ring->storage + (head % ring->capacity) * ring->frame_bytes,
              frame, ring->frame_bytes);
  ring->head.store(head + 1, std::memory_order_release);
  return dropped == 0 ? 1 : 0;
}

// Pop up to max_frames into out (contiguous); returns number popped.
int64_t ring_pop(void* handle, uint8_t* out, int64_t max_frames) {
  auto* ring = static_cast<FrameRing*>(handle);
  int64_t tail = ring->tail.load(std::memory_order_relaxed);
  int64_t head = ring->head.load(std::memory_order_acquire);
  int64_t avail = std::min(head - tail, max_frames);
  for (int64_t i = 0; i < avail; ++i) {
    std::memcpy(out + i * ring->frame_bytes,
                ring->storage + ((tail + i) % ring->capacity) * ring->frame_bytes,
                ring->frame_bytes);
  }
  ring->tail.store(tail + avail, std::memory_order_release);
  return avail;
}

int64_t ring_size(void* handle) {
  auto* ring = static_cast<FrameRing*>(handle);
  return ring->head.load(std::memory_order_acquire) -
         ring->tail.load(std::memory_order_acquire);
}

}  // extern "C"
