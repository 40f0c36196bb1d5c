// K2, the constrained flood for Hopper (sm_90a): 8-connected binary
// reconstruction of `seed` through `within`, x <- dilate3x3(x) & within,
// repeated until no pixel changes or `cap` steps have run, with zero fill
// outside the canvas (no wrap-around).
//
// Replaces the TPU kernel sykepic_tpu/ops/pallas_flood.py::flood_pallas
// (pallas_call at :102, body _kernel :49-77), which kept the whole loop in
// VMEM per batch tile. Plain version: sykepic_tpu_torch/ops/flood.py::
// flood_plain, which takes the same Jacobi steps one tensor op at a time.
//
// Semantics: every step reads only the previous step's state (Jacobi), so
// the result equals the plain version and the JAX flood at ANY cap, not
// only at convergence. An image stops when one of its steps changes
// nothing; steps after that would change nothing either, so stopping per
// image (here) and per batch tile (the TPU kernel) give the same masks.
//
// What bounds it: the bytes are one read of seed and within and one write
// of the output (3 B a pixel); the work is the steps these inputs need x
// 12 logic operations per 32-pixel word; and the steps of one image form a
// chain that no parallelism shortens. So a call on the main path's small
// canvases (2048 x 32x56) is bounded by bytes, and what costs time beyond
// that is latency: of the loads, and of each step's exchange between
// threads. The state is bit-packed, one 32-bit word per 32 pixels of a row
// (bit b of word j is column 32j + b; bits past the last column stay 0
// because their `within` bits are 0), so a step is, per word, the OR with
// the words above and below, shifts by one with the carry bits of the
// neighbouring words, and an AND with `within`.
//
// Loads and stores (both one-launch forms): 8 bool bytes (0 or 1) are
// packed into 8 bits by one multiply (pack8) and unpacked the same way
// (unpack8); a row whose width is a multiple of 8 on 8-byte aligned
// tensors moves in 8-byte accesses, any other in byte accesses.
// Neighbouring threads take neighbouring 8-byte chunks of a row, and each
// thread starts a batch of loads before it uses the first, so an image's
// loads are in flight together instead of one warp-wide load per word.
//
// - Warp form (flood_warp_kernel<R, WW>): canvases up to 128 x 256. One
//   warp holds one image in registers: lane l keeps rows [l*R, l*R + R) of
//   the state and of `within` as R x WW words. The rows above and below its
//   block come from the neighbouring lanes by __shfl_up/down_sync, the
//   carries across a row stay in the lane's registers, and convergence is
//   __any_sync: the loop touches no shared memory and waits at no barrier.
//   Eight images to a block (four at 4 x 8 words); a warp whose image has
//   converged leaves its loop. Loads and stores go through the warp's own
//   staging planes in shared memory, with __syncwarp only: the lanes read
//   and write along the rows (coalesced), then each lane takes its block.
//   (Each lane reading its own R rows directly, 32 rows a warp-wide load,
//   measured at 3.3x the byte bound at cap 0.)
// - Shared-memory form (flood_shared_kernel<K>): one block per image, for
//   canvases past the warp form whose two planes (the state and the
//   vertical OR, h * ceil(w/32) words each) fit the block's opt-in shared
//   memory (227 KB on the H100). Loads are coalesced (neighbouring threads
//   read neighbouring 8-byte chunks and write one packed byte each). Each
//   thread owns K fixed words for the whole loop, computes their position
//   once, and keeps their state and `within` in registers. A step is two
//   phases: each word's vertical OR is written to shared memory once, then
//   read by its own thread and its two horizontal neighbours; the step
//   ends in __syncthreads_or(changed). At K = 32 (over 16k words, only
//   canvases of more than ~520k pixels) the registers spill to local
//   memory.
// - Global-memory form (flood_init_kernel + flood_step_kernel): for canvases
//   past the shared-memory budget. One step per launch over all pixels, one
//   byte each, with a per-image "last step that changed" word in device
//   memory; the wrapper launches several steps between reads of it and
//   never passes `cap`.
//
// Interface: plain C functions (loaded with ctypes). Each launches on the
// given stream, allocates nothing, and returns cudaGetLastError(). `steps`
// may be null when the caller does not want the step counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSharedMaxThreads = 1024;
constexpr int kSharedMinThreads = 64;
constexpr int kStepThreads = 256;

// 8 bool bytes -> 8 bits (byte k -> bit k): the multiply places byte k's
// bit at 56 + k and no other product reaches bits 56-63.
__device__ __forceinline__ uint32_t pack8(uint64_t x) {
  return static_cast<uint32_t>((x * 0x0102040810204080ull) >> 56);
}

// 8 bits -> 8 bool bytes (bit k -> byte k): copy the byte 8 times, keep bit
// k in byte k, then turn each non-zero byte into 1.
__device__ __forceinline__ uint64_t unpack8(uint32_t bits) {
  const uint64_t r = (static_cast<uint64_t>(bits & 0xffu) *
                      0x0101010101010101ull) & 0x8040201008040201ull;
  return ((r + 0x7f7f7f7f7f7f7f7full) & 0x8080808080808080ull) >> 7;
}

// Bytes [c, c + 8) of a row of w bytes, zero past the row's end. `vec`: w is
// a multiple of 8 and the row is 8-byte aligned (c is a multiple of 8).
__device__ __forceinline__ uint64_t load8(const uint8_t* __restrict__ row,
                                          int c, int w, bool vec) {
  if (vec) {
    return c < w ? __ldg(reinterpret_cast<const unsigned long long*>(row + c))
                 : 0ull;
  }
  uint64_t v = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (c + k < w) v |= static_cast<uint64_t>(__ldg(row + c + k)) << (8 * k);
  }
  return v;
}

__device__ __forceinline__ void store8(uint8_t* __restrict__ row, int c,
                                       int w, bool vec, uint64_t v) {
  if (vec) {
    if (c < w) *reinterpret_cast<unsigned long long*>(row + c) = v;
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (c + k < w) row[c + k] = static_cast<uint8_t>(v >> (8 * k));
  }
}

// The warp form's block shape: images (warps) a block, and the staging
// planes' words for one lane's rows, padded by one word so that lanes
// reading their blocks hit distinct banks.
template <int R, int WW>
struct WarpShape {
  static constexpr int kImages = R * WW >= 32 ? 4 : 8;
  static constexpr int kLaneWords = R * WW + 1;
  static constexpr int kPlane = 32 * kLaneWords;
  static constexpr int kRowBytes = 4 * WW;  // packed bytes a row
  static constexpr int kPerLane = R * kRowBytes;  // packed bytes a lane moves
  // byte of the staging plane that holds packed byte g of row r
  static __device__ __forceinline__ int at(int r, int g) {
    return 4 * ((r / R) * kLaneWords + (r % R) * WW) + g;
  }
};

// One warp per image, R rows of WW words a lane: h <= 32 R, w <= 32 WW.
template <int R, int WW>
__global__ void __launch_bounds__(32 * WarpShape<R, WW>::kImages)
flood_warp_kernel(const uint8_t* __restrict__ seed,
                  const uint8_t* __restrict__ within,
                  uint8_t* __restrict__ out, int32_t* __restrict__ steps,
                  int b, int h, int w, bool vec, long long cap) {
  using S = WarpShape<R, WW>;
  __shared__ uint32_t stage[S::kImages][2][S::kPlane];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int img = blockIdx.x * S::kImages + warp;
  if (img >= b) return;  // the whole warp; nothing waits for it
  const size_t base = static_cast<size_t>(img) * h * w;
  uint32_t* st = stage[warp][0];
  uint32_t* wt = stage[warp][1];
  uint8_t* st8 = reinterpret_cast<uint8_t*>(st);
  uint8_t* wt8 = reinterpret_cast<uint8_t*>(wt);

  // load and pack, coalesced: slot c (packed byte g of row r) reads
  // columns [8g, 8g + 8), so neighbouring lanes read neighbouring chunks
  constexpr int kBatch = S::kPerLane < 8 ? S::kPerLane : 8;
#pragma unroll 1
  for (int s0 = 0; s0 < S::kPerLane; s0 += kBatch) {
    uint64_t s8[kBatch], m8[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = (s0 + u) * 32 + lane;
      const int r = c / S::kRowBytes;
      const int g = c % S::kRowBytes;
      s8[u] = m8[u] = 0ull;
      if (r < h) {
        const size_t row = base + static_cast<size_t>(r) * w;
        s8[u] = load8(seed + row, 8 * g, w, vec);
        m8[u] = load8(within + row, 8 * g, w, vec);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = (s0 + u) * 32 + lane;
      const int a = S::at(c / S::kRowBytes, c % S::kRowBytes);
      const uint32_t m = pack8(m8[u]);
      st8[a] = static_cast<uint8_t>(pack8(s8[u]) & m);
      wt8[a] = static_cast<uint8_t>(m);
    }
  }
  __syncwarp();

  // lane l keeps rows [l R, l R + R) in registers from here on
  uint32_t cur[R][WW], win[R][WW];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < WW; ++j) {
      cur[i][j] = st[lane * S::kLaneWords + i * WW + j];
      win[i][j] = wt[lane * S::kLaneWords + i * WW + j];
    }
  }

  long long it = 0;
  bool changed = true;
  while (it < cap && changed) {  // uniform across the warp
    uint32_t v[R][WW];
#pragma unroll
    for (int j = 0; j < WW; ++j) {
      uint32_t above = __shfl_up_sync(kFull, cur[R - 1][j], 1);
      uint32_t below = __shfl_down_sync(kFull, cur[0][j], 1);
      if (lane == 0) above = 0u;
      if (lane == 31) below = 0u;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        v[i][j] = cur[i][j] | (i > 0 ? cur[i - 1][j] : above) |
                  (i + 1 < R ? cur[i + 1][j] : below);
      }
    }
    bool mine = false;
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < WW; ++j) {
        const uint32_t x = v[i][j];
        const uint32_t left = j > 0 ? v[i][j - 1] >> 31 : 0u;
        const uint32_t right = j + 1 < WW ? v[i][j + 1] << 31 : 0u;
        const uint32_t g = (x | (x << 1) | left | (x >> 1) | right) &
                           win[i][j];
        mine |= g != cur[i][j];
        cur[i][j] = g;
      }
    }
    changed = __any_sync(kFull, mine);
    ++it;
  }

  // each lane wrote and read only its own words since the last sync
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < WW; ++j) {
      st[lane * S::kLaneWords + i * WW + j] = cur[i][j];
    }
  }
  __syncwarp();
#pragma unroll 4
  for (int c = lane; c < 32 * S::kPerLane; c += 32) {
    const int r = c / S::kRowBytes;
    const int g = c % S::kRowBytes;
    if (r < h) {
      store8(out + base + static_cast<size_t>(r) * w, 8 * g, w, vec,
             unpack8(st8[S::at(r, g)]));
    }
  }
  if (lane == 0 && steps != nullptr) steps[img] = static_cast<int32_t>(it);
}

// One block per image; thread t owns words t + k * blockDim.x, k < K.
template <int K>
__global__ void __launch_bounds__(kSharedMaxThreads)
flood_shared_kernel(const uint8_t* __restrict__ seed,
                    const uint8_t* __restrict__ within,
                    uint8_t* __restrict__ out, int32_t* __restrict__ steps,
                    int h, int w, int ww, bool vec, long long cap) {
  extern __shared__ uint32_t planes[];
  const int n = h * ww;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  uint32_t* st = planes;      // the state
  uint32_t* vt = planes + n;  // `within` while loading, then vertical ORs
  uint8_t* st8 = reinterpret_cast<uint8_t*>(st);
  uint8_t* vt8 = reinterpret_cast<uint8_t*>(vt);
  const size_t base = static_cast<size_t>(blockIdx.x) * h * w;
  // byte c of the packed planes holds columns 8 (c % rb) .. + 8 of row
  // c / rb, padding columns included
  const int rb = 4 * ww;
  const int n_bytes = h * rb;

  for (int c0 = t; c0 < n_bytes; c0 += 4 * nt) {
    uint64_t s8[4], m8[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * nt;
      s8[u] = m8[u] = 0ull;
      if (c < n_bytes) {
        const int r = c / rb;
        const size_t at = base + static_cast<size_t>(r) * w;
        const int col = 8 * (c - r * rb);
        s8[u] = load8(seed + at, col, w, vec);
        m8[u] = load8(within + at, col, w, vec);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * nt;
      if (c < n_bytes) {
        const uint32_t m = pack8(m8[u]);
        st8[c] = static_cast<uint8_t>(pack8(s8[u]) & m);
        vt8[c] = static_cast<uint8_t>(m);
      }
    }
  }
  __syncthreads();

  uint32_t cur[K], win[K];
  // bit k: word k has a row above, a row below, a word left, a word right
  uint32_t up = 0, down = 0, left = 0, right = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = t + k * nt;
    cur[k] = win[k] = 0u;
    if (q < n) {
      const int r = q / ww;
      const int j = q - r * ww;
      cur[k] = st[q];
      win[k] = vt[q];
      up |= static_cast<uint32_t>(r > 0) << k;
      down |= static_cast<uint32_t>(r + 1 < h) << k;
      left |= static_cast<uint32_t>(j > 0) << k;
      right |= static_cast<uint32_t>(j + 1 < ww) << k;
    }
  }
  __syncthreads();  // vt becomes the vertical-OR plane

  long long it = 0;
  int changed = 1;
  while (it < cap && changed) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = t + k * nt;
      if (q < n) {
        uint32_t x = cur[k];
        if ((up >> k) & 1u) x |= st[q - ww];
        if ((down >> k) & 1u) x |= st[q + ww];
        vt[q] = x;
      }
    }
    __syncthreads();  // every vertical OR written; st is read no more
    int mine = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = t + k * nt;
      if (q < n) {
        const uint32_t x = vt[q];
        const uint32_t l = ((left >> k) & 1u) ? vt[q - 1] >> 31 : 0u;
        const uint32_t r = ((right >> k) & 1u) ? vt[q + 1] << 31 : 0u;
        const uint32_t g = (x | (x << 1) | l | (x >> 1) | r) & win[k];
        mine |= g != cur[k];
        cur[k] = g;
        st[q] = g;
      }
    }
    // every new word is in st and vt is read no more; the OR makes the
    // loop condition uniform
    changed = __syncthreads_or(mine);
    ++it;
  }

  for (int c = t; c < n_bytes; c += nt) {
    const int r = c / rb;
    store8(out + base + static_cast<size_t>(r) * w, 8 * (c - r * rb), w, vec,
           unpack8(st8[c]));
  }
  if (t == 0 && steps != nullptr) steps[blockIdx.x] = static_cast<int32_t>(it);
}

__global__ void __launch_bounds__(kStepThreads)
flood_init_kernel(const uint8_t* __restrict__ seed,
                  const uint8_t* __restrict__ within,
                  uint8_t* __restrict__ state, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < n) state[i] = (seed[i] != 0) & (within[i] != 0);
}

// One Jacobi step over every pixel of the batch; an image whose pixel
// changed records `step` (all writers of one launch store the same value).
__global__ void __launch_bounds__(kStepThreads)
flood_step_kernel(const uint8_t* __restrict__ cur,
                  const uint8_t* __restrict__ within,
                  uint8_t* __restrict__ nxt, int32_t* __restrict__ last_changed,
                  int b, int h, int w, int step) {
  const long long hw = static_cast<long long>(h) * w;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= hw * b) return;
  const int img = static_cast<int>(i / hw);
  const long long p = i - img * hw;
  const int y = static_cast<int>(p / w);
  const int x = static_cast<int>(p - static_cast<long long>(y) * w);
  const uint8_t* s = cur + img * hw;
  uint8_t grown = 0;
  if (within[i]) {
    for (int dy = -1; dy <= 1 && !grown; ++dy) {
      const int yy = y + dy;
      if (yy < 0 || yy >= h) continue;
      for (int dx = -1; dx <= 1; ++dx) {
        const int xx = x + dx;
        if (xx >= 0 && xx < w && s[static_cast<long long>(yy) * w + xx]) {
          grown = 1;
          break;
        }
      }
    }
  }
  nxt[i] = grown;
  if (grown != cur[i]) last_changed[img] = step;
}

// 8-byte accesses need rows of a multiple of 8 bytes on aligned tensors.
bool vec_ok(const void* a, const void* b, const void* c, int w) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c);
  return w % 8 == 0 && bits % 8 == 0;
}

template <int R, int WW>
cudaError_t warp_launch(const void* seed, const void* within, void* out,
                        void* steps, int b, int h, int w, long long cap,
                        cudaStream_t stream) {
  constexpr int kImages = WarpShape<R, WW>::kImages;
  const int blocks = (b + kImages - 1) / kImages;
  flood_warp_kernel<R, WW><<<blocks, 32 * kImages, 0, stream>>>(
      static_cast<const uint8_t*>(seed), static_cast<const uint8_t*>(within),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(steps), b, h, w,
      vec_ok(seed, within, out, w), cap);
  return cudaGetLastError();
}

template <int R>
cudaError_t warp_launch_rows(int words, const void* seed, const void* within,
                             void* out, void* steps, int b, int h, int w,
                             long long cap, cudaStream_t stream) {
  switch (words) {
    case 1: return warp_launch<R, 1>(seed, within, out, steps, b, h, w, cap, stream);
    case 2: return warp_launch<R, 2>(seed, within, out, steps, b, h, w, cap, stream);
    case 4: return warp_launch<R, 4>(seed, within, out, steps, b, h, w, cap, stream);
    case 8: return warp_launch<R, 8>(seed, within, out, steps, b, h, w, cap, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int K>
cudaError_t shared_launch(const void* seed, const void* within, void* out,
                          void* steps, int b, int h, int w, int ww,
                          long long cap, cudaStream_t stream) {
  const int n = h * ww;
  int threads = ((n + K - 1) / K + 31) / 32 * 32;
  if (threads < kSharedMinThreads) threads = kSharedMinThreads;
  const size_t smem = static_cast<size_t>(2) * n * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flood_shared_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  flood_shared_kernel<K><<<b, threads, smem, stream>>>(
      static_cast<const uint8_t*>(seed), static_cast<const uint8_t*>(within),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(steps), h, w, ww,
      vec_ok(seed, within, out, w), cap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a block of this kernel may opt into on `device`, in bytes.
int flood_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return v;
}

// The warp form. seed, within: uint8 0/1 (b, h, w); out: uint8 (b, h, w);
// steps: int32 (b,) or null. rows (1, 2, 4) and words (1, 2, 4, 8) name the
// instance: h <= 32 * rows, w <= 32 * words.
int flood_warp_launch(const void* seed, const void* within, void* out,
                      void* steps, int b, int h, int w, int rows, int words,
                      long long cap, void* stream) {
  if (b == 0 || h == 0 || w == 0) return static_cast<int>(cudaSuccess);
  if (h > 32 * rows || w > 32 * words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return static_cast<int>(warp_launch_rows<1>(
        words, seed, within, out, steps, b, h, w, cap, s));
    case 2: return static_cast<int>(warp_launch_rows<2>(
        words, seed, within, out, steps, b, h, w, cap, s));
    case 4: return static_cast<int>(warp_launch_rows<4>(
        words, seed, within, out, steps, b, h, w, cap, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The shared-memory form, same arguments but the instance. The caller
// checked that 2 * h * ceil(w/32) * 4 bytes fit flood_smem_limit() and that
// h * ceil(w/32) <= 32 * 1024 words.
int flood_shared_launch(const void* seed, const void* within, void* out,
                        void* steps, int b, int h, int w, long long cap,
                        void* stream) {
  if (b == 0 || h == 0 || w == 0) return static_cast<int>(cudaSuccess);
  const int ww = (w + 31) / 32;
  const int n = h * ww;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (n + kSharedMaxThreads - 1) / kSharedMaxThreads;
  cudaError_t e;
  if (per <= 1) {
    e = shared_launch<1>(seed, within, out, steps, b, h, w, ww, cap, s);
  } else if (per <= 2) {
    e = shared_launch<2>(seed, within, out, steps, b, h, w, ww, cap, s);
  } else if (per <= 4) {
    e = shared_launch<4>(seed, within, out, steps, b, h, w, ww, cap, s);
  } else if (per <= 8) {
    e = shared_launch<8>(seed, within, out, steps, b, h, w, ww, cap, s);
  } else if (per <= 16) {
    e = shared_launch<16>(seed, within, out, steps, b, h, w, ww, cap, s);
  } else if (per <= 32) {
    e = shared_launch<32>(seed, within, out, steps, b, h, w, ww, cap, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// state <- seed & within, n bytes.
int flood_init_launch(const void* seed, const void* within, void* state,
                      long long n, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n + kStepThreads - 1) / kStepThreads;
  flood_init_kernel<<<static_cast<unsigned>(blocks), kStepThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seed), static_cast<const uint8_t*>(within),
      static_cast<uint8_t*>(state), n);
  return static_cast<int>(cudaGetLastError());
}

// nxt <- dilate3x3(cur) & within for (b, h, w) uint8 planes; last_changed:
// int32 (b,), set to `step` for each image with a changed pixel.
int flood_step_launch(const void* cur, const void* within, void* nxt,
                      void* last_changed, int b, int h, int w, int step,
                      void* stream) {
  const long long n = static_cast<long long>(b) * h * w;
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n + kStepThreads - 1) / kStepThreads;
  flood_step_kernel<<<static_cast<unsigned>(blocks), kStepThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(within),
      static_cast<uint8_t*>(nxt), static_cast<int32_t*>(last_changed), b, h,
      w, step);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
