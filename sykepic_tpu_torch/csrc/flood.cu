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
// Semantics: every step reads only the previous step's state (Jacobi, double
// buffered), so the result equals the plain version and the JAX flood at ANY
// cap, not only at convergence. An image stops when one of its steps changes
// nothing; steps after that would change nothing either, so stopping per
// image (here) and per batch tile (the TPU kernel) give the same masks.
//
// What bounds it: the chain of steps. The bytes are one read of seed and
// within and one write of the output (3 B a pixel); the work is
// steps x pixels logic operations, and the steps of one image form a chain
// that no parallelism shortens. The TPU kernel's bound was the XLA loop's
// per-step launches; the design here removes that in the same way, and
// goes further on memory:
//
// - Shared-memory form (flood_shared_kernel): one block per image. The
//   state is bit-packed, one 32-bit word per 32 pixels of a row, double
//   buffered in shared memory beside the packed `within` mask (3 planes of
//   h * ceil(w/32) words; a 48x96 image takes 1.7 KB). A step is, per word,
//   the OR of the words above and below, shifts by one with the carry bits
//   of the neighbouring words, and an AND with `within`: about 16 logic
//   operations for 32 pixels. It ends in __syncthreads_or(changed), so the
//   whole loop runs inside ONE launch per flood call and device memory is
//   touched only to load and to store.
// - Global-memory form (flood_init_kernel + flood_step_kernel): for canvases
//   whose three planes exceed the block's opt-in shared memory (227 KB on
//   the H100). One step per launch over all pixels, one byte each, with a
//   per-image "last step that changed" word in device memory; the wrapper
//   launches several steps between reads of it and never passes `cap`.
//
// Interface: plain C functions (loaded with ctypes). Each launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMinThreads = 64;
constexpr int kStepThreads = 256;

// OR of word (r, j) with the words directly above and below it; rows outside
// the canvas are zero.
__device__ __forceinline__ uint32_t column_or(const uint32_t* s, int r, int j,
                                              int h, int ww) {
  const uint32_t* p = s + r * ww + j;
  uint32_t v = p[0];
  if (r > 0) v |= p[-ww];
  if (r + 1 < h) v |= p[ww];
  return v;
}

// One block per image. Bit b of word j of a row is column 32*j + b; bits past
// the last column stay 0 because their `within` bits are 0.
__global__ void __launch_bounds__(kMaxThreads)
flood_shared_kernel(const uint8_t* __restrict__ seed,
                    const uint8_t* __restrict__ within,
                    uint8_t* __restrict__ out, int32_t* __restrict__ steps,
                    int h, int w, int ww, long long cap) {
  extern __shared__ uint32_t planes[];
  const int n = h * ww;
  uint32_t* cur = planes;
  uint32_t* nxt = planes + n;
  uint32_t* win = planes + 2 * n;
  const size_t base = static_cast<size_t>(blockIdx.x) * h * w;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  // load and pack: one warp per word, one lane per pixel (32 adjacent bytes)
  for (int q = warp; q < n; q += n_warps) {
    const int r = q / ww;
    const int c = (q - r * ww) * 32 + lane;
    const size_t i = base + static_cast<size_t>(r) * w + c;
    const bool inside = c < w;
    const uint32_t m = __ballot_sync(0xffffffffu, inside && within[i] != 0);
    const uint32_t s = __ballot_sync(0xffffffffu, inside && seed[i] != 0);
    if (lane == 0) {
      win[q] = m;
      cur[q] = s & m;
    }
  }
  __syncthreads();

  long long it = 0;
  int changed = 1;
  while (it < cap && changed) {
    int mine = 0;
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      const int r = q / ww;
      const int j = q - r * ww;
      const uint32_t mid = column_or(cur, r, j, h, ww);
      const uint32_t left = j > 0 ? column_or(cur, r, j - 1, h, ww) : 0u;
      const uint32_t right = j + 1 < ww ? column_or(cur, r, j + 1, h, ww) : 0u;
      const uint32_t grown = (mid | (mid << 1) | (left >> 31) | (mid >> 1) |
                              (right << 31)) & win[q];
      nxt[q] = grown;
      mine |= grown != cur[q];
    }
    // every thread has written its words of nxt and read its words of cur,
    // so the buffers may swap; the OR makes the loop condition uniform
    changed = __syncthreads_or(mine);
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
    ++it;
  }

  for (int q = warp; q < n; q += n_warps) {
    const int r = q / ww;
    const int c = (q - r * ww) * 32 + lane;
    if (c < w) {
      out[base + static_cast<size_t>(r) * w + c] =
          static_cast<uint8_t>((cur[q] >> lane) & 1u);
    }
  }
  if (threadIdx.x == 0) steps[blockIdx.x] = static_cast<int32_t>(it);
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

int n_threads(int words) {
  int t = (words + 31) / 32 * 32;
  if (t < kMinThreads) t = kMinThreads;
  if (t > kMaxThreads) t = kMaxThreads;
  return t;
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

// seed, within: uint8 0/1 (b, h, w); out: uint8 (b, h, w); steps: int32 (b,),
// the steps each image took. The caller checked that 3 * h * ceil(w/32) * 4
// bytes fit flood_smem_limit().
int flood_shared_launch(const void* seed, const void* within, void* out,
                        void* steps, int b, int h, int w, long long cap,
                        void* stream) {
  if (b == 0 || h == 0 || w == 0) return static_cast<int>(cudaSuccess);
  const int ww = (w + 31) / 32;
  const size_t smem = static_cast<size_t>(3) * h * ww * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flood_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flood_shared_kernel<<<b, n_threads(h * ww), smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seed), static_cast<const uint8_t*>(within),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(steps), h, w, ww, cap);
  return static_cast<int>(cudaGetLastError());
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
