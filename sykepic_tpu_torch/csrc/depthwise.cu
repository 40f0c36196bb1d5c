// Depthwise convolution over NHWC float32 activations, for Hopper (sm_90a):
//
//   y[n, oy, ox, c] = sum over ky, kx of w[c, 0, ky, kx] *
//                     x[n, oy * S - P + ky, ox * S - P + kx, c]
//
// with a square K x K filter (K = 3, 5 or 7), stride S (1 or 2) both ways,
// zero padding P = (K - 1) / 2, dilation 1, no bias, and the weight as
// nn.Conv2d holds it, (C, 1, K, K). x and y are contiguous NHWC (the NHWC
// view of a channels_last tensor), C a multiple of 4.
//
// Replaces no Pallas kernel: the JAX package leaves the depthwise
// convolution to XLA. It was added because cuDNN's float32 depthwise kernels
// for NHWC (conv2d_c1_k1_nhwc, convolve_common_engine_float_NHWC) ran
// ConvNeXt-T's 7x7 convolutions at about 11% of their byte bound on an H100.
// Plain version: sykepic_tpu_torch/ops/depthwise.py::depthwise_plain.
//
// What bounds it: bytes. Each input value is read once and each output
// value written once (8 B an output at stride 1, 20 B at stride 2); a 7x7
// tap loop is 49 FMAs an output, which at the card's float32 rate takes
// about 1.6 times less than those bytes take at 3.35 TB/s, so at 7x7 the
// instructions besides the FMAs decide how close it comes. The design:
//
// - A lane owns one channel, a warp 32 neighbouring channels, a block
//   (grid.y) a slice of 32 channels. The lane holds its channel's K x K
//   taps in registers for the whole launch: the block stages its slice of
//   the weights into shared memory once, coalesced and transposed (tap-
//   major, padded against bank conflicts), and each lane reads its taps
//   from there. No per-call transpose of the weight.
// - A warp computes a tile of RY output rows by X output columns of one
//   image for its 32 channels, in fully unrolled loops whose register
//   indices are all known at compile time: for each of the tile's
//   (RY - 1) S + K input rows it reads the (X - 1) S + K values of its
//   window from shared memory into registers (32 lanes on 32 banks) and
//   adds each to every output of the tile that uses it. The wrapper picks
//   the tile per shape (ops/depthwise.py::plan) from the instances below,
//   to waste few outputs at the map's edge.
// - The input rows reach shared memory by cp.async, 16 bytes a copy (128
//   neighbouring bytes a pixel: coalesced), with padding as zero fill, so
//   no register waits on device memory and no load is predicated: each
//   warp keeps the next three rows of its stream of tiles in flight in a
//   ring of four row slots, across the end of one tile into the next.
// - A persistent grid: as many blocks as stay resident, each walking its
//   slice's tiles of every image with a stride (neighbouring tiles on
//   neighbouring warps, so the rows two tiles share come from L2), and the
//   weights are staged once a block.
//
// Rounding: built with -fmad=false like the port's other kernels, but the
// tap loop is written with explicit fmaf (one rounding where mul-then-add
// rounds twice), in the plain version's order (taps row-major, from zero);
// the two agree to float32 rounding, not bit for bit.
//
// Interface: one plain C function (loaded with ctypes) that launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>
#include <vector>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlice = 32;  // channels a block: one a lane
constexpr int kAhead = 3;   // input rows a warp has in flight
constexpr int kSlots = kAhead + 1;

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool read) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // with a source size of 0 nothing is read and the 16 bytes are zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(read ? 16 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_rows() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Floats of shared memory before the warps' row slots: the slice's taps,
// [tap][lane] with one float of padding a tap, rounded up to 16 bytes.
template <int KK>
__host__ __device__ constexpr int taps_floats() {
  return (KK * (kSlice + 1) + 3) / 4 * 4;
}

template <int K, int S, int RY, int X>
constexpr int smem_bytes() {
  return 4 * (taps_floats<K * K>() +
              kWarps * kSlots * ((X - 1) * S + K) * kSlice);
}

// A warp's tile: its image, first output row and column, and what the
// lane's copies of each input row need, computed once a tile. The lane
// copies 16 bytes (its `part` of 8) of pixel j = 4 it + lane / 8 of the
// row in its copy `it`. Offsets are in floats from the lane's part of the
// image's first pixel, in an int (the launch checks an image fits).
template <int IC>
struct Tile {
  static constexpr int kCopies = (IC + 3) / 4;  // 16-byte copies a row
  int img, oy0, ox0;
  int row0;           // offset of input row 0 (negative above the map)
  int col[kCopies];   // offset of the copy's pixel in a row; -1: outside
};

template <int S, int RY, int X, int P, int IC>
__device__ __forceinline__ Tile<IC> tile_of(int g, int tiles, int tiles_x,
                                            int wd, int c, bool part_live) {
  Tile<IC> t;
  t.img = g / tiles;
  const int i = g - t.img * tiles;
  const int ty = i / tiles_x;
  t.oy0 = ty * RY;
  t.ox0 = (i - ty * tiles_x) * X;
  t.row0 = (t.oy0 * S - P) * wd * c;
  const int ix0 = t.ox0 * S - P + ((threadIdx.x & 31) >> 3);
#pragma unroll
  for (int it = 0; it < Tile<IC>::kCopies; ++it) {
    const int ix = ix0 + it * 4;
    const bool in = part_live &&
                    static_cast<unsigned>(ix) < static_cast<unsigned>(wd);
    t.col[it] = in ? ix * c : -1;
  }
  return t;
}

template <int K, int S, int RY, int X>
__global__ void __launch_bounds__(kThreads, 2)
depthwise_nhwc_kernel(const float* __restrict__ x,
                      const float* __restrict__ w, float* __restrict__ y,
                      int n, int h, int wd, int c, int ho, int wo,
                      int tiles_x, int tiles) {
  constexpr int P = (K - 1) / 2;
  constexpr int KK = K * K;
  constexpr int IR = (RY - 1) * S + K;  // input rows a tile reads
  constexpr int IC = (X - 1) * S + K;   // input columns a tile reads
  constexpr int kRow = IC * kSlice;     // floats of one staged input row
  static_assert(IR >= kAhead, "a tile holds the rows in flight");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float(*taps)[kSlice + 1] = reinterpret_cast<float(*)[kSlice + 1]>(smem);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * kSlice;
  const int slice = min(kSlice, c - c0);
  const bool live = lane < slice;
  // (C, 1, K, K) is contiguous over the slice's channels: read it
  // coalesced, store it tap-major
  const float* ws = w + static_cast<long long>(c0) * KK;
  for (int i = threadIdx.x; i < slice * KK; i += kThreads) {
    taps[i % KK][i / KK] = ws[i];
  }
  __syncthreads();
  float wr[KK];
#pragma unroll
  for (int t = 0; t < KK; ++t) wr[t] = live ? taps[t][lane] : 0.f;

  float* rows = smem + taps_floats<KK>() + warp * kSlots * kRow;
  const int items = n * tiles;  // the launch checks it fits
  const int step = gridDim.x * kWarps;
  int g = blockIdx.x * kWarps + warp;
  if (g >= items) return;

  // Input row r of tile t into slot `slot`: its IC pixels' slice of 32
  // channels, 16 bytes a copy, pixels outside the map as zeros (and the
  // channels past a part slice, which only dead lanes read).
  const int part = lane & 7, pix = lane >> 3;
  const bool part_live = part < slice / 4;
  const float* xp = x + c0 + part * 4;
  const int row_floats = wd * c;
  const long long image_in = static_cast<long long>(h) * row_floats;
  // the last copy of a row reaches past its IC pixels for some lanes
  const bool last_copy = (Tile<IC>::kCopies - 1) * 4 + pix < IC;
  float* lane_rows = rows + pix * kSlice + part * 4;
  auto stage = [&](const Tile<IC>& t, int r, int slot) {
    const bool row_in = static_cast<unsigned>(t.oy0 * S - P + r) <
                        static_cast<unsigned>(h);
    const int row = t.row0 + r * row_floats;
    const float* src = xp + t.img * image_in;
    float* dst = lane_rows + slot * kRow;
#pragma unroll
    for (int it = 0; it < Tile<IC>::kCopies; ++it) {
      const bool in = row_in && t.col[it] >= 0;
      if (it + 1 < Tile<IC>::kCopies || last_copy) {
        copy16(dst + it * 4 * kSlice, src + (in ? row + t.col[it] : 0), in);
      }
    }
  };

  // the warp's input rows, in order: row q is row q % IR of its
  // (q / IR)-th tile; kAhead of them are in flight, one copy group a row
  Tile<IC> cur = tile_of<S, RY, X, P, IC>(g, tiles, tiles_x, wd, c,
                                          part_live);
#pragma unroll
  for (int r = 0; r < kAhead; ++r) {
    stage(cur, r, r);
    commit();
  }
  int slot = 0;  // the slot of the row about to be read
  for (; g < items; g += step) {
    const bool more = g < items - step;
    const Tile<IC> next =
        more ? tile_of<S, RY, X, P, IC>(g + step, tiles, tiles_x, wd, c,
                                        part_live)
             : cur;
    float acc[RY][X];
#pragma unroll
    for (int i = 0; i < RY; ++i) {
#pragma unroll
      for (int o = 0; o < X; ++o) acc[i][o] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < IR; ++r) {
      wait_rows<kAhead - 1>();
      // every lane's copies of this row have landed, and every lane has
      // read the slot the next copy reuses
      __syncwarp();
      const int ahead = slot == 0 ? kSlots - 1 : slot - 1;
      if (r + kAhead < IR) {
        stage(cur, r + kAhead, ahead);
      } else if (more) {
        stage(next, r + kAhead - IR, ahead);
      }
      commit();
      const float* row = rows + slot * kRow + lane;
      float v[IC];
#pragma unroll
      for (int j = 0; j < IC; ++j) v[j] = row[j * kSlice];
      slot = slot == kSlots - 1 ? 0 : slot + 1;
#pragma unroll
      for (int i = 0; i < RY; ++i) {
        const int ky = r - i * S;  // known at compile time once unrolled
        if (ky >= 0 && ky < K) {
#pragma unroll
          for (int o = 0; o < X; ++o) {
#pragma unroll
            for (int kx = 0; kx < K; ++kx) {
              acc[i][o] = fmaf(wr[ky * K + kx], v[o * S + kx], acc[i][o]);
            }
          }
        }
      }
    }
    if (live) {
      float* yi = y + static_cast<long long>(cur.img) * ho * wo * c + c0 +
                  lane;
#pragma unroll
      for (int i = 0; i < RY; ++i) {
        const int oy = cur.oy0 + i;
#pragma unroll
        for (int o = 0; o < X; ++o) {
          const int ox = cur.ox0 + o;
          if (oy < ho && ox < wo) yi[(oy * wo + ox) * c] = acc[i][o];
        }
      }
    }
    cur = next;
  }
  wait_rows<0>();
}

// Blocks of one instance that stay resident on the current device (kept
// per instance and device: the occupancy query costs more than a launch).
struct Resident {
  const void* kernel;
  int dev;
  int blocks;
};
std::mutex resident_mu;
std::vector<Resident> resident_cache;

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int smem, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(resident_mu);
  for (const Resident& r : resident_cache) {
    if (r.kernel == key && r.dev == dev) {
      *blocks = r.blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess) {
    return err;
  }
  *blocks = (per_sm > 1 ? per_sm : 1) * sms;
  resident_cache.push_back({key, dev, *blocks});
  return cudaSuccess;
}

struct Args {
  const float* x;
  const float* w;
  float* y;
  int n, h, wd, c, ho, wo;
};

template <int K, int S, int RY, int X>
int launch(const Args& a, cudaStream_t stream) {
  auto* kernel = depthwise_nhwc_kernel<K, S, RY, X>;
  constexpr int smem = smem_bytes<K, S, RY, X>();
  int resident = 0;
  const cudaError_t err = resident_blocks(kernel, smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (a.wo + X - 1) / X;
  const int tiles = ((a.ho + RY - 1) / RY) * tiles_x;
  const int slices = (a.c + kSlice - 1) / kSlice;
  // the kernel counts a slice's tiles in an int, past its last one too,
  // and the floats of an image
  if (static_cast<long long>(a.n) * tiles + resident * kWarps > INT_MAX ||
      static_cast<long long>(a.h + 2 * K) * a.wd * a.c > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long needed =
      (static_cast<long long>(a.n) * tiles + kWarps - 1) / kWarps;
  long long workers = resident / slices;
  if (workers < 1) workers = 1;
  if (workers > needed) workers = needed;
  const dim3 grid(static_cast<unsigned>(workers),
                  static_cast<unsigned>(slices));
  kernel<<<grid, kThreads, smem, stream>>>(a.x, a.w, a.y, a.n, a.h, a.wd, a.c,
                                        a.ho, a.wo, tiles_x, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: float32 (n, h, wd, c) contiguous; w: float32 (c, 1, k, k) contiguous;
// y: float32 (n, ho, wo, c) contiguous, ho = (h - 1) / stride + 1 and the
// same for wo. (k, stride, tile_rows, tile_cols) names an instance below:
// the wrapper's plan.
int depthwise_launch(const void* x, const void* w, void* y, int n, int h,
                     int wd, int c, int k, int stride, int tile_rows,
                     int tile_cols, void* stream) {
  if (n < 0 || h < 1 || wd < 1 || c < 4 || c % 4 != 0 ||
      static_cast<long long>(h) * wd * c > INT_MAX ||
      (reinterpret_cast<std::uintptr_t>(x) & 15) ||
      (reinterpret_cast<std::uintptr_t>(w) & 3) ||
      (reinterpret_cast<std::uintptr_t>(y) & 3) || c / kSlice >= 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int pad = (k - 1) / 2;
  const Args a{static_cast<const float*>(x), static_cast<const float*>(w),
               static_cast<float*>(y), n, h, wd, c,
               (h + 2 * pad - k) / stride + 1, (wd + 2 * pad - k) / stride + 1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DEPTHWISE_CASE(K, S, RY, X)                                   \
  if (k == K && stride == S && tile_rows == RY && tile_cols == X) { \
    return launch<K, S, RY, X>(a, s);                               \
  }
  // ops/depthwise.py::TILES lists the same instances
  DEPTHWISE_CASE(3, 1, 6, 6)
  DEPTHWISE_CASE(3, 2, 6, 6)
  DEPTHWISE_CASE(5, 1, 6, 6)
  DEPTHWISE_CASE(5, 2, 4, 4)
  DEPTHWISE_CASE(5, 2, 3, 3)
  DEPTHWISE_CASE(7, 1, 5, 5)
  DEPTHWISE_CASE(7, 1, 6, 6)
#undef DEPTHWISE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
