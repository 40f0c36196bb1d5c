// Swin's shifted-window attention (torchvision's shifted_window_attention,
// from the product with qkv to before proj) for one block, read from and
// written to the unpadded NHWC map, for Hopper (sm_90a):
//
//   qkv  (n, h, w, 3c)  F.linear of the block's normed tokens: q | k | v,
//                       head hd at channels hd * 32 .. hd * 32 + 31 of each
//   bias (3c)           qkv's bias: the q, k and v of a zero token
//   table (169, heads)  the relative-position bias table
//   y    (n, h, w, c)   each token's attention output, heads in channel
//                       order hd * 32 + d (what proj then takes)
//
// The windows are those of the padded, rolled map: the map padded at the
// bottom and right to multiples of 7 (pad_h x pad_w), then rolled by minus
// the shift (shift_h, shift_w; the caller sets an axis's shift to 0 where
// the window covers it). Window token (r, col) of window (wy, wx) is the
// map's token ((wy 7 + r + shift_h) mod pad_h, (wx 7 + col + shift_w) mod
// pad_w), or padding where that lies past the map. A padded token is a key
// and a value like any other, with the k and v of a zero token, which are
// qkv's bias; its query row is not computed. Scores are q.k * scale, plus
// the head's bias table[(r_q - r_k + 6) * 13 + (col_q - col_k + 6)] (the
// row torchvision's relative_position_index holds), plus -100 between
// tokens of different regions of a shifted window: along a shifted axis
// the last window splits at 7 - shift, which is torchvision's region mask.
// Then the softmax over the 49 keys, and the product with v. Each real
// query's output goes to its own token of the map, so no pad, roll,
// partition, reverse or crop is left, and qkv and proj run on the map's
// real tokens only.
//
// Replaces no Pallas kernel: the JAX package has no Swin. It was added
// because the port's path on SDPA needed dense padded windows: ATen's
// pad, roll, partition and reverse copies around it took as long as the
// attention itself, qkv and proj ran on a fifth of padded tokens, and the
// memory-efficient SDPA kernel ran at 19% of its roofline over 64-row
// tiles that hold 49-token windows.
// Plain version: sykepic_tpu_torch/ops/window_attention.py::
// window_attention_plain.
//
// What bounds it: q, k and v of the real tokens read once and the output
// written once, 16 B a token and channel (4.7 us a 180-px Swin-T ROI at
// 3.35 TB/s), against the two products' float32 FMAs (2.9 us at the card's
// 67 TFLOP/s). Neither dominates; on the card the FMAs and the shared
// memory reads that feed them take the time, so the design keeps the
// device memory stream under them:
//
// - A block is one (image, window, group of G heads) item. Its threads
//   first stage the window's k and v for the group into shared memory by
//   cp.async, 16 bytes a copy, neighbouring threads on neighbouring bytes
//   (a token's G heads of k and of v are two contiguous runs; a window
//   row's 7 tokens are neighbours in the map except where the roll wraps),
//   padded tokens' k and v from the bias; the block stages its heads'
//   columns of the bias table while the copies are in flight. Four blocks
//   stay resident on an SM, so one block's copies overlap the others'
//   products.
// - A thread owns one real query row of one head, so padded query rows
//   take no thread: it reads the row's q straight from the map (its own 128
//   contiguous bytes) and keeps the 49 scores in registers (loops over the
//   keys fully unrolled, so every index is known at compile time), summed
//   a float4 of q at a time over all 49 keys, so 49 independent sums hide
//   the FMA latency; then its 32 accumulators, which it writes straight to
//   its token's place in the output. Every thread of a warp reads the same
//   k or v float4 at once (a broadcast); heads lie 4 banks apart, so a
//   warp that spans two heads reads both in one pass. The bias row of a
//   score is an immediate offset from the query's base in the staged
//   table.
//
// Rounding: built with -fmad=false like the port's other kernels; the dot
// products and the weighted sum are explicit fmaf. The scores are
// q.k * scale + (bias + mask) with the mask added to the bias first, as
// SDPA's additive mask holds them; their exponentials are __expf
// (ex2.approx of x log2 e: a relative error of about 2^-22 plus 2^-24 |x|
// at x <= 0, which moves no output beyond float32 rounding once the
// weights are normalised); the softmax divides once at the end. The plain
// version and torchvision agree to float32 rounding, not bit for bit.
//
// Interface: one plain C function (loaded with ctypes) that launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <mutex>
#include <vector>

namespace {

constexpr int kWin = 7;
constexpr int kSpan = 2 * kWin - 1;       // offsets along an axis
constexpr int kTable = kSpan * kSpan;     // rows of the bias table
constexpr int kTokens = kWin * kWin;      // tokens of a window
constexpr int kHeadDim = 32;
constexpr int kVecs = kHeadDim / 4;       // float4 of a head's row
constexpr int kKvStride = kTokens * kHeadDim + 4;  // floats of a head's k
constexpr float kRegionMask = -100.f;

// Threads, registers and shared memory of the instance for G heads a
// block: one thread a query row.
template <int G>
struct Plan {
  static constexpr int kThreads = (G * kTokens + 31) / 32 * 32;
  // resident blocks asked of the register allocator: about 96 registers a
  // thread (the 49 scores and the row's q), so that four blocks of three
  // heads stay on an SM, as their shared memory allows; at most eight
  // blocks (128 registers) of one head, where fewer registers spill
  static constexpr int kMinBlocks =
      65536 / (96 * kThreads) < 8 ? 65536 / (96 * kThreads) : 8;
  // float offsets in shared memory (16-byte aligned where float4 go): each
  // head's k, then each head's v, then each head's bias table
  static constexpr int kK = 0;
  static constexpr int kV = kK + G * kKvStride;
  static constexpr int kBias = kV + G * kKvStride;
  static constexpr int kBytes = 4 * (kBias + G * kTable);
};

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

template <int G>
__global__ void __launch_bounds__(Plan<G>::kThreads, Plan<G>::kMinBlocks)
window_attention_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const float* __restrict__ table,
                        float* __restrict__ y, int h, int w, int c,
                        int heads, int nh, int nw, int shift_h, int shift_w,
                        float scale) {
  using P = Plan<G>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // each window token's pixel (img h + y) w + x in the map, -1 if padding;
  // the real tokens' window indices in order, and how many there are
  __shared__ int token[kTokens];
  __shared__ int real[kTokens];
  __shared__ int n_real;

  const int tid = threadIdx.x;
  const int groups = heads / G;
  const int windows = nh * nw;
  const int grp = blockIdx.x % groups;
  const int win = (blockIdx.x / groups) % windows;
  const int img = blockIdx.x / groups / windows;
  const int wy = win / nw, wx = win - wy * nw;
  const int ch0 = grp * G * kHeadDim;  // the group's first channel

  if (tid < 32) {
    const int pad_h = nh * kWin, pad_w = nw * kWin;
    int count = 0;
#pragma unroll
    for (int t0 = 0; t0 < kTokens; t0 += 32) {
      const int t = t0 + tid;
      const int r = t / kWin, col = t - r * kWin;
      int oy = wy * kWin + r + shift_h;
      int ox = wx * kWin + col + shift_w;
      if (oy >= pad_h) oy -= pad_h;
      if (ox >= pad_w) ox -= pad_w;
      const bool is_real = t < kTokens && oy < h && ox < w;
      if (t < kTokens) token[t] = is_real ? (img * h + oy) * w + ox : -1;
      const unsigned ballot = __ballot_sync(0xFFFFFFFFu, is_real);
      if (is_real) real[count + __popc(ballot & ((1u << tid) - 1u))] = t;
      count += __popc(ballot);
    }
    if (tid == 0) n_real = count;
  }
  __syncthreads();

  // k and v of the group's heads: copy t is float4 e of part (k, v) of
  // token i
  constexpr int kPart = G * kVecs;
  const long long pixel = 3LL * c;
  for (int t = tid; t < kTokens * 2 * kPart; t += P::kThreads) {
    const int e = t % kPart;
    const int part = 1 + t / kPart % 2;
    const int i = t / (2 * kPart);
    const int g = e / kVecs, d = e % kVecs * 4;
    float* dst = smem + d + (part == 1 ? P::kK : P::kV) + g * kKvStride +
                 i * kHeadDim;
    const int p = token[i];
    const int ch = part * c + ch0 + e * 4;
    if (p >= 0) {
      copy16(dst, qkv + p * pixel + ch);
    } else {
      *reinterpret_cast<float4*>(dst) =
          __ldg(reinterpret_cast<const float4*>(bias + ch));
    }
  }
  // the bias table's columns of the group, while the copies are in flight
  for (int t = tid; t < G * kTable; t += P::kThreads) {
    const int g = t / kTable;
    smem[P::kBias + t] = table[(t - g * kTable) * heads + ch0 / kHeadDim + g];
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // thread tid: the real query row i of head g that is the window's
  // (tid - g n)-th, so padded query rows take no thread and the warps past
  // the real rows have nothing to do
  const int n = n_real;
  const int g = tid / n;
  if (g < G) {
    const int i = real[tid - g * n];
    const long long p = token[i];
    const float4* qg = reinterpret_cast<const float4*>(
        qkv + p * pixel + ch0 + g * kHeadDim);
    const float4* kh =
        reinterpret_cast<const float4*>(smem + P::kK + g * kKvStride);
    const float4* vh =
        reinterpret_cast<const float4*>(smem + P::kV + g * kKvStride);
    // q.k of every key, a float4 of q at a time: 49 independent sums, each
    // over d in order
    float s[kTokens];
#pragma unroll
    for (int j = 0; j < kTokens; ++j) s[j] = 0.f;
#pragma unroll
    for (int e = 0; e < kVecs; ++e) {
      const float4 q4 = __ldg(qg + e);
#pragma unroll
      for (int j = 0; j < kTokens; ++j) {
        const float4 k4 = kh[j * kVecs + e];
        s[j] = fmaf(q4.x, k4.x, s[j]);
        s[j] = fmaf(q4.y, k4.y, s[j]);
        s[j] = fmaf(q4.z, k4.z, s[j]);
        s[j] = fmaf(q4.w, k4.w, s[j]);
      }
    }
    // the regions along each axis: the last window of a shifted axis
    // splits at kWin - shift; a key on the other side from the query is
    // masked
    const int r = i / kWin, col = i - r * kWin;
    const int split_r = shift_h && wy == nh - 1 ? kWin - shift_h : kWin;
    const int split_c = shift_w && wx == nw - 1 ? kWin - shift_w : kWin;
    const unsigned rows_past = (0x7Fu << split_r) & 0x7Fu;
    const unsigned cols_past = (0x7Fu << split_c) & 0x7Fu;
    const unsigned row_bad =
        (rows_past >> r) & 1u ? ~rows_past & 0x7Fu : rows_past;
    const unsigned col_bad =
        (cols_past >> col) & 1u ? ~cols_past & 0x7Fu : cols_past;
    // the bias of key (rj, cj) lies rj * kSpan + cj before the query's
    const float* bt = smem + P::kBias + g * kTable +
                      (r + kWin - 1) * kSpan + (col + kWin - 1);
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTokens; ++j) {
      const int rj = j / kWin, cj = j % kWin;
      const bool masked = ((row_bad >> rj) | (col_bad >> cj)) & 1u;
      s[j] = s[j] * scale + (bt[-(rj * kSpan + cj)] +
                             (masked ? kRegionMask : 0.f));
      m = fmaxf(m, s[j]);
    }
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < kTokens; ++j) {
      s[j] = __expf(s[j] - m);
      l += s[j];
    }
    float acc[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
#pragma unroll
    for (int j = 0; j < kTokens; ++j) {
#pragma unroll
      for (int e = 0; e < kVecs; ++e) {
        const float4 v4 = vh[j * kVecs + e];
        acc[4 * e] = fmaf(s[j], v4.x, acc[4 * e]);
        acc[4 * e + 1] = fmaf(s[j], v4.y, acc[4 * e + 1]);
        acc[4 * e + 2] = fmaf(s[j], v4.z, acc[4 * e + 2]);
        acc[4 * e + 3] = fmaf(s[j], v4.w, acc[4 * e + 3]);
      }
    }
    // the output at the query's own token of the map
    const float inv = 1.f / l;
    float4* out = reinterpret_cast<float4*>(y + p * c + ch0 + g * kHeadDim);
#pragma unroll
    for (int e = 0; e < kVecs; ++e) {
      out[e] = make_float4(acc[4 * e] * inv, acc[4 * e + 1] * inv,
                           acc[4 * e + 2] * inv, acc[4 * e + 3] * inv);
    }
  }
}

// Instances whose shared-memory limit has been raised on a device (kept per
// instance and device: the attribute applies to the current device).
struct Configured {
  const void* kernel;
  int dev;
};
std::mutex configured_mu;
std::vector<Configured> configured;

template <typename Kernel>
cudaError_t configure(Kernel kernel, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(configured_mu);
  for (const Configured& k : configured) {
    if (k.kernel == key && k.dev == dev) return cudaSuccess;
  }
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured.push_back({key, dev});
  return err;
}

struct Args {
  const float* qkv;
  const float* bias;
  const float* table;
  float* y;
  int n, h, w, c, heads, nh, nw, shift_h, shift_w;
  float scale;
};

template <int G>
int launch(const Args& a, cudaStream_t stream) {
  using P = Plan<G>;
  auto* kernel = window_attention_kernel<G>;
  const cudaError_t err = configure(kernel, P::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(a.n) * a.nh * a.nw * (a.heads / G);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), P::kThreads, P::kBytes, stream>>>(
      a.qkv, a.bias, a.table, a.y, a.h, a.w, a.c, a.heads, a.nh, a.nw,
      a.shift_h, a.shift_w, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qkv: float32 (n, h, w, 3 c) contiguous; bias: float32 (3 c); table:
// float32 (169, heads) contiguous; y: float32 (n, h, w, c) contiguous;
// c = 32 heads; shifts in [0, 7). group (heads a block) names an instance
// below: the wrapper's plan, 3 where it divides heads (every Swin-T and
// Swin-S block), else 1.
int window_attention_launch(const void* qkv, const void* bias,
                            const void* table, void* y, int n, int h, int w,
                            int c, int heads, int shift_h, int shift_w,
                            int group, float scale, void* stream) {
  if (n < 0 || h < 1 || w < 1 || heads < 1 || c != heads * kHeadDim ||
      group < 1 || heads % group != 0 || shift_h < 0 || shift_h >= kWin ||
      shift_w < 0 || shift_w >= kWin ||
      static_cast<long long>(n) * h * w > INT_MAX ||
      (reinterpret_cast<std::uintptr_t>(qkv) & 15) ||
      (reinterpret_cast<std::uintptr_t>(bias) & 15) ||
      (reinterpret_cast<std::uintptr_t>(table) & 3) ||
      (reinterpret_cast<std::uintptr_t>(y) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Args a{static_cast<const float*>(qkv),
               static_cast<const float*>(bias),
               static_cast<const float*>(table),
               static_cast<float*>(y),
               n, h, w, c, heads,
               (h + kWin - 1) / kWin, (w + kWin - 1) / kWin,
               shift_h, shift_w, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // ops/window_attention.py::plan picks one of these instances
  switch (group) {
    case 1: return launch<1>(a, s);
    case 3: return launch<3>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
