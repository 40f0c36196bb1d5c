// ConvNeXt's eval LayerNorm over the channel axis, for Hopper (sm_90a):
//
//   y[r, :] = (s - mean(s)) * rsqrt(var(s) + eps) * weight + bias,
//   s = x[r, :] + pre_bias
//
// over rows of C float32 values stored contiguously (an NHWC activation's
// channel axis), mean and variance over the row's C values. pre_bias, the
// preceding convolution's bias, is optional; the sum x + pre_bias is rounded
// to float32 once, as it is when cuDNN's convolution output gets its bias
// in a broadcast pass of its own, so the fused bias changes no value.
//
// Replaces no Pallas kernel: the JAX package leaves LayerNorm to XLA, which
// fuses it. It was added because ATen's vectorized_layer_norm_kernel runs
// one thread block a row: at ConvNeXt-T's stage 1 a 2,048-slot dispatch is
// 4.1M rows of 96 channels (384 B), most of each block's threads sit idle,
// and it ran at a fifth of its byte bound on an H100. Plain version:
// sykepic_tpu_torch/ops/layernorm.py::layernorm_plain.
//
// What bounds it: bytes. Each value is read once and written once (8 B a
// value), plus pre_bias (C values, read once a thread); weight and bias are
// read once a thread too. A few float operations a value leave it far below
// the card's float rate, so the design only has to move those bytes at the
// full rate, in one launch a call:
//
// - A row lives in registers. A group of `lanes` neighbouring lanes (a
//   power of two, at most a warp) holds one row, K float4 a lane: lane j of
//   the group holds float4 j, j + lanes, j + 2 lanes, ..., so a warp's loads
//   and stores are 16 B a lane on neighbouring addresses. At C = 96 eight
//   lanes hold a row (3 float4 each) and a warp four rows; at C = 768 a
//   warp holds one row, 6 float4 a lane. The wrapper's plan
//   (ops/layernorm.py::plan) picks the fewest lanes that leave a lane at
//   most four float4; C may be any multiple of 4 up to 1536 (32 lanes x 12).
// - Mean and variance in two passes over the registers, never over memory:
//   each is an xor-shuffle sum within the group. The variance is the mean
//   of the squared deviations, not E[s^2] - mean^2.
// - weight, bias and pre_bias go into registers once a thread (up to 6
//   float4 a lane, which covers ConvNeXt-T; wider rows read them from the
//   cache each row, to keep the registers from spilling), and a persistent
//   grid of as many blocks as stay resident walks the rows with a stride.
//
// Rounding: built with -fmad=false; the kernel sums in another order than
// the plain version and rsqrtf is within 2 ulp, so the two agree to float32
// rounding, not bit for bit.
//
// Interface: one plain C function (loaded with ctypes) that launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <vector>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVecs = 12;  // float4 a lane: C <= 32 * 12 * 4 = 1536
constexpr int kHeldVecs = 6;  // up to this many, weight/bias/pre_bias are
                              // held in registers

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Sum over the `lanes` neighbouring lanes of a group (a power of two); every
// lane of the warp takes part.
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

template <int K, bool kPre>
__global__ void __launch_bounds__(kThreads)
layernorm_rows_kernel(const float4* __restrict__ x,
                      const float4* __restrict__ pre_bias,
                      const float4* __restrict__ weight,
                      const float4* __restrict__ bias,
                      float4* __restrict__ y, long long rows, int vecs,
                      int lanes, float eps) {
  constexpr bool kHeld = K <= kHeldVecs;
  constexpr int kH = kHeld ? K : 1;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);  // the lane's place in its row's group
  const int per_warp = 32 / lanes;     // rows a warp holds
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  const float c = static_cast<float>(vecs * 4);

  float4 w[kH], b[kH], pb[kH];
  if constexpr (kHeld) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = sub + k * lanes;
      const bool in = j < vecs;
      w[k] = in ? weight[j] : zero;
      b[k] = in ? bias[j] : zero;
      pb[k] = (kPre && in) ? pre_bias[j] : zero;
    }
  }

  // the loop's bound is the same for every lane of a warp, so the shuffles
  // always see the whole warp; a row past the end computes on zeros and
  // stores nothing
  for (long long row0 = warp * per_warp; row0 < rows;
       row0 += warps * per_warp) {
    const long long row = row0 + lane / lanes;
    const bool live = row < rows;
    const float4* xr = x + row * vecs;
    float4 v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = sub + k * lanes;
      v[k] = (live && j < vecs) ? xr[j] : zero;
    }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = sub + k * lanes;
      if (j < vecs) {
        if constexpr (kPre) {
          if constexpr (kHeld) {
            v[k] = add4(v[k], pb[k]);
          } else {
            v[k] = add4(v[k], pre_bias[j]);
          }
        }
        s += v[k].x + v[k].y + v[k].z + v[k].w;
      }
    }
    const float mean = group_sum(s, lanes) / c;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (sub + k * lanes < vecs) {
        const float dx = v[k].x - mean, dy = v[k].y - mean;
        const float dz = v[k].z - mean, dw = v[k].w - mean;
        q += dx * dx + dy * dy + dz * dz + dw * dw;
      }
    }
    const float rstd = rsqrtf(group_sum(q, lanes) / c + eps);
    if (!live) continue;
    float4* yr = y + row * vecs;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = sub + k * lanes;
      if (j < vecs) {
        float4 wk, bk;
        if constexpr (kHeld) {
          wk = w[k];
          bk = b[k];
        } else {
          wk = weight[j];
          bk = bias[j];
        }
        float4 o;
        o.x = (v[k].x - mean) * rstd * wk.x + bk.x;
        o.y = (v[k].y - mean) * rstd * wk.y + bk.y;
        o.z = (v[k].z - mean) * rstd * wk.z + bk.z;
        o.w = (v[k].w - mean) * rstd * wk.w + bk.w;
        yr[j] = o;
      }
    }
  }
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
cudaError_t resident_blocks(Kernel kernel, int* blocks) {
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
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, 0)) != cudaSuccess) {
    return err;
  }
  *blocks = (per_sm > 1 ? per_sm : 1) * sms;
  resident_cache.push_back({key, dev, *blocks});
  return cudaSuccess;
}

struct Args {
  const float4* x;
  const float4* pre_bias;
  const float4* weight;
  const float4* bias;
  float4* y;
  long long rows;
  int vecs;
  int lanes;
  float eps;
};

template <int K, bool kPre>
int launch(const Args& a, cudaStream_t stream) {
  auto* kernel = layernorm_rows_kernel<K, kPre>;
  int resident = 0;
  const cudaError_t err = resident_blocks(kernel, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_block = (kThreads / 32) * (32 / a.lanes);
  const long long needed = (a.rows + per_block - 1) / per_block;
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  kernel<<<grid, kThreads, 0, stream>>>(a.x, a.pre_bias, a.weight, a.bias,
                                        a.y, a.rows, a.vecs, a.lanes, a.eps);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPre>
int launch_vecs(int per_lane, const Args& a, cudaStream_t s) {
  switch (per_lane) {
    case 1: return launch<1, kPre>(a, s);
    case 2: return launch<2, kPre>(a, s);
    case 3: return launch<3, kPre>(a, s);
    case 4: return launch<4, kPre>(a, s);
    case 5: return launch<5, kPre>(a, s);
    case 6: return launch<6, kPre>(a, s);
    case 7: return launch<7, kPre>(a, s);
    case 8: return launch<8, kPre>(a, s);
    case 9: return launch<9, kPre>(a, s);
    case 10: return launch<10, kPre>(a, s);
    case 11: return launch<11, kPre>(a, s);
    case 12: return launch<12, kPre>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// x, y: float32 (rows, channels), contiguous; weight, bias and pre_bias
// (null: none): float32 (channels,). lanes (1, 2, ..., 32) and per_lane
// (1..12) are the wrapper's plan: lanes * per_lane float4 cover a row.
int layernorm_launch(const void* x, const void* pre_bias, const void* weight,
                     const void* bias, void* y, long long rows, int channels,
                     int lanes, int per_lane, float eps, void* stream) {
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const bool lanes_ok = lanes > 0 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (rows < 0 || channels <= 0 || channels % 4 != 0 || !lanes_ok ||
      per_lane < 1 || per_lane > kMaxVecs ||
      lanes * per_lane * 4 < channels || !aligned16(x) || !aligned16(y) ||
      !aligned16(weight) || !aligned16(bias) ||
      (pre_bias != nullptr && !aligned16(pre_bias))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float4*>(x),
               static_cast<const float4*>(pre_bias),
               static_cast<const float4*>(weight),
               static_cast<const float4*>(bias),
               static_cast<float4*>(y),
               rows,
               channels / 4,
               lanes,
               eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pre_bias != nullptr ? launch_vecs<true>(per_lane, a, s)
                             : launch_vecs<false>(per_lane, a, s);
}

}  // extern "C"
