// K1, the resize/pad kernel for Hopper (sm_90a), in two forms.
//
// Eval form: per-slot bilinear resize of a uint8 ROI, pad to the square
// target with the slot's border value, /255, replication to the channel
// count and an NHWC store (f32 or bf16). With `divisor` 1 instead of 255 it
// keeps the 0-255 scale (exactly: a division by 1 is exact), which the
// train step's rotation route warps and floors before it divides.
//
// Train form (any of `affine`, `bright`, `mean`/`std` given): the same, with
// the training augmentations folded in as the JAX train step folds them
// (sykepic_tpu/train/trainer.py:171-207): the sampling coordinate of output
// row or column i is q = a*i + b per axis (flip, translate and zoom, from
// sykepic_tpu/ops/augment.py::separable_params) instead of the iota; the
// "inside" mask compares that float q with pad and pad + new; then
// floor(min(max(v * bright, 0), 255)), the division by 255 and
// (x - mean[c]) / std[c] per channel. The train step passes the row of a
// device-resident store as the slot's window index, so each image is read
// in place, without a gather of pixels.
//
// Replaces the TPU kernel sykepic_tpu/ops/pallas_preprocess.py::
// resize_pad_batch_pallas (and, on the shelf path and in the train step,
// the einsum resize_pad_batch_mxu that took its place there because the
// Pallas kernel had no origins and no affine). Plain version:
// sykepic_tpu_torch/ops/preprocess.py::resize_pad_plain, which repeats this
// arithmetic step by step.
//
// What bounds it: the bytes it writes. Each slot stores T_h*T_w*C values
// (180*180*3*4 B = 389 KB in f32) and reads at most its ROI's uint8 bytes
// plus 40 B of metadata (56 B in the train form), at two FLOPs per tap --
// far below the card's compute rate. The design follows: one block per
// (slot, tile of output rows); the block computes the per-row and
// per-column taps and inside flags once into shared memory; each thread
// then makes one output pixel from four uint8 loads and writes its C
// values. The TPU kernel's banded matrices (A_h @ img @ A_w^T on the MXU)
// do not pay here: a two-tap gather needs no tensor cores, so wgmma and TMA
// do not apply. A simple, right kernel first; its time against the byte
// bound is in PERF.md.
//
// Rounding: every float step uses the explicit round-to-nearest intrinsics
// (no FMA contraction; the file is also built with -fmad=false) so that the
// source coordinate, and hence which tap is chosen at exact boundaries,
// matches the twin and the JAX kernel bit for bit. q = a*i + b is a multiply
// then an add. The coordinate divides first (src / n_new), then multiplies;
// the result divides by `divisor`, never multiplies by its reciprocal. Without an
// affine, q is the iota and the eval form's arithmetic is unchanged.
//
// Interface: a plain C function (loaded with ctypes). It launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMetaRows = 10;   // win, y0, x0, h, w, new_h, new_w, pt, pl, border
constexpr int kAffineRows = 4;  // a_y, b_y, a_x, b_x
constexpr int kMaxNormChans = 8;
constexpr int kRowsPerBlock = 16;
constexpr int kThreads = 256;

struct Taps {
  int i0;     // absolute source index of the first tap
  int i1;     // absolute source index of the second tap
  float w0;
  float w1;
  int inside; // q lies in [pad, pad + new)
};

// One axis: output coordinate q (the iota, or a*i + b in the train form)
// -> two source taps inside the ROI's own extent [0, src) placed at
// `origin` in a pixel plane of `limit` entries, and the inside flag.
__device__ __forceinline__ Taps axis_taps(float q, int pad, int n_new,
                                          float ratio, int src, int origin,
                                          int limit) {
  const float srcf = static_cast<float>(src);
  const float padf = static_cast<float>(pad);
  float f = __fadd_rn(
      __fmul_rn(__fadd_rn(__fsub_rn(q, padf), 0.5f), ratio), -0.5f);
  f = fminf(fmaxf(f, 0.0f), __fsub_rn(srcf, 1.0f));
  const float t0 = floorf(f);
  const float t1 = __fadd_rn(t0, 1.0f);
  Taps t;
  int i0 = static_cast<int>(t0);
  int i1;
  t.w0 = __fsub_rn(1.0f, __fsub_rn(f, t0));
  if (t1 < srcf) {
    i1 = i0 + 1;
    t.w1 = __fsub_rn(1.0f, __fsub_rn(t1, f));
  } else {
    i1 = src - 1;
    t.w1 = 0.0f;
  }
  // metadata that points outside the plane is clamped, never read past it
  t.i0 = min(max(origin + i0, 0), limit - 1);
  t.i1 = min(max(origin + i1, 0), limit - 1);
  t.inside = q >= padf && q < __fadd_rn(padf, static_cast<float>(n_new));
  return t;
}

// Output coordinate i of one axis: the iota, or a*i + b (a multiply, then
// an add: never an FMA) when the train form folds an affine in.
__device__ __forceinline__ float coord(int i, const float* aff, int n_slots,
                                       int slot, int row) {
  const float q = static_cast<float>(i);
  if (aff == nullptr) return q;
  return __fadd_rn(__fmul_rn(aff[row * n_slots + slot], q),
                   aff[(row + 1) * n_slots + slot]);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
resize_pad_kernel(const uint8_t* __restrict__ pix, int n_win, int win_h,
                  int win_w, const int32_t* __restrict__ meta, int n_slots,
                  int target_h, int target_w, int num_chans, float divisor,
                  const float* __restrict__ affine,
                  const float* __restrict__ bright,
                  const float* __restrict__ mean,
                  const float* __restrict__ stdev,
                  OutT* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  Taps* col = reinterpret_cast<Taps*>(smem_raw);  // [target_w]
  Taps* row = col + target_w;                     // [kRowsPerBlock]
  __shared__ int m[kMetaRows];
  __shared__ float norm_mean[kMaxNormChans];
  __shared__ float norm_std[kMaxNormChans];

  const int slot = blockIdx.x;
  const int row_begin = blockIdx.y * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, target_h - row_begin);
  if (threadIdx.x < kMetaRows) {
    m[threadIdx.x] = meta[threadIdx.x * n_slots + slot];
  }
  if (mean != nullptr && threadIdx.x < num_chans) {
    norm_mean[threadIdx.x] = mean[threadIdx.x];
    norm_std[threadIdx.x] = stdev[threadIdx.x];
  }
  __syncthreads();
  const int win = min(max(m[0], 0), n_win - 1);
  const int y0 = m[1], x0 = m[2], h = m[3], w = m[4];
  const int nh = m[5], nw = m[6], pt = m[7], pl = m[8];
  const float border = static_cast<float>(m[9]);
  const float ratio_y = __fdiv_rn(static_cast<float>(h), static_cast<float>(nh));
  const float ratio_x = __fdiv_rn(static_cast<float>(w), static_cast<float>(nw));
  const float br = bright == nullptr ? 1.0f : bright[slot];

  for (int j = threadIdx.x; j < target_w; j += blockDim.x) {
    col[j] = axis_taps(coord(j, affine, n_slots, slot, 2), pl, nw, ratio_x,
                       w, x0, win_w);
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    row[r] = axis_taps(coord(row_begin + r, affine, n_slots, slot, 0), pt,
                       nh, ratio_y, h, y0, win_h);
  }
  __syncthreads();

  const uint8_t* src = pix + static_cast<size_t>(win) * win_h * win_w;
  OutT* dst = out + (static_cast<size_t>(slot) * target_h + row_begin) *
                        target_w * num_chans;
  const int n_px = rows * target_w;
  for (int p = threadIdx.x; p < n_px; p += blockDim.x) {
    const int r = p / target_w;
    const int j = p - r * target_w;
    const Taps ty = row[r];
    const Taps tx = col[j];
    float v = border;
    if (ty.inside && tx.inside) {
      const uint8_t* r0 = src + static_cast<size_t>(ty.i0) * win_w;
      const uint8_t* r1 = src + static_cast<size_t>(ty.i1) * win_w;
      const float p00 = r0[tx.i0], p01 = r0[tx.i1];
      const float p10 = r1[tx.i0], p11 = r1[tx.i1];
      // vertical blend at both source columns, then horizontal (the
      // order of the einsum's contractions, repeated by the twin)
      const float left = __fadd_rn(__fmul_rn(ty.w0, p00), __fmul_rn(ty.w1, p10));
      const float right = __fadd_rn(__fmul_rn(ty.w0, p01), __fmul_rn(ty.w1, p11));
      v = __fadd_rn(__fmul_rn(tx.w0, left), __fmul_rn(tx.w1, right));
    }
    if (bright != nullptr) {
      // brightness, clip and the uint8-cast truncation (augment.py:211-214)
      v = floorf(fminf(fmaxf(__fmul_rn(v, br), 0.0f), 255.0f));
    }
    v = __fdiv_rn(v, divisor);
    OutT* o = dst + static_cast<size_t>(p) * num_chans;
    if (mean == nullptr) {
      for (int c = 0; c < num_chans; ++c) store(o + c, v);
    } else {
      for (int c = 0; c < num_chans; ++c) {
        store(o + c, __fdiv_rn(__fsub_rn(v, norm_mean[c]), norm_std[c]));
      }
    }
  }
}

}  // namespace

extern "C" {

// pix: uint8 (n_win, win_h, win_w); meta: int32 (10, n_slots);
// out: (n_slots, target_h, target_w, num_chans) float32 (out_bf16 == 0) or
// bfloat16 (out_bf16 == 1), each value divided by `divisor` (255, or 1 for
// the 0-255 scale). The train form's inputs may each be null:
// affine float32 (4, n_slots) = (a_y, b_y, a_x, b_x); bright float32
// (n_slots,); mean and stdev float32 (num_chans,), num_chans <= 8, both or
// neither. Returns cudaGetLastError() after the launch.
int resize_pad_launch(const void* pix, int n_win, int win_h, int win_w,
                      const void* meta, int n_slots, int target_h,
                      int target_w, int num_chans, int out_bf16,
                      float divisor, const void* affine, const void* bright,
                      const void* mean, const void* stdev, void* out,
                      void* stream) {
  if (n_slots == 0) return static_cast<int>(cudaSuccess);
  if (mean != nullptr && (stdev == nullptr || num_chans > kMaxNormChans)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_slots, (target_h + kRowsPerBlock - 1) / kRowsPerBlock);
  const size_t smem = sizeof(Taps) * (target_w + kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(pix);
  const int32_t* m = static_cast<const int32_t*>(meta);
  const float* aff = static_cast<const float*>(affine);
  const float* br = static_cast<const float*>(bright);
  const float* mu = static_cast<const float*>(mean);
  const float* sd = static_cast<const float*>(stdev);
  if (out_bf16) {
    resize_pad_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        p, n_win, win_h, win_w, m, n_slots, target_h, target_w, num_chans,
        divisor, aff, br, mu, sd, static_cast<__nv_bfloat16*>(out));
  } else {
    resize_pad_kernel<float><<<grid, kThreads, smem, s>>>(
        p, n_win, win_h, win_w, m, n_slots, target_h, target_w, num_chans,
        divisor, aff, br, mu, sd, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
