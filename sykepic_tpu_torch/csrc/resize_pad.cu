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
// (180*180*3 = 97,200: 389 KB in f32, 194 KB in bf16) from at most its
// ROI's uint8 bytes and 40 B of metadata (56 B in the train form), at a few
// float operations a pixel, far below the card's float rate. What keeps a
// plain thread-a-pixel kernel from that bound is the work around each byte:
// a narrow store per value (three partial-sector stores a pixel), an
// integer division, a reload of both axes' taps and a true division a
// pixel leave it as slow in bf16 as in f32, at a third of the bf16 byte
// bound. So this design spends as few instructions and store transactions
// on an output byte as it can:
//
// - Staged tiles, stored whole. A block walks a contiguous run of (slot,
//   tile) items; a tile is `tile_rows` consecutive output rows of one slot,
//   one contiguous span of the NHWC output. Its threads write every value,
//   channel copies included, into a shared staging buffer in output byte
//   order; then one thread hands the span to the TMA unit as a 1-D bulk
//   store (cp.async.bulk.global.shared::cta after fence.proxy.async), so
//   each output byte is written once, in full lines, whatever the dtype and
//   C. Two staging buffers alternate: tile k+1 is computed while tile k's
//   store drains. A bulk store needs 16-byte-aligned addresses and a size
//   that is a multiple of 16; where the output breaks that (an `out=` slice
//   at an odd offset, an odd T_w*C), the plan picks the vector path of the
//   same kernel: the tile is staged at the global address's offset mod 16
//   and all threads copy it out with 16-byte stores, scalar ones only at
//   the span's two ends.
// - Four pixels a thread. A thread makes kG = 4 adjacent columns of every
//   `lanes`-th row of a tile, so its pixels share one read of the row's
//   taps and leave as three 16-byte (f32) or 8-byte (bf16) shared stores
//   where C is 3. Threads are mapped to (lane, column group) once; no thread
//   divides to find its pixel.
// - Taps once a slot. When a block reaches a slot it computes the taps of
//   all the slot's columns and rows into shared memory, once.
// - The tail at compile time, and a level table. Each form (a division, or
//   with normalisation, or brightness with or without it) is its own
//   instance, so a pixel branches on none of them. With brightness the value
//   after the floor is an integer level 0..255, so the rest of its chain
//   (/divisor, and (x - mean[c]) / std[c]) is a 256 x C table the block
//   builds once with the same intrinsics in the same order; a pixel reads
//   one entry instead of paying 1 + C true divisions. Without brightness
//   the value is fractional, and each pixel keeps its true division.
//
// The TPU kernel's banded matrices (A_h @ img @ A_w^T on the MXU) do not
// pay here: a two-tap gather needs no tensor cores. Times against the byte
// bound are in PERF.md.
//
// Rounding: every float step uses the explicit round-to-nearest intrinsics
// (no FMA contraction; the file is also built with -fmad=false) so that the
// source coordinate, and hence which tap is chosen at exact boundaries,
// matches the plain version and the JAX kernel bit for bit. q = a*i + b is
// a multiply then an add. The coordinate divides first (src / n_new), then
// multiplies; the result divides by `divisor`, never multiplies by its
// reciprocal. Without an affine, q is the iota and the eval form's
// arithmetic is unchanged.
//
// Interface: a plain C function (loaded with ctypes). It launches on the
// given stream, allocates nothing, and returns cudaGetLastError(). The
// launch plan (tile rows, lanes, threads, store path, shared bytes) comes
// from sykepic_tpu_torch/ops/resize_pad.py::plan; the function checks it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int kMetaRows = 10;   // win, y0, x0, h, w, new_h, new_w, pt, pl, border
constexpr int kMaxNormChans = 8;
constexpr int kLevels = 256;    // brightness levels after the floor
constexpr int kMaxThreads = 256;
constexpr int kG = 4;           // adjacent output columns a thread makes
constexpr int kStoreBulk = 0;   // TMA 1-D bulk store of each staged tile
constexpr int kStoreVector = 1; // 16-byte stores, scalar at the span's ends

// What follows the blend: a true division by `divisor` (then, with
// normalisation, (x - mean[c]) / std[c] per channel), or, with brightness,
// the level's entry of the table (C entries a level with normalisation).
enum Tail { kDivide = 0, kDivideNorm = 1, kTable = 2, kTableNorm = 3 };

// One output row or column: the two source taps as offsets into the
// slot's pixel plane (a row's offsets are premultiplied by the plane's
// width), always inside it, and their weights. w0 lies in (0, 1]; the taps
// of a coordinate outside [pad, pad + new) carry -w0 instead: the border.
struct __align__(16) Taps {
  uint32_t off0;
  uint32_t off1;
  float w0;
  float w1;
};

struct Params {
  const uint8_t* pix;
  int n_win, win_h, win_w;
  const int32_t* meta;
  int n_slots;
  int target_h, target_w, num_chans;
  float divisor;
  const float* affine;  // (4, n_slots) a_y, b_y, a_x, b_x, or null
  const float* bright;  // (n_slots,), or null
  const float* mean;    // (num_chans,), or null (then stdev too)
  const float* stdev;
  unsigned char* out;
  int tile_rows;
  int lanes;            // threads a column group; lane l takes rows
                        // l, l + lanes, ... of a tile
  int tiles_per_slot;
  int store;            // kStoreBulk or kStoreVector
  int stage_bytes;      // one staging buffer, a multiple of 16
};

// One axis: output coordinate q (the iota, or a*i + b in the train form)
// -> two source taps inside the ROI's own extent [0, src) placed at
// `origin` in a plane of `limit` entries along this axis, times `scale`.
__device__ __forceinline__ Taps axis_taps(float q, int pad, int n_new,
                                          float ratio, int src, int origin,
                                          int limit, int scale) {
  const float srcf = static_cast<float>(src);
  const float padf = static_cast<float>(pad);
  float f = __fadd_rn(
      __fmul_rn(__fadd_rn(__fsub_rn(q, padf), 0.5f), ratio), -0.5f);
  f = fminf(fmaxf(f, 0.0f), __fsub_rn(srcf, 1.0f));
  const float t0 = floorf(f);
  const float t1 = __fadd_rn(t0, 1.0f);
  Taps t;
  const int i0 = static_cast<int>(t0);
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
  t.off0 = static_cast<uint32_t>(min(max(origin + i0, 0), limit - 1) * scale);
  t.off1 = static_cast<uint32_t>(min(max(origin + i1, 0), limit - 1) * scale);
  if (!(q >= padf && q < __fadd_rn(padf, static_cast<float>(n_new)))) {
    t.w0 = -t.w0;
  }
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

// An output value's bits: float32, or bfloat16 rounded to nearest even
template <typename OutT> struct Out;
template <> struct Out<float> {
  using Bits = uint32_t;
  static __device__ __forceinline__ Bits bits(float v) {
    return __float_as_uint(v);
  }
};
template <> struct Out<__nv_bfloat16> {
  using Bits = uint16_t;
  static __device__ __forceinline__ Bits bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// kN values of a thread's kG pixels, as the words a vector store takes
template <typename Bits, int kN>
union Pack {
  Bits e[kN];
  uint2 d[(kN * sizeof(Bits) + 7) / 8];
  uint4 q[(kN * sizeof(Bits) + 15) / 16];
};

// A source byte b as a float, exactly: the bits of 2^23 + b, less 2^23. An
// add and a logic op in place of a conversion, whose pipe runs at a
// quarter of the float rate.
__device__ __forceinline__ float byte_f(const uint8_t* p) {
  return __fsub_rn(__uint_as_float(0x4B000000u | __ldg(p)), 8388608.0f);
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16) of shared memory at `src` to global `dst`
// (both 16-byte aligned) by the TMA unit, as one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(src));
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(s), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most one bulk group is still reading its shared source
__device__ __forceinline__ void bulk_wait_read_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The vector store path: `n` staged bytes at `s` to `g`, where
// s == g (mod 16). Scalar elements up to g's first 16-byte boundary and
// after its last, 16-byte stores between.
template <typename Bits>
__device__ __forceinline__ void vector_copy(unsigned char* g,
                                            const unsigned char* s, int n,
                                            int tid, int nthr) {
  constexpr int kE = sizeof(Bits);
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
  const int head = min(n, (16 - mis) & 15);
  const int body_end = head + ((n - head) & ~15);
  for (int i = tid * kE; i < head; i += nthr * kE) {
    *reinterpret_cast<Bits*>(g + i) = *reinterpret_cast<const Bits*>(s + i);
  }
  for (int i = head + tid * 16; i < body_end; i += nthr * 16) {
    *reinterpret_cast<uint4*>(g + i) =
        *reinterpret_cast<const uint4*>(s + i);
  }
  for (int i = body_end + tid * kE; i < n; i += nthr * kE) {
    *reinterpret_cast<Bits*>(g + i) = *reinterpret_cast<const Bits*>(s + i);
  }
}

// kC: the channel count when it is 1 or 3 (the main paths), 0 for any
// other count read from the parameters. kTail: Tail.
template <typename OutT, int kC, int kTail>
__global__ void __launch_bounds__(kMaxThreads)
resize_pad_kernel(const Params p) {
  using Bits = typename Out<OutT>::Bits;
  constexpr bool kNorm = kTail == kDivideNorm || kTail == kTableNorm;
  constexpr bool kLevelTable = kTail == kTable || kTail == kTableNorm;
  // a thread's kG pixels in bytes when kC is known, and the vector store
  // that takes them: 48 and 24 bytes (C = 3) in 16- and 8-byte words, 16
  // and 8 (C = 1) in one
  constexpr int kGroupBytes = kC * kG * static_cast<int>(sizeof(Bits));
  constexpr int kChunk = kGroupBytes % 16 == 0 ? 16 : 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = kC > 0 ? kC : p.num_chans;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int T_w = p.target_w;
  const int T_h = p.target_h;
  const int R = p.tile_rows;
  const int ngroups = (T_w + kG - 1) / kG;
  Taps* col = reinterpret_cast<Taps*>(smem + 2 * p.stage_bytes);
  Taps* rowt = col + ngroups * kG;                   // [T_h]
  float* norm_mean = reinterpret_cast<float*>(rowt + T_h);
  float* norm_std = norm_mean + kMaxNormChans;
  Bits* table = reinterpret_cast<Bits*>(norm_std + kMaxNormChans);

  if (kNorm) {
    for (int c = tid; c < C; c += nthr) {
      norm_mean[c] = p.mean[c];
      norm_std[c] = p.stdev[c];
    }
  }
  if (kLevelTable) {
    // the chain after the floor, for each level, as the pixels would run it
    const int per = kNorm ? C : 1;
    for (int e = tid; e < kLevels * per; e += nthr) {
      const int level = e / per;
      const int c = e - level * per;
      float x = __fdiv_rn(static_cast<float>(level), p.divisor);
      if (kNorm) x = __fdiv_rn(__fsub_rn(x, p.mean[c]), p.stdev[c]);
      table[e] = Out<OutT>::bits(x);
    }
  }

  // this block's contiguous run of (slot, tile) items
  const long long total =
      static_cast<long long>(p.n_slots) * p.tiles_per_slot;
  const long long per = total / gridDim.x;
  const long long extra = total - per * gridDim.x;
  const long long b = blockIdx.x;
  const long long begin = b * per + min(b, extra);
  const long long end = begin + per + (b < extra ? 1 : 0);
  int slot = static_cast<int>(begin / p.tiles_per_slot);
  int tile = static_cast<int>(begin - static_cast<long long>(slot) *
                                          p.tiles_per_slot);
  // threads across a row's column groups, and this thread's place
  const int lanes = p.lanes;
  const int gt = nthr / lanes;
  const int lane = tid / gt;
  const int gi = tid - lane * gt;
  const int row_elems = T_w * C;
  const int row_bytes = row_elems * static_cast<int>(sizeof(Bits));

  // the current slot's state
  const uint8_t* src = nullptr;
  float border = 0.0f, border_out = 0.0f, br = 1.0f;
  bool fresh = true;
  int done = 0;
  for (long long k = begin; k < end; ++k) {
    if (fresh) {
      int m[kMetaRows];
#pragma unroll
      for (int i = 0; i < kMetaRows; ++i) m[i] = p.meta[i * p.n_slots + slot];
      const int win = min(max(m[0], 0), p.n_win - 1);
      border = static_cast<float>(m[9]);
      border_out = __fdiv_rn(border, p.divisor);
      const float ratio_y =
          __fdiv_rn(static_cast<float>(m[3]), static_cast<float>(m[5]));
      const float ratio_x =
          __fdiv_rn(static_cast<float>(m[4]), static_cast<float>(m[6]));
      br = kLevelTable ? p.bright[slot] : 1.0f;
      src = p.pix + static_cast<size_t>(win) * p.win_h * p.win_w;
      // the slot's taps, once: every column (a group's columns past T_w
      // repeat the last) and every row; read after the barrier below
      for (int j = tid; j < ngroups * kG; j += nthr) {
        col[j] = axis_taps(coord(min(j, T_w - 1), p.affine, p.n_slots, slot,
                                 2),
                           m[8], m[6], ratio_x, m[4], m[2], p.win_w, 1);
      }
      for (int i = tid; i < T_h; i += nthr) {
        rowt[i] = axis_taps(coord(i, p.affine, p.n_slots, slot, 0), m[7],
                            m[5], ratio_y, m[3], m[1], p.win_h, p.win_w);
      }
      fresh = false;
    }
    const int row0 = tile * R;
    const int rows = min(R, T_h - row0);
    const int nbytes = rows * row_bytes;
    unsigned char* gdst = p.out + (static_cast<size_t>(slot) * T_h + row0) *
                                      static_cast<size_t>(row_bytes);
    unsigned char* stage = smem + (done & 1) * p.stage_bytes;
    int mis = 0;
    if (p.store == kStoreBulk) {
      // the store that read this buffer two tiles ago must have finished
      if (tid == 0 && done >= 2) bulk_wait_read_one();
    } else {
      mis = static_cast<int>(reinterpret_cast<uintptr_t>(gdst) & 15);
      stage += mis;
    }
    __syncthreads();

    const bool vec = kC > 0 && (row_bytes % kChunk | mis % kChunk) == 0;
    Bits* st = reinterpret_cast<Bits*>(stage);
    for (int g = gi; g < ngroups; g += gt) {
      const int j0 = g * kG;
      const int nvalid = min(kG, T_w - j0);
      Taps tx[kG];
#pragma unroll
      for (int q = 0; q < kG; ++q) tx[q] = col[j0 + q];
      Bits* o = st + (lane * T_w + j0) * C;
      for (int r = lane; r < rows; r += lanes, o += lanes * row_elems) {
        const Taps ty = rowt[row0 + r];
        float v[kG];
        bool in[kG];
        if (ty.w0 > 0.0f) {
          const uint8_t* r0 = src + ty.off0;
          const uint8_t* r1 = src + ty.off1;
#pragma unroll
          for (int q = 0; q < kG; ++q) {
            const float p00 = byte_f(r0 + tx[q].off0);
            const float p01 = byte_f(r0 + tx[q].off1);
            const float p10 = byte_f(r1 + tx[q].off0);
            const float p11 = byte_f(r1 + tx[q].off1);
            // vertical blend at both source columns, then horizontal (the
            // order of the einsum's contractions, repeated by the plain
            // version)
            const float left =
                __fadd_rn(__fmul_rn(ty.w0, p00), __fmul_rn(ty.w1, p10));
            const float right =
                __fadd_rn(__fmul_rn(ty.w0, p01), __fmul_rn(ty.w1, p11));
            in[q] = tx[q].w0 > 0.0f;
            v[q] = in[q] ? __fadd_rn(__fmul_rn(tx[q].w0, left),
                                     __fmul_rn(tx[q].w1, right))
                         : border;
          }
        } else {
#pragma unroll
          for (int q = 0; q < kG; ++q) {
            in[q] = false;
            v[q] = border;
          }
        }
        // the tail: per pixel, its C output values
        int lv[kG];
        float x[kG];
#pragma unroll
        for (int q = 0; q < kG; ++q) {
          if (kLevelTable) {
            // brightness, clip and the uint8-cast truncation
            // (augment.py:211-214): a level of the table
            lv[q] = static_cast<int>(
                floorf(fminf(fmaxf(__fmul_rn(v[q], br), 0.0f), 255.0f)));
          } else {
            x[q] = in[q] ? __fdiv_rn(v[q], p.divisor) : border_out;
          }
        }
        auto value = [&](int q, int c) -> Bits {
          if (kTail == kTable) return table[lv[q]];
          if (kTail == kTableNorm) return table[lv[q] * C + c];
          if (kTail == kDivideNorm) {
            return Out<OutT>::bits(
                __fdiv_rn(__fsub_rn(x[q], norm_mean[c]), norm_std[c]));
          }
          return Out<OutT>::bits(x[q]);
        };
        if (kC > 0) {
          constexpr int kN = kG * (kC > 0 ? kC : 1);
          Pack<Bits, kN> pk;
#pragma unroll
          for (int q = 0; q < kG; ++q) {
            if (kNorm) {
#pragma unroll
              for (int c = 0; c < kC; ++c) pk.e[q * kC + c] = value(q, c);
            } else {
              const Bits y = value(q, 0);
#pragma unroll
              for (int c = 0; c < kC; ++c) pk.e[q * kC + c] = y;
            }
          }
          if (vec && nvalid == kG) {
            if (kChunk == 16) {
#pragma unroll
              for (int i = 0; i < kGroupBytes / 16; ++i) {
                reinterpret_cast<uint4*>(o)[i] = pk.q[i];
              }
            } else {
#pragma unroll
              for (int i = 0; i < kGroupBytes / 8; ++i) {
                reinterpret_cast<uint2*>(o)[i] = pk.d[i];
              }
            }
          } else {
#pragma unroll
            for (int q = 0; q < kG; ++q) {
              if (q < nvalid) {
#pragma unroll
                for (int c = 0; c < kC; ++c) o[q * kC + c] = pk.e[q * kC + c];
              }
            }
          }
        } else {
          for (int q = 0; q < nvalid; ++q) {
            if (kNorm) {
              for (int c = 0; c < C; ++c) o[q * C + c] = value(q, c);
            } else {
              const Bits y = value(q, 0);
              for (int c = 0; c < C; ++c) o[q * C + c] = y;
            }
          }
        }
      }
    }
    if (p.store == kStoreBulk) {
      fence_async_shared();
      __syncthreads();
      if (tid == 0) bulk_store(gdst, stage, nbytes);
    } else {
      __syncthreads();
      vector_copy<Bits>(gdst, stage, nbytes, tid, nthr);
    }
    ++done;
    if (++tile == p.tiles_per_slot) {
      tile = 0;
      ++slot;
      fresh = true;
    }
  }
  if (p.store == kStoreBulk && tid == 0) bulk_wait_all();
}

// Shared bytes of a plan: two staging buffers, the column and row taps,
// mean/std, and the level table. Mirrors ops/resize_pad.py::plan.
size_t smem_bytes(int stage_bytes, int target_h, int target_w,
                  int table_entries, int elem) {
  const size_t cols = static_cast<size_t>((target_w + kG - 1) / kG) * kG;
  return 2 * static_cast<size_t>(stage_bytes) +
         sizeof(Taps) * (cols + target_h) +
         2 * kMaxNormChans * sizeof(float) +
         static_cast<size_t>(table_entries) * elem;
}

// Blocks of one kernel instance that stay resident on the whole card at
// (threads, smem), worked out once a device and kept, so a launch pays no
// occupancy query; the instance's dynamic shared-memory ceiling is raised
// the first time a plan needs more than it allows.
struct Resident {
  const void* kernel;
  int dev;
  int threads;
  size_t smem;
  int blocks;
};
std::mutex resident_mu;
std::vector<Resident> resident_cache;

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem,
                            int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(resident_mu);
  size_t ceiling = 0;
  for (const Resident& r : resident_cache) {
    if (r.kernel != key || r.dev != dev) continue;
    if (r.threads == threads && r.smem == smem) {
      *blocks = r.blocks;
      return cudaSuccess;
    }
    if (r.smem > ceiling) ceiling = r.smem;
  }
  if (smem > ceiling &&
      (err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(smem))) != cudaSuccess) {
    return err;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess) {
    return err;
  }
  *blocks = max(per_sm, 1) * sms;
  resident_cache.push_back({key, dev, threads, smem, *blocks});
  return cudaSuccess;
}

template <typename OutT, int kC, int kTail>
int launch(const Params& p, int threads, size_t smem, cudaStream_t stream) {
  auto* kernel = resize_pad_kernel<OutT, kC, kTail>;
  int resident = 0;
  const cudaError_t err = resident_blocks(kernel, threads, smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many blocks as stay resident, each walking a run of tiles
  const long long tiles =
      static_cast<long long>(p.n_slots) * p.tiles_per_slot;
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT, int kTail>
int launch_chans(const Params& p, int threads, size_t smem,
                 cudaStream_t stream) {
  if (p.num_chans == 3) {
    return launch<OutT, 3, kTail>(p, threads, smem, stream);
  }
  if (p.num_chans == 1) {
    return launch<OutT, 1, kTail>(p, threads, smem, stream);
  }
  return launch<OutT, 0, kTail>(p, threads, smem, stream);
}

template <typename OutT>
int launch_tail(const Params& p, int threads, size_t smem,
                cudaStream_t stream) {
  const bool norm = p.mean != nullptr;
  if (p.bright != nullptr) {
    return norm ? launch_chans<OutT, kTableNorm>(p, threads, smem, stream)
                : launch_chans<OutT, kTable>(p, threads, smem, stream);
  }
  return norm ? launch_chans<OutT, kDivideNorm>(p, threads, smem, stream)
              : launch_chans<OutT, kDivide>(p, threads, smem, stream);
}

}  // namespace

extern "C" {

// pix: uint8 (n_win, win_h, win_w); meta: int32 (10, n_slots);
// out: (n_slots, target_h, target_w, num_chans) float32 (out_bf16 == 0) or
// bfloat16 (out_bf16 == 1), each value divided by `divisor` (255, or 1 for
// the 0-255 scale). The train form's inputs may each be null:
// affine float32 (4, n_slots) = (a_y, b_y, a_x, b_x); bright float32
// (n_slots,); mean and stdev float32 (num_chans,), num_chans <= 8, both or
// neither. The plan, as ops/resize_pad.py::plan gives it: tile_rows output
// rows a tile; lanes threads a group of kG columns; threads a block
// (lanes x the threads across the column groups); store 0 (bulk) or 1
// (vector); stage_bytes a staging buffer and smem_bytes in all. Returns
// cudaErrorInvalidValue for a plan that does not fit the call, else
// cudaGetLastError() after the launch.
int resize_pad_launch(const void* pix, int n_win, int win_h, int win_w,
                      const void* meta, int n_slots, int target_h,
                      int target_w, int num_chans, int out_bf16,
                      float divisor, const void* affine, const void* bright,
                      const void* mean, const void* stdev, void* out,
                      int tile_rows, int lanes, int threads, int store,
                      int stage_bytes, int smem, void* stream) {
  if (n_slots == 0) return static_cast<int>(cudaSuccess);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (mean != nullptr && (stdev == nullptr || num_chans > kMaxNormChans)) {
    return invalid;
  }
  const int elem = out_bf16 ? 2 : 4;
  const long long row_bytes =
      static_cast<long long>(target_w) * num_chans * elem;
  const long long tile_bytes = row_bytes * tile_rows;
  if (tile_rows < 1 || lanes < 1 || threads < 1 || threads > kMaxThreads ||
      threads % lanes != 0 || stage_bytes % 16 != 0 ||
      (store != kStoreBulk && store != kStoreVector)) {
    return invalid;
  }
  if (store == kStoreBulk) {
    // every tile's span must start on 16 bytes and hold a multiple of 16
    if (stage_bytes != tile_bytes || tile_bytes % 16 != 0 ||
        (row_bytes * target_h) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0) {
      return invalid;
    }
  } else if (stage_bytes < tile_bytes + 16) {
    return invalid;
  }
  const int table = bright == nullptr
                        ? 0
                        : kLevels * (mean != nullptr ? num_chans : 1);
  const size_t need =
      smem_bytes(stage_bytes, target_h, target_w, table, elem);
  if (need != static_cast<size_t>(smem)) return invalid;

  Params p;
  p.pix = static_cast<const uint8_t*>(pix);
  p.n_win = n_win;
  p.win_h = win_h;
  p.win_w = win_w;
  p.meta = static_cast<const int32_t*>(meta);
  p.n_slots = n_slots;
  p.target_h = target_h;
  p.target_w = target_w;
  p.num_chans = num_chans;
  p.divisor = divisor;
  p.affine = static_cast<const float*>(affine);
  p.bright = static_cast<const float*>(bright);
  p.mean = static_cast<const float*>(mean);
  p.stdev = static_cast<const float*>(stdev);
  p.out = static_cast<unsigned char*>(out);
  p.tile_rows = tile_rows;
  p.lanes = lanes;
  p.tiles_per_slot = (target_h + tile_rows - 1) / tile_rows;
  p.store = store;
  p.stage_bytes = stage_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) return launch_tail<__nv_bfloat16>(p, threads, need, s);
  return launch_tail<float>(p, threads, need, s);
}

}  // extern "C"
