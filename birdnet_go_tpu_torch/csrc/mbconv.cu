// Fused stride-1 MBConv for Hopper (sm_90a): kernel A (expand_dw_pool) and
// kernel B (scale_project).
//
// Replaces the TPU kernels expand_dw_pool and scale_project in
// birdnet_go_tpu/ops/pallas_mbconv.py and computes what they compute
// (the plain versions are in birdnet_go_tpu_torch/ops/pallas_mbconv.py):
//
//   A: x [B, S = H·W, C] → h = swish(BN(round(x) @ round(wexp)))   (or x)
//      → acc = Σ_taps h[s + (dy, dx)] · dwk[tap]  (SAME, stride 1)
//      → v = swish(BN(acc)) → y [B, S, Cm] (f32 or bf16), pool [B, Cm] = Σ_s v
//   B: z = round(f32(y) · se[b]) → o = z @ round(wproj) → BN → (+ res)
//      → out [B, S, C'] (f32 or bf16)
//
// round() is the matrix operand's rounding to dot_dtype (bf16 or none);
// products accumulate in float32, and everything between the products
// stays float32, as in the TPU kernels.
//
// What bounds them here. Kernel A does C·Cm + k²·Cm multiply-adds per
// position against about 2·Cm bytes of y written in bf16: 28 per byte at
// v2.4's (40 → 240, k5) block, so the expand blocks are bound by float32
// FMAs and the shared-memory reads that feed them; the expand-less
// (32 → 32, k3) block does 9·32 per 128 bytes and is bound by device memory.
// Kernel B does Cm·C' multiply-adds per 2·Cm + 4·C' bytes, FMA-bound in the
// same way.
//
// The design. The TPU kernel held a whole image in VMEM and rolled it once
// per tap; a whole image of v2.4's first block is 854 KB in float32, and a
// block has at most 227 KB. So kernel A walks the rows of one band of the
// image for one slice of 32 channels (a lane each) and keeps a ring of
// expanded rows in shared memory. Each pass copies up to 4 new input rows
// in 16-byte loads, expands them once (4 positions per thread, so that a
// weight read from shared memory feeds 4 FMAs and a float4 of input 4
// more), and computes up to 4 output rows from their k×k windows in the
// ring. The ring's rows carry zero halo columns and the rows outside the
// image read a zero row, so a tap is one shared-memory read and one FMA,
// without bounds checks. A band re-expands only its k - 1 halo rows, and
// the expanded tensor never goes to device memory. The pool is summed by each block in a fixed
// order and, when an image has several bands, summed over the bands by a
// second kernel, so repeated runs agree bit for bit (no atomics). Kernel B
// is a tiled shared-memory GEMM: 128 threads, each 8 positions × 2 output
// channels, with the SE scale and the bf16 rounding in the tile load (16-byte
// loads of y) and BN and the residual in its epilogue. Both use float32 FMAs
// on operands rounded to bf16; tensor cores (mma/wgmma) and TMA are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 32;                   // A: channels per block, one a lane
constexpr int kGroups = kThreads / kSlice;   // A: position groups
constexpr int kMaxSmem = 232448;
constexpr int kMaxGrid = 65535;
constexpr int kPass = 4;                     // A: rows per pass
constexpr int kPos = 4;                      // A: positions per expand step
constexpr int kUnroll = 2;                   // 16-byte loads in flight a thread
constexpr int kThreadsB = 128;               // B: threads per block
constexpr int kBK = 32;                      // B: Cm per step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float round_dot(float v, int dot_bf16) {
  return dot_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}
// 16 bytes of T from device memory as floats: 4 float or 8 bf16 values.
template <typename T>
constexpr int kVec = 16 / sizeof(T);
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
// n (a multiple of 4) floats to 16-byte-aligned shared memory.
template <int n>
__device__ __forceinline__ void store_smem(float* d, const float* v) {
#pragma unroll
  for (int k = 0; k < n; k += 4)
    *reinterpret_cast<float4*>(d + k) = make_float4(v[k], v[k + 1], v[k + 2],
                                                    v[k + 3]);
}
// s mod n for s in [-n, 2n): the ring slot of a row, without a division.
__device__ __forceinline__ int wrap(int s, int n) {
  return s < 0 ? s + n : (s >= n ? s - n : s);
}
// Moves the position (row r, column w) on by `step` positions, row-major.
__device__ __forceinline__ void advance(int& r, int& w, int step, int width) {
  w += step;
  while (w >= width) {
    w -= width;
    ++r;
  }
}
// Folded BN, x·k + b, rounded as two operations (no contraction).
__device__ __forceinline__ float bn(float v, float k, float b) {
  return __fadd_rn(__fmul_rn(v, k), b);
}
// v · sigmoid(v); __frcp_rn is the correctly rounded 1 / x, as 1.0f / x.
__device__ __forceinline__ float swish(float v) {
  return __fmul_rn(v, __frcp_rn(1.0f + expf(-v)));
}

// Kernel A. Grid (Cm slices, bands, B); block kThreads threads: lane = the
// channel within the slice, group = every kGroups-th position. Each pass
// expands up to kPass new rows and then computes up to kPass output rows.
// Dynamic shared memory: ring [kPass + K - 1][pitch][kSlice] | a zero row
// [pitch][kSlice] | red [kThreads] | ws [c_pad][kSlice] | xs
// [kPass·width][c_pad] (the last two only with an expand; c_pad = c_in
// rounded up to 4). A ring row holds its width columns between R zero
// columns on each side (pitch = width + 2R), and rows above or below the
// image read the zero row, so the depthwise taps need no bounds checks.
// At least 3 blocks an SM: the compiler's own choice (128 registers, 2
// blocks) measured 9% slower at v2.4's fused shapes on the H100.
template <typename Tx, typename Ty, bool kExpand, int K>
__global__ void __launch_bounds__(kThreads, 3)
expand_dw_pool_kernel(const Tx* __restrict__ x, const float* __restrict__ wexp,
                      const float* __restrict__ kexp,
                      const float* __restrict__ bexp,
                      const float* __restrict__ dwk,
                      const float* __restrict__ kdw,
                      const float* __restrict__ bdw, Ty* __restrict__ y,
                      float* __restrict__ part, int height, int width,
                      int c_in, int cm, int band_rows, int dot_bf16,
                      int vec) {
  constexpr int R = K / 2;
  constexpr int V = kVec<Tx>;
  constexpr int n_slots = kPass + K - 1;
  const int c_pad = (c_in + 3) & ~3;
  const int pitch = width + 2 * R;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* zero_row = ring + n_slots * pitch * kSlice;
  float* red = zero_row + pitch * kSlice;
  float* ws = red + kThreads;
  float* xs = ws + c_pad * kSlice;

  const int lane = threadIdx.x % kSlice;
  const int grp = threadIdx.x / kSlice;
  const int c0 = blockIdx.x * kSlice;
  const int c = c0 + lane;
  const bool valid = c < cm;
  const int band = blockIdx.y;
  const int b = blockIdx.z;
  const int s_len = height * width;
  const int h0 = band * band_rows;
  const int h1 = min(height, h0 + band_rows);
  const Tx* xb = x + static_cast<size_t>(b) * s_len * c_in;

  float taps[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) taps[t] = valid ? dwk[t * cm + c] : 0.0f;
  const float kd = valid ? kdw[c] : 0.0f;
  const float bd = valid ? bdw[c] : 0.0f;
  float ke = 0.0f, be = 0.0f;
  // the halo columns of every slot, and the zero row; nothing writes them
  // again (the first expand_rows starts with a barrier)
  for (int i = threadIdx.x; i < n_slots * 2 * R * kSlice; i += kThreads) {
    const int e = i / kSlice, slot = e / (2 * R), hc = e - slot * 2 * R;
    ring[(slot * pitch + (hc < R ? hc : width + hc)) * kSlice + i % kSlice] =
        0.0f;
  }
  for (int i = threadIdx.x; i < pitch * kSlice; i += kThreads)
    zero_row[i] = 0.0f;
  if (kExpand) {
    ke = valid ? kexp[c] : 0.0f;
    be = valid ? bexp[c] : 0.0f;
    for (int i = threadIdx.x; i < c_pad * kSlice; i += kThreads) {
      const int ci = i / kSlice, j = i - ci * kSlice;
      ws[i] = ci < c_in && c0 + j < cm
                  ? round_dot(wexp[static_cast<size_t>(ci) * cm + c0 + j],
                              dot_bf16)
                  : 0.0f;
    }
  }

  // Rows r0 .. r0 + n - 1 of the expanded activations (this slice) into
  // ring slots row % n_slots. Every thread of the block calls it with the
  // same arguments.
  auto expand_rows = [&](int r0, int n) {
    const int npos = n * width;
    __syncthreads();               // the slots' old rows and xs are read
    if (kExpand) {
      // the n rows are contiguous in x: one flat copy, in 16-byte loads
      // (kUnroll in flight a thread) where C and x's address allow them
      const Tx* src = xb + static_cast<size_t>(r0) * width * c_in;
      if (vec) {
        const int chunks = npos * c_in / V;
        for (int i0 = threadIdx.x; i0 < chunks; i0 += kUnroll * kThreads) {
          float v[kUnroll][V];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int i = i0 + u * kThreads;
            if (i < chunks) load16(src + static_cast<size_t>(i) * V, v[u]);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int i = i0 + u * kThreads;
            if (i >= chunks) break;
#pragma unroll
            for (int e = 0; e < V; ++e) v[u][e] = round_dot(v[u][e], dot_bf16);
            const int p = i * V / c_in;
            store_smem<V>(xs + p * c_pad + i * V - p * c_in, v[u]);
          }
        }
      } else {
        for (int i = threadIdx.x; i < npos * c_in; i += kThreads) {
          const int p = i / c_in, ci = i - p * c_in;
          xs[p * c_pad + ci] = round_dot(to_f32(src[i]), dot_bf16);
        }
      }
      for (int i = threadIdx.x; i < npos * (c_pad - c_in); i += kThreads) {
        const int p = i / (c_pad - c_in);
        xs[p * c_pad + c_in + i - p * (c_pad - c_in)] = 0.0f;
      }
      __syncthreads();
      // kPos positions per thread at a time: each weight read from shared
      // memory feeds kPos FMAs, each float4 of xs four. (r, w) tracks the
      // row and column of position p0 + j·kGroups without divisions.
      const int base = r0 % n_slots;
      int r = grp / width, w = grp % width;
      for (int p0 = grp; p0 < npos; p0 += kGroups * kPos) {
        const float* xr[kPos];
        float acc[kPos];
#pragma unroll
        for (int j = 0; j < kPos; ++j) {
          xr[j] = xs + min(p0 + j * kGroups, npos - 1) * c_pad;
          acc[j] = 0.0f;
        }
        for (int ci = 0; ci < c_pad; ci += 4) {
          const float w0 = ws[ci * kSlice + lane];
          const float w1 = ws[(ci + 1) * kSlice + lane];
          const float w2 = ws[(ci + 2) * kSlice + lane];
          const float w3 = ws[(ci + 3) * kSlice + lane];
#pragma unroll
          for (int j = 0; j < kPos; ++j) {
            const float4 v = *reinterpret_cast<const float4*>(xr[j] + ci);
            acc[j] = fmaf(v.x, w0, acc[j]);
            acc[j] = fmaf(v.y, w1, acc[j]);
            acc[j] = fmaf(v.z, w2, acc[j]);
            acc[j] = fmaf(v.w, w3, acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kPos; ++j) {
          if (p0 + j * kGroups < npos)
            ring[(wrap(base + r, n_slots) * pitch + R + w) * kSlice + lane] =
                swish(bn(acc[j], ke, be));
          advance(r, w, kGroups, width);
        }
      }
    } else if (vec) {
      // this slice's channels of each position, in 16-byte loads; a lane
      // past Cm reads a slot nothing wrote and its result is not stored
      const Tx* src = xb + static_cast<size_t>(r0) * width * c_in + c0;
      const int qn = min(kSlice, cm - c0) / V;       // loads per position
      for (int i0 = threadIdx.x; i0 < npos * qn; i0 += kUnroll * kThreads) {
        float v[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kThreads;
          if (i < npos * qn)
            load16(src + static_cast<size_t>(i / qn) * c_in + i % qn * V,
                   v[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kThreads;
          if (i >= npos * qn) break;
          const int p = i / qn, row = r0 + p / width;
          store_smem<V>(
              ring + ((row % n_slots) * pitch + R + p % width) * kSlice +
                  i % qn * V,
              v[u]);
        }
      }
    } else {
      const Tx* src = xb + static_cast<size_t>(r0) * width * c_in + c;
      for (int p = grp; p < npos; p += kGroups) {
        const int row = r0 + p / width;
        ring[((row % n_slots) * pitch + R + p % width) * kSlice + lane] =
            valid ? to_f32(src[static_cast<size_t>(p) * c_in]) : 0.0f;
      }
    }
  };

  int next = max(0, h0 - R);       // next row to expand
  float pool = 0.0f;
  for (int h = h0; h < h1; h += kPass) {
    const int rows = min(kPass, h1 - h);
    const int last = min(height - 1, h + rows - 1 + R);
    while (next <= last) {
      const int n = min(kPass, last - next + 1);
      expand_rows(next, n);
      next += n;
    }
    __syncthreads();
    const int base = h % n_slots;
    int r = grp / width, w = grp % width;
    for (int p = grp; p < rows * width;
         p += kGroups, advance(r, w, kGroups, width)) {
      const int hr = h + r;
      float acc = 0.0f;
#pragma unroll
      for (int dy = -R; dy <= R; ++dy) {
        const int hh = hr + dy;
        // column w of the padded row is input column w - R
        const float* row =
            (hh < 0 || hh >= height
                 ? zero_row
                 : ring + wrap(base + r + dy, n_slots) * pitch * kSlice) +
            w * kSlice + lane;
#pragma unroll
        for (int dx = 0; dx < K; ++dx)
          acc = fmaf(row[dx * kSlice], taps[(dy + R) * K + dx], acc);
      }
      const float v = swish(bn(acc, kd, bd));
      if (valid) {
        store(y + (static_cast<size_t>(b) * s_len +
                   static_cast<size_t>(hr) * width + w) * cm + c, v);
        pool += v;
      }
    }
  }

  // this block's pool: each group's sum, then the groups in order
  red[threadIdx.x] = pool;
  __syncthreads();
  if (grp == 0 && valid) {
    float sum = 0.0f;
    for (int g = 0; g < kGroups; ++g) sum += red[g * kSlice + lane];
    part[(static_cast<size_t>(b) * gridDim.y + band) * cm + c] = sum;
  }
}

// pool[b, c] = Σ_band part[b, band, c], bands in order.
__global__ void pool_bands_kernel(const float* __restrict__ part,
                                  float* __restrict__ pool, int n_bands,
                                  int cm, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int b = i / cm, c = i - b * cm;
  const float* p = part + static_cast<size_t>(b) * n_bands * cm + c;
  float sum = 0.0f;
  for (int k = 0; k < n_bands; ++k) sum += p[static_cast<size_t>(k) * cm];
  pool[i] = sum;
}

// Kernel B. Grid (C' tiles, S tiles, B); block kThreadsB threads, each
// computing 8 positions × 2 output channels of a kBM × kBN tile, kBN = 16
// (for C' <= 16) or 32.
template <typename Ty, typename To, int kBN>
__global__ void __launch_bounds__(kThreadsB)
scale_project_kernel(const Ty* __restrict__ y, const float* __restrict__ se,
                     const float* __restrict__ wproj,
                     const float* __restrict__ kpr,
                     const float* __restrict__ bpr, const void* __restrict__ res,
                     int res_bf16, To* __restrict__ out, int s_len, int cm,
                     int c2, int dot_bf16, int vec) {
  constexpr int V = kVec<Ty>;
  constexpr int kTx = kBN / 2;                 // threads across the columns
  constexpr int kBM = kThreadsB / kTx * 8;     // positions per block
  __shared__ __align__(16) float zs[kBK][kBM + 4];   // z tile, [k][position]
  __shared__ __align__(16) float wt[kBK][kBN];

  const int tx = threadIdx.x % kTx;
  const int ty = threadIdx.x / kTx;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int b = blockIdx.z;
  const Ty* yb = y + static_cast<size_t>(b) * s_len * cm;
  const float* seb = se + static_cast<size_t>(b) * cm;

  float acc[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = 0.0f;

  for (int k0 = 0; k0 < cm; k0 += kBK) {
    if (vec) {
      // 16-byte loads of y (Cm is a multiple of V), all issued first
      constexpr int kQ = kBK / V;                    // loads per position
      constexpr int kN = kBM * kQ / kThreadsB;       // loads per thread
      float v[kN][V];
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        const int i = threadIdx.x + u * kThreadsB;
        const int s = m0 + i / kQ, k = k0 + i % kQ * V;
        if (s < s_len && k < cm)
          load16(yb + static_cast<size_t>(s) * cm + k, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        const int i = threadIdx.x + u * kThreadsB;
        const int mm = i / kQ, kk = i % kQ * V;
        const bool in = m0 + mm < s_len && k0 + kk < cm;
#pragma unroll
        for (int e = 0; e < V; ++e)
          zs[kk + e][mm] =
              in ? round_dot(__fmul_rn(v[u][e], seb[k0 + kk + e]), dot_bf16)
                 : 0.0f;
      }
    } else {
      for (int i = threadIdx.x; i < kBM * kBK; i += kThreadsB) {
        const int kk = i % kBK, mm = i / kBK;
        const int s = m0 + mm, k = k0 + kk;
        float v = 0.0f;
        if (s < s_len && k < cm)
          v = round_dot(
              __fmul_rn(to_f32(yb[static_cast<size_t>(s) * cm + k]), seb[k]),
              dot_bf16);
        zs[kk][mm] = v;
      }
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreadsB) {
      const int nn = i % kBN, kk = i / kBN;
      const int k = k0 + kk, n = n0 + nn;
      wt[kk][nn] = k < cm && n < c2
                       ? round_dot(wproj[static_cast<size_t>(k) * c2 + n],
                                   dot_bf16)
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float2 wv = *reinterpret_cast<const float2*>(&wt[kk][2 * tx]);
      const float4 a0 = *reinterpret_cast<const float4*>(&zs[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&zs[kk][ty * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] = fmaf(a[j], wv.x, acc[j][0]);
        acc[j][1] = fmaf(a[j], wv.y, acc[j][1]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int n = n0 + 2 * tx + q;
    if (n >= c2) break;
    const float kn = kpr[n], bn_ = bpr[n];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = m0 + ty * 8 + j;
      if (s >= s_len) break;
      const size_t o = (static_cast<size_t>(b) * s_len + s) * c2 + n;
      float v = bn(acc[j][q], kn, bn_);
      if (res != nullptr)
        v = __fadd_rn(v, res_bf16
                             ? __bfloat162float(
                                   static_cast<const __nv_bfloat16*>(res)[o])
                             : static_cast<const float*>(res)[o]);
      store(out + o, v);
    }
  }
}

struct ArgsA {
  const void* x;
  const float *wexp, *kexp, *bexp, *dwk, *kdw, *bdw;
  void* y;
  float *pool, *part;
  int batch, height, width, c_in, cm, band_rows, dot_bf16;
};

template <typename Tx, typename Ty, bool kExpand, int K>
cudaError_t launch_a(const ArgsA& a, cudaStream_t stream) {
  const size_t c_pad = (a.c_in + 3) & ~3;
  const size_t floats =
      static_cast<size_t>(kPass + K) * (a.width + K - 1) * kSlice + kThreads +
      (kExpand ? c_pad * kSlice +
                     static_cast<size_t>(kPass) * a.width * c_pad
               : 0);
  const size_t smem = floats * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = expand_dw_pool_kernel<Tx, Ty, kExpand, K>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_bands = (a.height + a.band_rows - 1) / a.band_rows;
  const dim3 grid((a.cm + kSlice - 1) / kSlice, n_bands, a.batch);
  const int vec = a.c_in % kVec<Tx> == 0 &&
                  reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const Tx*>(a.x), a.wexp, a.kexp, a.bexp, a.dwk, a.kdw,
      a.bdw, static_cast<Ty*>(a.y), n_bands > 1 ? a.part : a.pool, a.height,
      a.width, a.c_in, a.cm, a.band_rows, a.dot_bf16, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_bands == 1) return err;
  const int total = a.batch * a.cm;
  pool_bands_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                      stream>>>(a.part, a.pool, n_bands, a.cm, total);
  return cudaGetLastError();
}

template <typename Tx, typename Ty>
cudaError_t dispatch_a(const ArgsA& a, int kernel, cudaStream_t st) {
  const bool e = a.wexp != nullptr;
  if (kernel == 3)
    return e ? launch_a<Tx, Ty, true, 3>(a, st) : launch_a<Tx, Ty, false, 3>(a, st);
  if (kernel == 5)
    return e ? launch_a<Tx, Ty, true, 5>(a, st) : launch_a<Tx, Ty, false, 5>(a, st);
  return cudaErrorInvalidValue;
}

template <typename Ty, typename To, int kBN>
cudaError_t launch_b_tile(const void* y, const float* se, const float* wproj,
                          const float* kpr, const float* bpr, const void* res,
                          int res_bf16, void* out, int batch, int s_len,
                          int cm, int c2, int dot_bf16, cudaStream_t stream) {
  constexpr int kBM = kThreadsB / (kBN / 2) * 8;
  const dim3 grid((c2 + kBN - 1) / kBN, (s_len + kBM - 1) / kBM, batch);
  if (grid.y > kMaxGrid) return cudaErrorInvalidValue;
  const int vec = cm % kVec<Ty> == 0 &&
                  reinterpret_cast<uintptr_t>(y) % 16 == 0;
  scale_project_kernel<Ty, To, kBN><<<grid, kThreadsB, 0, stream>>>(
      static_cast<const Ty*>(y), se, wproj, kpr, bpr, res, res_bf16,
      static_cast<To*>(out), s_len, cm, c2, dot_bf16, vec);
  return cudaGetLastError();
}

template <typename Ty, typename To>
cudaError_t launch_b(const void* y, const float* se, const float* wproj,
                     const float* kpr, const float* bpr, const void* res,
                     int res_bf16, void* out, int batch, int s_len, int cm,
                     int c2, int dot_bf16, cudaStream_t stream) {
  return c2 <= 16
             ? launch_b_tile<Ty, To, 16>(y, se, wproj, kpr, bpr, res,
                                         res_bf16, out, batch, s_len, cm, c2,
                                         dot_bf16, stream)
             : launch_b_tile<Ty, To, 32>(y, se, wproj, kpr, bpr, res,
                                         res_bf16, out, batch, s_len, cm, c2,
                                         dot_bf16, stream);
}

}  // namespace

extern "C" {

// Both launchers run on `stream` (a cudaStream_t), allocate nothing, and
// return the cudaError_t of the attribute call or of the launches (0 =
// success). The caller has checked shapes, dtypes and contiguity; the
// launchers refuse (cudaErrorInvalidValue) a batch beyond the grid, and a
// width whose ring kernel A's shared memory cannot hold. wexp and
// res may be null (no expand; no residual). `part` is scratch
// [batch, bands, cm] for kernel A's per-band pools, used when an image has
// more than one band of band_rows rows.
int expand_dw_pool_launch(const void* x, int x_bf16, const void* wexp,
                          const void* kexp, const void* bexp, const void* dwk,
                          const void* kdw, const void* bdw, void* y,
                          int y_bf16, void* pool, void* part, int batch,
                          int height, int width, int c_in, int cm, int kernel,
                          int band_rows, int dot_bf16, void* stream) {
  if (batch < 1 || batch > kMaxGrid || height < 1 || width < 1 || c_in < 1 ||
      cm < 1 || band_rows < 1)
    return cudaErrorInvalidValue;
  const ArgsA a{x, static_cast<const float*>(wexp),
                static_cast<const float*>(kexp),
                static_cast<const float*>(bexp),
                static_cast<const float*>(dwk),
                static_cast<const float*>(kdw),
                static_cast<const float*>(bdw), y,
                static_cast<float*>(pool), static_cast<float*>(part), batch,
                height, width, c_in, cm, band_rows, dot_bf16};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_bf16)
    return y_bf16 ? dispatch_a<bf, bf>(a, kernel, st)
                  : dispatch_a<bf, float>(a, kernel, st);
  return y_bf16 ? dispatch_a<float, bf>(a, kernel, st)
                : dispatch_a<float, float>(a, kernel, st);
}

int scale_project_launch(const void* y, int y_bf16, const void* se,
                         const void* wproj, const void* kpr, const void* bpr,
                         const void* res, int res_bf16, void* out,
                         int out_bf16, int batch, int s_len, int cm, int c2,
                         int dot_bf16, void* stream) {
  if (batch < 1 || batch > kMaxGrid || s_len < 1 || cm < 1 || c2 < 1)
    return cudaErrorInvalidValue;
  const auto* sef = static_cast<const float*>(se);
  const auto* wf = static_cast<const float*>(wproj);
  const auto* kf = static_cast<const float*>(kpr);
  const auto* bf_ = static_cast<const float*>(bpr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (y_bf16)
    return out_bf16
               ? launch_b<bf, bf>(y, sef, wf, kf, bf_, res, res_bf16, out,
                                  batch, s_len, cm, c2, dot_bf16, st)
               : launch_b<bf, float>(y, sef, wf, kf, bf_, res, res_bf16, out,
                                     batch, s_len, cm, c2, dot_bf16, st);
  return out_bf16
             ? launch_b<float, bf>(y, sef, wf, kf, bf_, res, res_bf16, out,
                                   batch, s_len, cm, c2, dot_bf16, st)
             : launch_b<float, float>(y, sef, wf, kf, bf_, res, res_bf16, out,
                                      batch, s_len, cm, c2, dot_bf16, st);
}

}  // extern "C"
