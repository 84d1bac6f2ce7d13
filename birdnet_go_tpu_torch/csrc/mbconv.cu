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
// What bounds them. At the models' shapes both are bound by device memory:
// A moves x and y once (2·(C + Cm) bytes a position in bf16) and B y, the
// residual and out. But A's work per byte is high: C·Cm bf16 multiply-adds
// (a tenth of the bytes' time on the tensor cores), k² float32 FMAs, two
// swishes and two BNs per y element, so its instruction issue, its shared-
// memory loads and the latency between its barriers set its time; B's
// product is small on the tensor cores, and its time is its loads.
//
// Kernel A's design. A block holds one band of rows of one image for one
// tile of channels (48 with an expand, which every Cm of the models
// fills exactly; 16 or 32 without) and walks the band pass by pass,
// keeping a float32 ring of expanded rows in shared memory, so the
// expanded tensor never goes to device memory and a band re-expands only
// its k - 1 halo rows. A pass expands about 32 positions' rows (an even
// count, at least 2) and computes the output rows whose windows they
// complete; the x rows of the next pass are copied with cp.async into the
// second of two staging buffers meanwhile. With bf16 matrix operands the
// expand runs on the tensor cores (mma.sync m16n8k16 bf16): x is staged in
// bf16 (a float32 x is rounded once, on the copy), C zero-padded to a
// multiple of 16, A fragments come by ldmatrix, and the tile's B fragments
// (packed by the host in fragment order, `pack_fragments`) are copied once
// into shared memory, each warp reading its 16 channels' with one 8-byte
// load per MMA pair; in registers they cost 32 of them, which held the
// kernel to 2 blocks an SM (0.4 ms slower over a v3.0 step). The float32
// accumulators go through BN·swish straight into the ring. With float32
// operands (no model step uses them) the expand stays on float32 FMAs fed
// from shared memory. The depthwise runs from registers: a thread computes
// 2 rows × 4 adjacent columns of its channel, sliding a window of k + 3
// ring values along each of the k + 1 rows it reads, so a value loaded
// once feeds up to 2·k FMAs. Lanes map to (channel, position), so a
// 16-channel tile keeps every thread busy. Swish takes __expf and
// __fdividef: the exact expf and __frcp_rn cost 0.5 ms more over a v3.0
// step, and every gate holds with the fast pair. The ring's rows carry
// zero halo columns and rows outside the image read a zero row, so the
// taps need no bounds checks. The pool is summed by each block in a fixed
// order and, when an image has several bands, over the bands by a second
// kernel: repeated runs agree bit for bit (no atomics).
//
// Kernel B's design. A block computes 64 positions × all C' output
// channels (up to 128 a block), so y is read from device memory once. y
// and the packed weights stream through a 3-stage cp.async pipeline of
// 32-channel slices; each A fragment comes by ldmatrix from bf16 y and is
// scaled in registers, f32(y) · se[b, k] rounded to bf16, before the
// mma.sync m16n8k16 bf16 products (y in float32, or a Cm that 16-byte
// copies do not fit, is scaled and rounded on a synchronous copy instead).
// BN and the residual run in an epilogue staged through shared memory, so
// out and the residual move in 16-byte accesses. With float32 matrix
// operands a float32-FMA tile computes it.
//
// Later work (diag/mbconv_breakdown gives each part's cost): A's fixed
// cost per pass (two barriers a pass, the copy's latency), its depthwise
// loads, a persistent grid; wgmma with A from registers and TMA for B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // A: most threads per block
constexpr int kMaxSmem = 232448;
constexpr int kMaxGrid = 65535;
constexpr int kTile = 48;         // A: channels per block with an expand
constexpr int kStrip = 4;         // A: output columns per depthwise strip
constexpr int kRows = 2;          // A: output rows per depthwise strip
constexpr int kMinPass = 2;       // A: least rows per pass (even)
constexpr int kPassPos = 32;      // A: positions per pass to aim for
constexpr int kStagesA = 2;       // A: staging buffers (copies a pass ahead)
constexpr int kMinBandRows = 16;  // A: least rows per band of an image
constexpr int kWaves = 4;         // A: blocks per SM to aim for with bands
constexpr int kPos = 4;           // A, float32 expand: positions per step
constexpr int kThreadsB = 128;    // B: threads per block (4 warps)
constexpr int kBM = 64;           // B: positions per block, 16 a warp
constexpr int kBK = 32;           // B: Cm per pipeline stage
constexpr int kStages = 3;        // B: pipeline stages
constexpr int kYPitch = kBK + 8;  // B: bf16 per staged y row (80 bytes)
constexpr int kBKF = 32;          // B, float32 tile: Cm per step

enum Expand { kNone = 0, kMma = 1, kFma = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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
// v · sigmoid(v), with the fast exp and division (a few ulp of float32;
// measured against expf and __frcp_rn in diag/mbconv_breakdown).
__device__ __forceinline__ float swish(float v) {
  return __fmul_rn(v, __fdividef(1.0f, 1.0f + __expf(-v)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from device to shared memory, asynchronously; with full false
// the 16 bytes are zeros and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}
// The A fragment of a 16×16 bf16 tile at p (row-major, this lane's row
// address: row lane % 16, column 8·(lane / 16)).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// d += a · b on the tensor cores: m16n8k16, bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}
// Two bf16 of y (low: channel k, high: k + 1) times (s.x, s.y), each
// product rounded to bf16: round(f32(y) · se), as the plain version.
__device__ __forceinline__ uint32_t scale2(uint32_t u, float2 s) {
  const float lo = __uint_as_float(u << 16);
  const float hi = __uint_as_float(u & 0xffff0000u);
  const __nv_bfloat162 z =
      __floats2bfloat162_rn(__fmul_rn(lo, s.x), __fmul_rn(hi, s.y));
  return *reinterpret_cast<const uint32_t*>(&z);
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}
__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Kernel A's shared memory: ring [n_slots][pitch][ncp] f32 | red
// [threads] f32 | kStagesA staging buffers of x rows [pass · width][sp]
// (rounded up to 16 positions for the MMAs) | ws: [c_pad][nc] f32 weights
// (the float32 expand) or the tile's B fragments [c_pad / 16][6][32 lanes]
// uint2 (the MMAs). A ring row holds its width columns between R zero
// columns on the left and R or more on the right (pitch = width rounded up
// to the strip, + 2R); the last slot is a zero row for the rows outside
// the image. ncp pads the channels against bank conflicts. A pass expands
// `pass` rows (an even count, about kPassPos positions) and computes the
// output rows whose windows they complete. The launcher and the kernel
// both compute it here.
struct LayoutA {
  int pass, n_slots, pitch, ncp, sp;
  size_t red, stage, stage_bytes, ws, total;   // byte offsets, sizes
};
// The B fragments of one tile's 8-channel column tiles (kTile / 8 of them)
// for one k16 step, in bytes.
constexpr int kFragStep = kTile / 8 * 32 * 8;

__host__ __device__ inline LayoutA layout_a(int mode, int k, int nc,
                                            int threads, int width, int c_in,
                                            int x_size) {
  LayoutA l;
  const int r = k / 2;
  const int want = round_up((kPassPos + width - 1) / width, 2);
  l.pass = want > kMinPass ? want : kMinPass;
  l.n_slots = l.pass + 2 * r;
  l.pitch = round_up(width, kStrip) + 2 * r;
  l.ncp = nc == 48 ? 56 : (nc == 16 ? 20 : nc);
  const int max_pos = l.pass * width;
  int rows = max_pos, elem;
  if (mode == kMma) {
    l.sp = round_up(c_in, 16) + 8;
    rows = round_up(max_pos, 16);
    elem = 2;
  } else if (mode == kFma) {
    l.sp = round_up(c_in, 4);
    elem = 4;
  } else {
    l.sp = nc;
    elem = x_size;
  }
  l.red = sizeof(float) * (l.n_slots + 1) * l.pitch * l.ncp;
  l.stage = l.red + align16(sizeof(float) * threads);
  l.stage_bytes = align16(static_cast<size_t>(rows) * l.sp * elem);
  l.ws = l.stage + kStagesA * l.stage_bytes;
  l.total = l.ws;
  if (mode == kFma) l.total += sizeof(float) * round_up(c_in, 4) * nc;
  if (mode == kMma) l.total += static_cast<size_t>(kFragStep) * (round_up(c_in, 16) / 16);
  return l;
}

// Kernel A. Grid (channel tiles of nc, bands, B); blockDim.x = nc · 4
// (with an expand) or 256 threads. w holds the expand's weights: packed B
// fragments (kMma), float32 [C, Cm] (kFma) or nothing (kNone). For the
// depthwise and the copies thread = (channel tid % nc, position group
// tid / nc); for the MMAs warp v covers channels 16·(v % 3) of the tile
// and every other 16-position tile from v / 3. Pass i copies the x rows of pass i + 1, expands its own rows into
// the ring and computes the output rows they complete: two barriers a pass.
template <typename Tx, typename Ty, int kMode, int K>
__global__ void __launch_bounds__(kThreads, 3)
expand_dw_pool_kernel(const Tx* __restrict__ x, const void* __restrict__ w,
                      const float* __restrict__ kexp,
                      const float* __restrict__ bexp,
                      const float* __restrict__ dwk,
                      const float* __restrict__ kdw,
                      const float* __restrict__ bdw, Ty* __restrict__ y,
                      float* __restrict__ part, int height, int width,
                      int c_in, int cm, int band_rows, int nc, int vec) {
  constexpr int R = K / 2;
  const int threads = blockDim.x;
  const LayoutA L = layout_a(kMode, K, nc, threads, width, c_in, sizeof(Tx));
  const int P = L.pass, n_slots = L.n_slots, pitch = L.pitch, ncp = L.ncp;
  const int sp = L.sp;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const float* zero_row = ring + n_slots * pitch * ncp;
  float* red = reinterpret_cast<float*>(smem + L.red);
  unsigned char* stage0 = smem + L.stage;
  float* ws = reinterpret_cast<float*>(smem + L.ws);

  const int tid = threadIdx.x;
  const int lc = tid % nc;           // the channel within the tile
  const int grp = tid / nc;
  const int n_grp = threads / nc;
  const int c0 = blockIdx.x * nc;
  const int c = c0 + lc;
  const bool valid = c < cm;
  const int band = blockIdx.y;
  const int b = blockIdx.z;
  const int s_len = height * width;
  const int h0 = band * band_rows;
  const int h1 = min(height, h0 + band_rows);
  // pass i expands rows [e0 + i·P, e0 + (i + 1)·P) of [e0, e1)
  const int e0 = max(0, h0 - R), e1 = min(height, h1 + R);
  const int n_pass = (e1 - e0 + P - 1) / P;
  const Tx* xb = x + static_cast<size_t>(b) * s_len * c_in;

  float taps[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) taps[t] = valid ? dwk[t * cm + c] : 0.0f;
  const float kd = valid ? kdw[c] : 0.0f;
  const float bd = valid ? bdw[c] : 0.0f;

  // the halo columns of every slot, the columns past the row, the zero
  // row; the MMA staging's padded channels, which must read zero
  const int n_pad = pitch - width;
  for (int i = tid; i < n_slots * n_pad * ncp; i += threads) {
    const int e = i / ncp, slot = e / n_pad, hc = e - slot * n_pad;
    ring[(slot * pitch + (hc < R ? hc : width + hc)) * ncp + i % ncp] = 0.0f;
  }
  for (int i = tid; i < pitch * ncp; i += threads)
    ring[n_slots * pitch * ncp + i] = 0.0f;
  const int c_pad = round_up(c_in, 16);
  if (kMode == kMma && c_pad > c_in) {
    __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(stage0);
    const int rows = static_cast<int>(L.stage_bytes / (2 * sp));
    for (int i = tid; i < kStagesA * rows * (c_pad - c_in); i += threads) {
      const int p = i / (c_pad - c_in);
      st[p * sp + c_in + i - p * (c_pad - c_in)] = __float2bfloat16_rn(0.0f);
    }
  }

  // MMA: the tile's B fragments into shared memory (zeros past Cm), the BN
  // constants of this warp's accumulator columns
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int slab = warp % 3, mg = warp / 3;
  const int n_mg = threads / 96;
  const int n_ks = c_pad / 16;
  const uint2* wf = reinterpret_cast<const uint2*>(ws);
  float ke[2][2], be[2][2];
  float kef = 0.0f, bef = 0.0f;
  if constexpr (kMode == kMma) {
    const uint2* wpk = static_cast<const uint2*>(w);
    const int n8 = (cm + 7) / 8;
    constexpr int kChunks = kFragStep / 16;
    for (int i = tid; i < n_ks * kChunks; i += threads) {
      const int ks = i / kChunks, q = i - ks * kChunks;
      const int nt = c0 / 8 + q / 16;         // 16 chunks an 8-channel tile
      const bool in = nt < n8;
      cp_async16(reinterpret_cast<unsigned char*>(ws) + i * 16,
                 wpk + (static_cast<size_t>(ks) * n8 + (in ? nt : 0)) * 32 +
                     (q % 16) * 2,
                 in);
    }
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = c0 + 16 * slab + 8 * j + 2 * t4 + e;
        ke[j][e] = ch < cm ? kexp[ch] : 0.0f;
        be[j][e] = ch < cm ? bexp[ch] : 0.0f;
      }
    }
  } else if constexpr (kMode == kFma) {
    const float* wexp = static_cast<const float*>(w);
    kef = valid ? kexp[c] : 0.0f;
    bef = valid ? bexp[c] : 0.0f;
    for (int i = tid; i < sp * nc; i += threads) {
      const int ci = i / nc, j = i - ci * nc;
      ws[i] = ci < c_in && c0 + j < cm
                  ? wexp[static_cast<size_t>(ci) * cm + c0 + j]
                  : 0.0f;
    }
  }
  __syncthreads();

  // The x rows of pass i into staging buffer i % kStagesA: asynchronous
  // 16-byte copies where the layout allows, else loads and stores
  // (converting).
  auto copy_rows = [&](int i) {
    const int r0 = e0 + i * P;
    const int n = min(P, e1 - r0);
    const int npos = n * width;
    unsigned char* buf = stage0 + i % kStagesA * L.stage_bytes;
    const Tx* src = xb + static_cast<size_t>(r0) * width * c_in;
    if constexpr (kMode == kMma) {
      __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(buf);
      if (vec) {                       // bf16 x, C a multiple of 8
        const int q = c_in / 8;
        for (int j = tid; j < npos * q; j += threads) {
          const int p = j / q;
          cp_async16(st + p * sp + (j - p * q) * 8, src + j * 8);
        }
      } else {
        for (int j = tid; j < npos * c_in; j += threads) {
          const int p = j / c_in;
          st[p * sp + j - p * c_in] = __float2bfloat16_rn(to_f32(src[j]));
        }
      }
    } else if constexpr (kMode == kFma) {
      float* st = reinterpret_cast<float*>(buf);
      for (int j = tid; j < npos * sp; j += threads) {
        const int p = j / sp, ci = j - p * sp;
        st[j] = ci < c_in ? to_f32(src[static_cast<size_t>(p) * c_in + ci])
                          : 0.0f;
      }
    } else {
      Tx* st = reinterpret_cast<Tx*>(buf);
      constexpr int V = 16 / sizeof(Tx);
      if (vec) {                       // C a multiple of V
        const int q = min(nc, cm - c0) / V;
        for (int j = tid; j < npos * q; j += threads) {
          const int p = j / q, k = j - p * q;
          cp_async16(st + p * nc + k * V,
                     src + static_cast<size_t>(p) * c_in + c0 + k * V);
        }
      } else {
        for (int p = grp; p < npos; p += n_grp)
          if (valid) st[p * nc + lc] = src[static_cast<size_t>(p) * c_in + c];
      }
    }
  };

  // The rows of pass i, from its staging buffer into the ring (slot =
  // row mod n_slots): the expand, or the conversion to float32.
  auto expand_rows = [&](int i) {
    const int r0 = e0 + i * P;
    const int npos = min(P, e1 - r0) * width;
    const int base = r0 % n_slots;
    const unsigned char* buf = stage0 + i % kStagesA * L.stage_bytes;
    if constexpr (kMode == kMma) {
      const __nv_bfloat16* st = reinterpret_cast<const __nv_bfloat16*>(buf);
      const int mtiles = (npos + 15) / 16;
      for (int mt = mg; mt < mtiles; mt += n_mg) {
        float acc[2][4] = {};
        const __nv_bfloat16* arow =
            st + (mt * 16 + lane % 16) * sp + lane / 16 * 8;
        for (int ks = 0; ks < n_ks; ++ks) {
          uint32_t a[4];
          ldmatrix_x4(a, arow + ks * 16);
          const uint2* bk = wf + (ks * (kTile / 8) + 2 * slab) * 32 + lane;
          mma_bf16(acc[0], a, bk[0]);
          mma_bf16(acc[1], a, bk[32]);
        }
        // rows g and g + 8 of the tile, columns 2·t4 and 2·t4 + 1 of each
        // of the warp's two 8-channel tiles
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = mt * 16 + g + 8 * hh;
          if (p >= npos) continue;
          const int r = p / width, w = p - r * width;
          float* dst = ring + (wrap(base + r, n_slots) * pitch + R + w) * ncp +
                       16 * slab + 2 * t4;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(
                swish(bn(acc[j][2 * hh], ke[j][0], be[j][0])),
                swish(bn(acc[j][2 * hh + 1], ke[j][1], be[j][1])));
        }
      }
    } else if constexpr (kMode == kFma) {
      // kPos positions a thread at a time: each weight read from shared
      // memory feeds kPos FMAs, each float4 of x four
      const float* xs = reinterpret_cast<const float*>(buf);
      int r = grp / width, w = grp % width;
      for (int p0 = grp; p0 < npos; p0 += n_grp * kPos) {
        const float* xr[kPos];
        float acc[kPos];
#pragma unroll
        for (int j = 0; j < kPos; ++j) {
          xr[j] = xs + min(p0 + j * n_grp, npos - 1) * sp;
          acc[j] = 0.0f;
        }
        for (int ci = 0; ci < sp; ci += 4) {
          const float w0 = ws[ci * nc + lc];
          const float w1 = ws[(ci + 1) * nc + lc];
          const float w2 = ws[(ci + 2) * nc + lc];
          const float w3 = ws[(ci + 3) * nc + lc];
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
          if (p0 + j * n_grp < npos)
            ring[(wrap(base + r, n_slots) * pitch + R + w) * ncp + lc] =
                swish(bn(acc[j], kef, bef));
          advance(r, w, n_grp, width);
        }
      }
    } else {
      const Tx* st = reinterpret_cast<const Tx*>(buf);
      int r = grp / width, w = grp % width;
      for (int p = grp; p < npos; p += n_grp, advance(r, w, n_grp, width))
        ring[(wrap(base + r, n_slots) * pitch + R + w) * ncp + lc] =
            valid ? to_f32(st[p * nc + lc]) : 0.0f;
    }
  };

  const int n_strip = round_up(width, kStrip) / kStrip;
  float pool = 0.0f;
  int lo = h0;                  // the first output row not yet computed
#pragma unroll
  for (int i = 0; i < kStagesA - 1; ++i) {
    if (i < n_pass) copy_rows(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_pass; ++i) {
    // the buffer of pass i + kStagesA - 1 was last read by pass i - 1's
    // expand, before its second barrier
    if (i + kStagesA - 1 < n_pass) copy_rows(i + kStagesA - 1);
    cp_async_commit();
    cp_async_wait<kStagesA - 1>();
    __syncthreads();            // pass i's x rows are in; the ring is read
    expand_rows(i);
    __syncthreads();            // the ring holds pass i's rows
    // the rows whose k×k windows the ring now holds
    const int end = min(e1, e0 + (i + 1) * P);
    const int hi = end == e1 ? h1 : min(h1, end - R);
    const int rows = hi - lo;
    const int base = lo % n_slots;
    // kRows × kStrip outputs a thread: each ring value loaded feeds up to
    // k taps of each of kRows rows
    for (int it = grp; it < (rows + kRows - 1) / kRows * n_strip;
         it += n_grp) {
      const int rr = it / n_strip, w0 = (it - rr * n_strip) * kStrip;
      const int r = rr * kRows, hr = lo + r;
      float acc[kRows][kStrip] = {};
#pragma unroll
      for (int ir = 0; ir < kRows + K - 1; ++ir) {
        const int hh = hr - R + ir;
        // column w of the padded row is input column w - R
        const float* row =
            (hh < 0 || hh >= height
                 ? zero_row
                 : ring + wrap(base + r - R + ir, n_slots) * pitch * ncp) +
            w0 * ncp + lc;
        float v[kStrip + K - 1];
#pragma unroll
        for (int j = 0; j < kStrip + K - 1; ++j) v[j] = row[j * ncp];
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          const int dy = ir - t;              // known when unrolled
          if (dy < 0 || dy >= K) continue;
#pragma unroll
          for (int dx = 0; dx < K; ++dx)
#pragma unroll
            for (int s = 0; s < kStrip; ++s)
              acc[t][s] = fmaf(v[s + dx], taps[dy * K + dx], acc[t][s]);
        }
      }
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        if (r + t >= rows || !valid) break;
#pragma unroll
        for (int s = 0; s < kStrip; ++s) {
          if (w0 + s >= width) break;
          const float v = swish(bn(acc[t][s], kd, bd));
          store(y + (static_cast<size_t>(b) * s_len +
                     static_cast<size_t>(hr + t) * width + w0 + s) * cm + c,
                v);
          pool += v;
        }
      }
    }
    lo = max(lo, hi);
  }

  // this block's pool: each group's sum, then the groups in order
  red[tid] = pool;
  __syncthreads();
  if (grp == 0 && valid) {
    float sum = 0.0f;
    for (int k = 0; k < n_grp; ++k) sum += red[k * nc + lc];
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

// 16 bytes of T at p as kVecOut<T> floats, and back.
template <typename T>
constexpr int kVecOut = 16 / sizeof(T);
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Kernel B's shared memory: kStages × (y [kBM][kYPitch] bf16 | w [2 k16
// steps][nt][32 lanes] uint2) | se [Cm rounded up to kBK] f32. The
// epilogue's tile [kBM][8·nt + 4] f32 reuses the stages.
__host__ __device__ inline size_t stage_bytes_b(int n_tiles) {
  return static_cast<size_t>(kBM) * kYPitch * 2 + 2 * n_tiles * 32 * 8;
}

// Kernel B on the tensor cores. Grid (S tiles of kBM, C' chunks of 8·kNT,
// B); kThreadsB threads, warp w computing positions 16·w .. 16·w + 15 of
// the tile for every output channel of the chunk. vec_y: y is bf16, Cm a
// multiple of 8, 16-byte aligned (asynchronous copies, scaled in
// registers); vec_out: C' chunk, out and res take 16-byte accesses.
template <typename Ty, typename To, int kNT>
__global__ void __launch_bounds__(kThreadsB)
scale_project_kernel(const Ty* __restrict__ y, const float* __restrict__ se,
                     const uint2* __restrict__ wpk,
                     const float* __restrict__ kpr,
                     const float* __restrict__ bpr,
                     const void* __restrict__ res, int res_bf16,
                     To* __restrict__ out, int s_len, int cm, int c2,
                     int vec_y, int vec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int m0 = blockIdx.x * kBM;
  const int nb = blockIdx.y * kNT;               // first 8-channel tile
  const int n8 = (c2 + 7) / 8;
  const int nt = min(kNT, n8 - nb);              // 8-channel tiles here
  const int b = blockIdx.z;
  const int n_k = (cm + kBK - 1) / kBK;
  const int n_ks = (cm + 15) / 16;
  const size_t sbytes = stage_bytes_b(nt);
  float* se_s = reinterpret_cast<float*>(smem + kStages * sbytes);
  const Ty* yb = y + static_cast<size_t>(b) * s_len * cm;

  for (int k = tid; k < n_k * kBK; k += kThreadsB)
    se_s[k] = k < cm ? se[static_cast<size_t>(b) * cm + k] : 0.0f;
  __syncthreads();

  // Cm slice kc into stage kc % kStages: y rows (zeros past S and Cm)
  // and the packed weights of its two k16 steps (zeros past Cm)
  auto load = [&](int kc) {
    unsigned char* st = smem + (kc % kStages) * sbytes;
    __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(st);
    uint2* wsm = reinterpret_cast<uint2*>(st + kBM * kYPitch * 2);
    const int k0 = kc * kBK;
    if (vec_y) {
      for (int i = tid; i < kBM * (kBK / 8); i += kThreadsB) {
        const int r = i / (kBK / 8), q = i % (kBK / 8);
        const int s = m0 + r, k = k0 + q * 8;
        const bool in = s < s_len && k < cm;
        cp_async16(ys + r * kYPitch + q * 8,
                   in ? static_cast<const void*>(
                            yb + static_cast<size_t>(s) * cm + k)
                      : static_cast<const void*>(yb),
                   in);
      }
    } else {
      for (int i = tid; i < kBM * kBK; i += kThreadsB) {
        const int r = i / kBK, q = i % kBK;
        const int s = m0 + r, k = k0 + q;
        ys[r * kYPitch + q] = __float2bfloat16_rn(
            s < s_len && k < cm
                ? __fmul_rn(to_f32(yb[static_cast<size_t>(s) * cm + k]),
                            se_s[k])
                : 0.0f);
      }
    }
    // two k16 steps × nt tiles × 32 lanes × 8 bytes, in 16-byte pieces
    for (int i = tid; i < 2 * nt * 16; i += kThreadsB) {
      const int kk = i / (nt * 16), rest = i - kk * nt * 16;
      const int ks = kc * 2 + kk;
      const bool in = ks < n_ks;
      const uint2* src =
          wpk + (static_cast<size_t>(in ? ks : 0) * n8 + nb) * 32 + rest * 2;
      cp_async16(wsm + kk * nt * 32 + rest * 2, src, in);
    }
  };

  float acc[kNT][4] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < n_k; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();            // slice kc is in; slice kc - 1 is consumed
    if (kc + kStages - 1 < n_k) load(kc + kStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (kc % kStages) * sbytes;
    const __nv_bfloat16* ys = reinterpret_cast<const __nv_bfloat16*>(st);
    const uint2* wsm = reinterpret_cast<const uint2*>(st + kBM * kYPitch * 2);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, ys + (warp * 16 + lane % 16) * kYPitch + kk * 16 +
                         lane / 16 * 8);
      if (vec_y) {
        // a[0], a[1]: channels 2·t4, 2·t4 + 1; a[2], a[3]: 8 more
        const int k = kc * kBK + kk * 16 + 2 * t4;
        const float2 s01 = *reinterpret_cast<const float2*>(se_s + k);
        const float2 s89 = *reinterpret_cast<const float2*>(se_s + k + 8);
        a[0] = scale2(a[0], s01);
        a[1] = scale2(a[1], s01);
        a[2] = scale2(a[2], s89);
        a[3] = scale2(a[3], s89);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        if (j < nt) mma_bf16(acc[j], a, wsm[(kk * nt + j) * 32 + lane]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();              // every stage is consumed

  // BN into the tile [kBM][ld] f32, then + res and out, row by row
  const int ld = 8 * nt + 4;
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j >= nt) break;
    const int col = 8 * j + 2 * t4, n = 8 * nb + col;
    const float k0 = n < c2 ? kpr[n] : 0.0f, b0 = n < c2 ? bpr[n] : 0.0f;
    const float k1 = n + 1 < c2 ? kpr[n + 1] : 0.0f;
    const float b1 = n + 1 < c2 ? bpr[n + 1] : 0.0f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(tile + (warp * 16 + g + 8 * hh) * ld + col) =
          make_float2(bn(acc[j][2 * hh], k0, b0),
                      bn(acc[j][2 * hh + 1], k1, b1));
  }
  __syncthreads();
  const int nw = min(8 * nt, c2 - 8 * nb);       // valid columns here
  const size_t o0 = (static_cast<size_t>(b) * s_len + m0) * c2 + 8 * nb;
  if (vec_out) {
    constexpr int V = kVecOut<To>;
    const int q = nw / V;
    for (int i = tid; i < kBM * q; i += kThreadsB) {
      const int r = i / q, cc = (i - r * q) * V;
      if (m0 + r >= s_len) break;
      const size_t o = o0 + static_cast<size_t>(r) * c2 + cc;
      float v[V], rv[V];
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = tile[r * ld + cc + e];
      if (res != nullptr) {
        load16(static_cast<const To*>(res) + o, rv);
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = __fadd_rn(v[e], rv[e]);
      }
      store16(out + o, v);
    }
  } else {
    for (int i = tid; i < kBM * nw; i += kThreadsB) {
      const int r = i / nw, cc = i - r * nw;
      if (m0 + r >= s_len) break;
      const size_t o = o0 + static_cast<size_t>(r) * c2 + cc;
      float v = tile[r * ld + cc];
      if (res != nullptr)
        v = __fadd_rn(v, res_bf16 ? __bfloat162float(
                                        static_cast<const __nv_bfloat16*>(
                                            res)[o])
                                  : static_cast<const float*>(res)[o]);
      store(out + o, v);
    }
  }
}

// Kernel B with float32 matrix operands. Grid (C' tiles, S tiles, B);
// block kThreadsB threads, each computing 8 positions × 2 output channels
// of a kBMF × kBN tile, kBN = 16 (for C' <= 16) or 32.
template <typename Ty, typename To, int kBN>
__global__ void __launch_bounds__(kThreadsB)
scale_project_f32_kernel(const Ty* __restrict__ y,
                         const float* __restrict__ se,
                         const float* __restrict__ wproj,
                         const float* __restrict__ kpr,
                         const float* __restrict__ bpr,
                         const void* __restrict__ res, int res_bf16,
                         To* __restrict__ out, int s_len, int cm, int c2) {
  constexpr int kTx = kBN / 2;                 // threads across the columns
  constexpr int kBMF = kThreadsB / kTx * 8;    // positions per block
  __shared__ __align__(16) float zs[kBKF][kBMF + 4];   // z tile, [k][position]
  __shared__ __align__(16) float wt[kBKF][kBN];

  const int tx = threadIdx.x % kTx;
  const int ty = threadIdx.x / kTx;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBMF;
  const int b = blockIdx.z;
  const Ty* yb = y + static_cast<size_t>(b) * s_len * cm;
  const float* seb = se + static_cast<size_t>(b) * cm;

  float acc[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = 0.0f;

  for (int k0 = 0; k0 < cm; k0 += kBKF) {
    for (int i = threadIdx.x; i < kBMF * kBKF; i += kThreadsB) {
      const int kk = i % kBKF, mm = i / kBKF;
      const int s = m0 + mm, k = k0 + kk;
      zs[kk][mm] = s < s_len && k < cm
                       ? __fmul_rn(to_f32(yb[static_cast<size_t>(s) * cm + k]),
                                   seb[k])
                       : 0.0f;
    }
    for (int i = threadIdx.x; i < kBKF * kBN; i += kThreadsB) {
      const int nn = i % kBN, kk = i / kBN;
      const int k = k0 + kk, n = n0 + nn;
      wt[kk][nn] = k < cm && n < c2 ? wproj[static_cast<size_t>(k) * c2 + n]
                                    : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBKF; ++kk) {
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
  const void* w;       // packed bf16 fragments, float32 [C, Cm], or null
  const float *kexp, *bexp, *dwk, *kdw, *bdw;
  void* y;
  float *pool, *part;
  int batch, height, width, c_in, cm, band_rows;
};

// The channels a block of kernel A covers.
int channel_tile(bool expand, int cm) {
  return expand ? kTile : (cm <= 16 ? 16 : 32);
}

// Rows per band of kernel A: bands enough for about kWaves blocks per SM
// where the images' channel tiles alone give fewer, each band at least
// kMinBandRows rows, as its halo expands k - 1 rows more. (Measured on the
// card at the v2.4 and B1 shapes: more bands help the expand-less blocks,
// and cost the expand blocks their halo rows.)
int band_rows_a(int batch, int height, int cm, bool expand, int sm_count) {
  const int nc = channel_tile(expand, cm);
  const long blocks = static_cast<long>(batch) * ((cm + nc - 1) / nc);
  const long want = (static_cast<long>(kWaves) * sm_count + blocks - 1) /
                    blocks;
  const long most = height / kMinBandRows;
  const int n = static_cast<int>(want < most ? want : most);
  return n > 1 ? (height + n - 1) / n : height;
}
// Threads per block of kernel A: four position groups of a 48-channel
// tile (six warps: three 16-channel MMA slabs, two position halves), else
// 256.
int threads_a(int nc) { return nc == kTile ? 4 * kTile : kThreads; }

template <typename Tx, typename Ty, int kMode, int K>
cudaError_t launch_a(const ArgsA& a, cudaStream_t stream) {
  const int nc = channel_tile(kMode != kNone, a.cm);
  const int threads = threads_a(nc);
  const LayoutA L =
      layout_a(kMode, K, nc, threads, a.width, a.c_in, sizeof(Tx));
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = expand_dw_pool_kernel<Tx, Ty, kMode, K>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  const int n_bands = (a.height + a.band_rows - 1) / a.band_rows;
  const dim3 grid((a.cm + nc - 1) / nc, n_bands, a.batch);
  const bool aligned = reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  int vec = 0;
  if (kMode == kMma)
    vec = sizeof(Tx) == 2 && a.c_in % 8 == 0 && aligned;
  else if (kMode == kNone)
    vec = a.c_in % (16 / sizeof(Tx)) == 0 && aligned;
  kern<<<grid, threads, L.total, stream>>>(
      static_cast<const Tx*>(a.x), a.w, a.kexp, a.bexp, a.dwk,
      a.kdw, a.bdw, static_cast<Ty*>(a.y), n_bands > 1 ? a.part : a.pool,
      a.height, a.width, a.c_in, a.cm, a.band_rows, nc, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_bands == 1) return err;
  const int total = a.batch * a.cm;
  pool_bands_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                      stream>>>(a.part, a.pool, n_bands, a.cm, total);
  return cudaGetLastError();
}

template <typename Tx, typename Ty, int K>
cudaError_t dispatch_k(const ArgsA& a, int dot_bf16, cudaStream_t st) {
  if (a.w == nullptr) return launch_a<Tx, Ty, kNone, K>(a, st);
  return dot_bf16 ? launch_a<Tx, Ty, kMma, K>(a, st)
                  : launch_a<Tx, Ty, kFma, K>(a, st);
}

template <typename Tx, typename Ty>
cudaError_t dispatch_a(const ArgsA& a, int kernel, int dot_bf16,
                       cudaStream_t st) {
  if (kernel == 3) return dispatch_k<Tx, Ty, 3>(a, dot_bf16, st);
  if (kernel == 5) return dispatch_k<Tx, Ty, 5>(a, dot_bf16, st);
  return cudaErrorInvalidValue;
}

struct ArgsB {
  const void* y;
  const float* se;
  const void* wproj;   // packed bf16 fragments, or float32 [Cm, C']
  const float *kpr, *bpr;
  const void* res;
  int res_bf16;
  void* out;
  int batch, s_len, cm, c2;
};

template <typename Ty, typename To, int kNT>
cudaError_t launch_b_mma(const ArgsB& a, cudaStream_t stream) {
  const int n8 = (a.c2 + 7) / 8;
  const dim3 grid((a.s_len + kBM - 1) / kBM, (n8 + kNT - 1) / kNT, a.batch);
  if (grid.y > kMaxGrid) return cudaErrorInvalidValue;
  const int nt = n8 < kNT ? n8 : kNT;
  const size_t se_bytes =
      align16(sizeof(float) * round_up(a.cm, kBK));
  const size_t smem = kStages * stage_bytes_b(nt) + se_bytes;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = scale_project_kernel<Ty, To, kNT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int V = kVecOut<To>;
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_y = sizeof(Ty) == 2 && a.cm % 8 == 0 && al(a.y);
  // a chunk of 8·kNT channels starts at a multiple of V; the residual
  // must have out's dtype
  const int vec_out = a.c2 % V == 0 && al(a.out) &&
                      (a.res == nullptr ||
                       (al(a.res) && a.res_bf16 == (sizeof(To) == 2)));
  kern<<<grid, kThreadsB, smem, stream>>>(
      static_cast<const Ty*>(a.y), a.se, static_cast<const uint2*>(a.wproj),
      a.kpr, a.bpr, a.res, a.res_bf16, static_cast<To*>(a.out), a.s_len,
      a.cm, a.c2, vec_y, vec_out);
  return cudaGetLastError();
}

template <typename Ty, typename To, int kBN>
cudaError_t launch_b_f32(const ArgsB& a, cudaStream_t stream) {
  constexpr int kBMF = kThreadsB / (kBN / 2) * 8;
  const dim3 grid((a.c2 + kBN - 1) / kBN, (a.s_len + kBMF - 1) / kBMF,
                  a.batch);
  if (grid.y > kMaxGrid) return cudaErrorInvalidValue;
  scale_project_f32_kernel<Ty, To, kBN><<<grid, kThreadsB, 0, stream>>>(
      static_cast<const Ty*>(a.y), a.se, static_cast<const float*>(a.wproj),
      a.kpr, a.bpr, a.res, a.res_bf16, static_cast<To*>(a.out), a.s_len,
      a.cm, a.c2);
  return cudaGetLastError();
}

template <typename Ty, typename To>
cudaError_t launch_b(const ArgsB& a, int dot_bf16, cudaStream_t st) {
  if (dot_bf16)
    return a.c2 <= 32 ? launch_b_mma<Ty, To, 4>(a, st)
                      : launch_b_mma<Ty, To, 16>(a, st);
  return a.c2 <= 16 ? launch_b_f32<Ty, To, 16>(a, st)
                    : launch_b_f32<Ty, To, 32>(a, st);
}

}  // namespace

extern "C" {

// Both launchers run on `stream` (a cudaStream_t), allocate nothing, and
// return the cudaError_t of the attribute call or of the launches (0 =
// success). The caller has checked shapes, dtypes and contiguity; the
// launchers refuse (cudaErrorInvalidValue) a batch beyond the grid, and a
// width whose rows kernel A's shared memory cannot hold. With dot_bf16 the
// matrix weights `wexp` / `wproj` come packed in mma fragment order
// (pack_fragments in ops/pallas_mbconv.py), else as float32 [C, Cm] /
// [Cm, C']. wexp and res may be null (no expand; no residual). `part` is
// scratch [batch, bands, cm] for kernel A's per-band pools, used when an
// image has more than one band of band_rows rows
// (expand_dw_pool_band_rows).
int expand_dw_pool_launch(const void* x, int x_bf16, const void* wexp,
                          const void* kexp, const void* bexp, const void* dwk,
                          const void* kdw, const void* bdw, void* y,
                          int y_bf16, void* pool, void* part, int batch,
                          int height, int width, int c_in, int cm, int kernel,
                          int band_rows, int dot_bf16, void* stream) {
  if (batch < 1 || batch > kMaxGrid || height < 1 || width < 1 || c_in < 1 ||
      cm < 1 || band_rows < 1)
    return cudaErrorInvalidValue;
  const ArgsA a{x, wexp, static_cast<const float*>(kexp),
                static_cast<const float*>(bexp),
                static_cast<const float*>(dwk),
                static_cast<const float*>(kdw),
                static_cast<const float*>(bdw), y,
                static_cast<float*>(pool), static_cast<float*>(part), batch,
                height, width, c_in, cm, band_rows};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_bf16)
    return y_bf16 ? dispatch_a<bf, bf>(a, kernel, dot_bf16, st)
                  : dispatch_a<bf, float>(a, kernel, dot_bf16, st);
  return y_bf16 ? dispatch_a<float, bf>(a, kernel, dot_bf16, st)
                : dispatch_a<float, float>(a, kernel, dot_bf16, st);
}

// The rows per band kernel A takes for `batch` images of `height` rows and
// cm channels (expand: with an expand) on the current device, which sizes
// `part`; 0 if the device cannot be queried.
int expand_dw_pool_band_rows(int batch, int height, int cm, int expand) {
  int dev = 0, sm_count = 0;
  if (batch < 1 || height < 1 || cm < 1 ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 0;
  return band_rows_a(batch, height, cm, expand != 0, sm_count);
}

int scale_project_launch(const void* y, int y_bf16, const void* se,
                         const void* wproj, const void* kpr, const void* bpr,
                         const void* res, int res_bf16, void* out,
                         int out_bf16, int batch, int s_len, int cm, int c2,
                         int dot_bf16, void* stream) {
  if (batch < 1 || batch > kMaxGrid || s_len < 1 || cm < 1 || c2 < 1)
    return cudaErrorInvalidValue;
  const ArgsB a{y, static_cast<const float*>(se), wproj,
                static_cast<const float*>(kpr),
                static_cast<const float*>(bpr), res, res_bf16, out, batch,
                s_len, cm, c2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (y_bf16)
    return out_bf16 ? launch_b<bf, bf>(a, dot_bf16, st)
                    : launch_b<bf, float>(a, dot_bf16, st);
  return out_bf16 ? launch_b<float, bf>(a, dot_bf16, st)
                  : launch_b<float, float>(a, dot_bf16, st);
}

}  // extern "C"
