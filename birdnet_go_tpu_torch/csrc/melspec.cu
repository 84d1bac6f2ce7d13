// Fused mel spectrogram for Hopper (sm_90a): int16 PCM [B, T] → mel
// [B, F, n_mels] in float32 or bfloat16, with the config's magnitude scale.
//
// Replaces the TPU kernel melspec_fused in
// birdnet_go_tpu/ops/pallas_melspec.py and runs the same two-stage real DFT
// with the same constants (kernel_consts in
// birdnet_go_tpu_torch/ops/pallas_melspec.py, a port of _kernel_consts,
// rearranged per residue group by group_consts): frame sample n = a·128 + b;
// stage 1 is a 16-point DFT over a, packed by conjugate symmetry into 16 real
// rows (re S[0..8], im S[1..7]); stage 2 is, per residue r, a contraction
// over b of the packed rows against the twiddle pair for the J2 bin groups j
// that the filterbank uses (bin r + 16·j); then |X|² and the projection
// through the permuted filterbank.
//
// What bounds it: about 0.42 M float32 multiply-adds per frame at J2 = 40
// (stage 1: 128·16·16 = 33 K; stage 2: 16·40·128·4 = 328 K; mel: 16·40·96 =
// 61 K): 60 GFLOP for a [256, 144000] call, against 87 MB of PCM and mel
// rows (0.03 ms). Stage 2 is 78% of it, so it goes to the tensor cores with
// the mel projection; priced by type (stage 1 at the 67 TFLOP/s float32
// peak, the rest as 3xTF32 at 495 TFLOP/s), the bound is 0.41 ms:
//
// - Residue groups. The residues pair up by the packed rows they read:
//   (0, 8) on rows 0 and 8, and (g, 16 - g) on rows g and 8 + g. Per group,
//   stage 2 of both residues is one product A [M frames × 256] · B [256 ×
//   4·J2], with A the two rows interleaved by sample (k = 2·b + row; group
//   0, whose residues read one row each, is [row 0 | row 8]) and B the two
//   residues' twiddle pairs side by side (group_consts). Stage 1 computes
//   the group's two rows on CUDA cores into A; the 16 rows are each
//   computed once.
// - 3xTF32. A single TF32 pass keeps 10 mantissa bits and misses the float32
//   gate by up to 35x on loud tones (tests/test_torch_melspec.py emulates
//   both). Each operand x is split as hi = tf32(x), lo = tf32(x - hi), and
//   mma.sync m16n8k8 sums lo·hi + hi·lo + hi·hi in float32. Stage 2 sums in
//   two levels: runs of 16 k-terms, both rows' terms of 8 samples, go into
//   a fresh fragment that is then added to the total (a serial float32 sum
//   over 128 terms lost 1.2e-3 of a quiet band next to a loud tone; summing
//   each row's 128 terms apart before the rows cancel lost 2e-4 of a quiet
//   log band).
//   The mel projection, power [M × 2·J2] · filterbank [2·J2 × n_mels] per
//   group, runs on the same 3xTF32 MMA into accumulators that stay in
//   registers over all groups.
// - Operands. The twiddles and the filterbank are split into (hi, lo) pairs
//   once on the host; stage 1 splits A and the |X|² epilogue splits the
//   power tile as they are written to shared memory. Every fragment value
//   is then one 64-bit load and no arithmetic.
// - No barriers in stage 2. Each warp covers all M = 32 frames of the block
//   (two m16 tiles) for its own bins, so every twiddle pair is read once
//   per block, straight from L2 into registers, one k8 step ahead of the
//   MMAs that use it: no barrier holds the warps in step (staging twiddles
//   through shared memory needs one per chunk, and they cost more than the
//   MMAs did). Each twiddle pair read from L2 feeds 32 frames.
// - Shared memory per block: the PCM span as int16 ((M - 1)·hop + 2048
//   samples) and the A tile (M × 260 pairs), which holds the group's power
//   tile after its MMAs: 102 KB at hop 512, 110 KB at hop 640, two blocks
//   on an SM. Four barriers a group.
// Where the time goes (birdnet_go_tpu_torch/diag/mel_breakdown.py, H100
// SXM, bf16 out): at v2.4 [256, 144000], 2.34 ms in all, of which the
// stage-2 MMAs 0.74, stage 1 0.45 (the int16 loads and conversions, redone
// for each of the 8 groups), the mel MMAs 0.39 and the twiddle loads 0.34;
// at v3.0 [256, 160000], 2.91 ms, the stage-2 MMAs 1.00 and the twiddle
// loads 0.65 (8.6 GB of (hi, lo) pairs from L2 at 32 frames a block).
// Left for later work: wgmma and TMA (asynchronous MMAs on a tile of 64
// frames, which halves the twiddle traffic), and overlapping stage 1 with
// the MMAs inside a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kA = 16;                   // stage-1 radix (points over a)
constexpr int kB = 128;                  // stage-2 length (b)
constexpr int kNfft = kA * kB;           // 2048
constexpr int kM = 32;                   // frames per block: two m16 tiles
constexpr int kK = 2 * kB;               // stage-2 depth: two packed rows
constexpr int kGroups = kA / 2;          // residue groups
constexpr int kAPitch = kK + 4;          // A-tile row pitch in pairs,
                                         // ≡ 4 mod 16: conflict-free 64-bit
                                         // fragment loads (4·row + col)
constexpr int kStage1Threads = 2 * kB;   // stage 1: (b, frame parity)
constexpr int kMelMax = 3;               // at most, mel n8 tiles per warp
constexpr int kMaxJ2 = 72;               // 16·72 > 1025 bins

enum MagScale { kLinear = 0, kLog = 1, kDb = 2, kNonlinear = 3 };

__device__ __forceinline__ float scale_mag(float x, int mag, float off) {
  switch (mag) {
    case kLog: return logf(x + off);
    case kDb: return 10.0f * log10f(x + off);
    case kNonlinear: return powf(fmaxf(x, 0.0f), 1.0f / 1.3f);
    default: return x;
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to float32 rounding, both TF32 values
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a · b on the tensor cores: a 16×8 (row), b 8×8 (col), d 16×8 f32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a · b in 3xTF32, the small products first, then hi·hi; b0 and b1
// are B's two fragment values as (hi, lo) pairs, split on the host
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float2 b0,
                                     float2 b1) {
  const uint32_t h0 = __float_as_uint(b0.x), l0 = __float_as_uint(b0.y);
  const uint32_t h1 = __float_as_uint(b1.x), l1 = __float_as_uint(b1.y);
  mma_tf32(d, al, h0, h1);
  mma_tf32(d, ah, l0, l1);
  mma_tf32(d, ah, h0, h1);
}

__host__ __device__ constexpr int pcm_bytes(int hop) {
  return (((kM - 1) * hop + kNfft) * 2 + 15) / 16 * 16;
}

// x as a (hi, lo) pair: a 64-bit shared-memory load gives both halves
__device__ __forceinline__ float2 split_pair(float x) {
  uint32_t hi, lo;
  split(x, hi, lo);
  return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

// The A fragment of rows (r, r + 8), columns (c, c + 4) of a row-major tile
// of (hi, lo) pairs at p = &tile[r][c].
__device__ __forceinline__ void load_a(const float2* p, int pitch,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float2 v[4] = {p[0], p[8 * pitch], p[4], p[8 * pitch + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = __float_as_uint(v[i].x);
    al[i] = __float_as_uint(v[i].y);
  }
}

// Grid (frame tiles of kM, batch rows); block W warps, each covering both
// m16 tiles of the block's frames. In stage 2 warp w walks its units w + i·W
// (i < UPW) one after another, a unit being (residue h of the group, bin
// group q of 8): the re and im n8 tiles of those bins; it keeps only their
// power. In the mel projection it owns the n8 tiles of mel bands w + i·W
// (i < MELT). Dynamic shared memory: pcm int16
// [span] | A [kM][kAPitch] (hi, lo) pairs, which holds the power tile
// [kM][2·j2 + 4] pairs between a group's stage 2 and its mel projection.
// bg2 [8][256][4·j2] and fbg2 [8][2·j2][nm8] are (hi, lo) pairs in global
// memory (L2-resident: 2.6 MB at j2 = 40).
template <int W, int UPW, int MELT>
__global__ void __launch_bounds__(W * 32, 2)
melspec_kernel(const int16_t* __restrict__ pcm, int t_len, int hop,
               int n_frames, const float* __restrict__ win,
               const float* __restrict__ wpk, const float2* __restrict__ bg2,
               const float2* __restrict__ fbg2, int j2, int n_mels, int nm8,
               int mag, float log_offset, void* __restrict__ out,
               int out_bf16) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* u = reinterpret_cast<int16_t*>(smem);
  float2* a2 = reinterpret_cast<float2*>(smem + pcm_bytes(hop));
  float2* pw2 = a2;                        // the power tile, after stage 2

  const int row = blockIdx.y;
  const int f0 = blockIdx.x * kM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;               // fragment row (and B column)
  const int tig = lane & 3;                // fragment column (and B row)
  const int jq = j2 / 8;                   // bin groups per residue
  const int bw = 4 * j2;                   // bg2 row length
  const int ppitch = 2 * j2 + 4;           // ≡ 4 mod 16, as kAPitch

  // PCM span → shared memory as int16; samples past the end of the signal
  // are 0 (they only feed frames >= n_frames, which are never written)
  {
    const int span = (kM - 1) * hop + kNfft;
    const long long t0 = static_cast<long long>(f0) * hop;
    const int16_t* src = pcm + static_cast<long long>(row) * t_len;
    for (int i = tid; i < span; i += W * 32) {
      const long long t = t0 + i;
      u[i] = t < t_len ? src[t] : static_cast<int16_t>(0);
    }
  }
  const int b1 = tid & (kB - 1);            // stage 1: sample b
  // this warp's stage-2 units: re column of the lane's B fragment in a
  // bg2 row (the im column is j2 further), residue h, power column; -1 = none
  int ucol[UPW], uh[UPW], upow[UPW];
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    const int v = warp + i * W;
    const int h = v / jq, q = v - h * jq;
    ucol[i] = v < 2 * jq ? h * 2 * j2 + q * 8 + gid : -1;
    uh[i] = h;
    upow[i] = h * j2 + q * 8 + 2 * tig;
  }
  // this warp's mel n8 tiles: column of the lane's B fragment; -1 = none
  int mcol[MELT];
#pragma unroll
  for (int i = 0; i < MELT; ++i) {
    const int nt = warp + i * W;
    mcol[i] = nt * 8 < nm8 ? nt * 8 + gid : -1;
  }

  float mel[MELT][2][4];
#pragma unroll
  for (int i = 0; i < MELT; ++i)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) mel[i][m][e] = 0.0f;

  for (int g = 0; g < kGroups; ++g) {
    // stage 1 for packed rows g and 8 + g, summed over a in order, two
    // frames at a time; A holds each value as its (hi, lo) pair
    __syncthreads();                       // PCM in place; A free
    if (tid < kStage1Threads) {
      // the window at b times 1/32768 (exact), and the two rows of wpk
      float wv[kA], w1[kA], w2[kA];
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        wv[a] = __ldg(win + a * kB + b1) * (1.0f / 32768.0f);
        w1[a] = __ldg(wpk + g * kA + a);
        w2[a] = __ldg(wpk + (kA / 2 + g) * kA + a);
      }
      for (int f = tid >> 7; f < kM; f += 4) {
        float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
        for (int a = 0; a < kA; ++a) {
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            const float xa =
                static_cast<float>(u[(f + 2 * d) * hop + a * kB + b1]) * wv[a];
            s[d][0] = fmaf(w1[a], xa, s[d][0]);
            s[d][1] = fmaf(w2[a], xa, s[d][1]);
          }
        }
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          float2* at = a2 + (f + 2 * d) * kAPitch;
          const float2 p1 = split_pair(s[d][0]), p2 = split_pair(s[d][1]);
          if (g == 0) {                    // [row 0 | row 8]
            at[b1] = p1;
            at[kB + b1] = p2;
          } else {                         // k = 2·b + row
            *reinterpret_cast<float4*>(at + 2 * b1) =
                make_float4(p1.x, p1.y, p2.x, p2.y);
          }
        }
      }
    }
    __syncthreads();                       // A ready

    // stage 2, one unit at a time: total += (partial over 16 k-terms) per
    // m16 tile, re and im; B fragments come from L2 one k8 step ahead of
    // their MMAs. Group 0 is block-diagonal: residue 0 on k < 128, 8 on
    // k >= 128.
    const float2* bsrc = bg2 + static_cast<size_t>(g) * kK * bw +
                         static_cast<size_t>(tig) * bw;
    float pw[UPW][2][4];                   // |X|² of each unit
#pragma unroll
    for (int i = 0; i < UPW; ++i) {
      if (ucol[i] < 0) continue;
      const int k_lo = g == 0 && uh[i] == 1 ? kB : 0;
      const int k_hi = g == 0 && uh[i] == 0 ? kB : kK;
      float tot[2][2][4], part[2][2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int v = 0; v < 4; ++v) tot[m][e][v] = part[m][e][v] = 0.0f;
      const float2* bp = bsrc + ucol[i];
      float2 bcur[2][2], bnext[2][2];
      auto load_b = [&](float2 (&b)[2][2], int k0) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          b[e][0] = __ldg(bp + static_cast<size_t>(k0) * bw + e * j2);
          b[e][1] = __ldg(bp + static_cast<size_t>(k0 + 4) * bw + e * j2);
        }
      };
      load_b(bcur, k_lo);
#pragma unroll 2
      for (int k0 = k_lo; k0 < k_hi; k0 += 8) {
        if (k0 + 8 < k_hi) load_b(bnext, k0 + 8);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t ah[4], al[4];
          load_a(a2 + (m * 16 + gid) * kAPitch + k0 + tig, kAPitch, ah, al);
#pragma unroll
          for (int e = 0; e < 2; ++e)
            mma3(part[m][e], ah, al, bcur[e][0], bcur[e][1]);
        }
        if (k0 & 8) {                      // every 16 k-terms
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                tot[m][e][v] += part[m][e][v];
                part[m][e][v] = 0.0f;
              }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bcur[e][0] = bnext[e][0];
          bcur[e][1] = bnext[e][1];
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          pw[i][m][v] = tot[m][0][v] * tot[m][0][v] +
                        tot[m][1][v] * tot[m][1][v];
    }
    __syncthreads();                       // A read: the power tile may go

    // power → [kM][2·j2] pairs (residue h at column h·j2 + j)
#pragma unroll
    for (int i = 0; i < UPW; ++i) {
      if (ucol[i] < 0) continue;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          pw2[(m * 16 + gid + (v >> 1) * 8) * ppitch + upow[i] + (v & 1)] =
              split_pair(pw[i][m][v]);
    }
    __syncthreads();

    // mel += power · fbg[g], 3xTF32
    const float2* fb = fbg2 + static_cast<size_t>(g) * 2 * j2 * nm8 +
                       static_cast<size_t>(tig) * nm8;
    for (int k0 = 0; k0 < 2 * j2; k0 += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        load_a(pw2 + (m * 16 + gid) * ppitch + k0 + tig, ppitch, ah[m],
               al[m]);
      const float2* fk = fb + static_cast<size_t>(k0) * nm8;
#pragma unroll
      for (int i = 0; i < MELT; ++i) {
        if (mcol[i] < 0) continue;
        const float2 b0 = __ldg(fk + mcol[i]);
        const float2 b1v = __ldg(fk + 4 * nm8 + mcol[i]);
#pragma unroll
        for (int m = 0; m < 2; ++m) mma3(mel[i][m], ah[m], al[m], b0, b1v);
      }
    }
  }

  // magnitude scale and store: lane holds frames (gid, gid + 8) of each m16
  // tile and bands (2·tig, 2·tig + 1) of each n8 tile
#pragma unroll
  for (int i = 0; i < MELT; ++i) {
    if (mcol[i] < 0) continue;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = f0 + m * 16 + gid + (e >> 1) * 8;
        const int n = mcol[i] - gid + 2 * tig + (e & 1);
        if (f >= n_frames || n >= n_mels) continue;
        const float v = scale_mag(mel[i][m][e], mag, log_offset);
        const size_t o =
            (static_cast<size_t>(row) * n_frames + f) * n_mels + n;
        if (out_bf16)
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
        else
          static_cast<float*>(out)[o] = v;
      }
  }
}

template <int W, int UPW, int MELT>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const int16_t* pcm, int t_len, int hop, int n_frames,
                   const float* win, const float* wpk, const float2* bg2,
                   const float2* fbg2, int j2, int n_mels, int nm8, int mag,
                   float log_offset, void* out, int out_bf16) {
  cudaError_t err = cudaFuncSetAttribute(
      melspec_kernel<W, UPW, MELT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  melspec_kernel<W, UPW, MELT><<<grid, W * 32, smem, stream>>>(
      pcm, t_len, hop, n_frames, win, wpk, bg2, fbg2, j2, n_mels, nm8, mag,
      log_offset, out, out_bf16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t), allocates nothing, and returns the
// cudaError_t of the attribute call or of the launch (0 = success). The
// caller has checked shapes, dtypes, contiguity and the config; bg2 and
// fbg2 are group_consts' [8, 256, 4·j2] and [8, 2·j2, n_mels rounded up to
// 8] split into (hi, lo) pairs. Refused (cudaErrorInvalidValue): j2 not a
// multiple of 8 or above 72, and more mel bands than the warps'
// accumulators hold (3 n8 tiles a warp: 240 at the 10 warps of j2 = 40,
// else 192).
int melspec_fused_launch(const void* pcm, int batch, int t_len, int hop,
                         int n_frames, const void* win, const void* wpk,
                         const void* bg2, const void* fbg2, int j2,
                         int n_mels, int mag, float log_offset, void* out,
                         int out_bf16, void* stream) {
  const int nm8 = (n_mels + 7) / 8 * 8;
  // stage-2 units: 2 residues × j2/8 bin groups; 10 warps where that
  // divides them evenly (j2 = 40), else 8
  const int units = j2 / 4;
  const int warps = units % 10 == 0 ? 10 : 8;
  const int upw = (units + warps - 1) / warps;
  const int melt = (nm8 / 8 + warps - 1) / warps;
  if (j2 <= 0 || j2 % 8 || j2 > kMaxJ2 || melt > kMelMax)
    return static_cast<int>(cudaErrorInvalidValue);
  // 102 KB at hop 512, 110 KB at hop 640: two blocks on an SM
  const size_t smem = pcm_bytes(hop) + sizeof(float2) * kM * kAPitch;
  const dim3 grid((n_frames + kM - 1) / kM, batch);
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const int16_t*>(pcm);
  auto w = static_cast<const float*>(win);
  auto k = static_cast<const float*>(wpk);
  auto b = static_cast<const float2*>(bg2);
  auto f = static_cast<const float2*>(fbg2);
  cudaError_t err;
#define MEL_LAUNCH(N, U, T)                                                  \
  launch<N, U, T>(grid, smem, s, p, t_len, hop, n_frames, w, k, b, f, j2,    \
                  n_mels, nm8, mag, log_offset, out, out_bf16)
  // the mel accumulators of 1 or 2 tiles a warp take the 2-tile kernel
  if (warps == 10)
    err = melt <= 2 ? MEL_LAUNCH(10, 1, 2) : MEL_LAUNCH(10, 1, 3);
  else if (upw == 1)
    err = melt <= 2 ? MEL_LAUNCH(8, 1, 2) : MEL_LAUNCH(8, 1, 3);
  else if (upw == 2)
    err = melt <= 2 ? MEL_LAUNCH(8, 2, 2) : MEL_LAUNCH(8, 2, 3);
  else
    err = melt <= 2 ? MEL_LAUNCH(8, 3, 2) : MEL_LAUNCH(8, 3, 3);
#undef MEL_LAUNCH
  return static_cast<int>(err);
}

const char* birdnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
