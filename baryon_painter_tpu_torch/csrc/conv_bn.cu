// K4: train-mode conv (or transposed conv) + batch norm + ReLU, forward and
// backward, hand-written for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of `fused_conv_bn_relu` in
// baryon_painter_tpu/ops/pallas_conv_bn.py: `_stats_kernel` (K4-stats),
// `_fwd_kernel` (K4-fwd), `_bwd1_kernel` (K4-bwd1) and `_bwd2_kernel`
// (K4-bwd2). With u = conv(x, w) the logical convolution (no bias), batch
// statistics over (N, H, W) per output channel, a = gamma * inv and
// b = beta - mean * a (inv = rsqrt(var + eps), formed by the wrapper):
//
//   K4-stats: u, written into the buffer that K4-fwd turns into y, and
//             per-block partial sums of u and u^2 per channel
//   K4-fwd:   y = max(u * a + b, 0), in place over u
//   K4-bwd1:  u again, written to a scratch tensor, and per-block partial
//             sums of dv and dv * uhat per channel, where dv = dy if y > 0
//             else 0 (the forward's ReLU mask) and uhat = (u - mean) * inv
//   K4-bwd2:  du = a * (dv - S1/n - uhat * S2/n) from u, y and dy; dx = the
//             adjoint conv of du; dW as partial sums over a fixed split of
//             the pixels
//
// The partial sums are written per block (bwd2: per split) and summed by the
// wrapper in torch (K4-stats' in f64); no atomics are used, so every result
// is deterministic.
//
// Two families of convolution, NCHW f32, computed directly (no
// space-to-depth, no phase-major weights):
//   S == 1: stride-1 "same" conv, odd K, P = (K - 1) / 2, w OIHW
//           (Cout, Cin, K, K); output (N, Cout, H, W).
//   S >  1: transposed conv with K = 2S and P = S/2, w IOHW (Cin, Cout, K, K)
//           as torch's conv_transpose2d takes it; output (N, Cout, S H, S W).
//           Fine output row oy takes the two coarse rows
//           iy = (oy + P) / S - t, t = 0, 1, with kernel row
//           ky = (oy + P) % S + S t; the same for columns. So each of the
//           S^2 output phases (oy % S, ox % S) is a 2 x 2 conv on the coarse
//           grid with its own sub-kernel, and the adjoint (dx) is a stride-S
//           conv of du with the whole K x K kernel: du at S iy + ky - P.
//
// Four implicit GEMMs a site run on the tensor cores, bounded by the tensor
// cores at 3xTF32 (sites B, C) or by memory (A, D):
//   u (stats, bwd1): M = output pixels of one phase, N = Cout,
//                    K = Cin x taps
//   bwd2 (dx):       M = input pixels, N = Cin, K = Cout x K^2
//   bwd2 (dW):       M = Cout, N = Cin x taps of one phase, K = output pixels
// Each f32 operand v is split into big = tf32(v) (cvt.rna) and small =
// tf32(v - big), and the product accumulates small*big + big*small +
// big*big in f32 (mma.sync m16n8k8 tf32): about f32's accuracy at three
// times the tensor-core work. The tensor cores' accumulators round toward
// zero, so the u and dx GEMMs sum each k-step from zero and dW each K
// chunk, and add that sum to the running sum by an ordinary f32 add (the
// error no longer grows with K, and u no longer drifts toward zero).
//   - Staging: each K chunk is copied raw into shared memory with cp.async
//     (16 bytes a copy where rows allow), through a ring of 2 to 4 stages
//     sized so two blocks share an SM; the next chunks' copies fly while
//     the current one is split into big/small (and, for du, formed from u,
//     y and dy) and multiplied. The im2col of the implicit GEMM is a table
//     of shared-memory offsets, one per K index, added to each thread's
//     pixel offset in the staged footprint.
//   - u GEMM and dx: a block of 8 warps owns an 8 R x 16 pixel tile and up
//     to 64 columns; a warp owns R pixel rows (R = 2 where the columns fill
//     at most 4 n8 tiles, so the B fragments serve two rows).
//   - stats and bwd1 are one kernel template (u_gemm_kernel) that differs
//     only in its epilogue: stats sums u and u^2, bwd1 dv and dv * uhat,
//     both from the accumulators as u is stored, over the pixels inside the
//     image. One mainloop with one K order, so the u behind the batch
//     statistics and the forward's mask is, bit for bit, the u bwd1
//     recomputes for bwd2 (u is never recomputed with a halo). The ReLU
//     mask of the backward is y > 0, the forward's own.
//   - K4-fwd is a pass over u in place, float4 groups a thread, one block
//     per (plane, run of groups), so a block loads its channel's a and b
//     once; bounded by memory (u read, y written). Writing u once and
//     reading it back costs less than a second tensor-core pass of the
//     conv, and y takes u's buffer, so the forward needs no more memory
//     than y.
//   - du is formed while staging, in shared memory, never in device memory.
//   - dW: a block owns a tile of dW (up to 64 output channels x a tile of
//     input channels x the taps of one phase) and accumulates in registers
//     over its split's run of consecutive chunks of 2 rows x 16 to 64
//     columns; it writes one partial per split (at most kMaxSplit a site),
//     which the wrapper sums. Where the (m16, n8) tiles are few the warps
//     split the chunk's K steps and add their sums at the end.
//
// bf16 (the JAX package's default compute dtype), the same four kernels
// templated on the element type T of x, w, y, dy and dx, with the JAX
// kernels' rounding points: u, its sums, S1 and S2 and the dW partials stay
// f32; K4-fwd writes y = bf16(max(u a + b, 0)) from the f32 u into a new
// bf16 tensor (y is 2 bytes an element, u 4, so it cannot take u's
// buffer); du is rounded to bf16 where it is formed, before both of its
// products; dx is rounded once from its f32 sum. The GEMMs run one pass of
// mma.sync m16n8k16 bf16 (the products of two bf16 values are exact in
// f32), each k16 step summed from zero and added in f32 as above. A bf16
// fragment register holds two adjacent K elements in one 32-bit word, so
// each GEMM orders K in pairs and stages the pairs as words:
//   - u GEMM: K = (tap, channel pair), channel pairs fastest; x is staged
//     raw, then converted into planes of channel pairs (a word per
//     footprint position, Cin = 3 padded to 4 with zeros in shared memory),
//     8 mod 32 words apart; the weights as (K pair, column) words.
//   - dx: K = (tap, output-channel pair); du is formed from the staged u,
//     y and dy into planes of channel pairs.
//   - dW: K = pixels; a chunk's rows are an even number of pixels, so a
//     pixel pair is one word of du; x is converted into a word at every
//     footprint position holding it and its right neighbour, so the pair
//     at any tap offset, even or odd, is one aligned word.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (baryon_painter_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"

namespace {

// a bfloat16 tensor element, read and written as its 16 bits (the top half
// of an f32)
typedef uint16_t bf16;

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

// wait until at most n (0 to 3) copy groups are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // bytes a block may use

template <int S, int K>
struct Geo {
  static_assert(S == 1 ? (K % 2 == 1) : (K == 2 * S && S % 2 == 0),
                "unsupported conv family");
  static constexpr int P = S == 1 ? (K - 1) / 2 : S / 2;
};

// Weight of (co, ci, ky, kx) in the family's layout.
template <int S, int K>
__host__ __device__ __forceinline__ size_t w_index(int co, int ci, int ky,
                                                   int kx, int cin,
                                                   int cout) {
  return S == 1 ? (((size_t)co * cin + ci) * K + ky) * K + kx
                : (((size_t)ci * cout + co) * K + ky) * K + kx;
}

// ------------------------------------------------------------------------ //
// The implicit GEMMs on the tensor cores in 3xTF32: u (K4-stats, K4-bwd1),
// dx and dW (K4-bwd2)

constexpr int kTH = 8;        // pixel tile of the u GEMM and dx: 8 R x 16
constexpr int kTW = 16;
constexpr int kNT = 64;       // output columns of a u GEMM or dx block
constexpr int kMW = 64;       // output channels (rows) of a dW block
// columns of a dW K chunk (2 rows): where a block's du tile has 16 rows, 64
// for the "same" conv and 32 for the transposed conv (whose x tile holds a
// block's 32 input channels); 16 for more rows. So shared memory leaves
// two blocks an SM.
constexpr int kDwWide = 64;
constexpr int kDwMid = 32;
constexpr int kDwNarrow = 16;
constexpr int kMaxSplit = 64; // partial dW a site, at most

__host__ __device__ constexpr int rup(int v, int m) {
  return (v + m - 1) / m * m;
}
__host__ __device__ constexpr int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
// row stride of a [k][n] B tile with n columns: 8 mod 32 (or n == 8), so
// the fragment loads of a warp hit 32 distinct banks
__host__ __device__ constexpr int ldb(int n) {
  return n <= 8 ? 8 : rup(n, 32) + 8;
}

template <int S, int K>
struct Bwd {
  static constexpr int P = Geo<S, K>::P;
  static constexpr int PH = S == 1 ? 1 : S * S;  // output phases
  static constexpr int TW1 = S == 1 ? K : 2;     // taps a dimension, a phase
  static constexpr int T1 = TW1 * TW1;
  static constexpr int T2 = K * K;               // taps of the adjoint
  // x footprint of t rows (columns) of a phase's grid; du footprint of t
  // rows (columns) of the input grid
  __host__ __device__ static constexpr int fx(int t) { return t + TW1 - 1; }
  __host__ __device__ static constexpr int fd(int t) {
    return S == 1 ? t + K - 1 : S * (t - 1) + K;
  }
  // a footprint row of n columns as staged: from the multiple of 4 at or
  // before its first column, whole groups of 4
  __host__ __device__ static constexpr int wa(int n) { return rup(n + 3, 4); }
  // input channels a bwd1 K chunk (K = CIC x T1, about 100 or 64)
  static constexpr int CIC = S == 1 ? clampi(100 / T1, 1, 16) : 8;
  static constexpr int KC1 = rup(CIC * T1, 8);
  // output channels a dx K chunk (K = COC x T2)
  static constexpr int COC =
      S == 1 ? clampi(104 / T2, 1, 8) : clampi(32 / T2, 1, 8);
  static constexpr int KC2 = rup(COC * T2, 8);
  // input channels a dW block (N = CIW x T1)
  static constexpr int CIW = S == 1 ? CIC : 32;
  static constexpr int NW = rup(CIW * T1, 8);
  // bwd1's x and dx's du footprint, a channel, for tiles of 8 R rows
  __host__ __device__ static constexpr int fx1(int R) {
    return fx(kTH * R) * wa(fx(kTW));
  }
  __host__ __device__ static constexpr int fdd(int R) {
    return fd(kTH * R) * wa(fd(kTW));
  }
  // dW x, a channel, for chunks of dwc columns
  __host__ __device__ static constexpr int fxw(int dwc) {
    return fx(2) * wa(fx(dwc));
  }
  static_assert(CIW * T1 <= 128, "dW block wider than 16 n8 tiles");
};

// The phase (ry, rx) = (oy % S, ox % S) of a transposed conv: its first
// coarse row offset off = (r + P) / S and sub-kernel origin (r + P) % S.
template <int S, int K>
struct Phase {
  int ry = 0, rx = 0, offy = 0, offx = 0, ky0 = 0, kx0 = 0;
  __device__ explicit Phase(int ph) {
    if (S > 1) {
      constexpr int P = Geo<S, K>::P;
      ry = ph / S;
      rx = ph % S;
      offy = (ry + P) / S;
      offx = (rx + P) / S;
      ky0 = (ry + P) % S;
      kx0 = (rx + P) % S;
    }
  }
  // kernel entry of tap t (t / TW1, t % TW1) of this phase
  __device__ int ky(int t) const {
    return S == 1 ? t / K : ky0 + S * (t / 2);
  }
  __device__ int kx(int t) const {
    return S == 1 ? t % K : kx0 + S * (t % 2);
  }
};

// Shared-memory offset of tap t in an x footprint of row stride fw, for the
// u GEMM: x at (q + t / TW1 - P) for S == 1, at (q + off - t / 2) for S > 1.
template <int S, int K>
__device__ __forceinline__ int x_tap(int t, int fw) {
  constexpr int TW1 = Bwd<S, K>::TW1;
  const int o = (t / TW1) * fw + t % TW1;
  return S == 1 ? o : -o;
}
// A pixel's offset (tile row r, column c) in that footprint, first tap.
template <int S>
__device__ __forceinline__ int x_pix(int r, int c, int fw) {
  return S == 1 ? r * fw + c : (r + 1) * fw + c + 1;
}

__device__ __forceinline__ void split_store(float v, float* hi, float* lo,
                                            int i) {
  const float h = tf32_rna(v);
  hi[i] = h;
  lo[i] = tf32_rna(v - h);
}

// split_store of 4 values at i4 (in float4s); hi, lo 16-byte aligned
__device__ __forceinline__ void split_store4(const float (&v)[4], float* hi,
                                             float* lo, int i4) {
  float4 h, l;
  h.x = tf32_rna(v[0]);
  h.y = tf32_rna(v[1]);
  h.z = tf32_rna(v[2]);
  h.w = tf32_rna(v[3]);
  l.x = tf32_rna(v[0] - h.x);
  l.y = tf32_rna(v[1] - h.y);
  l.z = tf32_rna(v[2] - h.z);
  l.w = tf32_rna(v[3] - h.w);
  reinterpret_cast<float4*>(hi)[i4] = h;
  reinterpret_cast<float4*>(lo)[i4] = l;
}

__device__ __forceinline__ void load4(const float* a, int i4, float (&v)[4]) {
  const float4 t = reinterpret_cast<const float4*>(a)[i4];
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// Stage nch planes' windows of FH rows x 4 NC4 columns from (ay, ax), ax a
// multiple of 4, into dst[c][FH][4 NC4], zero outside the h x w image;
// plane(c) is channel c's image. Rows of a w % 4 == 0 image take one
// 16-byte copy a group of 4 columns (each group lies wholly inside or
// outside the image), others four 4-byte copies.
template <int FH, int NC4, class Plane>
__device__ __forceinline__ void stage_window(float* dst, int nch, int ay,
                                             int ax, int h, int w,
                                             Plane&& plane) {
  const bool wide = (w & 3) == 0;
  for (int i = threadIdx.x; i < nch * FH * NC4; i += kThreads) {
    const int r = i / NC4;
    const int gy = ay + r % FH;
    const int gx = ax + 4 * (i % NC4);
    const float* p = plane(r / FH);
    float* d = dst + 4 * i;
    const bool row = gy >= 0 && gy < h;
    if (wide) {
      const bool ok = row && gx >= 0 && gx < w;
      cp_async16(d, ok ? p + (size_t)gy * w + gx : p, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row && gx + e >= 0 && gx + e < w;
        cp_async4(d + e, ok ? p + (size_t)gy * w + gx + e : p, ok);
      }
    }
  }
}

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }

// v rounded to bf16 to nearest even, as Tensor.to(torch.bfloat16) rounds
// (a NaN stays a NaN): its 16 bits in the low half of the word
__device__ __forceinline__ uint32_t bf16_rne(float v) {
  const uint32_t b = __float_as_uint(v);
  if ((b & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return (b + 0x7fffu + ((b >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ float bf16_f32(uint32_t h) {
  return __uint_as_float(h << 16);
}

// element i of a T tensor as f32, through the read-only cache
__device__ __forceinline__ float ld_f32(const float* p, size_t i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float ld_f32(const bf16* p, size_t i) {
  return bf16_f32(__ldg(p + i));
}

// p[i] = v in T (bf16: rounded to nearest even)
__device__ __forceinline__ void st_t(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void st_t(bf16* p, size_t i, float v) {
  p[i] = (bf16)bf16_rne(v);
}

// The bf16 GEMMs' K chunks, in pairs of K elements (8 pairs a k16 step):
// the u GEMM's K = taps x channel pairs of CIC channels (even), dx's K =
// taps x pairs of COC output channels (even); padded to whole k16 steps.
template <int S, int K>
struct BwdB {
  using B = Bwd<S, K>;
  static constexpr int CIC = S == 1 ? rup(clampi(100 / B::T1, 1, 16), 2) : 16;
  static constexpr int NP1 = CIC / 2 * B::T1;
  static constexpr int KP1 = rup(NP1, 8);
  static constexpr int COC = S == 1 ? rup(clampi(104 / B::T2, 1, 8), 2) : 2;
  static constexpr int NP2 = COC / 2 * B::T2;
  static constexpr int KP2 = rup(NP2, 8);
  // a staged bf16 row of n columns: from the multiple of 8 at or before its
  // first column, whole 16-byte groups
  __host__ __device__ static constexpr int wa8(int n) { return rup(n + 7, 8); }
  // words of a pair plane of n positions, 8 mod 32: the planes a warp's
  // four tig read start 8 banks apart
  __host__ __device__ static constexpr int plane(int n) {
    return n + (40 - n % 32) % 32;
  }
};

// stage_window for bf16 planes: FH rows x 8 NG8 columns from (ay, ax), ax a
// multiple of 8, into dst[c][FH][8 NG8], zero outside the image. Rows of a
// w % 8 == 0 image take one 16-byte copy a group of 8 columns; others are
// read an element at a time by plain loads (the ring's barrier orders them
// as it orders the copies).
template <int FH, int NG8, class Plane>
__device__ __forceinline__ void stage_window_bf(bf16* dst, int nch, int ay,
                                                int ax, int h, int w,
                                                Plane&& plane) {
  const bool wide = (w & 7) == 0;
  for (int i = threadIdx.x; i < nch * FH * NG8; i += kThreads) {
    const int r = i / NG8;
    const int gy = ay + r % FH;
    const int gx = ax + 8 * (i % NG8);
    const bf16* p = plane(r / FH);
    bf16* d = dst + 8 * i;
    const bool row = gy >= 0 && gy < h;
    if (wide) {
      const bool ok = row && gx >= 0 && gx < w;
      cp_async16(d, ok ? p + (size_t)gy * w + gx : p, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool ok = row && gx + e >= 0 && gx + e < w;
        d[e] = ok ? p[(size_t)gy * w + gx + e] : (bf16)0;
      }
    }
  }
}

// One K chunk of a bf16 GEMM whose rows are 16 pixels of a tile row (the u
// GEMM, dx), R rows a warp: acc[R == 1 ? j : 4 r + j] += A B for each n8
// tile j < nj (at most 4 where R = 2). A's pair (row's pixel, K pair k) is
// the word ap[pix[row] + koff[k]], B's (K pair k, column n) bp[k ld + n];
// kp pairs, each k16 step summed from zero and added in f32 (mma3_add).
template <int R>
__device__ __forceinline__ void pair_rows_mma(
    float (&acc)[8][4], const uint32_t* ap, const int* koff,
    const uint32_t* bp, int ld, int kp, const int (&p0)[R],
    const int (&p1)[R], int nj, int g, int tig) {
  constexpr int NJ = R == 1 ? 8 : 4;
  for (int kk = 0; kk < kp; kk += 8) {
    const int o0 = koff[kk + tig];
    const int o1 = koff[kk + tig + 4];
    uint32_t a[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      a[r][0] = ap[p0[r] + o0];
      a[r][1] = ap[p1[r] + o0];
      a[r][2] = ap[p0[r] + o1];
      a[r][3] = ap[p1[r] + o1];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
        const int b0 = (kk + tig) * ld + 8 * j + g;
        const uint32_t b[2] = {bp[b0], bp[b0 + 4 * ld]};
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(t, a[r], b);
          float(&c)[4] = acc[R == 1 ? j : 4 * r + j];
#pragma unroll
          for (int e = 0; e < 4; ++e) c[e] += t[e];
        }
      }
    }
  }
}

// i / d and i % d for 0 <= i < 2^20 and a runtime d, through d's float
// reciprocal (exact in that range; an integer division is ~20 instructions)
__device__ __forceinline__ int div_by(int i, float rd, int d, int& rem) {
  const int q = (int)(((float)i + 0.5f) * rd);
  rem = i - q * d;
  return q;
}

// The A fragment (rows g, g + 8; columns tig, tig + 4) of a pixel-row GEMM:
// element (row, k) lies at pix[row] + koff[k] in hi / lo.
__device__ __forceinline__ void load_a(uint32_t (&ah)[4], uint32_t (&al)[4],
                                       const float* hi, const float* lo,
                                       int p0, int p1, int k0, int k1) {
  const int i[4] = {p0 + k0, p1 + k0, p0 + k1, p1 + k1};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    ah[r] = bits(hi[i[r]]);
    al[r] = bits(lo[i[r]]);
  }
}

// The tensor cores accumulate with truncation, not f32's rounding to
// nearest, so a sum carried across k-steps in their accumulator drifts
// toward zero. dW's accumulators sum one K chunk from zero and each chunk's
// sum is added to the running f32 sum by an ordinary add.
__device__ __forceinline__ void add_chunk(float (&acc)[8][4],
                                          float (&part)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] += part[j][e];
      part[j][e] = 0.f;
    }
}

// acc += one k-step's 3xTF32 product, summed from zero on the tensor cores
// and added by an ordinary f32 add (the u and dx GEMMs): each k-step's sum
// is truncated once, so u carries no drift toward zero into the batch
// statistics (summed over a chunk of 4 to 13 k-steps, u at site A lost
// about 6e-7 of its scale on average; summed a k-step at a time 4e-8, with
// a smaller spread than an f32 FMA chain's).
__device__ __forceinline__ void mma3_add(float (&acc)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(t, ah, al, bh, bl);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// One K chunk of a GEMM whose rows are 16 pixels of a tile row (u, dx):
// acc[j] += A[rows][0..kc) B[0..kc)[8 j ..] for each n8 tile j < nj.
__device__ __forceinline__ void pixel_row_mma(
    float (&acc)[8][4], const float* ahi, const float* alo, const int* koff,
    const float* bhi, const float* blo, int ld, int kc, int p0, int p1,
    int nj, int g, int tig) {
  for (int kk = 0; kk < kc; kk += 8) {
    uint32_t ah[4], al[4];
    load_a(ah, al, ahi, alo, p0, p1, koff[kk + tig], koff[kk + tig + 4]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nj) {
        const int b0 = (kk + tig) * ld + 8 * j + g;
        const int b1 = b0 + 4 * ld;
        const uint32_t bh[2] = {bits(bhi[b0]), bits(bhi[b1])};
        const uint32_t bl[2] = {bits(blo[b0]), bits(blo[b1])};
        mma3_add(acc[j], ah, al, bh, bl);
      }
    }
  }
}

// pixel_row_mma for a warp that owns two tile rows (R = 2) and at most 4 n8
// tiles: acc[4 r + j] for row r, and the B fragments serve both rows.
__device__ __forceinline__ void pixel_rows2_mma(
    float (&acc)[8][4], const float* ahi, const float* alo, const int* koff,
    const float* bhi, const float* blo, int ld, int kc, const int (&p0)[2],
    const int (&p1)[2], int nj, int g, int tig) {
  for (int kk = 0; kk < kc; kk += 8) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      load_a(ah[r], al[r], ahi, alo, p0[r], p1[r], koff[kk + tig],
             koff[kk + tig + 4]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < nj) {
        const int b0 = (kk + tig) * ld + 8 * j + g;
        const int b1 = b0 + 4 * ld;
        const uint32_t bh[2] = {bits(bhi[b0]), bits(bhi[b1])};
        const uint32_t bl[2] = {bits(blo[b0]), bits(blo[b1])};
        mma3_add(acc[j], ah[0], al[0], bh, bl);
        mma3_add(acc[4 + j], ah[1], al[1], bh, bl);
      }
    }
  }
}

// Rows a warp owns in bwd1 and dx: 2 where the block's output columns fill
// at most 4 n8 tiles (the B fragments then serve two rows), else 1.
__host__ __device__ constexpr int rows_for(int ntv) {
  return ntv <= 32 ? 2 : 1;
}

template <typename F>
int with_rows(int ntv, F&& f) {
  if (rows_for(ntv) == 2) return f(std::integral_constant<int, 2>{});
  return f(std::integral_constant<int, 1>{});
}

// The K loop of a block over chunks [c0, c1) through a ring of `stages`
// raw buffers (2 to 4): issue(c, slot) starts chunk c's asynchronous copies
// into slot, `stages - 1` chunks ahead; step(c, slot) runs once chunk c has
// landed (it converts, synchronises and multiplies). The slot issue writes
// was last read by the previous step's convert, behind its barrier.
template <class Issue, class Step>
__device__ __forceinline__ void pipeline(int c0, int c1, int stages,
                                         Issue&& issue, Step&& step) {
  for (int i = 0; i < stages - 1; ++i) {
    if (c0 + i < c1) issue(c0 + i, i);
    cp_async_commit();
  }
  for (int c = c0; c < c1; ++c) {
    const int ahead = c + stages - 1;
    if (ahead < c1) issue(ahead, (ahead - c0) % stages);
    cp_async_commit();
    cp_async_wait_n(stages - 1);
    __syncthreads();
    step(c, (c - c0) % stages);
  }
}

// Ring depth of a kernel: the deepest of 4, 3, 2 stages whose shared
// memory lets two blocks share an SM, else 2.
template <class Floats>
int pick_stages(Floats&& floats) {
  for (int st = 4; st > 2; --st)
    if (floats(st) * (int)sizeof(float) <= kMaxSmem / 2 - 1024) return st;
  return 2;
}

// ---- the u GEMM: K4-stats and K4-bwd1 ------------------------------------ //

template <typename T, int S, int K, int R>
int u_gemm_smem_floats(int cout, int stages) {
  using B = Bwd<S, K>;
  const int ld = ldb(rup(cout < kNT ? cout : kNT, 8));
  if constexpr (kIsF32<T>) {
    return (stages + 2) * (B::CIC * B::fx1(R) + B::KC1 * ld) + 8 * kNT * 2 +
           B::KC1;
  } else {
    using C = BwdB<S, K>;
    constexpr int FH = B::fx(kTH * R);
    constexpr int FXW = B::fx(kTW);
    return stages * C::CIC * FH * C::wa8(FXW) / 2 +
           C::CIC / 2 * C::plane(FH * FXW) + C::KP1 * ld + 8 * kNT * 2 +
           C::KP1;
  }
}

// One block per (phase x 16-column tile, 8 R-row tile, sample x 64 output
// channels) of the phase's grid (the input grid's size); warp w owns rows
// w + 8 r, r < R. The block computes u on its tile, writes it, and writes
// one partial row of two per-channel sums over its pixels inside the image:
// K4-stats (STATS): u and u^2, from x and w alone (mean, inv, y and dy are
// not read); K4-bwd1: dv and dv * uhat, with dv = dy where the forward's
// y > 0. The mainloop is the same code for both. T = float: 3xTF32;
// T = bf16: one bf16 pass, x converted into channel-pair planes.
template <typename T, int S, int K, int R, bool STATS>
__global__ void __launch_bounds__(kThreads, 2)
    u_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ mean,
                  const float* __restrict__ inv, const T* __restrict__ y,
                  const T* __restrict__ dy, float* __restrict__ u,
                  float* __restrict__ p1, float* __restrict__ p2, int cin,
                  int H, int W, int cout, int stages) {
  using B = Bwd<S, K>;
  const int ntv = rup(cout < kNT ? cout : kNT, 8);
  const float rntv = 1.f / ntv;
  const int ld = ldb(ntv);
  extern __shared__ __align__(16) float smem[];

  const Phase<S, K> ph(blockIdx.x % B::PH);
  const int qx0 = (blockIdx.x / B::PH) * kTW;
  const int q0 = blockIdx.y * kTH * R;
  const int cot = (cout + kNT - 1) / kNT;
  const int n = blockIdx.z / cot;
  const int co0 = (blockIdx.z % cot) * kNT;
  const int orgy = S == 1 ? q0 - B::P : q0 + ph.offy - 1;
  const int orgx = S == 1 ? qx0 - B::P : qx0 + ph.offx - 1;
  const T* xn = x + (size_t)n * cin * H * W;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int nj = (min(kNT, cout - co0) + 7) / 8;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float* red;  // [8 warps][kNT][2], past the K loop's buffers

  if constexpr (kIsF32<T>) {
    constexpr int FH = B::fx(kTH * R);
    constexpr int FW = B::wa(B::fx(kTW));  // staged row, 16-byte groups
    constexpr int FX = B::fx1(R);
    constexpr int CIC = B::CIC;
    constexpr int KC = B::KC1;
    float* xraw = smem;                     // [stages][CIC][FX]
    float* xhi = xraw + stages * CIC * FX;  // [CIC][FX]
    float* xlo = xhi + CIC * FX;
    float* wraw = xlo + CIC * FX;           // [stages][KC][ld]
    float* whi = wraw + stages * KC * ld;   // [KC][ld]
    float* wlo = whi + KC * ld;
    red = wlo + KC * ld;
    int* koff = reinterpret_cast<int*>(red + 8 * kNT * 2);  // [KC]
    const int lead = orgx & 3;  // the footprint's first column in its row
    const int nchunks = (cin + CIC - 1) / CIC;

    auto issue = [&](int c, int slot) {
      const int ci0 = c * CIC;
      const int nci = min(CIC, cin - ci0);
      stage_window<FH, FW / 4>(xraw + slot * CIC * FX, nci, orgy,
                               orgx - lead, H, W, [&](int ch) {
                                 return xn + (size_t)(ci0 + ch) * H * W;
                               });
      float* wr = wraw + slot * KC * ld;
      for (int i = threadIdx.x; i < KC * ntv; i += kThreads) {
        int col;
        const int k = div_by(i, rntv, ntv, col);
        const int co = co0 + col;
        const int t = k % B::T1;
        const bool ok = k < nci * B::T1 && co < cout;
        cp_async4(wr + k * ld + col,
                  ok ? w + w_index<S, K>(co, ci0 + k / B::T1, ph.ky(t),
                                         ph.kx(t), cin, cout)
                     : w,
                  ok);
      }
    };
    auto convert = [&](int slot, int nci) {
      const float* xr = xraw + slot * CIC * FX;
      for (int i = threadIdx.x; i < nci * FX / 4; i += kThreads) {
        float v[4];
        load4(xr, i, v);
        split_store4(v, xhi, xlo, i);
      }
      const float* wr = wraw + slot * KC * ld;
      for (int i = threadIdx.x; i < KC * ntv; i += kThreads) {
        int col;
        const int k = div_by(i, rntv, ntv, col);
        split_store(wr[k * ld + col], whi, wlo, k * ld + col);
      }
      // padded K columns read tap 0 of channel 0 (finite) against zero
      // weights
      for (int k = threadIdx.x; k < KC; k += kThreads)
        koff[k] = k < nci * B::T1
                      ? (k / B::T1) * FX + x_tap<S, K>(k % B::T1, FW)
                      : 0;
    };

    int pix0[R], pix1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      pix0[r] = x_pix<S>(warp + 8 * r, g, FW) + lead;
      pix1[r] = x_pix<S>(warp + 8 * r, g + 8, FW) + lead;
    }
    pipeline(0, nchunks, stages, issue, [&](int c, int slot) {
      const int nci = min(CIC, cin - c * CIC);
      convert(slot, nci);
      __syncthreads();
      if constexpr (R == 1)
        pixel_row_mma(acc, xhi, xlo, koff, whi, wlo, ld, rup(nci * B::T1, 8),
                      pix0[0], pix1[0], nj, g, tig);
      else
        pixel_rows2_mma(acc, xhi, xlo, koff, whi, wlo, ld,
                        rup(nci * B::T1, 8), pix0, pix1, nj, g, tig);
    });
  } else {
    using C = BwdB<S, K>;
    constexpr int FH = B::fx(kTH * R);
    constexpr int FXW = B::fx(kTW);  // footprint columns
    constexpr int FW = C::wa8(FXW);  // staged row, 16-byte groups
    constexpr int FR = FH * FW;      // a staged channel
    constexpr int CIC = C::CIC;
    constexpr int CP = CIC / 2;      // channel pairs a chunk
    constexpr int PL = C::plane(FH * FXW);
    constexpr int KP = C::KP1;
    bf16* xraw = reinterpret_cast<bf16*>(smem);  // [stages][CIC][FR]
    uint32_t* xp =
        reinterpret_cast<uint32_t*>(xraw + stages * CIC * FR);  // [CP][PL]
    uint32_t* wb = xp + CP * PL;                                // [KP][ld]
    red = reinterpret_cast<float*>(wb + KP * ld);
    int* koff = reinterpret_cast<int*>(red + 8 * kNT * 2);  // [KP]
    const int lead = orgx & 7;
    const int nchunks = (cin + CIC - 1) / CIC;
    // K pair k: tap k / CP, channels 2 (k % CP) + {0, 1}; padded pairs read
    // position 0 (finite) against zero weights
    for (int k = threadIdx.x; k < KP; k += kThreads)
      koff[k] = k < C::NP1 ? (k % CP) * PL + x_tap<S, K>(k / CP, FXW) : 0;

    auto issue = [&](int c, int slot) {
      const int ci0 = c * CIC;
      stage_window_bf<FH, FW / 8>(xraw + slot * CIC * FR, min(CIC, cin - ci0),
                                  orgy, orgx - lead, H, W, [&](int ch) {
                                    return xn + (size_t)(ci0 + ch) * H * W;
                                  });
    };
    // x into channel-pair planes (channels past the chunk's, and Cin = 3's
    // fourth, are zero); the weights as pair words, read from device memory
    auto convert = [&](int c, int slot) {
      const int ci0 = c * CIC;
      const int nci = min(CIC, cin - ci0);
      const bf16* xr = xraw + slot * CIC * FR;
      for (int i = threadIdx.x; i < CP * FH * FXW; i += kThreads) {
        const int cp = i / (FH * FXW);
        const int p = i % (FH * FXW);
        const int e = (p / FXW) * FW + p % FXW + lead;
        const uint32_t lo = 2 * cp < nci ? xr[2 * cp * FR + e] : 0u;
        const uint32_t hi = 2 * cp + 1 < nci ? xr[(2 * cp + 1) * FR + e] : 0u;
        xp[cp * PL + p] = lo | hi << 16;
      }
      for (int i = threadIdx.x; i < KP * ntv; i += kThreads) {
        int col;
        const int k = div_by(i, rntv, ntv, col);
        const int co = co0 + col;
        const int t = k / CP;
        const int cl = 2 * (k % CP);
        uint32_t v = 0;
        if (k < C::NP1 && co < cout) {
          if (cl < nci)
            v = __ldg(w + w_index<S, K>(co, ci0 + cl, ph.ky(t), ph.kx(t),
                                        cin, cout));
          if (cl + 1 < nci)
            v |= (uint32_t)__ldg(w + w_index<S, K>(co, ci0 + cl + 1,
                                                   ph.ky(t), ph.kx(t), cin,
                                                   cout))
                 << 16;
        }
        wb[k * ld + col] = v;
      }
    };

    int pix0[R], pix1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      pix0[r] = x_pix<S>(warp + 8 * r, g, FXW);
      pix1[r] = x_pix<S>(warp + 8 * r, g + 8, FXW);
    }
    pipeline(0, nchunks, stages, issue, [&](int c, int slot) {
      convert(c, slot);
      __syncthreads();
      pair_rows_mma<R>(acc, xp, koff, wb, ld, KP, pix0, pix1, nj, g, tig);
    });
  }

  // epilogue: write u; the two sums over the block's pixels inside the
  // image (stats: u, u^2; bwd1: dv, dv * uhat with the forward's mask
  // y > 0). Each thread holds pixels (rows warp + 8 r, columns g, g + 8) x
  // channels 8 j + 2 tig + e, in acc[4 r + j] (R = 2) or acc[j].
  const int Ho = H * S;
  const int Wo = W * S;
  float s1[8][2], s2[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s1[j][e] = 0.f;
      s2[j][e] = 0.f;
      const int co = co0 + 8 * j + 2 * tig + e;
      if (j >= nj || co >= cout || (R == 2 && j >= 4)) continue;
      const float mc = STATS ? 0.f : __ldg(mean + co);
      const float ic = STATS ? 0.f : __ldg(inv + co);
      const size_t plane = ((size_t)n * cout + co) * Ho;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int q = q0 + warp + 8 * r;
        if (q >= H) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int qx = qx0 + g + 8 * h;
          if (qx >= W) continue;
          const int oy = S == 1 ? q : S * q + ph.ry;
          const int ox = S == 1 ? qx : S * qx + ph.rx;
          const size_t idx = (plane + oy) * Wo + ox;
          const float uv = acc[R == 1 ? j : 4 * r + j][2 * h + e];
          u[idx] = uv;
          if constexpr (STATS) {
            s1[j][e] += uv;
            s2[j][e] += uv * uv;
          } else {
            const float dv = ld_f32(y, idx) > 0.f ? ld_f32(dy, idx) : 0.f;
            s1[j][e] += dv;
            s2[j][e] += dv * ((uv - mc) * ic);
          }
        }
      }
    }
  // over the 8 pixel groups of the warp (lanes xor 4, 8, 16), then the 8
  // warps in a fixed order
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= nj) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float a1 = s1[j][e], a2 = s2[j][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        a1 += __shfl_xor_sync(0xffffffffu, a1, off);
        a2 += __shfl_xor_sync(0xffffffffu, a2, off);
      }
      if (g == 0) {
        const int col = 8 * j + 2 * tig + e;
        red[(warp * kNT + col) * 2] = a1;
        red[(warp * kNT + col) * 2 + 1] = a2;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * kNT) {
    const int col = threadIdx.x >> 1;
    const int which = threadIdx.x & 1;
    if (co0 + col < cout) {
      float s = 0.f;
      for (int wi = 0; wi < kThreads / 32; ++wi)
        s += red[(wi * kNT + col) * 2 + which];
      const size_t blk = ((size_t)n * gridDim.y + blockIdx.y) * gridDim.x +
                         blockIdx.x;
      (which ? p2 : p1)[blk * cout + co0 + col] = s;
    }
  }
}

// ---- K4-fwd ------------------------------------------------------------- //

constexpr int kFwdUnroll = 4;  // float4 groups a thread, a block

// y = max(u a + b, 0) with the product and the sum rounded separately (no
// FMA contraction), as the plain version's u * a + b computes it; NaN
// passes, as through torch.relu
__device__ __forceinline__ float bn_relu(float v, float a, float b) {
  const float t = __fadd_rn(__fmul_rn(v, a), b);
  return t < 0.f ? 0.f : t;
}

// K4-fwd, in place over u (NCHW, planes of hw elements; channel c of plane
// p is p % C): one block per (plane, run of kThreads x kFwdUnroll float4
// groups). A plane's float4 groups start at its first 16-byte boundary; the
// elements before it (its head) and after its last whole group (its tail),
// fewer than 4 each, are done by the plane's first block.
__global__ void __launch_bounds__(kThreads)
    bn_relu_kernel(float* __restrict__ u, const float* __restrict__ a,
                   const float* __restrict__ b, int C, int hw) {
  const int c = blockIdx.x % C;
  const float ac = __ldg(a + c);
  const float bc = __ldg(b + c);
  float* p = u + (size_t)blockIdx.x * hw;
  const int head = min(hw, (int)((0u - (unsigned)(
                                     reinterpret_cast<uintptr_t>(p) >> 2)) &
                                 3u));
  const int n4 = (hw - head) >> 2;
  float4* p4 = reinterpret_cast<float4*>(p + head);
  const int i0 = blockIdx.y * kThreads * kFwdUnroll + threadIdx.x;
  float4 v[kFwdUnroll];
#pragma unroll
  for (int j = 0; j < kFwdUnroll; ++j)
    if (i0 + j * kThreads < n4) v[j] = p4[i0 + j * kThreads];
#pragma unroll
  for (int j = 0; j < kFwdUnroll; ++j) {
    if (i0 + j * kThreads >= n4) break;
    v[j].x = bn_relu(v[j].x, ac, bc);
    v[j].y = bn_relu(v[j].y, ac, bc);
    v[j].z = bn_relu(v[j].z, ac, bc);
    v[j].w = bn_relu(v[j].w, ac, bc);
    p4[i0 + j * kThreads] = v[j];
  }
  if (blockIdx.y == 0) {
    const int tail = hw - head - 4 * n4;
    const int t = threadIdx.x;
    const int i = t < head ? t : head + 4 * n4 + (t - head);
    if (t < head + tail) p[i] = bn_relu(p[i], ac, bc);
  }
}

// K4-fwd in bf16: y = bf16(max(u a + b, 0)) (rounded to nearest even) from
// the f32 u into a new bf16 y of u's shape; one block per (plane, run of
// kThreads x kFwdUnroll groups of 4 elements), as bn_relu_kernel. Planes of
// hw % 4 == 0 elements read float4s and write 8-byte groups; others go an
// element at a time.
__global__ void __launch_bounds__(kThreads)
    bn_relu_bf16_kernel(const float* __restrict__ u,
                        const float* __restrict__ a,
                        const float* __restrict__ b, bf16* __restrict__ y,
                        int C, int hw) {
  const int c = blockIdx.x % C;
  const float ac = __ldg(a + c);
  const float bc = __ldg(b + c);
  const float* p = u + (size_t)blockIdx.x * hw;
  bf16* q = y + (size_t)blockIdx.x * hw;
  if ((hw & 3) == 0) {
    const int n4 = hw >> 2;
    const int i0 = blockIdx.y * kThreads * kFwdUnroll + threadIdx.x;
    float4 v[kFwdUnroll];
#pragma unroll
    for (int j = 0; j < kFwdUnroll; ++j)
      if (i0 + j * kThreads < n4)
        v[j] = reinterpret_cast<const float4*>(p)[i0 + j * kThreads];
#pragma unroll
    for (int j = 0; j < kFwdUnroll; ++j) {
      if (i0 + j * kThreads >= n4) break;
      uint2 o;
      o.x = bf16_rne(bn_relu(v[j].x, ac, bc)) |
            bf16_rne(bn_relu(v[j].y, ac, bc)) << 16;
      o.y = bf16_rne(bn_relu(v[j].z, ac, bc)) |
            bf16_rne(bn_relu(v[j].w, ac, bc)) << 16;
      reinterpret_cast<uint2*>(q)[i0 + j * kThreads] = o;
    }
  } else {
    const int e0 = blockIdx.y * kThreads * kFwdUnroll * 4;
    const int e1 = min(hw, e0 + kThreads * kFwdUnroll * 4);
    for (int e = e0 + threadIdx.x; e < e1; e += kThreads)
      q[e] = (bf16)bf16_rne(bn_relu(p[e], ac, bc));
  }
}

// ---- K4-bwd2 ------------------------------------------------------------ //

// The per-channel constants du = a (dv - s1n - (u - mean) inv s2n) needs.
struct DuConsts {
  const float* a;
  const float* mean;
  const float* inv;
  const float* s1n;
  const float* s2n;
};

__device__ __forceinline__ void load_consts(const DuConsts& k, int co,
                                            float* dst) {
  dst[0] = __ldg(k.a + co);
  dst[1] = __ldg(k.mean + co);
  dst[2] = __ldg(k.inv + co);
  dst[3] = __ldg(k.s1n + co);
  dst[4] = __ldg(k.s2n + co);
}

// du from the staged u, y and dy with the channel's constants (the wrapper's
// plain formula, operation for operation)
__device__ __forceinline__ float form_du(float uv, float yv, float dyv,
                                         const float* k) {
  const float dv = yv > 0.f ? dyv : 0.f;
  return k[0] * (dv - k[3] - (uv - k[1]) * k[2] * k[4]);
}

template <typename T, int S, int K, int R>
int dx_smem_floats(int cin, int stages) {
  using B = Bwd<S, K>;
  const int ld = ldb(rup(cin < kNT ? cin : kNT, 8));
  if constexpr (kIsF32<T>) {
    return stages * (3 * B::COC * B::fdd(R) + B::KC2 * ld + B::COC * 5) +
           2 * (B::COC * B::fdd(R) + B::KC2 * ld) + B::KC2;
  } else {
    using C = BwdB<S, K>;
    constexpr int FH = B::fd(kTH * R);
    constexpr int FR = FH * C::wa8(B::fd(kTW));
    // u (f32) and y, dy (bf16) staged; du's pair planes; the weights
    return stages * (2 * C::COC * FR + C::COC * 5) +
           C::COC / 2 * C::plane(FH * B::fd(kTW)) + C::KP2 * ld + C::KP2;
  }
}

// dx: one block per (16-column tile, 8 R-row tile, sample x 64 input
// channels) of the input grid; warp w owns rows w + 8 r, r < R. T = float:
// 3xTF32; T = bf16: du formed in channel-pair planes and rounded to bf16,
// one bf16 pass, dx rounded once.
template <typename T, int S, int K, int R>
__global__ void __launch_bounds__(kThreads, 2)
    dx_kernel(const T* __restrict__ w, DuConsts kc,
              const float* __restrict__ u, const T* __restrict__ y,
              const T* __restrict__ dy, T* __restrict__ dx, int cin, int H,
              int W, int cout, int stages) {
  using B = Bwd<S, K>;
  const int ntv = rup(cin < kNT ? cin : kNT, 8);
  const float rntv = 1.f / ntv;
  const int ld = ldb(ntv);
  extern __shared__ __align__(16) float smem[];

  const int p0x = blockIdx.x * kTW;
  const int p0y = blockIdx.y * kTH * R;
  const int cit = (cin + kNT - 1) / kNT;
  const int n = blockIdx.z / cit;
  const int ci0 = (blockIdx.z % cit) * kNT;
  const int Ho = H * S;
  const int Wo = W * S;
  // du footprint: S == 1: du at p - k + P; S > 1: du at S p + k - P
  const int orgy = S == 1 ? p0y + B::P - (K - 1) : S * p0y - B::P;
  const int fx0 = S == 1 ? p0x + B::P - (K - 1) : S * p0x - B::P;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int nj = (min(kNT, cin - ci0) + 7) / 8;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if constexpr (kIsF32<T>) {
    constexpr int FH = B::fd(kTH * R);
    constexpr int FW = B::wa(B::fd(kTW));  // staged row, 16-byte groups
    constexpr int FD = B::fdd(R);
    constexpr int COC = B::COC;
    constexpr int KC = B::KC2;
    float* raw = smem;                         // [stages][3][COC][FD]
    float* dhi = raw + stages * 3 * COC * FD;  // [COC][FD]
    float* dlo = dhi + COC * FD;
    float* wraw = dlo + COC * FD;              // [stages][KC][ld]
    float* whi = wraw + stages * KC * ld;
    float* wlo = whi + KC * ld;
    float* cst = wlo + KC * ld;                // [stages][COC][5]
    int* koff = reinterpret_cast<int*>(cst + stages * COC * 5);  // [KC]
    const int lead = fx0 & 3;
    const int orgx = fx0 - lead;
    const int nchunks = (cout + COC - 1) / COC;

    auto issue = [&](int c, int slot) {
      const int co0 = c * COC;
      const int nco = min(COC, cout - co0);
      float* rr = raw + slot * 3 * COC * FD;
      const float* ts[3] = {u, y, dy};
#pragma unroll
      for (int t = 0; t < 3; ++t)
        stage_window<FH, FW / 4>(rr + t * COC * FD, nco, orgy, orgx, Ho, Wo,
                                 [&](int ch) {
                                   return ts[t] +
                                          ((size_t)n * cout + co0 + ch) * Ho *
                                              Wo;
                                 });
      float* wr = wraw + slot * KC * ld;
      for (int i = threadIdx.x; i < KC * ntv; i += kThreads) {
        int col;
        const int k = div_by(i, rntv, ntv, col);
        const int ci = ci0 + col;
        const int t = k % B::T2;
        const bool ok = k < nco * B::T2 && ci < cin;
        cp_async4(wr + k * ld + col,
                  ok ? w + w_index<S, K>(co0 + k / B::T2, ci, t / K, t % K,
                                         cin, cout)
                     : w,
                  ok);
      }
      if (threadIdx.x < nco)
        load_consts(kc, co0 + threadIdx.x,
                    cst + (slot * COC + threadIdx.x) * 5);
    };
    auto convert = [&](int slot, int nco) {
      const float* rr = raw + slot * 3 * COC * FD;
      for (int i = threadIdx.x; i < nco * FD / 4; i += kThreads) {
        const int r = i / (FW / 4);
        const int gy = orgy + r % FH;
        const int gx = orgx + 4 * (i % (FW / 4));
        const float* k = cst + (slot * COC + r / FH) * 5;
        float uv[4], yv[4], dyv[4], du[4];
        load4(rr, i, uv);
        load4(rr + COC * FD, i, yv);
        load4(rr + 2 * COC * FD, i, dyv);
#pragma unroll
        for (int e = 0; e < 4; ++e)  // 0 outside: the adjoint's zero padding
          du[e] = gy >= 0 && gy < Ho && gx + e >= 0 && gx + e < Wo
                      ? form_du(uv[e], yv[e], dyv[e], k)
                      : 0.f;
        split_store4(du, dhi, dlo, i);
      }
      const float* wr = wraw + slot * KC * ld;
      for (int i = threadIdx.x; i < KC * ntv; i += kThreads) {
        int col;
        const int k = div_by(i, rntv, ntv, col);
        split_store(wr[k * ld + col], whi, wlo, k * ld + col);
      }
      for (int k = threadIdx.x; k < KC; k += kThreads) {
        int off = 0;
        if (k < nco * B::T2) {
          const int t = k % B::T2;
          const int tap = (t / K) * FW + t % K;
          off = (k / B::T2) * FD + (S == 1 ? -tap : tap);
        }
        koff[k] = off;
      }
    };

    // a pixel's du offset at tap 0: S == 1 (r + K - 1, c + K - 1); S > 1
    // (S r, S c)
    int pix0[R], pix1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = warp + 8 * r;
      pix0[r] = (S == 1 ? (row + K - 1) * FW + g + K - 1
                        : S * row * FW + S * g) +
                lead;
      pix1[r] = pix0[r] + 8 * S;
    }
    pipeline(0, nchunks, stages, issue, [&](int c, int slot) {
      const int nco = min(COC, cout - c * COC);
      convert(slot, nco);
      __syncthreads();
      if constexpr (R == 1)
        pixel_row_mma(acc, dhi, dlo, koff, whi, wlo, ld, rup(nco * B::T2, 8),
                      pix0[0], pix1[0], nj, g, tig);
      else
        pixel_rows2_mma(acc, dhi, dlo, koff, whi, wlo, ld,
                        rup(nco * B::T2, 8), pix0, pix1, nj, g, tig);
    });
  } else {
    using C = BwdB<S, K>;
    constexpr int FH = B::fd(kTH * R);
    constexpr int FDW = B::fd(kTW);  // footprint columns
    constexpr int FW = C::wa8(FDW);  // staged row, 16-byte groups
    constexpr int FR = FH * FW;      // a staged channel
    constexpr int COC = C::COC;
    constexpr int CP = COC / 2;      // channel pairs a chunk
    constexpr int PL = C::plane(FH * FDW);
    constexpr int KP = C::KP2;
    // u [stages][COC][FR]; y, dy [stages][2][COC][FR]; du's pair planes
    // [CP][PL]; weight pairs [KP][ld]; constants [stages][COC][5]; [KP]
    float* uraw = smem;
    bf16* braw = reinterpret_cast<bf16*>(uraw + stages * COC * FR);
    uint32_t* dp = reinterpret_cast<uint32_t*>(braw + stages * 2 * COC * FR);
    uint32_t* wb = dp + CP * PL;
    float* cst = reinterpret_cast<float*>(wb + KP * ld);
    int* koff = reinterpret_cast<int*>(cst + stages * COC * 5);
    const int lead = fx0 & 7;
    const int orgx = fx0 - lead;
    const int nchunks = (cout + COC - 1) / COC;
    // K pair k: tap t = k / CP, output channels 2 (k % CP) + {0, 1}
    for (int k = threadIdx.x; k < KP; k += kThreads) {
      int off = 0;
      if (k < C::NP2) {
        const int t = k / CP;
        const int tap = (t / K) * FDW + t % K;
        off = (k % CP) * PL + (S == 1 ? -tap : tap);
      }
      koff[k] = off;
    }

    auto issue = [&](int c, int slot) {
      const int co0 = c * COC;
      const int nco = min(COC, cout - co0);
      const size_t pl0 = ((size_t)n * cout + co0) * Ho * Wo;
      stage_window<FH, FW / 4>(uraw + slot * COC * FR, nco, orgy, orgx, Ho,
                               Wo, [&](int ch) {
                                 return u + pl0 + (size_t)ch * Ho * Wo;
                               });
      bf16* br = braw + 2 * slot * COC * FR;
      stage_window_bf<FH, FW / 8>(br, nco, orgy, orgx, Ho, Wo, [&](int ch) {
        return y + pl0 + (size_t)ch * Ho * Wo;
      });
      stage_window_bf<FH, FW / 8>(br + COC * FR, nco, orgy, orgx, Ho, Wo,
                                  [&](int ch) {
                                    return dy + pl0 + (size_t)ch * Ho * Wo;
                                  });
      if (threadIdx.x < nco)
        load_consts(kc, co0 + threadIdx.x,
                    cst + (slot * COC + threadIdx.x) * 5);
    };
    // du, rounded to bf16, into channel-pair planes (0 outside the image:
    // the adjoint's zero padding; 0 past the chunk's channels); the
    // weights as pair words, read from device memory
    auto convert = [&](int c, int slot) {
      const int co0 = c * COC;
      const int nco = min(COC, cout - co0);
      const float* ur = uraw + slot * COC * FR;
      const bf16* yr = braw + 2 * slot * COC * FR;
      const bf16* dr = yr + COC * FR;
      for (int i = threadIdx.x; i < CP * FH * FDW; i += kThreads) {
        const int cp = i / (FH * FDW);
        const int p = i % (FH * FDW);
        const int r = p / FDW;
        const int col = p % FDW;
        const int gy = orgy + r;
        const int gx = fx0 + col;
        const int e = r * FW + col + lead;
        uint32_t v = 0;
        if (gy >= 0 && gy < Ho && gx >= 0 && gx < Wo) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ch = 2 * cp + h;
            if (ch < nco) {
              const int j = ch * FR + e;
              v |= bf16_rne(form_du(ur[j], bf16_f32(yr[j]), bf16_f32(dr[j]),
                                    cst + (slot * COC + ch) * 5))
                   << (16 * h);
            }
          }
        }
        dp[cp * PL + p] = v;
      }
      for (int i = threadIdx.x; i < KP * ntv; i += kThreads) {
        int col;
        const int k = div_by(i, rntv, ntv, col);
        const int ci = ci0 + col;
        const int t = k / CP;
        const int co = co0 + 2 * (k % CP);
        uint32_t v = 0;
        if (k < C::NP2 && ci < cin) {
          if (co < cout)
            v = __ldg(w + w_index<S, K>(co, ci, t / K, t % K, cin, cout));
          if (co + 1 < cout)
            v |= (uint32_t)__ldg(w + w_index<S, K>(co + 1, ci, t / K, t % K,
                                                   cin, cout))
                 << 16;
        }
        wb[k * ld + col] = v;
      }
    };

    int pix0[R], pix1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = warp + 8 * r;
      pix0[r] = S == 1 ? (row + K - 1) * FDW + g + K - 1
                       : S * row * FDW + S * g;
      pix1[r] = pix0[r] + 8 * S;
    }
    pipeline(0, nchunks, stages, issue, [&](int c, int slot) {
      convert(c, slot);
      __syncthreads();
      pair_rows_mma<R>(acc, dp, koff, wb, ld, KP, pix0, pix1, nj, g, tig);
    });
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int iy = p0y + warp + 8 * r;
    if (iy >= H) break;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ci = ci0 + 8 * j + 2 * tig + e;
        if (j >= nj || ci >= cin || (R == 2 && j >= 4)) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ix = p0x + g + 8 * h;
          if (ix < W)
            st_t(dx, (((size_t)n * cin + ci) * H + iy) * W + ix,
                 acc[R == 1 ? j : 4 * r + j][2 * h + e]);
        }
      }
  }
}

// floats of the dW block's cross-warp reduction: 8 warps x 8 tiles x 32
// lanes x 4 (it reuses the shared memory of the K loop)
constexpr int kDwRed = 8 * 8 * 32 * 4;

// rows of a dW block's du tile: its output channels, in m16 tiles
__host__ __device__ constexpr int dw_rows(int cout) {
  return rup(cout < kMW ? cout : kMW, 16);
}

// f(IC<dwc>) with the dW chunk's columns for cout output channels
template <int S, typename F>
int with_dw_cols(int cout, F&& f) {
  if (dw_rows(cout) > 16) return f(std::integral_constant<int, kDwNarrow>{});
  if (S == 1) return f(std::integral_constant<int, kDwWide>{});
  return f(std::integral_constant<int, kDwMid>{});
}

template <typename T, int S, int K, int DWC>
int dw_smem_floats(int cout, int stages) {
  using B = Bwd<S, K>;
  const int mw = dw_rows(cout);
  int f;
  if constexpr (kIsF32<T>) {
    const int lda = 2 * DWC + 4;
    f = (stages * 3 + 2) * mw * lda + (stages + 2) * B::CIW * B::fxw(DWC) +
        mw * 5 + B::NW + 2 * DWC;
  } else {
    using C = BwdB<S, K>;
    constexpr int px = 2 * DWC;
    constexpr int FXR = B::fx(2);
    constexpr int FXC = B::fx(DWC);
    // u (f32), y and dy (bf16) and x (bf16) staged; du's pair words; x's
    // words
    f = stages * (mw * (px + 4) + mw * px + B::CIW * FXR * C::wa8(FXC) / 2) +
        mw * (DWC + 4) + B::CIW * FXR * FXC + mw * 5 + B::NW + px;
  }
  return f > kDwRed ? f : kDwRed;
}

// dW: one block per (phase x input-channel tile x output-channel tile,
// split); the block walks its split's run of consecutive K chunks of 2 x
// DWC pixels of the phase's grid (columns fastest, so consecutive chunks
// read the same rows of u, y, dy and x) and writes its partial dW. T =
// float: 3xTF32; T = bf16: du rounded to bf16 as pixel-pair words, x as a
// word at every footprint position (it and its right neighbour), one bf16
// pass.
template <typename T, int S, int K, int DWC>
__global__ void __launch_bounds__(kThreads, 2)
    dw_kernel(const T* __restrict__ x, DuConsts kc,
              const float* __restrict__ u, const T* __restrict__ y,
              const T* __restrict__ dy, float* __restrict__ dwp,
              int N, int cin, int H, int W, int cout, int stages) {
  using B = Bwd<S, K>;
  constexpr int CIW = B::CIW;
  constexpr int T1 = B::T1;
  constexpr int dwc = DWC;
  constexpr int px = 2 * DWC;      // chunk pixels
  constexpr int lda = px + 4;      // u (f32: also y, dy, du) row stride
  const int mw = dw_rows(cout);
  extern __shared__ __align__(16) float smem[];

  const int cit = (cin + CIW - 1) / CIW;
  const Phase<S, K> ph(blockIdx.x % B::PH);
  const int rest = blockIdx.x / B::PH;
  const int ci0 = (rest % cit) * CIW;
  const int co0 = (rest / cit) * kMW;
  const int nci = min(CIW, cin - ci0);
  const int nco = min(kMW, cout - co0);
  const int Ho = H * S;
  const int Wo = W * S;
  const int nrows = (H + 1) / 2;
  const int ncols = (W + dwc - 1) / dwc;
  const int nchunks = N * nrows * ncols;
  const int per = (nchunks + gridDim.y - 1) / gridDim.y;
  const int c0 = min(nchunks, (int)blockIdx.y * per);
  const int c1 = min(nchunks, c0 + per);

  // chunk c: sample, first row (of 2) and first column (of dwc)
  auto where = [&](int c, int& n, int& q0, int& qx0) {
    n = c / (nrows * ncols);
    const int r = c % (nrows * ncols);
    q0 = 2 * (r / ncols);
    qx0 = dwc * (r % ncols);
  };
  // stage chunk c's u (f32) and, for T = float, y and dy at row j of
  // rr[3][mw][lda] by asynchronous copies; bf16 y and dy go to by[2][mw][px]
  // by plain loads
  auto stage_du = [&](int c, float* rr, bf16* by) {
    int n, q0, qx0;
    where(c, n, q0, qx0);
    for (int i = threadIdx.x; i < nco * px; i += kThreads) {
      const int q = q0 + (i % px) / dwc;
      const int qx = qx0 + (i % px) % dwc;
      const bool ok = q < H && qx < W;
      const int oy = S == 1 ? q : S * q + ph.ry;
      const int ox = S == 1 ? qx : S * qx + ph.rx;
      const size_t idx =
          ok ? (((size_t)n * cout + co0 + i / px) * Ho + oy) * Wo + ox : 0;
      const int j = (i / px) * lda + i % px;
      cp_async4(rr + j, u + idx, ok);
      if constexpr (kIsF32<T>) {
        cp_async4(rr + mw * lda + j, y + idx, ok);
        cp_async4(rr + 2 * mw * lda + j, dy + idx, ok);
      } else {
        by[i] = ok ? y[idx] : (bf16)0;
        by[mw * px + i] = ok ? dy[idx] : (bf16)0;
      }
    }
  };
  const int mt = (nco + 15) / 16;  // m16 tiles of output channels

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int nn8 = (nci * T1 + 7) / 8;  // n8 tiles of (channel, tap) columns
  const int npairs = mt * nn8;         // (m16, n8) tiles
  // the 8 warps as wk_n K-step groups x wp_n tile groups: a warp takes the
  // tiles wp + wp_n i (at most 8) on the K steps wk + wk_n j of each chunk;
  // with few tiles the warps split the K steps instead, so each warp keeps
  // several independent MMA chains; their sums meet at the end
  const int wp_n = npairs <= 16 ? 2 : (npairs <= 32 ? 4 : 8);
  const int wk_n = 8 / wp_n;
  const int wk = warp % wk_n;
  const int wp = warp / wk_n;
  float acc[8][4], part[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[i][e] = 0.f;
      part[i][e] = 0.f;
    }

  if constexpr (kIsF32<T>) {
    constexpr int FW = B::wa(B::fx(DWC));  // staged x row, 16-byte groups
    constexpr int FXW = B::fxw(DWC);
    float* raw = smem;                        // [stages][3][mw][lda]
    float* dhi = raw + stages * 3 * mw * lda;  // [mw][lda]
    float* dlo = dhi + mw * lda;
    float* xraw = dlo + mw * lda;            // [stages][CIW][FXW]
    float* xhi = xraw + stages * CIW * FXW;
    float* xlo = xhi + CIW * FXW;
    float* cst = xlo + CIW * FXW;             // [mw][5]
    int* noff = reinterpret_cast<int*>(cst + mw * 5);  // [NW]
    int* pxo = noff + B::NW;                           // [px]

    for (int i = threadIdx.x; i < nco; i += kThreads)
      load_consts(kc, co0 + i, cst + i * 5);
    for (int k = threadIdx.x; k < B::NW; k += kThreads)
      noff[k] = k < nci * T1 ? (k / T1) * FXW + x_tap<S, K>(k % T1, FW) : 0;
    // chunks start at multiples of 16 columns: the x footprint's first
    // column lies `lead` into its staged row in every chunk
    const int lead = (S == 1 ? -B::P : ph.offx - 1) & 3;
    for (int k = threadIdx.x; k < px; k += kThreads)
      pxo[k] = x_pix<S>(k / dwc, k % dwc, FW) + lead;

    auto issue = [&](int c, int slot) {
      int n, q0, qx0;
      where(c, n, q0, qx0);
      stage_du(c, raw + slot * 3 * mw * lda, nullptr);
      const int orgy = S == 1 ? q0 - B::P : q0 + ph.offy - 1;
      const int orgx = S == 1 ? qx0 - B::P : qx0 + ph.offx - 1;
      const float* xn = x + (size_t)n * cin * H * W;
      stage_window<B::fx(2), FW / 4>(xraw + slot * CIW * FXW, nci, orgy,
                                     orgx - lead, H, W, [&](int ch) {
                                       return xn +
                                              (size_t)(ci0 + ch) * H * W;
                                     });
    };
    auto convert = [&](int c, int slot) {
      int n, q0, qx0;
      where(c, n, q0, qx0);
      const float* rr = raw + slot * 3 * mw * lda;
      for (int i = threadIdx.x; i < mt * 16 * px; i += kThreads) {
        const int cl = i / px;
        const int j = cl * lda + i % px;
        float du = 0.f;  // past the image or the channels
        if (cl < nco && q0 + (i % px) / dwc < H && qx0 + (i % px) % dwc < W)
          du = form_du(rr[j], rr[mw * lda + j], rr[2 * mw * lda + j],
                       cst + cl * 5);
        split_store(du, dhi, dlo, j);
      }
      const float* xr = xraw + slot * CIW * FXW;
      for (int i = threadIdx.x; i < nci * FXW / 4; i += kThreads) {
        float v[4];
        load4(xr, i, v);
        split_store4(v, xhi, xlo, i);
      }
    };

    pipeline(c0, c1, stages, issue, [&](int c, int slot) {
      convert(c, slot);
      __syncthreads();
      for (int kk = 8 * wk; kk < px; kk += 8 * wk_n) {
        const int x0 = pxo[kk + tig];
        const int x1 = pxo[kk + tig + 4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int pr = wp + wp_n * i;
          if (pr >= npairs) break;
          const int a0 = (16 * (pr / nn8) + g) * lda + kk + tig;
          const int ia[4] = {a0, a0 + 8 * lda, a0 + 4, a0 + 8 * lda + 4};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ah[r] = bits(dhi[ia[r]]);
            al[r] = bits(dlo[ia[r]]);
          }
          const int no = noff[8 * (pr % nn8) + g];
          const uint32_t bh[2] = {bits(xhi[x0 + no]), bits(xhi[x1 + no])};
          const uint32_t bl[2] = {bits(xlo[x0 + no]), bits(xlo[x1 + no])};
          mma3(part[i], ah, al, bh, bl);
        }
      }
      add_chunk(acc, part);
    });
  } else {
    using C = BwdB<S, K>;
    constexpr int ldw = DWC + 4;        // du words a row: 4 mod 8, so a
                                        // warp's A loads hit 32 banks
    constexpr int FXR = B::fx(2);       // x footprint rows
    constexpr int FXC = B::fx(DWC);     // x footprint columns
    constexpr int FWX = C::wa8(FXC);    // staged x row, 16-byte groups
    constexpr int XPL = FXR * FXC;      // x words a channel
    // u [stages][mw][lda]; y, dy [stages][2][mw][px]; du's pixel-pair
    // words [mw][ldw]; x [stages][CIW][FXR][FWX]; x's words [CIW][XPL];
    // constants [mw][5]; noff [NW]; pxo [px]
    float* uraw = smem;
    bf16* braw = reinterpret_cast<bf16*>(uraw + stages * mw * lda);
    uint32_t* duw = reinterpret_cast<uint32_t*>(braw + stages * 2 * mw * px);
    bf16* xraw = reinterpret_cast<bf16*>(duw + mw * ldw);
    uint32_t* xw =
        reinterpret_cast<uint32_t*>(xraw + stages * CIW * FXR * FWX);
    float* cst = reinterpret_cast<float*>(xw + CIW * XPL);
    int* noff = reinterpret_cast<int*>(cst + mw * 5);
    int* pxo = noff + B::NW;

    for (int i = threadIdx.x; i < nco; i += kThreads)
      load_consts(kc, co0 + i, cst + i * 5);
    for (int k = threadIdx.x; k < B::NW; k += kThreads)
      noff[k] = k < nci * T1 ? (k / T1) * XPL + x_tap<S, K>(k % T1, FXC) : 0;
    const int lead = (S == 1 ? -B::P : ph.offx - 1) & 7;
    for (int k = threadIdx.x; k < px; k += kThreads)
      pxo[k] = x_pix<S>(k / dwc, k % dwc, FXC);

    auto issue = [&](int c, int slot) {
      int n, q0, qx0;
      where(c, n, q0, qx0);
      stage_du(c, uraw + slot * mw * lda, braw + 2 * slot * mw * px);
      const int orgy = S == 1 ? q0 - B::P : q0 + ph.offy - 1;
      const int orgx = S == 1 ? qx0 - B::P : qx0 + ph.offx - 1;
      const bf16* xn = x + (size_t)n * cin * H * W;
      stage_window_bf<FXR, FWX / 8>(xraw + slot * CIW * FXR * FWX, nci, orgy,
                                    orgx - lead, H, W, [&](int ch) {
                                      return xn + (size_t)(ci0 + ch) * H * W;
                                    });
    };
    auto convert = [&](int c, int slot) {
      int n, q0, qx0;
      where(c, n, q0, qx0);
      const float* ur = uraw + slot * mw * lda;
      const bf16* yr = braw + 2 * slot * mw * px;
      const bf16* dr = yr + mw * px;
      // du rounded to bf16, pixel pairs (2 pp, 2 pp + 1) of a row as words
      for (int i = threadIdx.x; i < mt * 16 * dwc; i += kThreads) {
        const int cl = i / dwc;
        const int pp = i % dwc;
        uint32_t v = 0;  // past the image or the channels
        if (cl < nco) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = 2 * pp + h;
            if (q0 + p / dwc < H && qx0 + p % dwc < W)
              v |= bf16_rne(form_du(ur[cl * lda + p],
                                    bf16_f32(yr[cl * px + p]),
                                    bf16_f32(dr[cl * px + p]), cst + cl * 5))
                   << (16 * h);
          }
        }
        duw[cl * ldw + pp] = v;
      }
      // x: the word at (row, column) holds x there and at the next column
      const bf16* xr = xraw + slot * CIW * FXR * FWX;
      for (int i = threadIdx.x; i < nci * XPL; i += kThreads) {
        const int ch = i / XPL;
        const int p = i % XPL;
        const int col = p % FXC;
        const int e = (ch * FXR + p / FXC) * FWX + col + lead;
        xw[i] = (uint32_t)xr[e] | (col + 1 < FXC ? (uint32_t)xr[e + 1] << 16
                                                 : 0u);
      }
    };

    pipeline(c0, c1, stages, issue, [&](int c, int slot) {
      convert(c, slot);
      __syncthreads();
      // k16 steps: pixels kk + 2 tig, + 1 (b0) and kk + 2 tig + 8, + 9
      // (b1), each pair in one row of the chunk
      for (int kk = 16 * wk; kk < px; kk += 16 * wk_n) {
        const int x0 = pxo[kk + 2 * tig];
        const int x1 = pxo[kk + 2 * tig + 8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int pr = wp + wp_n * i;
          if (pr >= npairs) break;
          const int a0 = (16 * (pr / nn8) + g) * ldw + kk / 2 + tig;
          const uint32_t a[4] = {duw[a0], duw[a0 + 8 * ldw], duw[a0 + 4],
                                 duw[a0 + 8 * ldw + 4]};
          const int no = noff[8 * (pr % nn8) + g];
          const uint32_t b[2] = {xw[x0 + no], xw[x1 + no]};
          mma_bf16(part[i], a, b);
        }
      }
      add_chunk(acc, part);
    });
  }

  // the K-step groups' sums, in a fixed order, into the wk == 0 warps
  __syncthreads();
  float* red = smem;  // [warp][tile][lane][4]
  if (wk > 0)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((warp * 8 + i) * 32 + lane) * 4 + e] = acc[i][e];
  __syncthreads();
  if (wk > 0) return;
  for (int o = 1; o < wk_n; ++o)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][e] += red[(((warp + o) * 8 + i) * 32 + lane) * 4 + e];

  // this split's partial dW over its chunks (0 if it had none)
  float* dwb = dwp + (size_t)blockIdx.y * cin * cout * K * K;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int pr = wp + wp_n * i;
    if (pr >= npairs) break;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = 16 * (pr / nn8) + g + 8 * h;
        const int col = 8 * (pr % nn8) + 2 * tig + e;
        if (cl < nco && col < nci * T1) {
          const int t = col % T1;
          dwb[w_index<S, K>(co0 + cl, ci0 + col / T1, ph.ky(t), ph.kx(t),
                            cin, cout)] = acc[i][2 * h + e];
        }
      }
  }
}

template <int V>
using IC = std::integral_constant<int, V>;

// f(IC<S>, IC<K>) for the supported (stride, kernel) pairs; -1 otherwise.
template <typename F>
int dispatch(int s, int k, F&& f) {
  if (s == 1 && k == 1) return f(IC<1>{}, IC<1>{});
  if (s == 1 && k == 3) return f(IC<1>{}, IC<3>{});
  if (s == 1 && k == 5) return f(IC<1>{}, IC<5>{});
  if (s == 1 && k == 7) return f(IC<1>{}, IC<7>{});
  if (s == 2 && k == 4) return f(IC<2>{}, IC<4>{});
  if (s == 4 && k == 8) return f(IC<4>{}, IC<8>{});
  return -1;
}

// the grids of the u GEMM (z: samples x 64-channel tiles, y: row tiles) and
// of dx (z: samples x 64-channel tiles)
bool dims_ok(int n, int cin, int h, int w, int cout) {
  return n > 0 && cin > 0 && h > 0 && w > 0 && cout > 0 &&
         (long long)n * ((cout + kNT - 1) / kNT) <= 65535 &&
         (long long)n * ((cin + kNT - 1) / kNT) <= 65535 &&
         (h + kTH - 1) / kTH <= 65535;
}

// Ring depths of the u GEMM (stats, bwd1), dx and dW for the widths.
template <typename T, int S, int K>
void bwd_stages(int cin, int cout, int (&st)[3]) {
  st[0] = with_rows(rup(cout < kNT ? cout : kNT, 8), [&](auto R) {
    return pick_stages([&](int s) {
      return u_gemm_smem_floats<T, S, K, R.value>(cout, s);
    });
  });
  st[1] = with_rows(rup(cin < kNT ? cin : kNT, 8), [&](auto R) {
    return pick_stages(
        [&](int s) { return dx_smem_floats<T, S, K, R.value>(cin, s); });
  });
  st[2] = with_dw_cols<S>(cout, [&](auto D) {
    return pick_stages(
        [&](int s) { return dw_smem_floats<T, S, K, D.value>(cout, s); });
  });
}

// Shared memory of a block of the u GEMM (which = 0: stats and bwd1), dx
// (1) or dW (2) in bytes.
template <typename T, int S, int K>
int bwd_smem_bytes(int cin, int cout, int which) {
  int st[3];
  bwd_stages<T, S, K>(cin, cout, st);
  int f;
  if (which == 0) {
    f = with_rows(rup(cout < kNT ? cout : kNT, 8), [&](auto R) {
      return u_gemm_smem_floats<T, S, K, R.value>(cout, st[0]);
    });
  } else if (which == 1) {
    f = with_rows(rup(cin < kNT ? cin : kNT, 8), [&](auto R) {
      return dx_smem_floats<T, S, K, R.value>(cin, st[1]);
    });
  } else {
    f = with_dw_cols<S>(cout, [&](auto D) {
      return dw_smem_floats<T, S, K, D.value>(cout, st[2]);
    });
  }
  return f * (int)sizeof(float);
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// dW tiles of a site (phases x input-channel tiles x output-channel tiles)
template <int S, int K>
int dw_tiles(int cin, int cout) {
  using B = Bwd<S, K>;
  return B::PH * ((cin + B::CIW - 1) / B::CIW) * ((cout + kMW - 1) / kMW);
}

// dW splits: enough blocks for about four per SM, at most kMaxSplit and at
// most one a K chunk
template <int S, int K>
int bwd2_splits(int n, int h, int w, int cin, int cout) {
  const int dwc = with_dw_cols<S>(cout, [](auto D) { return D.value; });
  const long long chunks = (long long)n * ((h + 1) / 2) * ((w + dwc - 1) / dwc);
  const int others = dw_tiles<S, K>(cin, cout);
  long long s = (4LL * sm_count() + others - 1) / others;
  if (s > chunks) s = chunks;
  return clampi((int)(s < kMaxSplit ? s : kMaxSplit), 1, kMaxSplit);
}


template <typename Kern>
cudaError_t set_smem(Kern kern, int bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The u GEMM's launch: stats (mean, inv, y and dy null) or bwd1.
template <typename T, bool STATS>
int launch_u_gemm(const void* x, const void* w, const void* mean,
                  const void* inv, const void* y, const void* dy, void* u,
                  void* p1, void* p2, int n, int cin, int h, int wd,
                  int cout, int k, int s, void* stream) {
  if (!dims_ok(n, cin, h, wd, cout)) return (int)cudaErrorInvalidValue;
  const int r = dispatch(s, k, [&](auto S_, auto K_) {
    constexpr int S = decltype(S_)::value;
    constexpr int K = decltype(K_)::value;
    int st[3];
    bwd_stages<T, S, K>(cin, cout, st);
    return with_rows(rup(cout < kNT ? cout : kNT, 8), [&](auto R_) {
      constexpr int R = decltype(R_)::value;
      const int smem =
          u_gemm_smem_floats<T, S, K, R>(cout, st[0]) * (int)sizeof(float);
      cudaError_t err = set_smem(u_gemm_kernel<T, S, K, R, STATS>, smem);
      if (err != cudaSuccess) return (int)err;
      const dim3 grid(Bwd<S, K>::PH * ((wd + kTW - 1) / kTW),
                      (h + kTH * R - 1) / (kTH * R),
                      n * ((cout + kNT - 1) / kNT));
      u_gemm_kernel<T, S, K, R, STATS><<<grid, kThreads, smem,
                                         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<const float*>(mean), static_cast<const float*>(inv),
          static_cast<const T*>(y), static_cast<const T*>(dy),
          static_cast<float*>(u), static_cast<float*>(p1),
          static_cast<float*>(p2), cin, h, wd, cout, st[0]);
      return (int)cudaGetLastError();
    });
  });
  return r < 0 ? (int)cudaErrorInvalidValue : r;
}

// bwd2's two launches, dx then dW.
template <typename T>
int launch_bwd2(const void* x, const void* w, const DuConsts& kc,
                const void* u, const void* y, const void* dy, void* dx,
                void* dwp, int n, int cin, int h, int wd, int cout, int k,
                int s, int nsplit, cudaStream_t strm) {
  const int r = dispatch(s, k, [&](auto S_, auto K_) {
    constexpr int S = decltype(S_)::value;
    constexpr int K = decltype(K_)::value;
    const float* uf = static_cast<const float*>(u);
    const T* yt = static_cast<const T*>(y);
    const T* dyt = static_cast<const T*>(dy);
    int st[3];
    bwd_stages<T, S, K>(cin, cout, st);
    cudaError_t err = (cudaError_t)with_rows(
        rup(cin < kNT ? cin : kNT, 8), [&](auto R_) {
          constexpr int R = decltype(R_)::value;
          const int smem_dx =
              dx_smem_floats<T, S, K, R>(cin, st[1]) * (int)sizeof(float);
          cudaError_t e = set_smem(dx_kernel<T, S, K, R>, smem_dx);
          if (e != cudaSuccess) return (int)e;
          const dim3 grid_dx((wd + kTW - 1) / kTW,
                             (h + kTH * R - 1) / (kTH * R),
                             n * ((cin + kNT - 1) / kNT));
          dx_kernel<T, S, K, R><<<grid_dx, kThreads, smem_dx, strm>>>(
              static_cast<const T*>(w), kc, uf, yt, dyt, static_cast<T*>(dx),
              cin, h, wd, cout, st[1]);
          return (int)cudaGetLastError();
        });
    if (err != cudaSuccess) return (int)err;
    return with_dw_cols<S>(cout, [&](auto D) {
      constexpr int DWC = decltype(D)::value;
      const int smem_dw =
          dw_smem_floats<T, S, K, DWC>(cout, st[2]) * (int)sizeof(float);
      cudaError_t e = set_smem(dw_kernel<T, S, K, DWC>, smem_dw);
      if (e != cudaSuccess) return (int)e;
      const dim3 grid_dw(dw_tiles<S, K>(cin, cout), nsplit);
      dw_kernel<T, S, K, DWC><<<grid_dw, kThreads, smem_dw, strm>>>(
          static_cast<const T*>(x), kc, uf, yt, dyt,
          static_cast<float*>(dwp), n, cin, h, wd, cout, st[2]);
      return (int)cudaGetLastError();
    });
  });
  return r < 0 ? (int)cudaErrorInvalidValue : r;
}

}  // namespace

extern "C" {

// Spatial blocks a sample of the u GEMM's launch, stats or bwd1 (the rows
// of its partials per sample), for x (h, w) and cout output channels; -1
// for an unsupported (k, s). The same in both dtypes.
int bpt_conv_bn_bwd1_tiles(int h, int w, int cout, int k, int s) {
  return dispatch(s, k, [&](auto S_, auto K_) {
    using B = Bwd<decltype(S_)::value, decltype(K_)::value>;
    const int th = kTH * rows_for(rup(cout < kNT ? cout : kNT, 8));
    return B::PH * ((w + kTW - 1) / kTW) * ((h + th - 1) / th);
  });
}

// Partial dW rows of the bwd2 call (its pixel splits) for x (n, cin, h, w)
// and cout output channels; -1 for an unsupported (k, s). The same in both
// dtypes.
int bpt_conv_bn_bwd2_splits(int n, int cin, int h, int w, int cout, int k,
                            int s) {
  return dispatch(s, k, [&](auto S_, auto K_) {
    return bwd2_splits<decltype(S_)::value, decltype(K_)::value>(n, h, w,
                                                                 cin, cout);
  });
}

// Shared memory of a block of the u GEMM (which = 0: stats and bwd1), dx
// (1) or dW (2) launch in bytes, float32 (dtype 0) or bfloat16 (dtype 1);
// -1 for an unsupported (k, s), which or dtype.
int bpt_conv_bn_bwd_smem(int cin, int cout, int k, int s, int which,
                         int dtype) {
  if (which < 0 || which > 2 || dtype < 0 || dtype > 1) return -1;
  return dispatch(s, k, [&](auto S_, auto K_) {
    constexpr int S = decltype(S_)::value;
    constexpr int K = decltype(K_)::value;
    return dtype == 0 ? bwd_smem_bytes<float, S, K>(cin, cout, which)
                      : bwd_smem_bytes<bf16, S, K>(cin, cout, which);
  });
}

// stats: x (N, Cin, H, W), w OIHW (s == 1) or IOHW (s > 1), float32 (dtype
// 0) or bfloat16 (dtype 1). Writes u (N, Cout, s H, s W) and the partial
// sums of u (p1) and u^2 (p2), (N * tiles, Cout) with tiles =
// bpt_conv_bn_bwd1_tiles, f32. All contiguous. Returns the cudaError_t of
// the launch (0 on success); asynchronous on `stream`.
int bpt_conv_bn_stats(const void* x, const void* w, void* u, void* p1,
                      void* p2, int n, int cin, int h, int wd, int cout,
                      int k, int s, int dtype, void* stream) {
  if (dtype == 0)
    return launch_u_gemm<float, true>(x, w, nullptr, nullptr, nullptr,
                                      nullptr, u, p1, p2, n, cin, h, wd,
                                      cout, k, s, stream);
  if (dtype == 1)
    return launch_u_gemm<bf16, true>(x, w, nullptr, nullptr, nullptr,
                                     nullptr, u, p1, p2, n, cin, h, wd, cout,
                                     k, s, stream);
  return (int)cudaErrorInvalidValue;
}

// fwd: u (N, C, hw), a, b (C), f32, contiguous; y = max(u a + b, 0):
// dtype 0 over u in place (y must be u), dtype 1 into y (N, C, hw)
// bfloat16.
int bpt_conv_bn_fwd(void* u, const void* a, const void* b, void* y, int n,
                    int c, int hw, int dtype, void* stream) {
  // blocks a plane: ceil(hw / (4 kThreads kFwdUnroll)), which covers every
  // element of bn_relu_bf16_kernel's element path (hw % 4 != 0) too; for
  // hw % 4 == 0 it is ceil((hw / 4) / (kThreads kFwdUnroll))
  const long long groups =
      ((long long)hw + 4 * kThreads * kFwdUnroll - 1) /
      (4 * kThreads * kFwdUnroll);
  if (n <= 0 || c <= 0 || hw <= 0 || (long long)n * c > 2147483647LL ||
      groups > 65535 || (dtype == 0 && y != u) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n * c, groups > 0 ? (int)groups : 1);
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    bn_relu_kernel<<<grid, kThreads, 0, strm>>>(
        static_cast<float*>(u), static_cast<const float*>(a),
        static_cast<const float*>(b), c, hw);
  else
    bn_relu_bf16_kernel<<<grid, kThreads, 0, strm>>>(
        static_cast<const float*>(u), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<bf16*>(y), c, hw);
  return (int)cudaGetLastError();
}

// bwd1: x, w as stats; mean, inv (Cout) f32; y, dy (N, Cout, s H, s W) in
// x's dtype. Writes u (y's shape, f32) and the partial sums of dv (p1) and
// dv * uhat (p2), (N * tiles, Cout) with tiles = bpt_conv_bn_bwd1_tiles.
int bpt_conv_bn_bwd1(const void* x, const void* w, const void* mean,
                     const void* inv, const void* y, const void* dy, void* u,
                     void* p1, void* p2, int n, int cin, int h, int wd,
                     int cout, int k, int s, int dtype, void* stream) {
  if (dtype == 0)
    return launch_u_gemm<float, false>(x, w, mean, inv, y, dy, u, p1, p2, n,
                                       cin, h, wd, cout, k, s, stream);
  if (dtype == 1)
    return launch_u_gemm<bf16, false>(x, w, mean, inv, y, dy, u, p1, p2, n,
                                      cin, h, wd, cout, k, s, stream);
  return (int)cudaErrorInvalidValue;
}

// bwd2: x, w as stats; a, mean, inv, s1n = S1 / count, s2n = S2 / count
// (Cout) f32; u (from bwd1, f32), y, dy (N, Cout, s H, s W; x's dtype).
// Writes dx (N, Cin, H, W; x's dtype) and dwp (nsplit, w's shape; f32),
// nsplit = bpt_conv_bn_bwd2_splits: two launches on `stream`, dx then dW.
int bpt_conv_bn_bwd2(const void* x, const void* w, const void* a,
                     const void* mean, const void* inv, const void* s1n,
                     const void* s2n, const void* u, const void* y,
                     const void* dy, void* dx, void* dwp, int n, int cin,
                     int h, int wd, int cout, int k, int s, int nsplit,
                     int dtype, void* stream) {
  if (!dims_ok(n, cin, h, wd, cout) || nsplit < 1 || nsplit > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  const DuConsts kc{static_cast<const float*>(a),
                    static_cast<const float*>(mean),
                    static_cast<const float*>(inv),
                    static_cast<const float*>(s1n),
                    static_cast<const float*>(s2n)};
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd2<float>(x, w, kc, u, y, dy, dx, dwp, n, cin, h, wd,
                              cout, k, s, nsplit, strm);
  if (dtype == 1)
    return launch_bwd2<bf16>(x, w, kc, u, y, dy, dx, dwp, n, cin, h, wd,
                             cout, k, s, nsplit, strm);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
