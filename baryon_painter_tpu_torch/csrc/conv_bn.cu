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
//             per-tile partial sums of u and u^2 per channel
//   K4-fwd:   y = max(u * a + b, 0), in place over u
//   K4-bwd1:  u again, written to a scratch tensor, and per-tile partial
//             sums of dv and dv * uhat per channel, where dv = dy if y > 0
//             else 0 (the forward's ReLU mask) and uhat = (u - mean) * inv
//   K4-bwd2:  du = a * (dv - S1/n - uhat * S2/n), formed once a pixel from
//             u, y and dy (in f32 over u, which bwd2 is the last to read);
//             dW as partial sums over a split of the pixels; dx = the
//             adjoint conv of du
//
// The partial sums are written per tile (dW: per split) and summed by the
// wrapper in torch (K4-stats' in f64); no atomics are used, so every result
// is deterministic.
//
// Two families of convolution, NCHW, computed directly (no space-to-depth):
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
// What bounds them: the GEMMs run on the tensor cores at 3xTF32 (f32) or
// bf16; at the fiducial sites (batch 24, 512^2) sites B and C are bounded by
// the tensor cores in f32, A and D and every bf16 site by memory (PERF.md).
//
// Design (Hopper's warpgroup products fed by TMA). Three implicit GEMMs, all
// with A from registers and B from shared memory:
//   u (stats, bwd1): M = output pixels of one phase, N = Cout (tiles of
//                    64 columns), K = Cin x taps of the phase (ci slowest)
//   dx:              M = input pixels, N = Cin, K = Cout x K^2 (co slowest)
//   dW:              M = Cin x taps of one phase (a 64-row tile a slab of
//                    channels), N = Cout, K = the phase's pixels
//   - wgmma m64nN (N = 8, 16, 32 or 64, the narrowest that holds the
//     block's columns), k8 tf32 or k16 bf16. f32 is 3xTF32: each f32
//     operand v is split into big and small, and small*big + big*small +
//     big*big accumulate; the weights' halves come split from the wrapper
//     (ops/conv_bn.py `_kernel_weights`, rounded to nearest), A is split
//     in registers (rounded to nearest in the u GEMM, whose sums reach the
//     batch statistics; truncating in dx and dW), dW's du as it is staged
//     (truncating). bf16 products are exact.
//   - One block = three consumer warpgroups and one producer warpgroup
//     that hands registers to them (setmaxnreg: 40 and 152). The
//     producer's first thread streams each K chunk with TMA through a ring
//     of stages with a full/empty mbarrier pair each: u and dx a weight
//     tile (N rows x 128 bytes of K, in the 128-byte swizzle wgmma's
//     descriptor reads) and the window of x or du that the chunk's
//     channels span (zeros out of bounds: the convolution's padding), and
//     the producer's first warp writes the chunk's table of (channel, tap)
//     offsets into the same stage, so shared memory does not grow with K;
//     dW whole fine rows of du (all S^2 phases of its coarse rows, so
//     nothing is read strided by phase) and the window of x they need.
//   - A is gathered: each lane loads its fragment's elements from the staged
//     window, at its pixel's offset plus the K index's offset (u, dx: the
//     stage's table; dW: its rows' (channel, tap) offsets plus the
//     pixel's), so every family and phase runs one mainloop.
//   - u and dx: persistent blocks, one an SM, walk tiles of 12 MT x 16
//     pixels (MT m64 tiles of 4 rows a warpgroup: 2 for N <= 16, whose
//     products are short, so each wait and table lookup serves twice the
//     pixels, else 1), the ring running on across tiles; a K chunk is 1 to
//     4 rows of 32 f32 / 64 bf16 (4 for N <= 16: a chunk's ring wait and
//     window fetch are paid once for its rows). dW: a block owns up to 3
//     MTW m64 row tiles (MTW = 64 / N, at most 4, a warpgroup) and walks
//     its split's chunks of RD coarse rows x 32 (f32) or 64 (bf16)
//     columns; the splits are sized so at least two blocks an SM run, and
//     each writes its partial dW, summed by the wrapper in a fixed order.
//     dW's N is narrower where every phase's du tiles would not fit (s = 4
//     in f32 past 16).
//   - The tensor cores' sums truncate: each k-step's products are summed
//     from zero in one of two accumulators and added into an f32 side sum
//     in registers once its wgmma group is done, while the next k-step's
//     group runs in the other and the next k-step's A loads (the error does
//     not grow with K, and u does not drift toward zero into the batch
//     statistics). Each 128-byte row of K ends with every group done: a
//     group in flight across a runtime loop's back edge makes ptxas
//     serialize the wgmmas (C7514).
//   - stats and bwd1 are one kernel template that differs only in its
//     epilogue: stats sums u and u^2, bwd1 dv and dv * uhat, both over the
//     pixels inside the image as u is stored. One mainloop with one K
//     order, so the u behind the batch statistics and the forward's mask
//     is, bit for bit, the u bwd1 recomputes for bwd2.
//   - du is formed once a pixel by a pass over memory (`du_kernel`), into
//     u's buffer in f32 (bf16: a bf16 tensor, du rounded to bf16 where it
//     is formed, before both of its products), with zeros past the image's
//     width where the row pitch is padded; dW and dx then stage du alone.
//   - TMA reads rows whose pitch is a multiple of 16 bytes: the wrapper
//     pads x and du's rows where the width is not (the edges only).
//   - The waits on mbarriers loop in PTX and the roles branch on a warp
//     index the compiler knows is warp-uniform: otherwise ptxas serializes
//     the wgmmas (C7518; kernel_report prints such notes).
//
// bf16 (the JAX package's default compute dtype): x, w, y, dy and dx bf16;
// u, its sums, S1 and S2 and the dW partials f32; K4-fwd writes y =
// bf16(max(u a + b, 0)) from the f32 u into a new bf16 tensor (y is 2 bytes
// an element, u 4, so it cannot take u's buffer); dx is rounded once from
// its f32 sum.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and called through ctypes (baryon_painter_tpu_torch/ops/_build.py).
// cuTensorMapEncodeTiled is reached through the runtime's driver entry
// point, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "ptx.cuh"

namespace {

// a bfloat16 tensor element, read and written as its 16 bits (the top half
// of an f32)
typedef uint16_t bf16;

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

constexpr int kMaxSmem = 232448;        // bytes a block may use
constexpr int kWGS = 3;                 // consumer warpgroups
constexpr int kConsumers = 128 * kWGS;
constexpr int kThreads = kConsumers + 128;   // and the producer warpgroup
// registers a producer and a consumer thread (setmaxnreg): the pixel
// GEMMs' producer walks tiles (it spilled at 24, and at 32 with N = 64),
// and 3 x 128 x 152 + 128 x 40 fits the SM's 65536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 152;
constexpr int kTR = 4 * kWGS;           // u and dx: tiles of 12 MT x 16
constexpr int kTW = 16;                 // pixels, MT m64 tiles of 4 rows a
                                        // warpgroup
constexpr int kRow = 128;               // bytes of K a B row holds
constexpr int kSteps = 4;               // k-steps a 128-byte row
constexpr int kMaxBox = 256;            // elements a TMA box dimension
constexpr int kMaxRaw = 32768;          // dW: bytes of du a stage, at most

__host__ __device__ constexpr int rup(int v, int m) {
  return (v + m - 1) / m * m;
}
__host__ __device__ constexpr int cdiv(int v, int m) {
  return (v + m - 1) / m;
}

// KCH: K elements a 128-byte row; KSTEP: a wgmma's K; PARTS: B's parts
// (f32: big and small)
template <typename T>
struct Elt;
template <>
struct Elt<float> {
  static constexpr int KCH = 32, KSTEP = 8, PARTS = 2;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Elt<bf16> {
  static constexpr int KCH = 64, KSTEP = 16, PARTS = 1;
  static constexpr CUtensorMapDataType TMA =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// m64 tiles a u or dx warpgroup holds (pix_mt) and a dW warpgroup
// (dw_mtw), as their side sums' registers allow
__host__ __device__ constexpr int pix_mt(int nt) { return nt <= 16 ? 2 : 1; }
__host__ __device__ constexpr int dw_mtw(int nt) {
  return nt >= 64 ? 1 : (64 / nt > 4 ? 4 : 64 / nt);
}

// The 3xTF32 split of v rounded to nearest: big = tf32(v), small =
// tf32(v - big), both exact tf32 values, so the tensor cores truncate
// neither. A truncating split (split_tf32: big = v with 13 low bits
// cleared, small = v - big, which the tensor cores truncate) biases every
// product toward zero by about 2^-21 of it: in u that bias reaches the
// batch statistics as a drift (tests/test_torch_conv_bn_gemm.py), in dx
// and dW it stays 200x inside their tolerance
__device__ __forceinline__ void split_rna(float v, uint32_t& big,
                                          uint32_t& small) {
  const float b = tf32_rna(v);
  big = __float_as_uint(b);
  small = __float_as_uint(tf32_rna(v - b));
}

// The A fragment of one k-step, gathered from a staged window: element
// (row, k) at s[r + o] with r the row's offset and o the K index's.
template <typename T>
struct Frag;

template <>
struct Frag<float> {
  static constexpr int NK = 2;   // K indices a lane: tig, tig + 4
  // the gathered elements, before their split (fetched a k-step ahead)
  struct Raw {
    float v[4];
  };
  uint32_t big[4], small[4];
  __device__ __forceinline__ static void fetch(Raw& w, const float* s,
                                               int r0, int r1,
                                               const int (&o)[NK]) {
    w.v[0] = s[r0 + o[0]];
    w.v[1] = s[r1 + o[0]];
    w.v[2] = s[r0 + o[1]];
    w.v[3] = s[r1 + o[1]];
  }
  // RNA: the split rounded to nearest (the u GEMM, whose sums reach the
  // batch statistics), else truncating (dx, dW: two instructions a value)
  template <bool RNA>
  __device__ __forceinline__ void split(const Raw& w) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (RNA)
        split_rna(w.v[e], big[e], small[e]);
      else
        split_tf32(w.v[e], big[e], small[e]);
    }
  }
  // d = a b in 3xTF32; desc: B's big half, its small half NT rows on
  template <int N>
  __device__ __forceinline__ void mma(float (&d)[N / 2],
                                      uint64_t desc) const {
    constexpr uint64_t kSmall = (uint64_t)N * kRow >> 4;
    Wgmma<N>::tf32(d, small, desc, false);
    Wgmma<N>::tf32(d, big, desc + kSmall, true);
    Wgmma<N>::tf32(d, big, desc, true);
  }
  __device__ __forceinline__ static void lane_k(int tig, int (&k)[NK]) {
    k[0] = tig;
    k[1] = tig + 4;
  }
};

template <>
struct Frag<bf16> {
  static constexpr int NK = 4;   // 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9
  struct Raw {
    uint32_t h[8];
  };
  uint32_t a[4];
  __device__ __forceinline__ static void fetch(Raw& w, const bf16* s,
                                               int r0, int r1,
                                               const int (&o)[NK]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      w.h[4 * i] = s[r0 + o[2 * i]];
      w.h[4 * i + 1] = s[r0 + o[2 * i + 1]];
      w.h[4 * i + 2] = s[r1 + o[2 * i]];
      w.h[4 * i + 3] = s[r1 + o[2 * i + 1]];
    }
  }
  template <bool RNA>   // bf16 values are exact: the pairs packed, no split
  __device__ __forceinline__ void split(const Raw& w) {
    a[0] = w.h[0] | w.h[1] << 16;
    a[1] = w.h[2] | w.h[3] << 16;
    a[2] = w.h[4] | w.h[5] << 16;
    a[3] = w.h[6] | w.h[7] << 16;
  }
  template <int N>
  __device__ __forceinline__ void mma(float (&d)[N / 2],
                                      uint64_t desc) const {
    Wgmma<N>::bf16(d, a, desc, false);
  }
  __device__ __forceinline__ static void lane_k(int tig, int (&k)[NK]) {
    k[0] = 2 * tig;
    k[1] = 2 * tig + 1;
    k[2] = 2 * tig + 8;
    k[3] = 2 * tig + 9;
  }
};

// sum += acc, once acc's wgmma group is done (an ordinary, rounding add)
template <int R>
__device__ __forceinline__ void drain(float (&sum)[R], float (&acc)[R]) {
#pragma unroll
  for (int e = 0; e < R; ++e) {
    fence_operand(acc[e]);
    sum[e] += acc[e];
  }
}

// The ring's barriers: full[s] completes when a chunk's data landed,
// empty[s] when every consumer warp is done with it
struct Ring {
  uint32_t bars;
  int stages;
  __device__ __forceinline__ uint32_t full(int s) const {
    return bars + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8 * (stages + s);
  }
};

// The block's shared memory from a 1024-byte aligned base (swizzle atoms
// and TMA boxes start on one)
struct Smem {
  uint32_t base;          // shared-memory address
  unsigned char* ptr;     // the same, generic
};

__device__ __forceinline__ Smem smem_base() {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  return {base, smem_raw + (base - raw)};
}

// full[s] completes on `arrivals` arrivals and its TMA bytes
__device__ __forceinline__ void init_ring(const Ring& ring, int arrivals) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring.stages; ++s) {
      mbar_init(ring.full(s), arrivals);
      mbar_init(ring.empty(s), kConsumers / 32);
    }
    mbar_fence_init();
  }
}

__device__ __forceinline__ void release(const Ring& ring, int s, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(ring.empty(s));
}

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

// ------------------------------------------------------------------------ //
// The pixel GEMMs: u (K4-stats, K4-bwd1) and dx (K4-bwd2). M = a block's
// 12 x 16 pixels, K = channels x taps in chunks of one 128-byte B row, the
// window of channels a chunk spans staged beside its weight tile.

struct PixGeo {
  int S, K, P, PH;          // family; output phases (dx: 1)
  int gh, gw;               // the grid the blocks tile (x's H, W)
  int ho, wo;               // the output plane (u: y's; dx: x's)
  int ncol;                 // N: Cout (u) or Cin (dx)
  int tr;                   // a tile's rows: 12 pix_mt(N)
  int taps, kdim, nrows;    // taps a channel; K; 128-byte rows of K
  int R, nchunks;           // rows a chunk (a stage), chunks
  int FH, FW, nch;          // the window: rows, row pitch, channels
  int stages;
  int wtile, wbytes, xbytes, table;  // a stage: R weight tiles, a window,
  int stage;                         // the chunk's offset table (from the
                                     // stage's start), bytes
  int bars, red, bytes;              // offsets from the base; bytes asked
};

// kind 0: the u GEMM, 1: dx
template <typename T>
PixGeo pix_geo(int kind, int s, int k, int cin, int h, int w, int cout,
               int nt) {
  constexpr int KCH = Elt<T>::KCH;
  const int al = 16 / (int)sizeof(T);   // TMA rows: 16-byte multiples
  PixGeo g{};
  g.S = s;
  g.K = k;
  g.P = s == 1 ? (k - 1) / 2 : s / 2;
  g.PH = kind == 1 ? 1 : s * s;
  g.gh = h;
  g.gw = w;
  g.ho = kind == 1 ? h : s * h;
  g.wo = kind == 1 ? w : s * w;
  g.ncol = kind == 1 ? cin : cout;
  g.tr = kTR * pix_mt(nt);
  const int chans = kind == 1 ? cout : cin;
  g.taps = kind == 1 || s == 1 ? k * k : 4;
  g.kdim = chans * g.taps;
  g.nrows = cdiv(g.kdim, KCH);
  // a window row starts at the 16-byte boundary at or before its first
  // column (TMA's boxes start there), up to al - 1 columns early
  if (s == 1) {
    g.FH = g.tr + k - 1;
    g.FW = rup(kTW + k - 1 + al - 1, al);
  } else if (kind == 0) {
    g.FH = g.tr + 1;
    g.FW = rup(kTW + 1 + al - 1, al);
  } else {
    g.FH = s * (g.tr - 1) + k;
    g.FW = rup(s * (kTW - 1) + k + al - 1, al);
  }
  // rows of K a chunk: up to 4 for narrow N (a chunk's waits, drain and
  // window are paid once for its rows), fewer where they do not fit
  g.wtile = Elt<T>::PARTS * nt * kRow;
  for (g.R = nt <= 16 ? 4 : nt == 32 ? 2 : 1; g.R >= 1; --g.R) {
    if (g.R > g.nrows) continue;
    g.nchunks = cdiv(g.nrows, g.R);
    g.nch = 0;
    for (int j = 0; j < g.nchunks; ++j) {
      const int lo = j * g.R * KCH / g.taps;
      int hi = ((j + 1) * g.R * KCH - 1) / g.taps;
      if (hi > chans - 1) hi = chans - 1;
      if (hi - lo + 1 > g.nch) g.nch = hi - lo + 1;
    }
    g.wbytes = g.R * g.wtile;
    g.xbytes = g.nch * g.FH * g.FW * (int)sizeof(T);
    g.table = g.wbytes + rup(g.xbytes, 16);
    g.stage = rup(g.table + 4 * g.R * KCH, 1024);
    for (g.stages = 4; g.stages >= 2; --g.stages) {
      g.bars = g.stages * g.stage;
      g.red = g.bars + 16 * g.stages;
      g.bytes = g.red + 4 * (kConsumers / 32) * nt * 2 + 1024;
      if (g.bytes <= kMaxSmem) break;
    }
    if (g.stages >= 2 && g.nch <= kMaxBox) break;
  }
  if (g.R < 1 || g.FW > kMaxBox || g.FH > kMaxBox)
    g.bytes = 0;   // does not fit: the launch refuses it
  return g;
}

// The first column of a window row whose first needed column is c: the
// 16-byte boundary at or before it (a box's innermost start must be one)
template <typename T>
__device__ __forceinline__ int aligned_col(int c) {
  return c & ~(16 / (int)sizeof(T) - 1);
}

// Offsets in the window: of the pixel in tile row r, column c (first tap),
// of tap t, and the window's origin in the staged tensor. u: x at
// (q + ty - P) (S == 1) or (q + off - ty) (S > 1, the phase's offset);
// dx: du at (p - ky + P) (S == 1) or (S p + ky - P) (S > 1).
__device__ __forceinline__ int pix_off(const PixGeo& g, int kind, int r,
                                       int c) {
  if (kind == 0)
    return g.S == 1 ? r * g.FW + c : (r + 1) * g.FW + c + 1;
  return g.S == 1 ? (r + g.K - 1) * g.FW + c + g.K - 1
                  : g.S * (r * g.FW + c);
}

__device__ __forceinline__ int tap_off(const PixGeo& g, int kind, int t) {
  const int tw = kind == 0 && g.S > 1 ? 2 : g.K;
  const int o = (t / tw) * g.FW + t % tw;
  return (kind == 0) == (g.S == 1) ? o : -o;
}

// A tile of a pixel GEMM launch: phase x 16-column tile, tr-row tile and
// sample x NT columns of the grid; `row` numbers its partial sums (per
// sample, phases and column tiles fastest)
struct PixTile {
  int ph, qx0, q0, n, n0, row;
};

__host__ __device__ __forceinline__ int pix_tiles(const PixGeo& g, int nt,
                                                  int n) {
  return g.PH * cdiv(g.gw, kTW) * cdiv(g.gh, g.tr) * n * cdiv(g.ncol, nt);
}

__device__ __forceinline__ PixTile pix_tile(const PixGeo& g, int nt, int t) {
  const int gx = g.PH * cdiv(g.gw, kTW);
  const int gy = cdiv(g.gh, g.tr);
  const int bx = t % gx;
  const int by = (t / gx) % gy;
  const int bz = t / (gx * gy);
  const int cot = cdiv(g.ncol, nt);
  PixTile p;
  p.ph = bx % g.PH;
  p.qx0 = (bx / g.PH) * kTW;
  p.q0 = by * g.tr;
  p.n = bz / cot;
  p.n0 = (bz % cot) * nt;
  p.row = (p.n * gy + by) * gx + bx;
  return p;
}

// The tile's window: its first needed column cx and row oy (kind 0: x for
// the u GEMM, at the phase's offset; 1: du for dx)
__device__ __forceinline__ void window(const PixGeo& g, int kind,
                                       const PixTile& p, int& cx, int& oy) {
  if (kind == 0) {
    const int offy = g.S == 1 ? 0 : (p.ph / g.S + g.P) / g.S;
    const int offx = g.S == 1 ? 0 : (p.ph % g.S + g.P) / g.S;
    cx = g.S == 1 ? p.qx0 - g.P : p.qx0 + offx - 1;
    oy = g.S == 1 ? p.q0 - g.P : p.q0 + offy - 1;
  } else {
    cx = g.S == 1 ? p.qx0 + g.P - (g.K - 1) : g.S * p.qx0 - g.P;
    oy = g.S == 1 ? p.q0 + g.P - (g.K - 1) : g.S * p.q0 - g.P;
  }
}

// One 128-byte row of K's four k-steps for the warpgroup's MT m64 tiles,
// A in f[0] already: each k-step's products summed from zero in
// acc[kk % 2] and drained into `sum` once its group is done, while the next
// runs; the next k-step's elements fetched (fetch(kk, next_row)) while
// this one's products run. The row ends with every group done: a pipeline
// that crosses no loop's back edge, which ptxas follows without
// serializing the wgmmas (C7514).
template <typename T, int NT, int MT, bool RNA, class Fetch>
__device__ __forceinline__ void row_products(
    float (&sum)[MT][NT / 2], float (&acc)[2][MT][NT / 2],
    Frag<T> (&f)[2][MT], typename Frag<T>::Raw (&w)[MT], uint64_t desc,
    int more, Fetch&& fetch) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < MT; ++m)
      f[kk & 1][m].template mma<NT>(acc[kk & 1][m], desc + 2 * kk);
    wgmma_commit();
    const bool next = kk < kSteps - 1 || more;
    if (next) fetch((kk + 1) % kSteps, kk == kSteps - 1);
    if (kk < kSteps - 1) {
      wgmma_wait<1>();
      if (kk > 0)
#pragma unroll
        for (int m = 0; m < MT; ++m) drain(sum[m], acc[(kk - 1) & 1][m]);
    } else {
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        drain(sum[m], acc[(kk - 1) & 1][m]);
        drain(sum[m], acc[kk & 1][m]);
      }
    }
    if (next)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        f[(kk + 1) & 1][m].template split<RNA>(w[m]);
  }
}

// One tile's products: K chunks it .. it + nchunks - 1 of the ring (the
// block's running chunk count), each of up to R 128-byte rows of K, A
// gathered at the lane's pixels p0[m], p1[m] of its MT m64 tiles through
// the chunk's offset table in its stage.
template <typename T, int NT, int MT, bool RNA>
__device__ __forceinline__ void pixel_mainloop(float (&sum)[MT][NT / 2],
                                               const PixGeo& g,
                                               const Smem& sm,
                                               const Ring& ring,
                                               const int (&p0)[MT],
                                               const int (&p1)[MT], int lane,
                                               int it) {
  constexpr int KCH = Elt<T>::KCH;
  constexpr int KSTEP = Elt<T>::KSTEP;
  constexpr int NK = Frag<T>::NK;
  int kl[NK];
  Frag<T>::lane_k(lane & 3, kl);
  float acc[2][MT][NT / 2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) sum[m][e] = 0.f;
  Frag<T> f[2][MT];
  typename Frag<T>::Raw w[MT];
  for (int j = 0; j < g.nchunks; ++j, ++it) {
    const int s = it % g.stages;
    mbar_wait(ring.full(s), (it / g.stages) & 1);
    const uint32_t st = sm.base + s * g.stage;
    const T* xs = reinterpret_cast<const T*>(sm.ptr + s * g.stage +
                                             g.wbytes);
    const int* koff = reinterpret_cast<const int*>(sm.ptr + s * g.stage +
                                                   g.table);
    const int rows = min(g.R, g.nrows - j * g.R);
    // the elements of k-step kk of row r of this chunk
    auto fetch = [&](int r, int kk) {
      const int* kt = koff + r * KCH + kk * KSTEP;
      int o[NK];
#pragma unroll
      for (int i = 0; i < NK; ++i) o[i] = kt[kl[i]];
#pragma unroll
      for (int m = 0; m < MT; ++m) Frag<T>::fetch(w[m], xs, p0[m], p1[m], o);
    };
    fetch(0, 0);
#pragma unroll
    for (int m = 0; m < MT; ++m) f[0][m].template split<RNA>(w[m]);
    for (int r = 0; r < rows; ++r) {
      const uint64_t desc = wgmma_desc_sw128(st + r * g.wtile);
      row_products<T, NT, MT, RNA>(sum, acc, f, w, desc,
                                   r + 1 < rows ? 1 : 0,
                                   [&](int kk, bool next_row) {
                                     fetch(next_row ? r + 1 : r, kk);
                                   });
    }
    release(ring, s, lane);
  }
}

// The producer's first warp, for each of the block's tiles and each chunk
// j: its lanes write the chunk's table of K offsets into the stage (K
// index k0 + e, k0 = j R KCH, at (channel - the chunk's first channel) x
// the window's plane + the tap's offset; padded K indices read offset 0,
// finite, against zero weights) and arrive; lane 0 loads by TMA the
// chunk's weight tiles (weights (PH, PARTS, N, K) innermost last: a box of
// KCH x NT rows x the parts at (row KCH, n0, 0, ph) for each of its rows)
// and window (a box of FW x FH x nch channels at (ox, oy, the chunk's
// first channel, n), ox the 16-byte boundary at or before the first needed
// column), zeros out of bounds. The ring runs on across tiles, so the next
// tile's chunks land while the consumers finish a tile.
template <typename T, int NT>
__device__ __forceinline__ void pixel_producer(const PixGeo& g, int kind,
                                               int nb, const Smem& sm,
                                               const Ring& ring,
                                               const CUtensorMap* xmap,
                                               const CUtensorMap* wmap,
                                               int lane) {
  constexpr int KCH = Elt<T>::KCH;
  if (lane == 0) {
    tma_prefetch_map(xmap);
    tma_prefetch_map(wmap);
  }
  int it = 0;
  for (int t = blockIdx.x; t < pix_tiles(g, NT, nb); t += gridDim.x) {
    const PixTile p = pix_tile(g, NT, t);
    int cx, oy;
    window(g, kind, p, cx, oy);
    for (int j = 0; j < g.nchunks; ++j, ++it) {
      const int s = it % g.stages;
      const int rows = min(g.R, g.nrows - j * g.R);
      const int k0 = j * g.R * KCH;
      const int lo = k0 / g.taps;
      mbar_wait(ring.empty(s), ((it / g.stages) & 1) ^ 1);
      int* koff = reinterpret_cast<int*>(sm.ptr + s * g.stage + g.table);
      for (int e = lane; e < rows * KCH; e += 32) {
        const int k = k0 + e;
        int o = 0;
        if (k < g.kdim) {
          const int ch = k / g.taps;
          o = (ch - lo) * g.FH * g.FW + tap_off(g, kind, k - ch * g.taps);
        }
        koff[e] = o;
      }
      if (lane != 0) {
        mbar_arrive(ring.full(s));
        continue;
      }
      mbar_arrive_expect_tx(ring.full(s), rows * g.wtile + g.xbytes);
      const uint32_t st = sm.base + s * g.stage;
      for (int r = 0; r < rows; ++r)
        tma_load_4d(st + r * g.wtile, wmap, ring.full(s), k0 + r * KCH, p.n0,
                    0, p.ph);
      tma_load_4d(st + g.wbytes, xmap, ring.full(s), aligned_col<T>(cx), oy,
                  lo, p.n);
    }
  }
}

// K4-stats (STATS) and K4-bwd1: persistent blocks, one an SM, each walking
// the tiles blockIdx.x, + gridDim.x, ... (pix_tile: phase x 16-column
// tile, 12 MT-row tile, sample x NT output channels of the phase's grid,
// x's); warpgroup wg's warp w owns tile rows 4 wg + w + 12 m. For each
// tile the block computes u, writes it, and writes the tile's partial row
// of two per-channel sums over its pixels inside the image: stats u and
// u^2 (mean, inv, y and dy are not read); bwd1 dv and dv * uhat, with dv =
// dy where the forward's y > 0.
template <typename T, int NT, bool STATS>
__global__ void __launch_bounds__(kThreads, 1)
    u_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, const PixGeo g,
                  int nb, const float* __restrict__ mean,
                  const float* __restrict__ inv, const T* __restrict__ y,
                  const T* __restrict__ dy, float* __restrict__ u,
                  float* __restrict__ p1, float* __restrict__ p2) {
  const Smem sm = smem_base();
  const Ring ring{sm.base + g.bars, g.stages};
  float* red = reinterpret_cast<float*>(sm.ptr + g.red);
  const int lane = threadIdx.x & 31;
  const int warp = warp_id();

  init_ring(ring, 32);
  __syncthreads();
  if (warp >= kConsumers / 32) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers / 32)
      pixel_producer<T, NT>(g, 0, nb, sm, ring, &xmap, &wmap, lane);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  constexpr int MT = pix_mt(NT);
  // the warp's tile rows: tr, tr + 12, ...
  const int tr = 4 * (warp >> 2) + (warp & 3);
  const int gl = lane >> 2;
  const int tig = lane & 3;
  int it = 0;
  for (int t = blockIdx.x; t < pix_tiles(g, NT, nb);
       t += gridDim.x, it += g.nchunks) {
    const PixTile p = pix_tile(g, NT, t);
    int cx, oy0;
    window(g, 0, p, cx, oy0);
    const int lead = cx - aligned_col<T>(cx);
    int pa[MT], pb[MT];   // the lane's pixels (rows gl, gl + 8 of m64)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      pa[m] = lead + pix_off(g, 0, tr + kTR * m, gl);
      pb[m] = lead + pix_off(g, 0, tr + kTR * m, gl + 8);
    }
    float sum[MT][NT / 2];
    pixel_mainloop<T, NT, MT, true>(sum, g, sm, ring, pa, pb, lane, it);

    // epilogue: write u; the two sums over the pixels inside the image.
    // sum[m][4 j + 2 h + c]: pixel (row tr + 12 m, column gl + 8 h),
    // channel n0 + 8 j + 2 tig + c; a thread's pixels summed m, then h,
    // an 8-column group at a time (bwd1 loads a group's y and dy before it
    // uses one), each group's sums then over the warp's 8 pixel groups
    // (lanes xor 4, 8, 16) into red, summed over the 12 warps below
    const int ry = p.ph / g.S, rx = p.ph % g.S;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      float a1[2] = {0.f, 0.f}, a2[2] = {0.f, 0.f};
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int q = p.q0 + tr + kTR * m;
        const int oy = g.S == 1 ? q : g.S * q + ry;
        // element i = 2 h + c: column gl + 8 h, channel n0 + 8 j + 2 tig + c
        size_t idx[4];
        bool in[4];
        float yv[4], dyv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int co = p.n0 + 8 * j + 2 * tig + (i & 1);
          const int qx = p.qx0 + gl + 8 * (i >> 1);
          in[i] = co < g.ncol && q < g.gh && qx < g.gw;
          const int ox = g.S == 1 ? qx : g.S * qx + rx;
          idx[i] = ((((size_t)p.n * g.ncol + co) * g.ho) + oy) * g.wo + ox;
          if constexpr (!STATS) {
            yv[i] = in[i] ? ld_f32(y, idx[i]) : 0.f;
            dyv[i] = in[i] ? ld_f32(dy, idx[i]) : 0.f;
          }
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int co = p.n0 + 8 * j + 2 * tig + c;
          const float mc = STATS || co >= g.ncol ? 0.f : __ldg(mean + co);
          const float ic = STATS || co >= g.ncol ? 0.f : __ldg(inv + co);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 2 * h + c;
            if (!in[i]) continue;
            const float v = sum[m][4 * j + i];
            u[idx[i]] = v;
            if constexpr (STATS) {
              a1[c] += v;
              a2[c] = fmaf(v, v, a2[c]);
            } else {
              const float dv = yv[i] > 0.f ? dyv[i] : 0.f;
              a1[c] += dv;
              a2[c] = fmaf(dv, __fmul_rn(__fsub_rn(v, mc), ic), a2[c]);
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float b1 = a1[c], b2 = a2[c];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          b1 += __shfl_xor_sync(0xffffffffu, b1, off);
          b2 += __shfl_xor_sync(0xffffffffu, b2, off);
        }
        if (gl == 0) {
          const int col = 8 * j + 2 * tig + c;
          red[(warp * NT + col) * 2] = b1;
          red[(warp * NT + col) * 2 + 1] = b2;
        }
      }
    }
    named_barrier(1, kConsumers);
    if (threadIdx.x < 2 * NT) {
      const int col = threadIdx.x >> 1;
      const int which = threadIdx.x & 1;
      if (p.n0 + col < g.ncol) {
        float s = 0.f;
        for (int wi = 0; wi < kConsumers / 32; ++wi)
          s += red[(wi * NT + col) * 2 + which];
        (which ? p2 : p1)[(size_t)p.row * g.ncol + p.n0 + col] = s;
      }
    }
    named_barrier(1, kConsumers);   // red is read before the next tile's
  }
}

// dx: persistent blocks as the u GEMM's, over the tiles (16-column tile,
// 12 MT-row tile, sample x NT input channels) of x's grid, K = Cout x K^2
// over the window of du.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1)
    dx_kernel(const __grid_constant__ CUtensorMap dmap,
              const __grid_constant__ CUtensorMap wmap, const PixGeo g,
              int nb, T* __restrict__ dx) {
  const Smem sm = smem_base();
  const Ring ring{sm.base + g.bars, g.stages};
  const int lane = threadIdx.x & 31;
  const int warp = warp_id();

  init_ring(ring, 32);
  __syncthreads();
  if (warp >= kConsumers / 32) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers / 32)
      pixel_producer<T, NT>(g, 1, nb, sm, ring, &dmap, &wmap, lane);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  constexpr int MT = pix_mt(NT);
  const int tr = 4 * (warp >> 2) + (warp & 3);
  const int gl = lane >> 2;
  const int tig = lane & 3;
  int it = 0;
  for (int t = blockIdx.x; t < pix_tiles(g, NT, nb);
       t += gridDim.x, it += g.nchunks) {
    const PixTile p = pix_tile(g, NT, t);
    int cx, oy;
    window(g, 1, p, cx, oy);
    const int lead = cx - aligned_col<T>(cx);
    int pa[MT], pb[MT];   // the lane's pixels (rows gl, gl + 8 of m64)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      pa[m] = lead + pix_off(g, 1, tr + kTR * m, gl);
      pb[m] = lead + pix_off(g, 1, tr + kTR * m, gl + 8);
    }
    float sum[MT][NT / 2];
    pixel_mainloop<T, NT, MT, false>(sum, g, sm, ring, pa, pb, lane, it);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int iy = p.q0 + tr + kTR * m;
      if (iy >= g.gh) continue;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int ci = p.n0 + 8 * j + 2 * tig + c;
          if (ci >= g.ncol) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ix = p.qx0 + gl + 8 * h;
            if (ix < g.gw)
              st_t(dx, (((size_t)p.n * g.ncol + ci) * g.gh + iy) * g.gw + ix,
                   sum[m][4 * j + 2 * h + c]);
          }
        }
    }
  }
}

// ------------------------------------------------------------------------ //
// du: once a pixel, before dx and dW

// The per-channel constants du = a (dv - s1n - (u - mean) inv s2n) needs.
struct DuConsts {
  const float* a;
  const float* mean;
  const float* inv;
  const float* s1n;
  const float* s2n;
};

constexpr int kDuThreads = 256;

// du (N, C, ho, pitch) in T from u (f32), y and dy (N, C, ho, wo) in T:
// the plain formula, operation for operation, rounded once to T; zeros in
// the columns past wo. One block per (plane, run of rows); a thread writes
// 16 bytes of a row. In f32 du may be u itself (pitch == wo): each thread
// reads the elements it then writes.
template <typename T>
__global__ void __launch_bounds__(kDuThreads)
    du_kernel(const float* u, const T* __restrict__ y,
              const T* __restrict__ dy, DuConsts kc, T* du, int C, int ho,
              int wo, int pitch) {
  constexpr int V = 16 / (int)sizeof(T);
  const int c = blockIdx.x % C;
  const float a = __ldg(kc.a + c), mean = __ldg(kc.mean + c),
              inv = __ldg(kc.inv + c), s1n = __ldg(kc.s1n + c),
              s2n = __ldg(kc.s2n + c);
  const size_t in0 = (size_t)blockIdx.x * ho * wo;
  const size_t out0 = (size_t)blockIdx.x * ho * pitch;
  const int vpr = pitch / V;
  for (int i = blockIdx.y * kDuThreads + threadIdx.x; i < ho * vpr;
       i += gridDim.y * kDuThreads) {
    const int row = i / vpr;
    const int c0 = (i - row * vpr) * V;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float v = 0.f;
      if (c0 + e < wo) {
        const size_t idx = in0 + (size_t)row * wo + c0 + e;
        const float dv = ld_f32(y, idx) > 0.f ? ld_f32(dy, idx) : 0.f;
        const float uhat = __fmul_rn(__fsub_rn(u[idx], mean), inv);
        v = __fmul_rn(a, __fsub_rn(__fsub_rn(dv, s1n), __fmul_rn(uhat, s2n)));
      }
      if constexpr (kIsF32<T>) {
        w[e] = __float_as_uint(v);
      } else {
        const uint32_t b = bf16_rne(v);
        w[e / 2] = e % 2 ? w[e / 2] | b << 16 : b;
      }
    }
    *reinterpret_cast<uint4*>(du + out0 + (size_t)row * pitch + c0) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ------------------------------------------------------------------------ //
// dW: M = Cin x taps of one phase in m64 tiles of CB channels (a "slab"),
// N = Cout (NT columns a block), K = the phase's pixels.

struct DwGeo {
  int S, K, P, PH, T1;
  int cin, cout, gh, gw, ho, wo;
  int CB, tiles, tb;           // channels a tile; m64 tiles; tiles a block
  int lgS, lgRD, RD, CW, lgCW, segs, nrb;   // rows a chunk and columns a
                               // chunk (powers of 2), column segments, row
                               // blocks
  int nchunks, per;            // chunks (all samples), chunks a split
  int FH, FW, nch;             // the x window
  int stages;
  int rawbytes, xbytes, stage, bars, b, bytes;
};

template <typename T>
DwGeo dw_geo(int s, int k, int n, int cin, int h, int w, int cout, int nt,
             int sms) {
  constexpr int KCH = Elt<T>::KCH;
  const int al = 16 / (int)sizeof(T);
  DwGeo g{};
  g.S = s;
  g.K = k;
  g.P = s == 1 ? (k - 1) / 2 : s / 2;
  g.PH = s * s;
  g.T1 = s == 1 ? k * k : 4;
  g.cin = cin;
  g.cout = cout;
  g.gh = h;
  g.gw = w;
  g.ho = s * h;
  g.wo = s * w;
  g.CB = 64 / g.T1 > 0 ? 64 / g.T1 : 1;
  g.tiles = cdiv(cin, g.CB) * g.PH;
  g.lgS = s == 1 ? 0 : s == 2 ? 1 : 2;
  g.CW = KCH;
  g.lgCW = KCH == 32 ? 5 : 6;
  g.segs = cdiv(w, g.CW);
  // rows a chunk: the most (up to 8, at most h) whose du fits kMaxRaw
  g.lgRD = 0;
  while (g.lgRD < 3 && (2 << g.lgRD) <= h &&
         nt * s * (2 << g.lgRD) * s * g.CW * (int)sizeof(T) <= kMaxRaw)
    ++g.lgRD;
  g.RD = 1 << g.lgRD;
  g.nrb = cdiv(h, g.RD);
  g.nchunks = n * g.nrb * g.segs;
  g.FH = g.RD + (s == 1 ? k - 1 : 2);
  g.FW = rup(g.CW + (s == 1 ? k - 1 : 2) + al - 1, al);
  g.rawbytes = nt * s * g.RD * s * g.CW * (int)sizeof(T);
  const int bbytes = g.PH * g.RD * Elt<T>::PARTS * nt * kRow;
  for (g.tb = kWGS * dw_mtw(nt); g.tb >= 1; --g.tb) {
    if (g.tb > g.tiles) continue;
    g.nch = 0;
    for (int b0 = 0; b0 < g.tiles; b0 += g.tb) {
      const int last = (b0 + g.tb < g.tiles ? b0 + g.tb : g.tiles) - 1;
      const int c = (last / g.PH - b0 / g.PH + 1) * g.CB;
      if (c > g.nch) g.nch = c;
    }
    g.xbytes = g.nch * g.FH * g.FW * (int)sizeof(T);
    g.stage = rup(g.rawbytes, 1024) + rup(g.xbytes, 1024);
    for (g.stages = 4; g.stages >= 2; --g.stages) {
      g.b = g.stages * g.stage;
      g.bars = g.b + bbytes;
      g.bytes = g.bars + 16 * g.stages + 1024;
      if (g.bytes <= kMaxSmem) break;
    }
    if (g.stages >= 2 && g.nch <= kMaxBox) break;
  }
  if (g.tb < 1 || g.FW > kMaxBox || s * g.CW > kMaxBox) {
    g.bytes = 0;
    return g;
  }
  // splits: enough blocks for two an SM, at most one a chunk
  const int blocks = cdiv(g.tiles, g.tb) * cdiv(cout, nt);
  int splits = cdiv(2 * sms, blocks);
  if (splits > g.nchunks) splits = g.nchunks;
  if (splits < 1) splits = 1;
  g.per = cdiv(g.nchunks, splits);
  return g;
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1)
    dw_kernel(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap dmap, const DwGeo g,
              float* __restrict__ dwp) {
  constexpr int MTW = dw_mtw(NT);
  constexpr int KSTEP = Elt<T>::KSTEP;
  constexpr int PARTS = Elt<T>::PARTS;
  constexpr int NK = Frag<T>::NK;
  const Smem sm = smem_base();
  const Ring ring{sm.base + g.bars, g.stages};

  const int base = blockIdx.x * g.tb;
  const int lim = min(g.tiles, base + g.tb);
  const int co0 = blockIdx.y * NT;
  const int c0 = min(g.nchunks, (int)blockIdx.z * g.per);
  const int c1 = min(g.nchunks, c0 + g.per);
  const int clo = (base / g.PH) * g.CB;   // the window's first channel
  // the x window's first needed column from a chunk's first (a multiple
  // of CW, so its rows start lead columns earlier in every chunk)
  const int cx = g.S == 1 ? -g.P : -1;
  const int lead = cx - aligned_col<T>(cx);
  const int lane = threadIdx.x & 31;
  const int warp = warp_id();

  init_ring(ring, 1);
  __syncthreads();
  if (warp >= kConsumers / 32) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&dmap);
      for (int c = c0; c < c1; ++c) {
        const int i = c - c0;
        const int s = i % g.stages;
        mbar_wait(ring.empty(s), ((i / g.stages) & 1) ^ 1);
        mbar_arrive_expect_tx(ring.full(s), g.rawbytes + g.xbytes);
        const int n = c / (g.nrb * g.segs);
        const int rem = c - n * g.nrb * g.segs;
        const int q0 = (rem / g.segs) * g.RD;
        const int qx0 = (rem % g.segs) * g.CW;
        const uint32_t st = sm.base + s * g.stage;
        // whole fine rows of du: every phase of the chunk's coarse rows
        tma_load_4d(st, &dmap, ring.full(s), g.S * qx0, g.S * q0, co0, n);
        tma_load_4d(st + rup(g.rawbytes, 1024), &xmap, ring.full(s),
                    aligned_col<T>(qx0 + cx), g.S == 1 ? q0 - g.P : q0 - 1,
                    clo, n);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp >> 2;
  const int gl = lane >> 2;
  const int tig = lane & 3;
  // this warpgroup's tiles base + wg + kWGS i: (slab, phase) = (m / PH,
  // m % PH); the lane's rows rho = 16 (warp % 4) + gl (+ 8) are (channel,
  // tap) = (slab CB + rho / T1, rho % T1), their window offsets r0, r1 (0
  // for rows past the channels: read, never written)
  int r0[MTW], r1[MTW], phs[MTW];
#pragma unroll
  for (int i = 0; i < MTW; ++i) {
    const int m = base + wg + kWGS * i;
    const int sb = m / g.PH;
    const int ph = m - sb * g.PH;
    phs[i] = ph;
    const int ry = ph / g.S, rx = ph % g.S;
    const int offy = g.S == 1 ? 0 : (ry + g.P) / g.S;
    const int offx = g.S == 1 ? 0 : (rx + g.P) / g.S;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rho = 16 * (warp & 3) + gl + 8 * h;
      const int ci = sb * g.CB + rho / g.T1;
      const int t = rho % g.T1;
      int o = 0;
      if (rho < g.CB * g.T1 && ci < g.cin) {
        const int tw = g.S == 1 ? g.K : 2;
        const int ty = t / tw, tx = t % tw;
        o = (ci - clo) * g.FH * g.FW + lead +
            (g.S == 1 ? ty * g.FW + tx
                      : (offy - ty + 1) * g.FW + offx - tx + 1);
      }
      (h ? r1 : r0)[i] = o;
    }
  }
  int kl[NK];
  Frag<T>::lane_k(tig, kl);
  float sum[MTW][1][NT / 2], acc[2][1][NT / 2];
  typename Frag<T>::Raw w[1];
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) sum[i][0][e] = 0.f;
  Frag<T> f[2][1];
  const int fw = g.S * g.CW;               // a staged du row
  const int frows = g.S * g.RD;
  const int raw_total = NT * frows * fw;
  const uint32_t bsm = sm.base + g.b;
  unsigned char* bptr = sm.ptr + g.b;
  for (int c = c0; c < c1; ++c) {
    const int i = c - c0;
    const int s = i % g.stages;
    mbar_wait(ring.full(s), (i / g.stages) & 1);
    // B is free once every warpgroup's products on the last chunk are done
    named_barrier(1, kConsumers);
    // du's raw rows (co, fine row, fine column) into the phases' B tiles
    // (phase, row, part, co, 128-byte swizzled row of the coarse columns)
    const T* raw = reinterpret_cast<const T*>(sm.ptr + s * g.stage);
    const int lgfw = g.lgS + g.lgCW, lgfr = g.lgS + g.lgRD;
    for (int idx = threadIdx.x; idx < raw_total; idx += kConsumers) {
      const int fc = idx & (fw - 1);
      const int fr = (idx >> lgfw) & (frows - 1);
      const int co = idx >> (lgfw + lgfr);
      const int ph = ((fr & (g.S - 1)) << g.lgS) + (fc & (g.S - 1));
      const int r = fr >> g.lgS;
      const int byte = (fc >> g.lgS) * (int)sizeof(T);
      unsigned char* tile =
          bptr + ((ph * g.RD + r) * PARTS) * NT * kRow + co * kRow +
          ((((byte >> 4) ^ (co & 7))) << 4) + (byte & 15);
      if constexpr (kIsF32<T>) {
        uint32_t big, small;
        split_tf32(raw[idx], big, small);
        *reinterpret_cast<uint32_t*>(tile) = big;
        *reinterpret_cast<uint32_t*>(tile + NT * kRow) = small;
      } else {
        *reinterpret_cast<bf16*>(tile) = raw[idx];
      }
    }
    fence_proxy_async();   // the tiles' writes, before wgmma reads them
    named_barrier(1, kConsumers);
    const T* xs = reinterpret_cast<const T*>(sm.ptr + s * g.stage +
                                             rup(g.rawbytes, 1024));
#pragma unroll
    for (int t = 0; t < MTW; ++t) {
      if (base + wg + kWGS * t >= lim) break;
      // the pixels of k-step kk of coarse row r, for this tile's rows
      auto fetch = [&](int r, int kk) {
        int o[NK];
#pragma unroll
        for (int e = 0; e < NK; ++e) o[e] = r * g.FW + kk * KSTEP + kl[e];
        Frag<T>::fetch(w[0], xs, r0[t], r1[t], o);
      };
      fetch(0, 0);
      f[0][0].template split<false>(w[0]);
      for (int r = 0; r < g.RD; ++r)
        row_products<T, NT, 1, false>(
            sum[t], acc, f, w,
            wgmma_desc_sw128(bsm + ((phs[t] * g.RD + r) * PARTS) * NT * kRow),
            r + 1 < g.RD ? 1 : 0, [&](int kk, bool next_row) {
              fetch(next_row ? r + 1 : r, kk);
            });
    }
    release(ring, s, lane);
  }

  // this split's partial dW over its chunks (0 if it had none), in w's
  // layout: sum[t][4 j + 2 h + c] is row rho = 16 (warp % 4) + gl + 8 h,
  // column co0 + 8 j + 2 tig + c
  float* dwb = dwp + (size_t)blockIdx.z * g.cin * g.cout * g.K * g.K;
#pragma unroll
  for (int t = 0; t < MTW; ++t) {
    const int m = base + wg + kWGS * t;
    if (m >= lim) break;
    const int sb = m / g.PH;
    const int ph = m - sb * g.PH;
    const int ky0 = g.S == 1 ? 0 : (ph / g.S + g.P) % g.S;
    const int kx0 = g.S == 1 ? 0 : (ph % g.S + g.P) % g.S;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rho = 16 * (warp & 3) + gl + 8 * h;
      const int ci = sb * g.CB + rho / g.T1;
      const int tt = rho % g.T1;
      if (rho >= g.CB * g.T1 || ci >= g.cin) continue;
      const int ky = g.S == 1 ? tt / g.K : ky0 + g.S * (tt / 2);
      const int kx = g.S == 1 ? tt % g.K : kx0 + g.S * (tt % 2);
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int co = co0 + 8 * j + 2 * tig + c;
          if (co >= g.cout) continue;
          const size_t wi =
              g.S == 1
                  ? (((size_t)co * g.cin + ci) * g.K + ky) * g.K + kx
                  : (((size_t)ci * g.cout + co) * g.K + ky) * g.K + kx;
          dwb[wi] = sum[t][0][4 * j + 2 * h + c];
        }
    }
  }
}


// ---- K4-fwd ------------------------------------------------------------- //

constexpr int kFwdThreads = 256;
constexpr int kFwdUnroll = 4;  // float4 groups a thread, a block

// y = max(u a + b, 0) with the product and the sum rounded separately (no
// FMA contraction), as the plain version's u * a + b computes it; NaN
// passes, as through torch.relu
__device__ __forceinline__ float bn_relu(float v, float a, float b) {
  const float t = __fadd_rn(__fmul_rn(v, a), b);
  return t < 0.f ? 0.f : t;
}

// K4-fwd, in place over u (NCHW, planes of hw elements; channel c of plane
// p is p % C): one block per (plane, run of kFwdThreads x kFwdUnroll float4
// groups). A plane's float4 groups start at its first 16-byte boundary; the
// elements before it (its head) and after its last whole group (its tail),
// fewer than 4 each, are done by the plane's first block.
__global__ void __launch_bounds__(kFwdThreads)
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
  const int i0 = blockIdx.y * kFwdThreads * kFwdUnroll + threadIdx.x;
  float4 v[kFwdUnroll];
#pragma unroll
  for (int j = 0; j < kFwdUnroll; ++j)
    if (i0 + j * kFwdThreads < n4) v[j] = p4[i0 + j * kFwdThreads];
#pragma unroll
  for (int j = 0; j < kFwdUnroll; ++j) {
    if (i0 + j * kFwdThreads >= n4) break;
    v[j].x = bn_relu(v[j].x, ac, bc);
    v[j].y = bn_relu(v[j].y, ac, bc);
    v[j].z = bn_relu(v[j].z, ac, bc);
    v[j].w = bn_relu(v[j].w, ac, bc);
    p4[i0 + j * kFwdThreads] = v[j];
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
// kFwdThreads x kFwdUnroll groups of 4 elements), as bn_relu_kernel. Planes of
// hw % 4 == 0 elements read float4s and write 8-byte groups; others go an
// element at a time.
__global__ void __launch_bounds__(kFwdThreads)
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
    const int i0 = blockIdx.y * kFwdThreads * kFwdUnroll + threadIdx.x;
    float4 v[kFwdUnroll];
#pragma unroll
    for (int j = 0; j < kFwdUnroll; ++j)
      if (i0 + j * kFwdThreads < n4)
        v[j] = reinterpret_cast<const float4*>(p)[i0 + j * kFwdThreads];
#pragma unroll
    for (int j = 0; j < kFwdUnroll; ++j) {
      if (i0 + j * kFwdThreads >= n4) break;
      uint2 o;
      o.x = bf16_rne(bn_relu(v[j].x, ac, bc)) |
            bf16_rne(bn_relu(v[j].y, ac, bc)) << 16;
      o.y = bf16_rne(bn_relu(v[j].z, ac, bc)) |
            bf16_rne(bn_relu(v[j].w, ac, bc)) << 16;
      reinterpret_cast<uint2*>(q)[i0 + j * kFwdThreads] = o;
    }
  } else {
    const int e0 = blockIdx.y * kFwdThreads * kFwdUnroll * 4;
    const int e1 = min(hw, e0 + kFwdThreads * kFwdUnroll * 4);
    for (int e = e0 + threadIdx.x; e < e1; e += kFwdThreads)
      q[e] = (bf16)bf16_rne(bn_relu(p[e], ac, bc));
  }
}

// ------------------------------------------------------------------------ //
// Launches

template <int V>
using IC = std::integral_constant<int, V>;

bool family_ok(int s, int k) {
  return (s == 1 && (k == 1 || k == 3 || k == 5 || k == 7)) ||
         ((s == 2 || s == 4) && k == 2 * s);
}

// N of a block for `cols` columns: the narrowest of 8, 16, 32, 64 that
// holds them (64 past 64: column tiles)
int pick_nt(int cols) {
  return cols <= 8 ? 8 : cols <= 16 ? 16 : cols <= 32 ? 32 : 64;
}

template <typename F>
int with_nt(int nt, F&& f) {
  switch (nt) {
    case 8: return f(IC<8>{});
    case 16: return f(IC<16>{});
    case 32: return f(IC<32>{});
    default: return f(IC<64>{});
  }
}

// A 4-d tensor map of a contiguous tensor (dims innermost first, elements),
// out-of-bounds reads zero; the 128-byte swizzle for the weight tiles
// wgmma reads, none for the windows the lanes gather from
template <typename T>
bool encode(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[4],
            const cuuint32_t (&box)[4], bool swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t strides[3] = {dims[0] * sizeof(T),
                                 dims[0] * dims[1] * sizeof(T),
                                 dims[0] * dims[1] * dims[2] * sizeof(T)};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, Elt<T>::TMA, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kern>
cudaError_t set_smem(Kern kern, int bytes) {
  if (bytes <= 0 || bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// x's pitch (elements a row in memory): at least w and 16-byte rows
bool pitch_ok(int pitch, int w, int esize) {
  return pitch >= w && (pitch * esize) % 16 == 0;
}

// The persistent grids number their tiles in an int: at most 16 phases x
// column tiles x row tiles x samples x 8-column blocks of the wider side
bool dims_ok(int n, int cin, int h, int w, int cout) {
  return n > 0 && cin > 0 && h > 0 && w > 0 && cout > 0 &&
         16LL * cdiv(w, kTW) * cdiv(h, kTR) * n *
                 cdiv(cin > cout ? cin : cout, 8) <= 2147483647LL;
}

// dW's N: the narrowest of 8, 16, 32, 64 that holds Cout, or narrower
// where its tiles of every phase do not fit (s = 4 in f32 past 16); 0 if
// none fits
template <typename T>
int dw_nt(int s, int k, int n, int cin, int h, int w, int cout) {
  for (int nt = pick_nt(cout); nt >= 8; nt /= 2) {
    const int bytes = with_nt(nt, [&](auto NT_) {
      return dw_geo<T>(s, k, n, cin, h, w, cout, decltype(NT_)::value, 132)
          .bytes;
    });
    if (bytes > 0) return nt;
  }
  return 0;
}

// N of the u GEMM (which = 0), dx (1) or dW (2) launch: the block's
// columns, Cout, Cin and Cout (dW's possibly narrower); 0 for a dW launch
// that fits at no N
template <typename T>
int block_nt(int which, int n, int cin, int h, int w, int cout, int k,
             int s) {
  if (which == 2) return dw_nt<T>(s, k, n, cin, h, w, cout);
  return pick_nt(which == 1 ? cin : cout);
}

// The u GEMM's launch: stats (mean, inv, y and dy null) or bwd1. x (N, Cin,
// h, xpitch), wk (PH, PARTS, Cout, Kp).
template <typename T, bool STATS>
int launch_u(const void* x, const void* wk, const void* mean,
             const void* inv, const void* y, const void* dy, void* u,
             void* p1, void* p2, int n, int cin, int h, int w, int xpitch,
             int cout, int k, int s, cudaStream_t strm) {
  if (!family_ok(s, k) || !dims_ok(n, cin, h, w, cout) ||
      !pitch_ok(xpitch, w, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  return with_nt(block_nt<T>(0, n, cin, h, w, cout, k, s), [&](auto NT_) {
    constexpr int NT = decltype(NT_)::value;
    const PixGeo g = pix_geo<T>(0, s, k, cin, h, w, cout, NT);
    CUtensorMap xmap, wmap;
    if (g.bytes == 0 ||
        !encode<T>(&xmap, x, {(cuuint64_t)xpitch, (cuuint64_t)h,
                              (cuuint64_t)cin, (cuuint64_t)n},
                   {(cuuint32_t)g.FW, (cuuint32_t)g.FH, (cuuint32_t)g.nch,
                    1},
                   false) ||
        !encode<T>(&wmap, wk, {(cuuint64_t)g.nrows * Elt<T>::KCH,
                               (cuuint64_t)cout, Elt<T>::PARTS,
                               (cuuint64_t)g.PH},
                   {Elt<T>::KCH, NT, Elt<T>::PARTS, 1}, true))
      return (int)cudaErrorInvalidValue;
    cudaError_t err = set_smem(u_gemm_kernel<T, NT, STATS>, g.bytes);
    if (err != cudaSuccess) return (int)err;
    const int tiles = pix_tiles(g, NT, n);
    const int grid = tiles < sm_count() ? tiles : sm_count();
    u_gemm_kernel<T, NT, STATS><<<grid, kThreads, g.bytes, strm>>>(
        xmap, wmap, g, n, static_cast<const float*>(mean),
        static_cast<const float*>(inv), static_cast<const T*>(y),
        static_cast<const T*>(dy), static_cast<float*>(u),
        static_cast<float*>(p1), static_cast<float*>(p2));
    return (int)cudaGetLastError();
  });
}

// dx from du (N, Cout, s h, dpitch) and wk (1, PARTS, Cin, Kp)
template <typename T>
int launch_dx(const void* du, const void* wk, void* dx, int n, int cin,
              int h, int w, int cout, int dpitch, int k, int s,
              cudaStream_t strm) {
  if (!family_ok(s, k) || !dims_ok(n, cin, h, w, cout) ||
      !pitch_ok(dpitch, s * w, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  return with_nt(block_nt<T>(1, n, cin, h, w, cout, k, s), [&](auto NT_) {
    constexpr int NT = decltype(NT_)::value;
    const PixGeo g = pix_geo<T>(1, s, k, cin, h, w, cout, NT);
    CUtensorMap dmap, wmap;
    if (g.bytes == 0 ||
        !encode<T>(&dmap, du, {(cuuint64_t)dpitch, (cuuint64_t)s * h,
                               (cuuint64_t)cout, (cuuint64_t)n},
                   {(cuuint32_t)g.FW, (cuuint32_t)g.FH, (cuuint32_t)g.nch,
                    1},
                   false) ||
        !encode<T>(&wmap, wk, {(cuuint64_t)g.nrows * Elt<T>::KCH,
                               (cuuint64_t)cin, Elt<T>::PARTS, 1},
                   {Elt<T>::KCH, NT, Elt<T>::PARTS, 1}, true))
      return (int)cudaErrorInvalidValue;
    cudaError_t err = set_smem(dx_kernel<T, NT>, g.bytes);
    if (err != cudaSuccess) return (int)err;
    const int tiles = pix_tiles(g, NT, n);
    const int grid = tiles < sm_count() ? tiles : sm_count();
    dx_kernel<T, NT><<<grid, kThreads, g.bytes, strm>>>(
        dmap, wmap, g, n, static_cast<T*>(dx));
    return (int)cudaGetLastError();
  });
}

// dW's partials (nsplit, w's shape) from x (N, Cin, h, xpitch) and du (N,
// Cout, s h, dpitch)
template <typename T>
int launch_dw(const void* x, const void* du, void* dwp, int n, int cin,
              int h, int w, int xpitch, int cout, int dpitch, int k, int s,
              int nsplit, cudaStream_t strm) {
  if (!family_ok(s, k) || !dims_ok(n, cin, h, w, cout) ||
      !pitch_ok(xpitch, w, sizeof(T)) || !pitch_ok(dpitch, s * w, sizeof(T)))
    return (int)cudaErrorInvalidValue;
  const int nt = block_nt<T>(2, n, cin, h, w, cout, k, s);
  if (nt == 0) return (int)cudaErrorInvalidValue;
  return with_nt(nt, [&](auto NT_) {
    constexpr int NT = decltype(NT_)::value;
    const DwGeo g = dw_geo<T>(s, k, n, cin, h, w, cout, NT, sm_count());
    CUtensorMap xmap, dmap;
    if (g.bytes == 0 || cdiv(g.nchunks, g.per) != nsplit ||
        !encode<T>(&xmap, x, {(cuuint64_t)xpitch, (cuuint64_t)h,
                              (cuuint64_t)cin, (cuuint64_t)n},
                   {(cuuint32_t)g.FW, (cuuint32_t)g.FH, (cuuint32_t)g.nch,
                    1},
                   false) ||
        !encode<T>(&dmap, du, {(cuuint64_t)dpitch, (cuuint64_t)s * h,
                               (cuuint64_t)cout, (cuuint64_t)n},
                   {(cuuint32_t)(s * g.CW), (cuuint32_t)(s * g.RD), NT, 1},
                   false))
      return (int)cudaErrorInvalidValue;
    cudaError_t err = set_smem(dw_kernel<T, NT>, g.bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(cdiv(g.tiles, g.tb), cdiv(cout, NT), nsplit);
    dw_kernel<T, NT><<<grid, kThreads, g.bytes, strm>>>(
        xmap, dmap, g, static_cast<float*>(dwp));
    return (int)cudaGetLastError();
  });
}

template <typename T>
int launch_du(const void* u, const void* y, const void* dy,
              const DuConsts& kc, void* du, int n, int c, int ho, int wo,
              int dpitch, cudaStream_t strm) {
  if (n <= 0 || c <= 0 || ho <= 0 || wo <= 0 ||
      (long long)n * c > 2147483647LL || !pitch_ok(dpitch, wo, sizeof(T)) ||
      (!kIsF32<T> && du == u) || (du == u && dpitch != wo))
    return (int)cudaErrorInvalidValue;
  const int vecs = ho * (dpitch / (16 / (int)sizeof(T)));
  const dim3 grid(n * c, cdiv(vecs, kDuThreads) < 16 ? cdiv(vecs, kDuThreads)
                                                     : 16);
  du_kernel<T><<<grid, kDuThreads, 0, strm>>>(
      static_cast<const float*>(u), static_cast<const T*>(y),
      static_cast<const T*>(dy), kc, static_cast<T*>(du), c, ho, wo, dpitch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tiles a sample of the u GEMM's launch, stats or bwd1 (the rows of its
// partials per sample), for x (h, w) and Cout (the tile's rows: 24 for
// Cout <= 16, else 12); -1 for an unsupported (k, s). The same in both
// dtypes.
int bpt_conv_bn_bwd1_tiles(int h, int w, int cout, int k, int s) {
  if (!family_ok(s, k) || h <= 0 || w <= 0 || cout <= 0) return -1;
  return s * s * cdiv(w, kTW) * cdiv(h, kTR * pix_mt(pick_nt(cout)));
}

// Partial dW rows of the dW launch (its pixel splits) for x (n, cin, h, w)
// and cout output channels, float32 (dtype 0) or bfloat16 (1); -1 for an
// unsupported (k, s) or dtype, or a launch that does not fit.
int bpt_conv_bn_bwd2_splits(int n, int cin, int h, int w, int cout, int k,
                            int s, int dtype) {
  if (!family_ok(s, k) || n <= 0 || cin <= 0 || h <= 0 || w <= 0 ||
      cout <= 0 || dtype < 0 || dtype > 1)
    return -1;
  const int nt = dtype == 0 ? dw_nt<float>(s, k, n, cin, h, w, cout)
                            : dw_nt<bf16>(s, k, n, cin, h, w, cout);
  if (nt == 0) return -1;
  return with_nt(nt, [&](auto NT_) {
    constexpr int NT = decltype(NT_)::value;
    const int sms = sm_count();
    if (dtype == 0) {
      const DwGeo g = dw_geo<float>(s, k, n, cin, h, w, cout, NT, sms);
      return g.bytes == 0 ? -1 : cdiv(g.nchunks, g.per);
    }
    const DwGeo g = dw_geo<bf16>(s, k, n, cin, h, w, cout, NT, sms);
    return g.bytes == 0 ? -1 : cdiv(g.nchunks, g.per);
  });
}

// N (the block's columns, the instantiation's template argument) of the u
// GEMM (which = 0: stats and bwd1), dx (1) or dW (2) launch, float32
// (dtype 0) or bfloat16 (dtype 1), for x (n, cin, h, w) and cout output
// channels; 0 for a launch that does not fit, -1 for an unsupported (k, s),
// which or dtype.
int bpt_conv_bn_nt(int n, int cin, int h, int w, int cout, int k, int s,
                   int which, int dtype) {
  if (!family_ok(s, k) || which < 0 || which > 2 || dtype < 0 || dtype > 1 ||
      n <= 0 || cin <= 0 || h <= 0 || w <= 0 || cout <= 0)
    return -1;
  return dtype == 0 ? block_nt<float>(which, n, cin, h, w, cout, k, s)
                    : block_nt<bf16>(which, n, cin, h, w, cout, k, s);
}

// Shared memory of a block of the u GEMM (which = 0: stats and bwd1), dx
// (1) or dW (2) launch in bytes, at the N bpt_conv_bn_nt gives, as
// bpt_conv_bn_nt's arguments; 0 for one that does not fit, -1 for an
// unsupported (k, s), which or dtype.
int bpt_conv_bn_bwd_smem(int n, int cin, int h, int w, int cout, int k,
                         int s, int which, int dtype) {
  const int nt = bpt_conv_bn_nt(n, cin, h, w, cout, k, s, which, dtype);
  if (nt <= 0) return nt;
  return with_nt(nt, [&](auto NT_) {
    constexpr int NT = decltype(NT_)::value;
    if (which == 2)
      return dtype == 0
                 ? dw_geo<float>(s, k, n, cin, h, w, cout, NT, 132).bytes
                 : dw_geo<bf16>(s, k, n, cin, h, w, cout, NT, 132).bytes;
    return dtype == 0 ? pix_geo<float>(which, s, k, cin, h, w, cout, NT).bytes
                      : pix_geo<bf16>(which, s, k, cin, h, w, cout, NT).bytes;
  });
}

// stats: x (N, Cin, H, xpitch), wk the u GEMM's weights (ops/conv_bn.py
// `_kernel_weights`: (PH, PARTS, Cout, Kp)), float32 (dtype 0) or bfloat16
// (dtype 1). Writes u (N, Cout, s H, s W) and the partial sums of u (p1)
// and u^2 (p2), (N * tiles, Cout) with tiles = bpt_conv_bn_bwd1_tiles,
// f32. Returns the cudaError_t of the launch (0 on success); asynchronous
// on `stream`.
int bpt_conv_bn_stats(const void* x, const void* wk, void* u, void* p1,
                      void* p2, int n, int cin, int h, int wd, int xpitch,
                      int cout, int k, int s, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_u<float, true>(x, wk, nullptr, nullptr, nullptr, nullptr,
                                 u, p1, p2, n, cin, h, wd, xpitch, cout, k, s,
                                 st);
  if (dtype == 1)
    return launch_u<bf16, true>(x, wk, nullptr, nullptr, nullptr, nullptr, u,
                                p1, p2, n, cin, h, wd, xpitch, cout, k, s,
                                st);
  return (int)cudaErrorInvalidValue;
}

// bwd1: x, wk as stats; mean, inv (Cout) f32; y, dy (N, Cout, s H, s W) in
// x's dtype. Writes u (y's shape, f32) and the partial sums of dv (p1) and
// dv * uhat (p2), (N * tiles, Cout).
int bpt_conv_bn_bwd1(const void* x, const void* wk, const void* mean,
                     const void* inv, const void* y, const void* dy, void* u,
                     void* p1, void* p2, int n, int cin, int h, int wd,
                     int xpitch, int cout, int k, int s, int dtype,
                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_u<float, false>(x, wk, mean, inv, y, dy, u, p1, p2, n, cin,
                                  h, wd, xpitch, cout, k, s, st);
  if (dtype == 1)
    return launch_u<bf16, false>(x, wk, mean, inv, y, dy, u, p1, p2, n, cin,
                                 h, wd, xpitch, cout, k, s, st);
  return (int)cudaErrorInvalidValue;
}

// bwd2's first launch, du = a (dv - s1n - (u - mean) inv s2n) with s1n =
// S1 / count, s2n = S2 / count: u (f32), y, dy (N, C, ho, wo; x's dtype);
// a, mean, inv, s1n, s2n (C) f32. Writes du (N, C, ho, dpitch) in x's
// dtype, zeros past wo; in float32 du may be u (dpitch == wo).
int bpt_conv_bn_du(const void* u, const void* y, const void* dy,
                   const void* a, const void* mean, const void* inv,
                   const void* s1n, const void* s2n, void* du, int n, int c,
                   int ho, int wo, int dpitch, int dtype, void* stream) {
  const DuConsts kc{static_cast<const float*>(a),
                    static_cast<const float*>(mean),
                    static_cast<const float*>(inv),
                    static_cast<const float*>(s1n),
                    static_cast<const float*>(s2n)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_du<float>(u, y, dy, kc, du, n, c, ho, wo, dpitch, st);
  if (dtype == 1)
    return launch_du<bf16>(u, y, dy, kc, du, n, c, ho, wo, dpitch, st);
  return (int)cudaErrorInvalidValue;
}

// bwd2's dx: du as bpt_conv_bn_du writes it, wk dx's weights
// (`_kernel_weights`: (1, PARTS, Cin, Kp)); writes dx (N, Cin, h, w) in x's
// dtype.
int bpt_conv_bn_dx(const void* du, const void* wk, void* dx, int n, int cin,
                   int h, int wd, int cout, int dpitch, int k, int s,
                   int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dx<float>(du, wk, dx, n, cin, h, wd, cout, dpitch, k, s,
                            st);
  if (dtype == 1)
    return launch_dx<bf16>(du, wk, dx, n, cin, h, wd, cout, dpitch, k, s,
                           st);
  return (int)cudaErrorInvalidValue;
}

// bwd2's dW: x (N, Cin, h, xpitch) and du as bpt_conv_bn_du writes it;
// writes dwp (nsplit, w's shape; f32), nsplit = bpt_conv_bn_bwd2_splits.
int bpt_conv_bn_dw(const void* x, const void* du, void* dwp, int n, int cin,
                   int h, int wd, int xpitch, int cout, int dpitch, int k,
                   int s, int nsplit, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dw<float>(x, du, dwp, n, cin, h, wd, xpitch, cout, dpitch,
                            k, s, nsplit, st);
  if (dtype == 1)
    return launch_dw<bf16>(x, du, dwp, n, cin, h, wd, xpitch, cout, dpitch,
                           k, s, nsplit, st);
  return (int)cudaErrorInvalidValue;
}

// fwd: u (N, C, hw), a, b (C), f32, contiguous; y = max(u a + b, 0):
// dtype 0 over u in place (y must be u), dtype 1 into y (N, C, hw)
// bfloat16.
int bpt_conv_bn_fwd(void* u, const void* a, const void* b, void* y, int n,
                    int c, int hw, int dtype, void* stream) {
  // blocks a plane: ceil(hw / (4 kFwdThreads kFwdUnroll)), which covers
  // every element of bn_relu_bf16_kernel's element path (hw % 4 != 0) too;
  // for hw % 4 == 0 it is ceil((hw / 4) / (kFwdThreads kFwdUnroll))
  const long long groups =
      ((long long)hw + 4 * kFwdThreads * kFwdUnroll - 1) /
      (4 * kFwdThreads * kFwdUnroll);
  if (n <= 0 || c <= 0 || hw <= 0 || (long long)n * c > 2147483647LL ||
      groups > 65535 || (dtype == 0 && y != u) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n * c, groups > 0 ? (int)groups : 1);
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    bn_relu_kernel<<<grid, kFwdThreads, 0, strm>>>(
        static_cast<float*>(u), static_cast<const float*>(a),
        static_cast<const float*>(b), c, hw);
  else
    bn_relu_bf16_kernel<<<grid, kFwdThreads, 0, strm>>>(
        static_cast<const float*>(u), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<bf16*>(y), c, hw);
  return (int)cudaGetLastError();
}

}  // extern "C"
