// Fused continuous-GMM senone scoring for Hopper (sm_90a), on the tensor
// cores.
//
// Replaces the Pallas TPU kernel cmusphinx_tpu/ops/pallas_gmm.py::_kernel
// (launched by fused_mixture_scores_packed).  For every frame t and senone s
//
//   score[t, s] = logsumexp_k( const[s,k] + x_t . lin[s,k,:] - x_t^2 . quad[s,k,:] )
//
// with lin = 2 prec mean, quad = prec = 0.5/var, const = lrd + ln w - sum prec mean^2.
// Only the [T, S] result is written: the [T, S*K] densities never leave
// the registers.
//
// What bounds it.  At the hub4 width (S=5150, K=32, D=39) and T=2000 the
// products are 2*T*S*K*D = 25.7 G multiply-adds (51.4 GFLOP) and the
// log-sum-exp T*S*K = 330 M exps, against ~93 MB of bytes (0.03 ms at
// 3.35 TB/s): arithmetic, not memory.  The least time of each mode:
//   highest  3xTF32 on the tensor cores at 495 TFLOP/s        0.31 ms
//   high     3 bf16 products at 989 TFLOP/s                   0.16 ms
//   bf16     the exps on the special-function units            0.079 ms
//            (16 a clock per SM, 132 SMs at 1.98 GHz: 4.18 T/s; one
//            bf16 product alone would take 0.05 ms)
// That the exps run on those units alone is this design's assumption, not
// a hard limit: some of them could run as FMA polynomials.
//
// The design.
//   - One product, not two: A = [x | x^2] per frame and B = [lin | -quad]
//     per density, each over a depth Dp = 2D rounded up to 16 (80 at
//     D=39), zero-padded.
//   - B is packed once, at scorer construction (ops/fused_gmm.py
//     pack_params), into senone tiles of N densities that are byte images
//     of the shared-memory operand: each part (hi, lo) in the wgmma
//     no-swizzle K-major core-matrix layout ([N/8][Dp*E/16] cores of 8 rows
//     x 16 bytes).  The consts sit in an array of their own.  K is padded
//     to a power of two Kp >= 8 (pad densities carry const -1e30, the
//     reference's _PAD_CONST), S to whole tiles.  The hi/lo split is done
//     there, so the inner loop does no splitting.
//   - A block has WG consumer warpgroups of 64 frames each (2 in highest,
//     3 in high and bf16) and one producer warp.  The consumers stage
//     their frames' [x | x^2] (split per mode) in shared memory once.  The
//     producer streams the block's senone tiles into a ring of up to 4
//     stages, one bulk copy (cp.async.bulk, the TMA engine) per tile,
//     completed on an mbarrier; the consumers free a stage on a second
//     mbarrier as soon as their products are done.
//   - Per tile each warpgroup issues wgmma (A and B from shared memory),
//     the k-steps unrolled (one instantiation per depth):
//       highest  tf32 m64n64k8,   hi.lo + lo.hi + hi.hi
//       high     bf16 m64n128k16, hi.lo + lo.hi + hi.hi
//       bf16     bf16 m64n128k16, one product
//     N is 64 in highest so that the f32 hi and lo parts of A (80 KB at
//     D=39) and three stages of B fit the 227 KB of shared memory.
//   - The epilogue stays in the accumulator registers and adds the consts
//     (read from L2 while the tile is awaited) as it reads them: in the
//     wgmma layout a senone's Kp columns of one frame lie in the 4 lanes
//     of a quad, so each thread takes the max over its columns, two
//     shuffles make it the quad's, then the exps, their sum, two more
//     shuffles and one log, for all senones of the tile at once.  A senone
//     wider than a tile (Kp > N) carries a running (max, sum) across its
//     tiles.  Results are staged in shared memory and written as rows of
//     32 senones (128 bytes) of out[T, S].
//   - The grid is (frame blocks) x (senone ranges), about four blocks per
//     SM, instead of persistent blocks: a block costs one staging of its
//     frames, and the split keeps the 132 SMs busy at T = 2000 as at
//     T = 9,600.  The warpgroups of a block interleave their tensor-core
//     work and their exps on the SM's schedulers.  Tried and dropped (no
//     faster on the H100): two accumulators per warpgroup overlapping one
//     tile's epilogue with the next tile's products, a deeper ring, split
//     bulk copies, 4 warpgroups (register spills), the consts read from
//     the shared-memory stage.
//   - Depth up to D = 64: one instantiation a depth, Dp = 16..128
//     (fused_gmm_kernel).  The ring of "highest" has one stage
//     (Geom::FREE) at Dp >= 112 (D >= 49), that of "high" at Dp = 128
//     (D >= 57): there a tile's bulk copy no longer overlaps the products
//     of the one before.
//   - Depth past D = 64 (fused_gmm_wide_kernel): a depth loop.  Dp is
//     rounded up to chunks of CD = 32 elements, and pack_params lays each
//     senone tile out chunk by chunk, so one ring stage is one chunk of one
//     tile, still one bulk copy.  Each chunk's k-steps are unrolled at
//     compile time (a runtime k-loop made ptxas serialise wgmma); the
//     chunks of a tile accumulate into the same registers, each chunk's
//     group of products committed on its own and its stage freed once the
//     next chunk's products are issued (wait_group 1), and the log-sum-exp
//     epilogue runs once per tile, after the last chunk.  The consumers
//     stage A = [x | x^2] from x themselves, as the narrow kernel does, in
//     the same per-chunk core-matrix layout (stage_chunk).  Where the block's
//     whole A fits beside a ring of two stages, A stays resident, staged
//     once per block; the block takes fewer frames (WG from the mode's
//     default down to 1) as the depth grows: at D = 78 "highest" runs 2
//     warpgroups and "high"/"bf16" 3, at D = 150 "highest" 1, "high" 2,
//     "bf16" 3.  Where even 64 frames' A does not fit beside two stages
//     (D > 176 in "highest", D > 368 in "high", D > 800 in "bf16"), each
//     warpgroup stages its own rows of A chunk by chunk, for every tile,
//     into a double buffer (the products of chunk j - 2, the last reader of
//     a buffer, are complete once chunk j - 1's are issued and awaited to
//     one group).  That reads x from L2 once per tile and is bound by the
//     staging, not by the tensor cores, but it takes any D, as the
//     reference does.  wide_plan makes the choice at launch
//     (fused_gmm_plan reports it).
//   - What holds it back (builds with parts cut out, PERF.md): without the
//     epilogue the time is the same, and without the products too a
//     large part stays: the per-tile pipeline, not the arithmetic, sets
//     the time of "high" and "bf16".
//
// Numerics (ops/fused_gmm.py and PERF.md hold the bounds):
//   0 highest: each operand split into tf32 hi = rn(a), lo = rn(a - hi) (10
//              mantissa bits, round to nearest even); a.b ~= ah.bh + ah.bl +
//              al.bh, error ~3 * 2^-22 of |a.b| per product, f32 accumulation.
//   1 high:    the same split into bf16 hi and lo.
//   2 bf16:    bf16 parameters, bf16(x) and bf16(x*x) (squared in f32 first).
//
// Build: four units of this file, compiled in parallel and linked into one
// library (ops/fused_gmm.py build): one a mode, -DK1_MODE=0/1/2, holding
// that mode's kernels, and one without K1_MODE, holding the C entry points:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC [-DK1_MODE=m] -c -o unit.o fused_gmm.cu
//   nvcc -shared -o libfused_gmm.so unit*.o
// C interface only; loaded with ctypes (cmusphinx_tpu_torch/ops/fused_gmm.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Mode { HIGHEST = 0, HIGH = 1, BF16 = 2 };

// N: densities per senone tile; E: bytes per operand element; P: parts;
// WG: consumer warpgroups (64 frames each).
template <int MODE> struct Cfg;
template <> struct Cfg<HIGHEST> {
  static constexpr int N = 64, NLOG = 6, E = 4, P = 2, WG = 2;
};
template <> struct Cfg<HIGH> {
  static constexpr int N = 128, NLOG = 7, E = 2, P = 2, WG = 3;
};
template <> struct Cfg<BF16> {
  static constexpr int N = 128, NLOG = 7, E = 2, P = 1, WG = 3;
};

constexpr int SB = 32;                   // senones staged per output flush
constexpr int SROW = SB + 1;             // staged row stride (floats)
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;
constexpr int OUT_OFF = 128;            // after the 2 x MAX_STAGES mbarriers
constexpr int CD = 32;                  // depth elements a chunk (wide kernel)

// The geometry of one mode and depth: the block's frames and threads;
// Dp = KS k-steps of 32 bytes; the tile's bytes, its stride in the ring,
// and the ring's stages in the shared memory left after the mbarriers,
// the staged outputs and A.
template <int MODE, int KS> struct Geom {
  static constexpr int N = Cfg<MODE>::N, E = Cfg<MODE>::E, P = Cfg<MODE>::P;
  static constexpr int WG = Cfg<MODE>::WG;
  static constexpr int BM = 64 * WG;               // frames per block
  static constexpr int CONSUMERS = 128 * WG;
  static constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
  static constexpr int A_OFF = (OUT_OFF + BM * SROW * 4 + 127) / 128 * 128;
  static constexpr int DP = KS * 32 / E;
  static constexpr int TILE_BYTES = P * N * DP * E;
  static constexpr int STRIDE = (TILE_BYTES + 127) / 128 * 128;
  static constexpr int FIXED = A_OFF + P * BM * DP * E;
  static constexpr int FREE = (SMEM_LIMIT - FIXED) / STRIDE;
  static constexpr int STAGES = FREE < MAX_STAGES ? FREE : MAX_STAGES;
  static constexpr int SMEM = FIXED + STAGES * STRIDE;
};

// The geometry of the wide kernel at WG warpgroups: per chunk of CD depth
// elements, KS k-steps, B's bytes (one tile) and A's (one frame block).
// The chunk count and the ring's stages are runtime values (wide_plan).
// STREAM: A staged chunk by chunk into a double buffer instead of resident.
template <int MODE, int WG> struct Wide {
  static constexpr int N = Cfg<MODE>::N, E = Cfg<MODE>::E, P = Cfg<MODE>::P;
  static constexpr int BM = 64 * WG;
  static constexpr int CONSUMERS = 128 * WG;
  static constexpr int THREADS = CONSUMERS + 32;
  static constexpr int A_OFF = (OUT_OFF + BM * SROW * 4 + 127) / 128 * 128;
  static constexpr int KS = CD * E / 32;
  static constexpr int CHUNK_B = P * N * CD * E;
  static constexpr int CHUNK_A = P * BM * CD * E;
  // Shared memory before the ring: mbarriers, staged outputs, A.
  template <bool STREAM>
  static constexpr int fixed(int nch) {
    return A_OFF + (STREAM ? 2 : nch) * CHUNK_A;
  }
  template <bool STREAM>
  static constexpr int stages(int nch) {
    const int s = (SMEM_LIMIT - fixed<STREAM>(nch)) / CHUNK_B;
    return s < MAX_STAGES ? s : MAX_STAGES;
  }
};

// ---- PTX wrappers ----------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One bulk copy global -> shared, completed on `bar` (the TMA engine).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// wgmma shared-memory descriptor, no swizzle: start address, leading byte
// offset 128 (the next core matrix along K), stride byte offset `sbo` (the
// next 8 rows).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define D16(i) D4(i), D4(i + 4), D4(i + 8), D4(i + 12)

// acc [64 x 64] (+)= A [64 x 8] . B [64 x 8]^T, tf32 operands.
__device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db,
                                    int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : D16(0), D16(16)
      : "l"(da), "l"(db), "r"(scale_d));
}

// acc [64 x 128] (+)= A [64 x 16] . B [128 x 16]^T, bf16 operands.
__device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db,
                                    int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D16(0), D16(16), D16(32), D16(48)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef D16
#undef D4

// ---- operand rounding --------------------------------------------------
__device__ __forceinline__ float tf32_rn(float v) {
  uint32_t b = __float_as_uint(v);
  b += 0xFFFu + ((b >> 13) & 1u);
  return __uint_as_float(b & 0xFFFFE000u);
}

template <int MODE>
__device__ __forceinline__ void put_a(uint8_t* a, int part_bytes, int off,
                                      float v) {
  if (MODE == HIGHEST) {
    const float h = tf32_rn(v);
    *reinterpret_cast<float*>(a + off) = h;
    *reinterpret_cast<float*>(a + part_bytes + off) = tf32_rn(v - h);
  } else if (MODE == HIGH) {
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    *reinterpret_cast<__nv_bfloat16*>(a + off) = h;
    *reinterpret_cast<__nv_bfloat16*>(a + part_bytes + off) =
        __float2bfloat16_rn(v - __bfloat162float(h));
  } else {
    *reinterpret_cast<__nv_bfloat16*>(a + off) = __float2bfloat16_rn(v);
  }
}

// Stages chunk c of A = [x | x^2] (depth c*CD .. c*CD + CD - 1; x^2 squared
// in f32; zero past 2D) for rows [0, rows) (frames t0 + r; zero at t >= T),
// split per mode, at `a` ([P][rows x CD] core matrices), by threads tid of
// nthr.  The loads of U elements are issued before their stores, so that
// their latencies overlap.
template <int MODE>
__device__ __forceinline__ void stage_chunk(uint8_t* a, int rows, int c,
                                            const float* __restrict__ x,
                                            int t0, int T, int D, int tid,
                                            int nthr) {
  constexpr int E = Cfg<MODE>::E, EPC = 16 / E, KG = CD / EPC, U = 8;
  const int part = rows * CD * E, n = rows * CD;
  for (int i0 = tid; i0 < n; i0 += U * nthr) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * nthr, r = i / CD, k = c * CD + i % CD;
      v[u] = i < n && t0 + r < T && k < 2 * D
                 ? x[(size_t)(t0 + r) * D + (k < D ? k : k - D)]
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * nthr, r = i / CD, kk = i % CD;
      if (i < n)
        put_a<MODE>(a, part,
                    (r >> 3) * KG * 128 + (r & 7) * 16 + (kk / EPC) * 128 +
                        (kk % EPC) * E,
                    c * CD + kk >= D ? v[u] * v[u] : v[u]);
    }
  }
}

// e^x on the special-function unit (ex2.approx), subnormal results flushed
// to zero: their share of a sum of exps is below f32's resolution.  The
// non-ftz form costs three more instructions an exp for its range fix.
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// ---- the epilogue --------------------------------------------------------
// Log-sum-exp of one tile's densities (acc holds const + x.lin - x^2.quad)
// over segments of CPS 8-column chunks, each segment one senone (or, with
// CARRY, the part of a senone in this tile, merged into cm/cs).  Thread
// (warp w, lane l) holds rows w*16 + l/4 (h=0) and +8 (h=1), columns
// 8j + 2(l%4) + {0,1} of chunk j in acc[4j + 2h + {0,1}].  The steps run
// over all segments at once (maxima, their shuffles, the exps, the sums'
// shuffles, the logs) and without branches, so that the independent
// segments hide each other's latencies.
template <int N, int CPS, bool CARRY>
__device__ __forceinline__ void lse_tile(const float (&acc)[N / 2],
                                         const float2 (&cc)[N / 8],
                                         float* row0, float* row1, int col0,
                                         bool leader, bool last,
                                         float (&cm)[2], float (&cs)[2]) {
  constexpr int NCH = N / 8;
  constexpr int NSEG = CPS <= NCH ? NCH / CPS : 1;
  constexpr int CH = CPS <= NCH ? CPS : NCH;
  // The density of (chunk j, row half h, column e): acc + const.
  auto dens = [&](int j, int h, int e) {
    return acc[4 * j + 2 * h + e] + (e ? cc[j].y : cc[j].x);
  };
  float m[NSEG][2], s[NSEG][2];
#pragma unroll
  for (int g = 0; g < NSEG; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = -INFINITY;
#pragma unroll
      for (int j = g * CH; j < (g + 1) * CH; ++j)
        v = fmaxf(v, fmaxf(dens(j, h, 0), dens(j, h, 1)));
      m[g][h] = v;
    }
#pragma unroll
  for (int k = 1; k <= 2; k <<= 1)
#pragma unroll
    for (int g = 0; g < NSEG; ++g)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        m[g][h] = fmaxf(m[g][h], __shfl_xor_sync(0xffffffffu, m[g][h], k));
#pragma unroll
  for (int g = 0; g < NSEG; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // Every density -inf: take 0 as the pivot, and the sum is 0.
      m[g][h] = m[g][h] == -INFINITY ? 0.0f : m[g][h];
      float v = 0.0f;
#pragma unroll
      for (int j = g * CH; j < (g + 1) * CH; ++j)
        v += exp_fast(dens(j, h, 0) - m[g][h]) + exp_fast(dens(j, h, 1) - m[g][h]);
      s[g][h] = v;
    }
#pragma unroll
  for (int k = 1; k <= 2; k <<= 1)
#pragma unroll
    for (int g = 0; g < NSEG; ++g)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        s[g][h] += __shfl_xor_sync(0xffffffffu, s[g][h], k);
#pragma unroll
  for (int g = 0; g < NSEG; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float val = m[g][h] + __logf(s[g][h]);
      if (CARRY) {
        const float mm = fmaxf(cm[h], m[g][h]);
        cs[h] = cs[h] * exp_fast(cm[h] - mm) + s[g][h] * exp_fast(m[g][h] - mm);
        cm[h] = mm;
        val = cm[h] + __logf(cs[h]);
        if (last) {
          cm[h] = -INFINITY;
          cs[h] = 0.0f;
        }
      }
      if (leader && (!CARRY || last)) (h ? row1 : row0)[col0 + g] = val;
    }
}

// ---- the kernel ----------------------------------------------------------
template <int MODE, int KS>
__global__ void __launch_bounds__(Geom<MODE, KS>::THREADS, 1)
fused_gmm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ tiles,
                 const float* __restrict__ cst,
                 float* __restrict__ out, int T, int S, int D, int kp_log,
                 int n_units, int tps_log) {
  constexpr int N = Cfg<MODE>::N, NLOG = Cfg<MODE>::NLOG;
  constexpr int E = Cfg<MODE>::E, P = Cfg<MODE>::P;
  constexpr int EPC = 16 / E;                 // elements per core-matrix row
  using G = Geom<MODE, KS>;
  constexpr int Dp = G::DP, STAGES = G::STAGES, stride = G::STRIDE;
  constexpr int tile_bytes = G::TILE_BYTES;
  constexpr int WG = G::WG, BM = G::BM, CONSUMERS = G::CONSUMERS;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  float* out_stage = reinterpret_cast<float*>(smem + OUT_OFF);
  uint8_t* a_smem = smem + G::A_OFF;
  constexpr int KG = Dp / EPC;                // core matrices along the depth
  constexpr int a_part = BM * Dp * E;
  uint8_t* ring = a_smem + P * a_part;

  // This block's frames and senone tiles.
  const int t0 = blockIdx.x * BM;
  const int u0 = static_cast<int>((int64_t)blockIdx.y * n_units / gridDim.y);
  const int u1 = static_cast<int>((int64_t)(blockIdx.y + 1) * n_units / gridDim.y);
  const int tile0 = u0 << tps_log;
  const int n_my = (u1 - u0) << tps_log;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The role, warp-uniform to the compiler (a shuffle), so that the
  // consumers' wgmma are not taken for a divergent path and serialized.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp >= CONSUMERS / 32) {               // the producer warp
    if (threadIdx.x == CONSUMERS) {
      for (int i = 0; i < n_my; ++i) {
        const int st = i % STAGES;
        mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], tile_bytes);
        bulk_load(ring + st * stride, tiles + (size_t)(tile0 + i) * tile_bytes,
                  tile_bytes, &full[st]);
      }
    }
    return;
  }

  // Stage A = [x | x^2] of the block's frames, split per mode: zero it,
  // load the block's x (contiguous rows, all loads of a thread in flight
  // at once), then write x and x^2 where they belong.
  for (int i = threadIdx.x; i < P * a_part / 16; i += CONSUMERS)
    reinterpret_cast<uint4*>(a_smem)[i] = make_uint4(0, 0, 0, 0);
  constexpr int XPT = (BM * Dp / 2 + CONSUMERS - 1) / CONSUMERS;  // D <= Dp/2
  const int n_x = (T - t0 < BM ? T - t0 : BM) * D;
  float xv[XPT];
#pragma unroll
  for (int j = 0; j < XPT; ++j) {
    const int i = threadIdx.x + j * CONSUMERS;
    xv[j] = i < n_x ? x[(size_t)t0 * D + i] : 0.0f;
  }
  named_sync(1, CONSUMERS);
#pragma unroll
  for (int j = 0; j < XPT; ++j) {
    const int i = threadIdx.x + j * CONSUMERS;
    if (i < n_x) {
      const int r = i / D, k = i - r * D;
      const int base = (r >> 3) * KG * 128 + (r & 7) * 16;
      put_a<MODE>(a_smem, a_part, base + (k / EPC) * 128 + (k % EPC) * E, xv[j]);
      put_a<MODE>(a_smem, a_part, base + ((k + D) / EPC) * 128 + ((k + D) % EPC) * E,
                  xv[j] * xv[j]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  named_sync(1, CONSUMERS);

  const int wg = threadIdx.x / 128, w = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, q = (lane & 3) * 2;
  const bool leader = (lane & 3) == 0;
  const uint32_t sbo = KG * 128;
  const uint32_t a_addr = smem_u32(a_smem) + wg * 8 * KG * 128;
  float* sout = out_stage + wg * 64 * SROW;
  float* row0 = sout + (w * 16 + lane / 4) * SROW;
  float* row1 = row0 + 8 * SROW;

  const bool carry = tps_log > 0;             // a senone spans several tiles
  const int spt = carry ? 1 : 1 << (NLOG - kp_log);   // senones per tile
  const int cps = (carry ? N : 1 << kp_log) / 8;      // chunks per senone
  const int tmask = (1 << tps_log) - 1;
  float cm[2] = {-INFINITY, -INFINITY}, cs[2] = {0.0f, 0.0f};
  int nb = 0;                                  // senones staged
  int sb0 = carry ? tile0 >> tps_log : tile0 * spt;

  auto flush = [&]() {
    named_sync(2 + wg, 128);
    for (int rr = 0; rr < 16; ++rr) {
      const int row = w * 16 + rr, t = t0 + wg * 64 + row;
      if (t < T && lane < nb && sb0 + lane < S)
        out[(size_t)t * S + sb0 + lane] = sout[row * SROW + lane];
    }
    named_sync(2 + wg, 128);
    sb0 += nb;
    nb = 0;
  };

  // Issue tile i's products into d (asynchronous: wait_group waits).
  float2 cc[N / 8];
  auto issue = [&](float (&d)[N / 2], int i) {
    const int st = i % STAGES;
    // This thread's consts of the tile, from global memory (L2): loaded
    // before the wait, so that their latency hides behind it.
    const float2* ct = reinterpret_cast<const float2*>(cst + (size_t)(tile0 + i) * N);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) cc[j] = __ldg(ct + 4 * j + q / 2);
    mbar_wait(&full[st], (i / STAGES) & 1);
    const uint32_t b_addr = smem_u32(ring + st * stride);
    fence_regs(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    // Passes (A part, B part): hi.lo, lo.hi, hi.hi (small terms first).
    constexpr int P0 = P == 2 ? 0 : 2;
#pragma unroll
    for (int p = P0; p < 3; ++p) {
      const int pa = p == 1, pb = p == 0;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma(d, make_desc(a_addr + pa * a_part + ks * 256, sbo),
            make_desc(b_addr + pb * N * Dp * E + ks * 256, sbo),
            p != P0 || ks != 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  };
  // Tile i's epilogue, once its products are in d.
  auto finish = [&](float (&d)[N / 2], int i) {
    const int tile = tile0 + i, st = i % STAGES;
    fence_regs(d);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);

    const bool first = (tile & tmask) == 0, last = (tile & tmask) == tmask;
    if (first && nb + spt > SB) flush();
    if (carry) {
      lse_tile<N, N / 8, true>(d, cc, row0, row1, nb, leader, last, cm, cs);
    } else {
      switch (cps) {
        case 1: lse_tile<N, 1, false>(d, cc, row0, row1, nb, leader, last, cm, cs); break;
        case 2: lse_tile<N, 2, false>(d, cc, row0, row1, nb, leader, last, cm, cs); break;
        case 4: lse_tile<N, 4, false>(d, cc, row0, row1, nb, leader, last, cm, cs); break;
        case 8: lse_tile<N, 8, false>(d, cc, row0, row1, nb, leader, last, cm, cs); break;
        default: lse_tile<N, 16, false>(d, cc, row0, row1, nb, leader, last, cm, cs); break;
      }
    }
    if (last) nb += spt;
  };

  float acc[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc[j] = 0.0f;
  for (int i = 0; i < n_my; ++i) {
    issue(acc, i);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    finish(acc, i);
  }
  flush();
}

// The depth loop (D > 64).  x [T, D]; tiles: per senone tile nch chunks
// of CHUNK_B bytes ([P][N rows x CD] core matrices each).  A is staged by
// the consumers: resident (nch chunks of CHUNK_A bytes, [P][BM rows x CD]
// each), or with STREAM per warpgroup and chunk into a double buffer.
template <int MODE, int WG, bool STREAM>
__global__ void __launch_bounds__(Wide<MODE, WG>::THREADS, 1)
fused_gmm_wide_kernel(const float* __restrict__ x,
                      const uint8_t* __restrict__ tiles,
                      const float* __restrict__ cst, float* __restrict__ out,
                      int T, int S, int D, int kp_log, int n_units,
                      int tps_log, int nch, int stages) {
  using G = Wide<MODE, WG>;
  constexpr int N = G::N, NLOG = Cfg<MODE>::NLOG, E = G::E, P = G::P;
  constexpr int EPC = 16 / E;
  constexpr int BM = G::BM, CONSUMERS = G::CONSUMERS, KS = G::KS;
  constexpr int CB = G::CHUNK_B, CA = G::CHUNK_A;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  float* out_stage = reinterpret_cast<float*>(smem + OUT_OFF);
  uint8_t* a_smem = smem + G::A_OFF;
  uint8_t* ring = a_smem + (STREAM ? 2 : nch) * CA;

  const int t0 = blockIdx.x * BM;
  const int u0 = static_cast<int>((int64_t)blockIdx.y * n_units / gridDim.y);
  const int u1 = static_cast<int>((int64_t)(blockIdx.y + 1) * n_units / gridDim.y);
  const int tile0 = u0 << tps_log;
  const int n_my = (u1 - u0) << tps_log;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp >= CONSUMERS / 32) {               // the producer warp
    if (threadIdx.x == CONSUMERS) {
      for (int i = 0; i < n_my; ++i)
        for (int c = 0; c < nch; ++c) {
          const int j = i * nch + c, st = j % stages;
          mbar_wait(&empty[st], ((j / stages) & 1) ^ 1);
          mbar_expect_tx(&full[st], CB);
          bulk_load(ring + st * CB,
                    tiles + ((size_t)(tile0 + i) * nch + c) * CB, CB, &full[st]);
        }
    }
    return;
  }

  const int wg = threadIdx.x / 128, w = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, q = (lane & 3) * 2;
  const bool leader = (lane & 3) == 0;
  constexpr uint32_t sbo = CD / EPC * 128;     // the next 8 rows of a chunk
  constexpr int b_part = N * CD * E;
  // A's parts: the block's BM rows resident, or this warpgroup's 64 rows
  // in its half of the double buffer (CA / WG bytes a chunk).
  constexpr int a_part = (STREAM ? 64 : BM) * CD * E;
  uint8_t* a_own = a_smem + (STREAM ? wg * 2 * (CA / WG) : 0);
  if (!STREAM) {
    for (int c = 0; c < nch; ++c)
      stage_chunk<MODE>(a_smem + c * CA, BM, c, x, t0, T, D, threadIdx.x,
                        CONSUMERS);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1, CONSUMERS);
  }
  float* sout = out_stage + wg * 64 * SROW;
  float* row0 = sout + (w * 16 + lane / 4) * SROW;
  float* row1 = row0 + 8 * SROW;

  const bool carry = tps_log > 0;
  const int spt = carry ? 1 : 1 << (NLOG - kp_log);
  const int cps = (carry ? N : 1 << kp_log) / 8;
  const int tmask = (1 << tps_log) - 1;
  float cm[2] = {-INFINITY, -INFINITY}, cs[2] = {0.0f, 0.0f};
  int nb = 0;
  int sb0 = carry ? tile0 >> tps_log : tile0 * spt;

  auto flush = [&]() {
    named_sync(2 + wg, 128);
    for (int rr = 0; rr < 16; ++rr) {
      const int row = w * 16 + rr, t = t0 + wg * 64 + row;
      if (t < T && lane < nb && sb0 + lane < S)
        out[(size_t)t * S + sb0 + lane] = sout[row * SROW + lane];
    }
    named_sync(2 + wg, 128);
    sb0 += nb;
    nb = 0;
  };

  float2 cc[N / 8];
  float acc[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc[j] = 0.0f;
  for (int i = 0; i < n_my; ++i) {
    const int tile = tile0 + i;
    const float2* ct = reinterpret_cast<const float2*>(cst + (size_t)tile * N);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) cc[j] = __ldg(ct + 4 * j + q / 2);
    // The tile's chunks, all into acc: chunk c's products are issued, then
    // chunk c-1's are awaited and its stage freed.
    for (int c = 0; c < nch; ++c) {
      const int j = i * nch + c, st = j % stages;
      uint32_t a_addr;
      if (STREAM) {
        // Buffer j & 1 was last read by chunk j - 2, complete by now.
        uint8_t* a = a_own + (j & 1) * (CA / WG);
        stage_chunk<MODE>(a, 64, c, x, t0 + wg * 64, T, D, threadIdx.x % 128,
                          128);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        named_sync(2 + wg, 128);
        a_addr = smem_u32(a);
      } else {
        a_addr = smem_u32(a_smem) + c * CA + wg * 8 * sbo;
      }
      mbar_wait(&full[st], (j / stages) & 1);
      const uint32_t b_addr = smem_u32(ring + st * CB);
      fence_regs(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      constexpr int P0 = P == 2 ? 0 : 2;
#pragma unroll
      for (int p = P0; p < 3; ++p) {
        const int pa = p == 1, pb = p == 0;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          mma(acc, make_desc(a_addr + pa * a_part + ks * 256, sbo),
              make_desc(b_addr + pb * b_part + ks * 256, sbo),
              c != 0 || p != P0 || ks != 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      if (c > 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(j - 1) % stages]);
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(i * nch + nch - 1) % stages]);

    const bool first = (tile & tmask) == 0, last = (tile & tmask) == tmask;
    if (first && nb + spt > SB) flush();
    if (carry) {
      lse_tile<N, N / 8, true>(acc, cc, row0, row1, nb, leader, last, cm, cs);
    } else {
      switch (cps) {
        case 1: lse_tile<N, 1, false>(acc, cc, row0, row1, nb, leader, last, cm, cs); break;
        case 2: lse_tile<N, 2, false>(acc, cc, row0, row1, nb, leader, last, cm, cs); break;
        case 4: lse_tile<N, 4, false>(acc, cc, row0, row1, nb, leader, last, cm, cs); break;
        case 8: lse_tile<N, 8, false>(acc, cc, row0, row1, nb, leader, last, cm, cs); break;
        default: lse_tile<N, 16, false>(acc, cc, row0, row1, nb, leader, last, cm, cs); break;
      }
    }
    if (last) nb += spt;
  }
  flush();
}

// The wide kernel's choice for nch chunks: the most warpgroups whose
// resident A leaves a ring of two stages, else A staged chunk by chunk at
// the mode's own warpgroups.  Returns the stages (< 2: none fits).  The ring needs
// two: a chunk's stage is freed only once the next chunk's products are
// issued.
template <int MODE>
int resident_stages(int wg, int nch) {
  switch (wg) {
    case 1: return Wide<MODE, 1>::template stages<false>(nch);
    case 2: return Wide<MODE, 2>::template stages<false>(nch);
    default: return Wide<MODE, 3>::template stages<false>(nch);
  }
}

template <int MODE>
int wide_plan(int nch, int& wg, bool& stream) {
  for (int g = Cfg<MODE>::WG; g >= 1; --g) {
    const int st = resident_stages<MODE>(g, nch);
    if (st >= 2) {
      wg = g;
      stream = false;
      return st;
    }
  }
  wg = Cfg<MODE>::WG;
  stream = true;
  return Wide<MODE, Cfg<MODE>::WG>::template stages<true>(nch);
}

// Sets the kernel's shared-memory ceiling once a device.
template <typename K>
cudaError_t allow_smem(K kern, uint64_t& attr_set, int dev) {
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(attr_set >> dev & 1)) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    attr_set |= uint64_t{1} << dev;
  }
  return cudaSuccess;
}

template <int MODE, int WG, bool STREAM>
int launch_wide(const float* x, const uint8_t* tiles, const float* cst,
                float* out, int T, int S, int D, int kp_log, int n_tiles,
                int nch, cudaStream_t stream) {
  using G = Wide<MODE, WG>;
  constexpr int NLOG = Cfg<MODE>::NLOG;
  const int stages = G::template stages<STREAM>(nch);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int tps_log = kp_log > NLOG ? kp_log - NLOG : 0;
  if ((int64_t)n_tiles * G::N < (int64_t)S << kp_log ||
      (n_tiles & ((1 << tps_log) - 1)))
    return (int)cudaErrorInvalidValue;
  auto kern = fused_gmm_wide_kernel<MODE, WG, STREAM>;
  static uint64_t attr_set = 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if ((err = allow_smem(kern, attr_set, dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const int n_units = n_tiles >> tps_log;
  const int frame_blocks = (T + G::BM - 1) / G::BM;
  int split = (4 * sms + frame_blocks - 1) / frame_blocks;
  split = split < n_units ? split : n_units;
  split = split > 0 ? (split < 65535 ? split : 65535) : 1;
  const int smem = G::template fixed<STREAM>(nch) + stages * G::CHUNK_B;
  kern<<<dim3(frame_blocks, split), G::THREADS, smem, stream>>>(
      x, tiles, cst, out, T, S, D, kp_log, n_units, tps_log, nch, stages);
  return (int)cudaGetLastError();
}

// The depth loop at wide_plan's geometry for dp / CD chunks.
template <int MODE>
int dispatch_wide(int dp, const float* x, const uint8_t* tiles,
                  const float* cst, float* out, int T, int S, int D,
                  int kp_log, int n_tiles, int tile_bytes, cudaStream_t st) {
  constexpr int WG = Cfg<MODE>::WG;
  const int nch = dp / CD;
  if (dp % CD || tile_bytes != nch * Wide<MODE, 1>::CHUNK_B)
    return (int)cudaErrorInvalidValue;
  int wg = 0;
  bool streamed = false;
  if (wide_plan<MODE>(nch, wg, streamed) < 2) return (int)cudaErrorInvalidValue;
  if (streamed)
    return launch_wide<MODE, WG, true>(x, tiles, cst, out, T, S, D, kp_log,
                                       n_tiles, nch, st);
  switch (wg) {
    case 1: return launch_wide<MODE, 1, false>(x, tiles, cst, out, T, S, D, kp_log, n_tiles, nch, st);
    case 2: return launch_wide<MODE, 2, false>(x, tiles, cst, out, T, S, D, kp_log, n_tiles, nch, st);
    default:
      if constexpr (WG >= 3)
        return launch_wide<MODE, 3, false>(x, tiles, cst, out, T, S, D, kp_log, n_tiles, nch, st);
      return (int)cudaErrorInvalidValue;
  }
}

template <int MODE, int KS>
int launch(const float* x, const uint8_t* tiles, const float* cst, float* out,
           int T, int S, int D, int kp_log, int n_tiles, int tile_bytes,
           cudaStream_t stream) {
  using G = Geom<MODE, KS>;
  constexpr int N = Cfg<MODE>::N, NLOG = Cfg<MODE>::NLOG;
  if constexpr (G::STAGES < 1) {
    return (int)cudaErrorInvalidValue;        // D too wide for this mode
  } else {
    const int tps_log = kp_log > NLOG ? kp_log - NLOG : 0;
    if (tile_bytes != G::TILE_BYTES || (int64_t)n_tiles * N < (int64_t)S << kp_log ||
        (n_tiles & ((1 << tps_log) - 1)))
      return (int)cudaErrorInvalidValue;
    auto kern = fused_gmm_kernel<MODE, KS>;
    // The shared-memory size is set once for each device (a launch costs
    // only the launch on the host).
    static uint64_t attr_set = 0;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!(attr_set >> dev & 1)) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
      if (err != cudaSuccess) return (int)err;
      attr_set |= uint64_t{1} << dev;
    }
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return (int)err;
    // About four blocks an SM: frame blocks x senone ranges.
    const int n_units = n_tiles >> tps_log;
    const int frame_blocks = (T + G::BM - 1) / G::BM;
    int split = (4 * sms + frame_blocks - 1) / frame_blocks;
    split = split < n_units ? split : n_units;
    split = split > 0 ? (split < 65535 ? split : 65535) : 1;
    kern<<<dim3(frame_blocks, split), G::THREADS, G::SMEM, stream>>>(
        x, tiles, cst, out, T, S, D, kp_log, n_units, tps_log);
    return (int)cudaGetLastError();
  }
}

// One instantiation a depth, so that the k-steps (32 bytes of depth each)
// unroll: Dp = 16..128 (D <= 64); past it, the depth loop.
template <int MODE, int KS = Cfg<MODE>::E == 4 ? 2 : 1>
int dispatch(int Dp, const float* x, const uint8_t* tiles, const float* cst,
             float* out, int T, int S, int D, int kp_log, int n_tiles,
             int tile_bytes, cudaStream_t stream) {
  if constexpr (KS > 4 * Cfg<MODE>::E) {
    // Past Dp = 128: the depth loop.
    return dispatch_wide<MODE>(Dp, x, tiles, cst, out, T, S, D, kp_log,
                               n_tiles, tile_bytes, stream);
  } else {
    if (Dp * Cfg<MODE>::E / 32 == KS)
      return launch<MODE, KS>(x, tiles, cst, out, T, S, D, kp_log, n_tiles,
                              tile_bytes, stream);
    return dispatch<MODE, KS + (Cfg<MODE>::E == 4 ? 2 : 1)>(
        Dp, x, tiles, cst, out, T, S, D, kp_log, n_tiles, tile_bytes, stream);
  }
}

}  // namespace

// One mode's kernels at any depth (each defined in that mode's unit).
#define K1_DISPATCH_ARGS                                                   \
  int Dp, const float *x, const uint8_t *tiles, const float *cst,           \
      float *out, int T, int S, int D, int kp_log, int n_tiles,            \
      int tile_bytes, cudaStream_t stream
int fused_gmm_dispatch_0(K1_DISPATCH_ARGS);
int fused_gmm_dispatch_1(K1_DISPATCH_ARGS);
int fused_gmm_dispatch_2(K1_DISPATCH_ARGS);

#ifdef K1_MODE
#define K1_CAT(a, b) a##b
#define K1_NAME(m) K1_CAT(fused_gmm_dispatch_, m)
int K1_NAME(K1_MODE)(K1_DISPATCH_ARGS) {
  return dispatch<K1_MODE>(Dp, x, tiles, cst, out, T, S, D, kp_log, n_tiles,
                           tile_bytes, stream);
}
#else

// x [T, D] f32; tiles: n_tiles packed senone tiles of tile_bytes each
// and cst their n_tiles * N consts (ops/fused_gmm.py pack_params for this
// mode, N densities a tile, Kp = 2^kp_log densities a senone, depth Dp;
// past Dp = 128 chunk by chunk); out [T, S] f32.  All contiguous, on one
// device.  Returns the CUDA error code of the launch (0 = success).
extern "C" int fused_gmm_launch(int mode, const void* x, const void* tiles,
                                const void* cst, void* out, int T, int S, int D, int Dp,
                                int kp_log, int n_tile, int n_tiles,
                                int tile_bytes, void* stream) {
  if (T <= 0 || S <= 0) return 0;
  if (D <= 0 || Dp < 2 * D || Dp % 16 || kp_log < 3 || kp_log > 20 ||
      n_tiles <= 0)
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const uint8_t* tp = static_cast<const uint8_t*>(tiles);
  const float* cp = static_cast<const float*>(cst);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case HIGHEST:
      if (n_tile != Cfg<HIGHEST>::N) return (int)cudaErrorInvalidValue;
      return fused_gmm_dispatch_0(Dp, xp, tp, cp, op, T, S, D, kp_log,
                                  n_tiles, tile_bytes, st);
    case HIGH:
      if (n_tile != Cfg<HIGH>::N) return (int)cudaErrorInvalidValue;
      return fused_gmm_dispatch_1(Dp, xp, tp, cp, op, T, S, D, kp_log,
                                  n_tiles, tile_bytes, st);
    case BF16:
      if (n_tile != Cfg<BF16>::N) return (int)cudaErrorInvalidValue;
      return fused_gmm_dispatch_2(Dp, xp, tp, cp, op, T, S, D, kp_log,
                                  n_tiles, tile_bytes, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The depth loop's geometry at depth dp (a multiple of 32 above 128), as
// fused_gmm_launch takes it: *wg consumer warpgroups (64 frames each) and
// *streamed (A staged chunk by chunk rather than resident).
extern "C" int fused_gmm_plan(int mode, int dp, int* wg, int* streamed) {
  if (dp <= 128 || dp % CD) return (int)cudaErrorInvalidValue;
  const int nch = dp / CD;
  bool s = false;
  int st = 0;
  switch (mode) {
    case HIGHEST: st = wide_plan<HIGHEST>(nch, *wg, s); break;
    case HIGH: st = wide_plan<HIGH>(nch, *wg, s); break;
    case BF16: st = wide_plan<BF16>(nch, *wg, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  *streamed = s;
  return st >= 2 ? 0 : (int)cudaErrorInvalidValue;
}
#endif  // K1_MODE
