// pocketsphinx's phonetically-tied-mixture scorer (ptm_mgau.c: eval_topn,
// ptm_mgau_codebook_norm, ptm_mgau_senone_eval), bit-faithful, as one
// kernel from features [N, D] to senone scores [N, S].
//
// It replaces no TPU kernel: the JAX package has no scorer for this model.
// The plain version is `PtmParityScorer.score_ref` (ops/gmm.py); the
// wrapper is ops/ptm_parity.py, which packs the operands.
//
// What bounds it.  At the en-us model's shape (C = 42 codebooks, 3 streams
// of 13, K = 128, S = 5,126, top 4) and a batch's N ~ 9,600 frames, the
// densities are 8.05 G float32 operations (the reference's order: a
// subtraction, two products and a subtraction a dimension, each rounded,
// so no fused multiply-add; 0.24 ms at one an SM lane a clock) and the
// least bytes are the [N, S] float32 output, ~197 MB (0.060 ms).
// Instruction throughput, not memory, sets the time: on an H100 the first
// pass takes ~0.64 ms (its float32 chain, the codewords' loads, the top-N
// insertion) and the second ~0.38 ms (the log-add's integer operations,
// which run at half the float32 rate), 1.03 ms in all; other block
// sizes, blocks an SM, unrolling and frames a task moved it by under 10 %
// (PERF.md).
//
// The design, one cooperative launch in two passes around one grid-wide
// barrier (the norm of a frame needs every codebook's top score; an
// arrival count in the scratch, zeroed on the stream before the launch):
//
//  pass 1, a warp a task (a codebook and stream, a tile of 32 frames): a
//   lane a frame, its stream's features in registers; the codewords'
//   parameters are read at one address across the warp (one record of
//   means, precisions and determinant a codeword), so the tasks of one
//   codebook run on neighbouring warps and share them in L1.  Each lane
//   keeps its frame's top N in registers by insertion (strictly greater
//   moves up: ties stay with the lower index) and writes them, shifted
//   right by SHIFT and packed with their indices, to a scratch [N, C, F, 4].
//  pass 2, a block two frames: the norm of each stream (a shared-memory max
//   over the codebooks), each entry's fsc and the byte offset of its
//   weight row, then the senones in groups of 4 that share a codebook
//   (the wrapper orders the senones by codebook and pads each codebook's
//   run to a multiple of 4): one 4-byte load a stream and rank gives 4
//   senones' weights, the 8-bit log-add reads its table from shared memory
//   (the table's nonzero head, `dmax` entries, one a bank), and the scores
//   go to a shared row in the senones' own order, written out coalesced.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TPB = 256;        // threads a block
constexpr int WPB = TPB / 32;   // warps a block
constexpr int TILE = 32;        // frames a pass-1 task: one a lane
constexpr int MAXF = 4;         // streams
constexpr int FPT = 2;          // frames a pass-2 task

struct Args {
  const float* x;       // [N, D]
  const int* cols;      // [F, L] feature column of each stream dimension
  const float4* book;   // [C, F, K] records: L means, L precisions, lrd
  const uint8_t* mixp;  // [F, K, Sp] weights, senones ordered by codebook
  const int* gcb;       // [Sp / 4] codebook of each group of 4
  const int* orig;      // [Sp] senone of each ordered slot (-1: padding)
  const int* table;     // [256] the 8-bit log-add table
  int* top;             // [N, C, F, 4] scratch
  unsigned* bar;        // the barrier's arrival count, zeroed before launch
  float* out;           // [N, S]
  int N, D, C, F, K, S, Sp, shift, max_neg, dmax;
  float scale;
};

// Every block of the grid waits here until all have arrived.  The launch is
// cooperative, so all blocks are resident; `bar` is zeroed on the stream
// before each launch and used once.
__device__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (atomicAdd(bar, 0u) < gridDim.x) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

template <int L, int NT>
__global__ void __launch_bounds__(TPB, 3) ptm_parity_kernel(Args a) {
  constexpr int REC = (2 * L + 1 + 3) / 4;   // float4s a codeword record
  extern __shared__ int smem[];
  int* table_s = smem;                        // [256]
  int* norm_s = table_s + 256;                // [FPT, MAXF]
  int* sel_s = norm_s + FPT * MAXF;           // [FPT, C, F, 4]
  float* row_s = reinterpret_cast<float*>(sel_s + FPT * a.C * a.F * 4);
                                              // [FPT, S]
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < 256; i += TPB) table_s[i] = a.table[i];

  // ---- pass 1: the top N of each (frame, codebook, stream).
  const int ntile = (a.N + TILE - 1) / TILE;
  const long long ntask = (long long)a.C * a.F * ntile;
  const long long nwarp = (long long)gridDim.x * WPB;
  for (long long task = (long long)blockIdx.x * WPB + (tid >> 5);
       task < ntask; task += nwarp) {
    const int pair = (int)(task / ntile), tile = (int)(task % ntile);
    const int c = pair / a.F, f = pair % a.F;
    const int n = tile * TILE + lane;
    const bool live = n < a.N;
    float xr[L];
#pragma unroll
    for (int j = 0; j < L; ++j)
      xr[j] = live ? a.x[(long long)n * a.D + a.cols[f * L + j]] : 0.f;
    int v[NT], id[NT];
#pragma unroll
    for (int r = 0; r < NT; ++r) { v[r] = INT_MIN; id[r] = 0; }
    const float4* rec = a.book + (long long)(c * a.F + f) * a.K * REC;
#pragma unroll 2
    for (int k = 0; k < a.K; ++k) {
      float p[4 * REC];
#pragma unroll
      for (int i = 0; i < REC; ++i) {
        const float4 q = __ldg(rec + k * REC + i);
        p[4 * i] = q.x; p[4 * i + 1] = q.y; p[4 * i + 2] = q.z;
        p[4 * i + 3] = q.w;
      }
      float d = p[2 * L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const float diff = __fsub_rn(xr[j], p[j]);
        const float sq = __fmul_rn(diff, diff);
        d = __fsub_rn(d, __fmul_rn(sq, p[L + j]));
      }
      const int di = __float2int_rz(fminf(fmaxf(d, -2.0e9f), 0.f));
      if (di > v[NT - 1]) {
        // Entries below di move down one place; di takes the first place
        // whose entry it beats, after every entry equal to it.
#pragma unroll
        for (int r = NT - 1; r >= 0; --r) {
          if (r > 0 && di > v[r - 1]) {
            v[r] = v[r - 1]; id[r] = id[r - 1];
          } else if (di > v[r]) {
            v[r] = di; id[r] = k;
          }
        }
      }
    }
    if (live) {
      int e[4] = {0, 0, 0, 0};
#pragma unroll
      for (int r = 0; r < NT; ++r) e[r] = (v[r] >> a.shift) * 256 + id[r];
      reinterpret_cast<int4*>(a.top)[((long long)n * a.C + c) * a.F + f] =
          make_int4(e[0], e[1], e[2], e[3]);
    }
  }
  grid_barrier(a.bar);

  // ---- pass 2: a block FPT frames.
  const int CF = a.C * a.F, G = a.Sp / 4;
  for (int n0 = blockIdx.x * FPT; n0 < a.N; n0 += gridDim.x * FPT) {
    const int nf = min(FPT, a.N - n0);
    const int4* top =
        reinterpret_cast<const int4*>(a.top) + (long long)n0 * CF;
    if (tid < FPT * MAXF) norm_s[tid] = INT_MIN;
    __syncthreads();
    for (int i = tid; i < nf * CF; i += TPB) {
      atomicMax(norm_s + (i / CF) * MAXF + i % a.F, __ldcg(top + i).x >> 8);
    }
    __syncthreads();
    for (int i = tid; i < nf * CF; i += TPB) {
      const int4 e = __ldcg(top + i);
      const int f = i % a.F, norm = norm_s[(i / CF) * MAXF + f];
      const int ev[4] = {e.x, e.y, e.z, e.w};
      int w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int r = 0; r < NT; ++r) {
        const int fsc = min(norm - (ev[r] >> 8), a.max_neg);
        w[r] = (fsc << 24) | ((f * a.K + (ev[r] & 255)) * a.Sp);
      }
      reinterpret_cast<int4*>(sel_s)[i] = make_int4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();
    for (int i = tid; i < nf * G; i += TPB) {
      const int t = i / G, g = i % G;
      const int4* sel = reinterpret_cast<const int4*>(sel_s) + t * CF;
      const int cb = __ldg(a.gcb + g);
      int acc[4] = {0, 0, 0, 0};
      for (int f = 0; f < a.F; ++f) {
        const int4 wv = sel[cb * a.F + f];
        const int ws[4] = {wv.x, wv.y, wv.z, wv.w};
        int fd[4];
#pragma unroll
        for (int r = 0; r < NT; ++r) {
          const unsigned m = __ldg(reinterpret_cast<const unsigned*>(
              a.mixp + (ws[r] & 0xFFFFFF)) + g);
          const int fsc = (int)((unsigned)ws[r] >> 24);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int y = (int)((m >> (8 * q)) & 255u) + fsc;
            if (r == 0) {
              fd[q] = y;
            } else {
              const int u = fd[q];
              fd[q] = min(u, y) - table_s[min(abs(u - y), a.dmax)];
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += fd[q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = __ldg(a.orig + 4 * g + q);
        if (s >= 0) row_s[t * a.S + s] = __fmul_rn(-(float)acc[q], a.scale);
      }
    }
    __syncthreads();
    float* orow = a.out + (long long)n0 * a.S;
    for (int i = tid; i < nf * a.S; i += TPB) orow[i] = row_s[i];
  }
}

size_t smem_bytes(int C, int F, int S) {
  return sizeof(int) * (256 + FPT * (MAXF + (size_t)C * F * 4)) +
         sizeof(float) * FPT * S;
}

template <int L, int NT>
int launch(const Args& args, void* stream) {
  auto kern = ptm_parity_kernel<L, NT>;
  const size_t smem = smem_bytes(args.C, args.F, args.S);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, TPB,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // Every block resident at once (the barrier needs it), and no more
  // blocks than either pass has work for.
  const long long tasks = (long long)args.C * args.F *
                          ((args.N + TILE - 1) / TILE);
  const long long work = std::max((tasks + WPB - 1) / WPB,
                                  (long long)(args.N + FPT - 1) / FPT);
  const long long grid = std::min((long long)sms * per_sm, work);
  err = cudaMemsetAsync(args.bar, 0, sizeof(unsigned),
                        static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  Args a = args;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3((unsigned)grid),
                                    dim3(TPB), params, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// One call on the caller's stream; returns 0 or the CUDA error.  `L` is the
// padded stream width (13, or 16 for any width up to 16), `topn` 1 to 4.
extern "C" int ptm_parity_launch(
    const void* x, const void* cols, const void* book, const void* mixp,
    const void* gcb, const void* orig, const void* table, void* top,
    void* bar, void* out,
    int N, int D, int C, int F, int K, int S, int Sp, int L, int topn,
    int shift, int max_neg, int dmax, float scale, void* stream) {
  if (N <= 0) return 0;
  if (F < 1 || F > MAXF || K < topn || K > 256 || Sp % 4 || C * F > TPB) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{static_cast<const float*>(x), static_cast<const int*>(cols),
         static_cast<const float4*>(book), static_cast<const uint8_t*>(mixp),
         static_cast<const int*>(gcb), static_cast<const int*>(orig),
         static_cast<const int*>(table), static_cast<int*>(top),
         static_cast<unsigned*>(bar), static_cast<float*>(out), N, D, C, F,
         K, S, Sp, shift, max_neg, dmax, scale};
#define PTM_CASE(LL, NN) \
  if (L == LL && topn == NN) return launch<LL, NN>(a, stream);
  PTM_CASE(13, 1) PTM_CASE(13, 2) PTM_CASE(13, 3) PTM_CASE(13, 4)
  PTM_CASE(16, 1) PTM_CASE(16, 2) PTM_CASE(16, 3) PTM_CASE(16, 4)
#undef PTM_CASE
  return (int)cudaErrorInvalidValue;
}
