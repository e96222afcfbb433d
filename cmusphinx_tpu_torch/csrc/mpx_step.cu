// The multiplexed-left-context frame step's channel update for Hopper
// (sm_90a): two kernels around the search's word-exit readout.
//
// Replaces no TPU kernel.  The reference's mpx step
// (cmusphinx_tpu/decode/ngram_search.py, _make_core and its batched form)
// was jnp code that XLA compiled and fused; the port ran it as PyTorch
// kernels over the [B, C, S] carry, ten concatenations and nested selects
// a frame among them (cmusphinx_tpu_torch/ops/mpx_step.py holds that
// composition as the plain version these kernels are held to, bit for
// bit).
//
//   mpx_step_exits   (A)  hmm_step: each state's senone score gathered
//                         through its own senone-sequence row (a payload),
//                         emission, the exit into the final state, the
//                         self / j-1 / j-2 transitions with their tie
//                         order; writes the exits, their three payloads
//                         (tape slot, h2, h1) and the frame's best score
//                         per row, and no [B, C, S] array.
//   mpx_prune_enter  (B)  the same step again from the same carry, the
//                         channel beam (with the phone-loop lookahead),
//                         the word-exit beam on the predecessor's exit,
//                         the within-word propagation, the entries routed
//                         by word with their left context's row,
//                         hmm_enter, the valid mask: the new carry, in
//                         place.
//
// What bounds them.  Every operation is an IEEE add, max or compare; the
// work is the bytes.  The carry is alpha (float32) and four int32
// payloads, 20 bytes a state: at the 64k flat lexicon (B=16, C~349,000,
// S=3) 335 MB.  A reads it and writes 16 bytes a channel; B reads it
// again, 4 bytes a channel of the predecessors' exits, and writes it.  B
// redoes the step rather than read A's stepped arrays back: the step is
// adds and maxes, so the second pass gives the first's bits, and the
// stepped carry (another 20 bytes a state written and read) is never
// stored.  The senone-sequence rows [B, n_xs, S] stay in L2.
//
// The design.  A block of 256 threads takes 256 channels of one batch row
// (grid: channel blocks x rows), a thread one channel with its S states in
// registers.  The block stages its part of the [B, C, S] arrays through
// shared memory, so that every global load and store is a coalesced run.
// The row's best score is a max, exact in any order: a warp shuffle, the
// block's warps in shared memory, then one atomic max a block into
// best[b] (set to -inf by the caller); B reads it after A has ended,
// which the stream orders.  B reads an exit's payloads and an entry's
// payloads only where a token enters: that is where the plain version's
// selects take them.  B leaves an invalid row's carry untouched.  Nothing
// is allocated here: the wrapper hands in every buffer.  Adds are written
// in the plain version's order and nvcc contracts no add (there is no
// multiply), so the results are the plain version's bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPB = 256;
constexpr int NPAY = 4;   // tape slot, senone-sequence row, h2, h1
constexpr float NEG_INF = -1.0e30f;

// torch.maximum: the larger, NaN if either is.
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// clamp_min(NEG_INF), NaN kept.
__device__ __forceinline__ float floor_neg(float a) {
  return a < NEG_INF ? NEG_INF : a;
}

__device__ __forceinline__ void atomic_max(float* addr, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

// The carry's arrays: alpha and the four payloads, each [B, C, S].
struct Carry {
  float* alpha;
  int* pay[NPAY];
};

struct Bands {
  const float* d0;
  const float* d1;
  const float* d2;
  const float* e_last;
  const float* e_prev;
};

// One block's part of the carry in shared memory: TPB channels of S
// states, alpha and the payloads.
template <int S>
struct Staged {
  float a[TPB * S];
  int p[NPAY][TPB * S];
};

template <int S>
__device__ __forceinline__ void stage_in(Staged<S>& sm, const Carry& cy,
                                         size_t base, int n) {
  for (int k = threadIdx.x; k < n; k += TPB) {
    sm.a[k] = cy.alpha[base + k];
#pragma unroll
    for (int q = 0; q < NPAY; ++q) sm.p[q][k] = cy.pay[q][base + k];
  }
}

template <int S>
__device__ __forceinline__ void stage_out(const Staged<S>& sm,
                                          const Carry& cy, size_t base,
                                          int n) {
  for (int k = threadIdx.x; k < n; k += TPB) {
    cy.alpha[base + k] = sm.a[k];
#pragma unroll
    for (int q = 0; q < NPAY; ++q) cy.pay[q][base + k] = sm.p[q][k];
  }
}

// hmm_step for channel c of row b from the staged carry: the new alpha
// and payloads in a[] and p[][], the exit and its payloads in *ex and
// xp[] (the tape slot, h2, h1).  Each state's senone score is row
// p[1][j] of the frame's rows.
template <int S>
__device__ __forceinline__ void step_channel(
    const Staged<S>& sm, const float* __restrict__ rows, const Bands& bd,
    int b, int c, int n_xs, float a[S], int p[NPAY][S], float* ex,
    int xp[3]) {
  const int t = threadIdx.x;
  float s[S];
  int h[NPAY][S];
  const float* row_b = rows + static_cast<size_t>(b) * n_xs * S;
#pragma unroll
  for (int j = 0; j < S; ++j) {
#pragma unroll
    for (int q = 0; q < NPAY; ++q) h[q][j] = sm.p[q][t * S + j];
    s[j] = sm.a[t * S + j] + row_b[static_cast<size_t>(h[1][j]) * S + j];
  }
  // The exit: the last state wins ties.
  const float e_l = s[S - 1] + bd.e_last[c];
  float e = e_l;
  int src = S - 1;
  if constexpr (S >= 2) {
    const float e_p = s[S - 2] + bd.e_prev[c];
    if (!(e_l >= e_p)) {
      e = e_p;
      src = S - 2;
    }
  }
  *ex = floor_neg(e);
  xp[0] = src == S - 1 ? h[0][S - 1] : h[0][S > 1 ? S - 2 : 0];
  xp[1] = src == S - 1 ? h[2][S - 1] : h[2][S > 1 ? S - 2 : 0];
  xp[2] = src == S - 1 ? h[3][S - 1] : h[3][S > 1 ? S - 2 : 0];
  // Transitions: the self loop first on ties, then j-1, then j-2; the
  // first states' own payloads stand in for their missing predecessors.
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float c_self = s[j] + bd.d0[static_cast<size_t>(c) * S + j];
    float v = c_self;
    int from = j;
    if constexpr (S == 2) {
      const float c_prev =
          j >= 1 ? s[j - 1] + bd.d1[static_cast<size_t>(c) * (S - 1) + j - 1]
                 : NEG_INF;
      v = tmax(c_self, c_prev);
      if (!(c_self >= c_prev)) from = j >= 1 ? j - 1 : 0;
    } else if constexpr (S >= 3) {
      const float c_prev =
          j >= 1 ? s[j - 1] + bd.d1[static_cast<size_t>(c) * (S - 1) + j - 1]
                 : NEG_INF;
      const float c_skip =
          j >= 2 ? s[j - 2] + bd.d2[static_cast<size_t>(c) * (S - 2) + j - 2]
                 : NEG_INF;
      const float m12 = tmax(c_prev, c_skip);
      v = tmax(c_self, m12);
      if (!(c_self >= m12))
        from = c_prev >= c_skip ? (j >= 1 ? j - 1 : 0) : (j >= 2 ? j - 2 : j);
    }
    a[j] = floor_neg(v);
#pragma unroll
    for (int q = 0; q < NPAY; ++q) {
      // A select over the unrolled states keeps h[][] in registers.
      int x = h[q][0];
#pragma unroll
      for (int i = 1; i < S; ++i) x = from == i ? h[q][i] : x;
      p[q][j] = x;
    }
  }
}

template <int S>
__global__ void __launch_bounds__(TPB) mpx_step_exits(
    Carry cy, const float* __restrict__ rows, Bands bd, float* __restrict__ ex,
    int* __restrict__ exh3, float* __restrict__ best, int C, int n_xs) {
  __shared__ Staged<S> sm;
  __shared__ int sx[TPB * 3];
  __shared__ float wbest[TPB / 32];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * TPB;
  const int m = min(TPB, C - c0);
  const size_t base = (static_cast<size_t>(b) * C + c0) * S;
  stage_in(sm, cy, base, m * S);
  __syncthreads();
  const int c = c0 + threadIdx.x;
  float top = __int_as_float(static_cast<int>(0xff800000u));   // -inf
  if (c < C) {
    float a[S], e;
    int p[NPAY][S], xp[3];
    step_channel<S>(sm, rows, bd, b, c, n_xs, a, p, &e, xp);
    ex[static_cast<size_t>(b) * C + c] = e;
#pragma unroll
    for (int q = 0; q < 3; ++q) sx[threadIdx.x * 3 + q] = xp[q];
#pragma unroll
    for (int j = 0; j < S; ++j) top = fmaxf(top, a[j]);
  }
  __syncthreads();
  const size_t xbase = (static_cast<size_t>(b) * C + c0) * 3;
  for (int k = threadIdx.x; k < m * 3; k += TPB) exh3[xbase + k] = sx[k];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, o));
  if ((threadIdx.x & 31) == 0) wbest[threadIdx.x >> 5] = top;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < TPB / 32; ++w) top = fmaxf(top, wbest[w]);
    atomic_max(best + b, top);
  }
}

// The search's channel tables [C] and the per-word entries [B, W].
struct Tables {
  const int* xs;             // static senone-sequence row
  const int* pc;             // predecessor channel (0 where none)
  const uint8_t* has_prev;
  const uint8_t* is_entry;
  const int* word_of;
  const int* lc_base;        // the channel's lcmap row times n_ci
  const int* ci_of;
  const int* lcmap;          // [n_lcrows * n_ci] -> senone-sequence row
};

template <int S>
__global__ void __launch_bounds__(TPB) mpx_prune_enter(
    Carry cy, const float* __restrict__ rows, Bands bd,
    const float* __restrict__ ex, const int* __restrict__ exh3,
    const float* __restrict__ best, Tables tb,
    const float* __restrict__ ent_w, const int4* __restrict__ ent_pay,
    const float* __restrict__ la_t, int64_t la_stride,
    const uint8_t* __restrict__ valid, int64_t valid_stride, int C, int n_xs,
    int W, int prune, float log_beam, float log_wbeam, float pip) {
  __shared__ Staged<S> sm;
  const int b = blockIdx.y;
  if (!valid[b * valid_stride]) return;        // the old carry stays
  const int c0 = blockIdx.x * TPB;
  const int m = min(TPB, C - c0);
  const size_t base = (static_cast<size_t>(b) * C + c0) * S;
  stage_in(sm, cy, base, m * S);
  __syncthreads();
  const int c = c0 + threadIdx.x;
  float a[S];
  int p[NPAY][S];
  if (c < C) {
    float e_own;
    int xp_own[3];
    step_channel<S>(sm, rows, bd, b, c, n_xs, a, p, &e_own, xp_own);
    const float bs = best[b];
    if (prune) {
      float cmax = a[0];
#pragma unroll
      for (int j = 1; j < S; ++j) cmax = tmax(cmax, a[j]);
      if (la_t != nullptr) cmax = cmax + la_t[b * la_stride + tb.ci_of[c]];
      if (!(cmax > bs + log_beam)) {
#pragma unroll
        for (int j = 0; j < S; ++j) a[j] = NEG_INF;
      }
    }
    // The entry into state 0: the word's cross-word entry at its entry
    // channel, else the predecessor's exit with the phone penalty.
    if (tb.is_entry[c]) {
      const size_t bw = static_cast<size_t>(b) * W + tb.word_of[c];
      const float entry = ent_w[bw];
      if (entry > a[0]) {
        const int4 ep = ent_pay[bw];
        a[0] = entry;
        p[0][0] = ep.x;
        p[1][0] = tb.lcmap[tb.lc_base[c] + ep.y];
        p[2][0] = ep.z;
        p[3][0] = ep.w;
      }
    } else if (tb.has_prev[c]) {
      const size_t bp = static_cast<size_t>(b) * C + tb.pc[c];
      float e = ex[bp];
      if (prune && !(e > bs + log_wbeam)) e = NEG_INF;
      const float entry = e + pip;
      if (entry > a[0]) {
        a[0] = entry;
        p[0][0] = exh3[bp * 3];
        p[1][0] = tb.xs[c];
        p[2][0] = exh3[bp * 3 + 1];
        p[3][0] = exh3[bp * 3 + 2];
      }
    }
  }
  // A thread reads and writes back only its own channel's staged states.
  if (c < C) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      sm.a[threadIdx.x * S + j] = a[j];
#pragma unroll
      for (int q = 0; q < NPAY; ++q) sm.p[q][threadIdx.x * S + j] = p[q][j];
    }
  }
  __syncthreads();
  stage_out(sm, cy, base, m * S);
}

dim3 grid_of(int B, int C) { return dim3((C + TPB - 1) / TPB, B); }

Carry carry_of(void* alpha, void* hist, void* xsr, void* hw2, void* hw1) {
  Carry cy;
  cy.alpha = static_cast<float*>(alpha);
  cy.pay[0] = static_cast<int*>(hist);
  cy.pay[1] = static_cast<int*>(xsr);
  cy.pay[2] = static_cast<int*>(hw2);
  cy.pay[3] = static_cast<int*>(hw1);
  return cy;
}

Bands bands_of(const void* d0, const void* d1, const void* d2,
               const void* e_last, const void* e_prev) {
  return Bands{static_cast<const float*>(d0), static_cast<const float*>(d1),
               static_cast<const float*>(d2),
               static_cast<const float*>(e_last),
               static_cast<const float*>(e_prev)};
}

}  // namespace

// Kernel A on the caller's stream; returns cudaGetLastError() after the
// launch (0 when it was taken).  The carry is read, not written.
extern "C" int mpx_step_exits_launch(
    int S, void* alpha, void* hist, void* xsr, void* hw2, void* hw1,
    const void* rows, const void* d0, const void* d1, const void* d2,
    const void* e_last, const void* e_prev, void* ex, void* exh3, void* best,
    int B, int C, int n_xs, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Carry cy = carry_of(alpha, hist, xsr, hw2, hw1);
  const Bands bd = bands_of(d0, d1, d2, e_last, e_prev);
#define MPX_A(NS)                                                          \
  mpx_step_exits<NS><<<grid_of(B, C), TPB, 0, st>>>(                       \
      cy, static_cast<const float*>(rows), bd, static_cast<float*>(ex),    \
      static_cast<int*>(exh3), static_cast<float*>(best), C, n_xs);        \
  break;
  switch (S) {
    case 1: MPX_A(1)
    case 2: MPX_A(2)
    case 3: MPX_A(3)
    case 4: MPX_A(4)
    case 5: MPX_A(5)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MPX_A
  return static_cast<int>(cudaGetLastError());
}

// Kernel B on the caller's stream: writes the new carry in place, on the
// valid rows.  la_t may be null.
extern "C" int mpx_prune_enter_launch(
    int S, void* alpha, void* hist, void* xsr, void* hw2, void* hw1,
    const void* rows, const void* d0, const void* d1, const void* d2,
    const void* e_last, const void* e_prev, const void* ex, const void* exh3,
    const void* best, const void* xs, const void* pc, const void* has_prev,
    const void* is_entry, const void* word_of, const void* lc_base,
    const void* ci_of, const void* lcmap, const void* ent_w,
    const void* ent_pay, const void* la_t, int64_t la_stride,
    const void* valid, int64_t valid_stride, int B, int C, int n_xs, int W,
    int prune, float log_beam, float log_wbeam, float pip, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Carry cy = carry_of(alpha, hist, xsr, hw2, hw1);
  const Bands bd = bands_of(d0, d1, d2, e_last, e_prev);
  const Tables tb{static_cast<const int*>(xs), static_cast<const int*>(pc),
                  static_cast<const uint8_t*>(has_prev),
                  static_cast<const uint8_t*>(is_entry),
                  static_cast<const int*>(word_of),
                  static_cast<const int*>(lc_base),
                  static_cast<const int*>(ci_of),
                  static_cast<const int*>(lcmap)};
#define MPX_B(NS)                                                           \
  mpx_prune_enter<NS><<<grid_of(B, C), TPB, 0, st>>>(                       \
      cy, static_cast<const float*>(rows), bd,                              \
      static_cast<const float*>(ex), static_cast<const int*>(exh3),         \
      static_cast<const float*>(best), tb,                                  \
      static_cast<const float*>(ent_w), static_cast<const int4*>(ent_pay),  \
      static_cast<const float*>(la_t), la_stride,                           \
      static_cast<const uint8_t*>(valid), valid_stride, C, n_xs, W, prune,  \
      log_beam, log_wbeam, pip);                                            \
  break;
  switch (S) {
    case 1: MPX_B(1)
    case 2: MPX_B(2)
    case 3: MPX_B(3)
    case 4: MPX_B(4)
    case 5: MPX_B(5)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MPX_B
  return static_cast<int>(cudaGetLastError());
}
