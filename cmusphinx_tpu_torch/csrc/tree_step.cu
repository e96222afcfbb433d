// The one-copy prefix-tree frame step's channel update for Hopper (sm_90a):
// two kernels around the search's word-exit readout.
//
// Replaces no TPU kernel.  The reference's tree step
// (cmusphinx_tpu/decode/ngram_search.py, _make_core_tree and
// _make_core_tree_batched) was jnp code that XLA compiled and fused; the
// port ran it as ~550 PyTorch kernels a frame step, each a pass over the
// [B, C, S] channel arrays (cmusphinx_tpu_torch/ops/tree_step.py holds
// that composition as the plain version these kernels are held to, bit
// for bit).
//
//   tree_step_exits   (A)  hmm_step: emission, the exit into the final
//                          state, the self / j-1 / j-2 transitions, each
//                          with its tie order; the entry age advanced on
//                          the way in; the frame's best score per row.
//   tree_prune_enter  (B)  the channel and word-exit beams, the
//                          within-word propagation with the telescoping
//                          smear, the entries at the roots, hmm_enter, the
//                          valid mask: the new carry, in place.
//
// What bounds them.  Every operation is an IEEE add, max or compare; the
// work is the bytes.  At the 64k tree (B=16, C=262,717, S=3) one [B, C, S]
// float array is 50.4 MB, its uint8 entry age 12.6 MB, a [B, C] array
// 16.8 MB.  A reads alpha and age and writes them stepped with the exits
// (~168 MB with the senone rows and bands); B reads the stepped arrays and
// the exits through the predecessor channel and writes the carry (~153 MB
// with the channel tables): about 321 MB a frame step, 96 us at 3.35
// TB/s.  The update needs 279 MB at the least (83 us; tree_step.py
// least_bytes): B could redo the step from alpha0 and the ages, reading
// 5 bytes a state where it reads A's stepped arrays back.
//
// The design.  A block of 256 threads takes 256 channels of one batch row
// (grid: channel blocks x rows), a thread one channel with its S states in
// registers.  The block stages its rows of the [B, C, S] arrays through
// shared memory, so that every global load and store is a coalesced run
// of the array.  A gathers each channel's senone-sequence row from the
// frame's [B, n_xs, S] scores (n_xs << C: the rows stay in L2), so the
// [B, C, S] expansion is never written.  The row's best score is a max,
// exact in any order: a warp shuffle, the block's warps in shared memory,
// then one atomic max a block into best[b] (set to -inf by the caller).
// B reads best[b] after A has ended, which the stream orders.  B leaves
// an invalid row's carry untouched, so it needs no copy of it.  Nothing
// is allocated here: the wrapper hands in every buffer.  Adds are written
// in the plain version's order and nvcc contracts no add (there is no
// multiply), so the results are the plain version's bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPB = 256;
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

template <int S>
__global__ void __launch_bounds__(TPB) tree_step_exits(
    const float* __restrict__ alpha0, const uint8_t* __restrict__ hist0,
    const float* __restrict__ rows, const int* __restrict__ xs,
    const float* __restrict__ d0, const float* __restrict__ d1,
    const float* __restrict__ d2, const float* __restrict__ e_last,
    const float* __restrict__ e_prev, float* __restrict__ alpha,
    uint8_t* __restrict__ hist, float* __restrict__ ex,
    uint8_t* __restrict__ exh, float* __restrict__ best, int C, int n_xs) {
  __shared__ float sa[TPB * S];
  __shared__ uint8_t sh[TPB * S];
  __shared__ float wbest[TPB / 32];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * TPB;
  const int n = min(TPB, C - c0) * S;
  const size_t base = (static_cast<size_t>(b) * C + c0) * S;
  for (int k = threadIdx.x; k < n; k += TPB) {
    sa[k] = alpha0[base + k];
    sh[k] = hist0[base + k];
  }
  __syncthreads();
  const int c = c0 + threadIdx.x;
  float top = __int_as_float(static_cast<int>(0xff800000u));   // -inf
  if (c < C) {
    const float* sen = rows + (static_cast<size_t>(b) * n_xs + xs[c]) * S;
    float s[S];
    uint8_t h[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      s[j] = sa[threadIdx.x * S + j] + sen[j];
      const uint8_t a = sh[threadIdx.x * S + j];
      h[j] = (a < 254 ? a : 254) + 1;
    }
    // The exit: the last state wins ties.
    const float e_l = s[S - 1] + e_last[c];
    float e = e_l;
    uint8_t eh = h[S - 1];
    if constexpr (S >= 2) {
      const float e_p = s[S - 2] + e_prev[c];
      if (!(e_l >= e_p)) {
        e = e_p;
        eh = h[S - 2];
      }
    }
    const size_t bc = static_cast<size_t>(b) * C + c;
    ex[bc] = floor_neg(e);
    exh[bc] = eh;
    // Transitions: the self loop first on ties, then j-1, then j-2; the
    // first states' own ages stand in for their missing predecessors.
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const float c_self = s[j] + d0[static_cast<size_t>(c) * S + j];
      float v = c_self;
      uint8_t p = h[j];
      if constexpr (S == 2) {
        const float c_prev =
            j >= 1 ? s[j - 1] + d1[static_cast<size_t>(c) * (S - 1) + j - 1]
                   : NEG_INF;
        v = tmax(c_self, c_prev);
        if (!(c_self >= c_prev)) p = h[j >= 1 ? j - 1 : 0];
      } else if constexpr (S >= 3) {
        const float c_prev =
            j >= 1 ? s[j - 1] + d1[static_cast<size_t>(c) * (S - 1) + j - 1]
                   : NEG_INF;
        const float c_skip =
            j >= 2 ? s[j - 2] + d2[static_cast<size_t>(c) * (S - 2) + j - 2]
                   : NEG_INF;
        const float m12 = tmax(c_prev, c_skip);
        v = tmax(c_self, m12);
        if (!(c_self >= m12))
          p = c_prev >= c_skip ? h[j >= 1 ? j - 1 : 0] : h[j >= 2 ? j - 2 : j];
      }
      v = floor_neg(v);
      sa[threadIdx.x * S + j] = v;
      sh[threadIdx.x * S + j] = p;
      top = fmaxf(top, v);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += TPB) {
    alpha[base + k] = sa[k];
    hist[base + k] = sh[k];
  }
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

template <int S>
__global__ void __launch_bounds__(TPB) tree_prune_enter(
    float* __restrict__ alpha_out, uint8_t* __restrict__ hist_out,
    const float* __restrict__ alpha, const uint8_t* __restrict__ hist,
    const float* __restrict__ ex, const uint8_t* __restrict__ exh,
    const float* __restrict__ best, const int* __restrict__ pc,
    const uint8_t* __restrict__ has_prev, const uint8_t* __restrict__ is_entry,
    const int* __restrict__ root, const int* __restrict__ ci_of,
    const float* __restrict__ la_delta, const float* __restrict__ la_entry,
    const float* __restrict__ ent, const float* __restrict__ corr,
    const float* __restrict__ la_t, int64_t la_stride,
    const uint8_t* __restrict__ valid, int64_t valid_stride, int C, int R,
    int prune, float log_beam, float log_wbeam, float pip) {
  __shared__ float sa[TPB * S];
  __shared__ uint8_t sh[TPB * S];
  const int b = blockIdx.y;
  if (!valid[b * valid_stride]) return;        // the old carry stays
  const int c0 = blockIdx.x * TPB;
  const int n = min(TPB, C - c0) * S;
  const size_t base = (static_cast<size_t>(b) * C + c0) * S;
  for (int k = threadIdx.x; k < n; k += TPB) {
    sa[k] = alpha[base + k];
    sh[k] = hist[base + k];
  }
  __syncthreads();
  const int c = c0 + threadIdx.x;
  if (c < C) {
    float a[S];
#pragma unroll
    for (int j = 0; j < S; ++j) a[j] = sa[threadIdx.x * S + j];
    const float bs = best[b];
    if (prune) {
      float cmax = a[0];
#pragma unroll
      for (int j = 1; j < S; ++j) cmax = tmax(cmax, a[j]);
      if (la_t != nullptr) cmax = cmax + la_t[b * la_stride + ci_of[c]];
      if (!(cmax > bs + log_beam)) {
#pragma unroll
        for (int j = 0; j < S; ++j) a[j] = NEG_INF;
      }
    }
    // The entry into state 0: the re-entry at a root, else the
    // predecessor's exit with the phone penalty and the smear's delta.
    float entry = NEG_INF;
    uint8_t ep = 255;
    if (is_entry[c]) {
      entry = ent[b] + la_entry[c];
      if (corr != nullptr)
        entry = entry + corr[static_cast<size_t>(b) * R + root[c]];
      ep = 0;
    } else if (has_prev[c]) {
      const size_t bp = static_cast<size_t>(b) * C + pc[c];
      float e = ex[bp];
      if (prune && !(e > bs + log_wbeam)) e = NEG_INF;
      entry = (e + pip) + la_delta[c];
      ep = exh[bp];
    }
    if (entry > a[0]) {
      a[0] = entry;
      sh[threadIdx.x * S] = ep;
    }
#pragma unroll
    for (int j = 0; j < S; ++j) sa[threadIdx.x * S + j] = a[j];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += TPB) {
    alpha_out[base + k] = sa[k];
    hist_out[base + k] = sh[k];
  }
}

dim3 grid_of(int B, int C) { return dim3((C + TPB - 1) / TPB, B); }

}  // namespace

// Kernel A on the caller's stream; returns cudaGetLastError() after the
// launch (0 when it was taken).
extern "C" int tree_step_exits_launch(
    int S, const void* alpha0, const void* hist0, const void* rows,
    const void* xs, const void* d0, const void* d1, const void* d2,
    const void* e_last, const void* e_prev, void* alpha, void* hist, void* ex,
    void* exh, void* best, int B, int C, int n_xs, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TREE_A(NS)                                                          \
  tree_step_exits<NS><<<grid_of(B, C), TPB, 0, st>>>(                       \
      static_cast<const float*>(alpha0), static_cast<const uint8_t*>(hist0), \
      static_cast<const float*>(rows), static_cast<const int*>(xs),          \
      static_cast<const float*>(d0), static_cast<const float*>(d1),          \
      static_cast<const float*>(d2), static_cast<const float*>(e_last),      \
      static_cast<const float*>(e_prev), static_cast<float*>(alpha),         \
      static_cast<uint8_t*>(hist), static_cast<float*>(ex),                  \
      static_cast<uint8_t*>(exh), static_cast<float*>(best), C, n_xs);       \
  break;
  switch (S) {
    case 1: TREE_A(1)
    case 2: TREE_A(2)
    case 3: TREE_A(3)
    case 4: TREE_A(4)
    case 5: TREE_A(5)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TREE_A
  return static_cast<int>(cudaGetLastError());
}

// Kernel B on the caller's stream: writes the new carry into alpha_out and
// hist_out (the old carry) for the valid rows.  corr and la_t may be null.
extern "C" int tree_prune_enter_launch(
    int S, void* alpha_out, void* hist_out, const void* alpha,
    const void* hist, const void* ex, const void* exh, const void* best,
    const void* pc, const void* has_prev, const void* is_entry,
    const void* root, const void* ci_of, const void* la_delta,
    const void* la_entry, const void* ent, const void* corr, const void* la_t,
    int64_t la_stride, const void* valid, int64_t valid_stride, int B, int C,
    int R, int prune, float log_beam, float log_wbeam, float pip,
    void* stream) {
  if (B <= 0 || C <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TREE_B(NS)                                                           \
  tree_prune_enter<NS><<<grid_of(B, C), TPB, 0, st>>>(                       \
      static_cast<float*>(alpha_out), static_cast<uint8_t*>(hist_out),        \
      static_cast<const float*>(alpha), static_cast<const uint8_t*>(hist),    \
      static_cast<const float*>(ex), static_cast<const uint8_t*>(exh),        \
      static_cast<const float*>(best), static_cast<const int*>(pc),           \
      static_cast<const uint8_t*>(has_prev),                                  \
      static_cast<const uint8_t*>(is_entry), static_cast<const int*>(root),   \
      static_cast<const int*>(ci_of), static_cast<const float*>(la_delta),    \
      static_cast<const float*>(la_entry), static_cast<const float*>(ent),    \
      static_cast<const float*>(corr), static_cast<const float*>(la_t),       \
      la_stride, static_cast<const uint8_t*>(valid), valid_stride, C, R,      \
      prune, log_beam, log_wbeam, pip);                                       \
  break;
  switch (S) {
    case 1: TREE_B(1)
    case 2: TREE_B(2)
    case 3: TREE_B(3)
    case 4: TREE_B(4)
    case 5: TREE_B(5)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TREE_B
  return static_cast<int>(cudaGetLastError());
}
