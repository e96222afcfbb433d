// The cross-word entry readout for Hopper (sm_90a): each search word's best
// entry over a frame's E word exits, its LM score taken from each exit's
// history's real successor lists.
//
// Replaces no TPU kernel.  The reference's readout
// (cmusphinx_tpu/decode/ngram_search.py, the cores' word_transition) was
// jnp code that XLA compiled; the port ran it as PyTorch kernels over
// dense score rows (cmusphinx_tpu_torch/ops/lm_entries.py holds that
// composition as the plain version this kernel is held to, bit for bit).
//
//   lm_entries  for utterance b and search word w, over the exits e:
//                 lmw(e)  the trigram P(w | h1_e, h2_e) with backoff
//                 bonus   fil_pen[w] for a filler, else lw * lmw + wip
//                 ac(e)   the exit's score in the variant that serves w's
//                         first CI phone (slot_rc[b, e, rssid[wsel, ci]])
//                 cand    ac + bonus where the exit is live, else NEG_INF
//               writes the max over e, its tape slot t*E + e* (the lowest
//               e on ties; -1 where no exit reaches the word) and, for
//               the mpx step, the entry's payloads (tape slot, the exit
//               word's last CI phone, h2, h1) as one int4.
//
// What bounds it.  The plain version builds a dense score row of the whole
// LM vocabulary for each of the B*E histories, padding every history's
// bigram scatter to the longest successor list (<s>'s, all 64,000 words
// in a 64k LM), then a [B, E, W] candidate array: gigabytes a frame.  The
// work here is the [B, W] outputs and the word tables, read once, and the
// successor entries that fall in each block's words: tens of MB.
//
// Why successor lists in search-word space.  Search words do not come in
// LM-id order (ids by frequency, words by dictionary), and several search
// words may share one LM id (alternate pronunciations; fillers clamped
// from -1 to 0).  So the lists are built once, at the readout's set-up,
// mapped through the inverse of the search words' LM ids and sorted by
// search word: one list a LM word (its bigram successors) and one a bigram
// row (its trigram successors).  A block of words then finds the part of
// a history's list that falls in its words by two bisections.
//
// The design.  A block of 256 threads takes 1,024 search words of one
// utterance (grid: word blocks x utterances), a thread four words at a
// stride of 256 (coalesced, and free of shared-memory bank conflicts).  The
// block reads the histories of EH exits at once, each bisection chain in
// a thread of its own: for exit i, thread i finds the part of h2's bigram
// list that falls in the block's words from below, thread 32+i from above,
// and thread 64+i the (h1, h2) bigram row in the LM's list of h1 (the
// trigram context and its backoff weight) and the part of its trigram list
// in the words; with right-context variants, the exits' scores a first CI
// phone go to shared memory.  Then EC exits at a time: every thread writes
// its words' backed-off scores into shared memory, the block overwrites
// the bigram successors' scores and then, after a barrier, the trigram
// successors' (the scatters' order in the plain version), and each thread
// folds its words' candidates into a running max and first argmax, in
// the order of the exits.  The lists hold no duplicate word, so no two
// threads write one slot.  Every product and sum is __fmul_rn / __fadd_rn
// in the plain version's order: nvcc may not contract lw * lmw + wip into
// an FMA.  Nothing is allocated here: the wrapper hands in every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPB = 256;           // threads a block
constexpr int WPT = 4;             // search words a thread
constexpr int TILE = TPB * WPT;    // search words a block
constexpr int EH = 32;             // exits whose histories are read at once
constexpr int EC = 8;              // exits whose scores are staged at once
constexpr float NEG_INF = -1.0e30f;

// The LM: its unigram tables and bigram lists by LM id (for the trigram
// context's row and backoff weight), and the successor lists in
// search-word space.
struct Lm {
  const float* ug_prob;   // [V]
  const float* ug_bo;     // [V]
  const int64_t* bg_ptr;  // [V+1]
  const int64_t* bg_wid;  // [NB], sorted within each row
  const float* bg_bo;     // [NB]
  const int* sbg_ptr;     // [V+1]: LM word -> its bigram successors
  const int* sbg_w;       //   their search words, sorted within each row
  const float* sbg_p;     //   their bigram scores
  const int* stg_ptr;     // [NB+1]: bigram row -> its trigram successors
  const int* stg_w;
  const float* stg_p;
  int trigram;            // the LM adds bo(h1, h2) and has trigram lists
};

// The search words' tables, [W] but rssid [W, n_ci].
struct Words {
  const int64_t* lid;     // LM id, -1 clamped to 0
  const uint8_t* is_filler;
  const float* fil_pen;
  const int64_t* firstci;
  const int64_t* rssid;
  int W, n_ci;
  float lw, wip;
};

// The frame's exits, [B, E] (slot_rc [B, E, Vr]); t the frame (0-d).
struct Exits {
  const int64_t* t;
  const uint8_t* ok;
  const int64_t* wsel;
  const int64_t* h1;
  const int64_t* h2;
  const float* slot_rc;
  const int64_t* lastci;  // [W]; null without the payloads
  int E, Vr;
};

struct Out {
  float* ent_w;           // [B, W]
  int64_t* ebp;           // [B, W], or null
  int4* ent_pay;          // [B, W] of (tape slot, lastci, h2, h1), or null
};

// First index in [lo, hi) whose value is >= key.
__device__ __forceinline__ int lower_bound(const int* a, int lo, int hi,
                                           int key) {
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (a[m] < key) lo = m + 1; else hi = m;
  }
  return lo;
}

// The row of `key` in [lo, hi) of the sorted a, -1 if absent.
__device__ __forceinline__ int64_t find_row(const int64_t* a, int64_t lo,
                                            int64_t hi, int64_t key) {
  int64_t l = lo, h = hi;
  while (l < h) {
    const int64_t m = l + ((h - l) >> 1);
    if (a[m] < key) l = m + 1; else h = m;
  }
  return (l < hi && a[l] == key) ? l : -1;
}

__global__ void __launch_bounds__(TPB) lm_entries(Lm lm, Words wd, Exits ex,
                                                  Out out) {
  extern __shared__ float ac_tab[];          // [EH, n_ci] when Vr > 1
  __shared__ float val[EC][TILE];            // lmw of (staged exit, word)
  __shared__ float s_bo2[EH], s_bo12[EH], s_ac[EH];
  __shared__ int s_blo[EH], s_bhi[EH], s_tlo[EH], s_thi[EH];
  __shared__ uint8_t s_ok[EH], s_has2[EH];

  const int b = blockIdx.y;
  const int w0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  const int E = ex.E;
  const int lane = tid & 31, warp = tid >> 5;

  float ug[WPT], fpen[WPT], best[WPT];
  int fci[WPT], estar[WPT];
  bool fil[WPT];
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int w = w0 + tid + k * TPB;
    const bool live = w < wd.W;
    ug[k] = live ? lm.ug_prob[wd.lid[w]] : 0.f;
    fil[k] = live && wd.is_filler[w] != 0;
    fpen[k] = live ? wd.fil_pen[w] : 0.f;
    fci[k] = live ? static_cast<int>(wd.firstci[w]) : 0;
    best[k] = NEG_INF;
    estar[k] = 0;
  }
  for (int h0 = 0; h0 < E; h0 += EH) {
    const int nh = min(EH, E - h0);
    // ---- the histories: three bisection chains an exit ----
    const int role = warp, i = lane;
    if (role < 3 && i < nh) {
      const size_t be = static_cast<size_t>(b) * E + h0 + i;
      const bool ok = ex.ok[be] != 0;
      const int64_t h2 = ex.h2[be];
      const bool live2 = ok && h2 >= 0;
      if (role == 0) {
        s_ok[i] = ok;
        s_has2[i] = h2 >= 0;
        s_bo2[i] = h2 >= 0 ? lm.ug_bo[h2] : 0.f;
        if (ex.Vr == 1) s_ac[i] = ex.slot_rc[be];
        s_blo[i] = live2 ? lower_bound(lm.sbg_w, lm.sbg_ptr[h2],
                                       lm.sbg_ptr[h2 + 1], w0) : 0;
      } else if (role == 1) {
        s_bhi[i] = live2 ? lower_bound(lm.sbg_w, lm.sbg_ptr[h2],
                                       lm.sbg_ptr[h2 + 1], w0 + TILE) : 0;
      } else {
        const int64_t h1 = ex.h1[be];
        float bo12 = 0.f;
        int tlo = 0, thi = 0;
        if (live2 && lm.trigram && h1 >= 0) {
          const int64_t r = find_row(lm.bg_wid, lm.bg_ptr[h1],
                                     lm.bg_ptr[h1 + 1], h2);
          if (r >= 0) {
            bo12 = lm.bg_bo[r];
            const int tl = lm.stg_ptr[r], th = lm.stg_ptr[r + 1];
            tlo = lower_bound(lm.stg_w, tl, th, w0);
            thi = lower_bound(lm.stg_w, tlo, th, w0 + TILE);
          }
        }
        s_bo12[i] = bo12;
        s_tlo[i] = tlo;
        s_thi[i] = thi;
      }
    }
    if (ex.Vr > 1) {
      for (int k = tid; k < nh * wd.n_ci; k += TPB) {
        const int j = k / wd.n_ci, ci = k - j * wd.n_ci;
        const size_t be = static_cast<size_t>(b) * E + h0 + j;
        const int64_t v = wd.rssid[ex.wsel[be] * wd.n_ci + ci];
        ac_tab[k] = ex.slot_rc[be * ex.Vr + v];
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < nh; c0 += EC) {
      const int n = min(EC, nh - c0);
      // ---- the backed-off base: ug_bo(h2) + ug(w), then + bo(h1, h2) ----
      for (int j = 0; j < n; ++j) {
        const int e = c0 + j;
        if (!s_ok[e]) continue;
#pragma unroll
        for (int k = 0; k < WPT; ++k) {
          float v = s_has2[e] ? __fadd_rn(s_bo2[e], ug[k]) : ug[k];
          if (lm.trigram) v = __fadd_rn(v, s_bo12[e]);
          val[j][tid + k * TPB] = v;
        }
      }
      __syncthreads();
      // ---- h2's bigram successors (bo(h1, h2) added after): a warp an exit
      for (int j = warp; j < n; j += TPB / 32) {
        const int e = c0 + j;
        for (int q = s_blo[e] + lane; q < s_bhi[e]; q += 32) {
          const float p = lm.sbg_p[q];
          val[j][lm.sbg_w[q] - w0] = lm.trigram ? __fadd_rn(p, s_bo12[e]) : p;
        }
      }
      __syncthreads();
      // ---- the (h1, h2) trigram successors, which win ----
      for (int j = warp; j < n; j += TPB / 32) {
        const int e = c0 + j;
        for (int q = s_tlo[e] + lane; q < s_thi[e]; q += 32)
          val[j][lm.stg_w[q] - w0] = lm.stg_p[q];
      }
      __syncthreads();
      // ---- each word's candidates folded: the max, the first e on ties --
      for (int j = 0; j < n; ++j) {
        const int e = c0 + j;
        const bool ok = s_ok[e] != 0;
#pragma unroll
        for (int k = 0; k < WPT; ++k) {
          float cand = NEG_INF;
          if (ok) {
            const float bonus =
                fil[k] ? fpen[k]
                       : __fadd_rn(__fmul_rn(wd.lw, val[j][tid + k * TPB]),
                                   wd.wip);
            const float ac =
                ex.Vr == 1 ? s_ac[e] : ac_tab[e * wd.n_ci + fci[k]];
            cand = __fadd_rn(ac, bonus);
          }
          if (h0 + e == 0 || cand > best[k]) {
            best[k] = cand;
            estar[k] = h0 + e;
          }
        }
      }
      __syncthreads();
    }
  }
  const int64_t t = *ex.t;
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int w = w0 + tid + k * TPB;
    if (w >= wd.W) break;
    const size_t bw = static_cast<size_t>(b) * wd.W + w;
    const int64_t ebp = best[k] > NEG_INF * 0.5f ? t * E + estar[k] : -1;
    out.ent_w[bw] = best[k];
    if (out.ent_pay != nullptr) {
      const size_t be = static_cast<size_t>(b) * E + estar[k];
      out.ent_pay[bw] = make_int4(static_cast<int>(ebp),
                                  static_cast<int>(ex.lastci[ex.wsel[be]]),
                                  static_cast<int>(ex.h2[be]),
                                  static_cast<int>(ex.h1[be]));
    } else {
      out.ebp[bw] = ebp;
    }
  }
}

}  // namespace

// The kernel on the caller's stream; returns cudaGetLastError() after the
// launch (0 when it was taken).  lastci, ebp and ent_pay may be null: the
// payloads (lastci, ent_pay) or the tape slots (ebp) are written.
extern "C" int lm_entries_launch(
    const void* ug_prob, const void* ug_bo, const void* bg_ptr,
    const void* bg_wid, const void* bg_bo, const void* sbg_ptr,
    const void* sbg_w, const void* sbg_p, const void* stg_ptr,
    const void* stg_w, const void* stg_p, int trigram, const void* lid,
    const void* is_filler, const void* fil_pen, const void* firstci,
    const void* rssid, int W, int n_ci, float lw, float wip, const void* t,
    const void* ok, const void* wsel, const void* h1, const void* h2,
    const void* slot_rc, const void* lastci, int B, int E, int Vr,
    void* ent_w, void* ebp, void* ent_pay, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  const Lm lm{static_cast<const float*>(ug_prob),
              static_cast<const float*>(ug_bo),
              static_cast<const int64_t*>(bg_ptr),
              static_cast<const int64_t*>(bg_wid),
              static_cast<const float*>(bg_bo),
              static_cast<const int*>(sbg_ptr),
              static_cast<const int*>(sbg_w),
              static_cast<const float*>(sbg_p),
              static_cast<const int*>(stg_ptr),
              static_cast<const int*>(stg_w),
              static_cast<const float*>(stg_p), trigram};
  const Words wd{static_cast<const int64_t*>(lid),
                 static_cast<const uint8_t*>(is_filler),
                 static_cast<const float*>(fil_pen),
                 static_cast<const int64_t*>(firstci),
                 static_cast<const int64_t*>(rssid), W, n_ci, lw, wip};
  const Exits ex{static_cast<const int64_t*>(t),
                 static_cast<const uint8_t*>(ok),
                 static_cast<const int64_t*>(wsel),
                 static_cast<const int64_t*>(h1),
                 static_cast<const int64_t*>(h2),
                 static_cast<const float*>(slot_rc),
                 static_cast<const int64_t*>(lastci), E, Vr};
  const Out out{static_cast<float*>(ent_w), static_cast<int64_t*>(ebp),
                static_cast<int4*>(ent_pay)};
  const dim3 grid((W + TILE - 1) / TILE, B);
  const size_t smem = Vr > 1 ? sizeof(float) * EH * n_ci : 0;
  lm_entries<<<grid, TPB, smem, static_cast<cudaStream_t>(stream)>>>(
      lm, wd, ex, out);
  return static_cast<int>(cudaGetLastError());
}
