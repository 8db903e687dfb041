// The MSM's bucket assembly: the dense (L, W, D) bucket tables from phase
// A's emissions and lane tails, in two launches.
//
// Replaces, on the main path, the use the port made of the TPU kernel
// panda_tpu/ops/point_pallas.py::_run (padd) in the bucket assembly of
// panda_tpu/ops/msm.py (segmented_prefix_scan over the lanes' tails,
// _locate_runs on the tail keys, one complete add over every bucket): in
// the port a Hillis-Steele scan of ceil(log2 m) padd launches, one padd over
// (L, W, D) and ~150 small torch launches of gathers and selects.  The
// launchers take a curve id, the curve's index in _ext.MSM_CURVES.
//
// What it computes.  Bucket b of window w is B_b = (the run of b that phase
// A emitted inside a lane, where there is one: the emission at the sorted
// position hi_b = #(digit <= b), valid where its key is b and hi_b does not
// start a lane) + (the total of the lanes' tails whose key is b); a bucket
// with neither is the identity.  The tail keys are nondecreasing along the
// m lanes, so each bucket's tails are one contiguous run of lanes, and only
// that run's total is ever read.
//
// Launch 1, the buckets with tails (buckets_tails_kernel): a segmented
// reduction, not a prefix scan.  Block g of window w takes the lanes from
// the first run that starts at or after lane g B (B = T * chunk) to the
// first that starts at or after (g + 1) B, found by a binary search of the
// sorted keys, so every run lies in one block; thread r takes `chunk'`
// consecutive lanes of them (chunk' = ceil(lanes / T), `chunk` unless a run
// is longer than a block) and sums their equal-key runs in registers.  The
// run open at the chunk's end (its carry) is combined across the block's
// threads by a segmented Hillis-Steele scan over the T carries in shared
// memory (log2 T rounds).  The thread that holds a run's last lane then
// has the run's total and stores it; last, each thread adds to the
// buckets it stored their interior emissions, where there are any (a pass
// of its own, so that the chunk's loop holds fewer registers).  About
// m + (m / chunk) log2 T adds, against
// the ~m log2 m of the scan it replaces; the run ends of the tails come
// from the key changes, so no second histogram runs.  Lanes whose key is 0
// or the dead key (lanes that end in padding) are skipped.
//
// Launch 2, the others (buckets_fill_kernel): one thread a bucket; a
// bucket whose tails launch 1 stored (lane q = hi_b / S - 1 ends with key
// b) is left alone, any other gets its interior emission or the identity.
// No add, so the copy runs at full occupancy.
//
// Layouts (uint32 words; L = 8 for BN254, 12 for the BLS curves), with S
// steps of m lanes, P = S m:
//   ekeys          (W, S, m)  emitted run keys, step-major (phase A)
//   ex, ey, ez     (L, W*P)   emitted run sums, defined where ekeys is a key
//   tkeys          (W, m)     lane tail keys
//   tx, ty, tz     (L, W*m)   lane tail sums
//   hi             (W, D)     int64 run ends hi_b
//   out            (L, W*D)   the bucket tables
//
// Bound on the H100: bytes, ~106 MB at 2^20 for BN254 (the tables
// written, hi_b, the emissions read at the run ends); the adds (one a live
// tail lane, one a bucket with both parts) are a few percent of the
// multiply rate.  The tails' adds depend on each other along a chunk and a
// scan round, so launch 1 is latency-bound: ops/msm.py's plan gives each
// thread as few lanes as one wave of the card allows, for a depth of about
// chunk + log2 T adds where runs cross chunks.  The per-thread bodies are plain functions, so the host runs a
// block phase by phase (tests/test_torch_csrc.py).

#include "field.cuh"

#if !defined(__CUDACC__)
#include <vector>
#endif

namespace ptt {

// A key no tail carries: "no lane" before a block's first.
constexpr uint32_t kBkNone = 0xFFFFFFFFu;

PT_HD bool bk_live(uint32_t key, int D) {
  return key >= 1u && key <= (uint32_t)D;
}

// Where both launches read and write the bucket tables.
struct bk_tables {
  cpts e;                 // emissions (L, W*P)
  const uint32_t* ekeys;  // (W, S, m)
  const int64_t* hi;      // (W, D)
  mpts out;               // (L, W*D)
  int64_t W, S, m;
  int D;
};

// The emission of bucket b of window w at its run end, where it holds b.
template <int N>
PT_FN bool bk_interior(const bk_tables& tb, int64_t w, uint32_t b,
                       xyz_t<N>& v) {
  const int64_t P = tb.S * tb.m;
  const int64_t h = tb.hi[w * tb.D + (b - 1u)];
  const int64_t slot = h < P ? h : P - 1;
  const int64_t pos = w * P + (slot % tb.S) * tb.m + slot / tb.S;
  if (h % tb.S == 0 || tb.ekeys[pos] != b) return false;
  v = load_pt<N>(tb.e.x, tb.e.y, tb.e.z, pos, tb.W * P);
  return true;
}

// Bucket b's slot in the tables.
template <int N>
PT_FN void bk_store(const bk_tables& tb, int64_t w, uint32_t b,
                    const xyz_t<N>& v) {
  store_pt(tb.out.x, tb.out.y, tb.out.z, w * tb.D + (b - 1u), tb.W * tb.D,
           v);
}

template <int N>
PT_FN xyz_t<N> bk_load(const bk_tables& tb, int64_t w, uint32_t b) {
  return load_pt<N>(tb.out.x, tb.out.y, tb.out.z, w * tb.D + (b - 1u),
                    tb.W * tb.D);
}

// The first lane at or after `from` whose run starts there: `from` itself
// unless lane from - 1 holds the same key, else the first lane with a
// larger key (the keys are sorted); m past the end.
PT_HD int64_t bk_run_start(const uint32_t* keys, int64_t m, int64_t from) {
  if (from <= 0) return 0;
  if (from >= m) return m;
  const uint32_t k = keys[from - 1];
  int64_t lo = from, hi = m;          // first lane in [from, m) with key > k
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (keys[mid] > k) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// Thread state of launch 1: its lanes [lo, hi) of the block's [.., end),
// the key of lane lo - 1 within the block (kBkNone for the block's first),
// the run open at hi - 1 (key, sum S, flag: it started in this chunk, so
// the scan takes nothing from the threads before), the key of lane lo,
// and whether the chunk's first run ends inside it after beginning before
// it (head).
template <int N>
struct bk_thread {
  xyz_t<N> S;
  int64_t lo, hi, end;
  uint32_t key, prev_key, head_key;
  bool flag, head;
};

// Launch 1, phase 1: the block's lanes [b0, b1) (every run in one block),
// thread r's chunk of them in registers; the total of a run that ends in
// the chunk goes to its bucket's slot (for the chunk's first run, where it
// began before the chunk, without the sum before it: phase 3 adds that).
template <class C>
PT_FN void bk_tails_chunk(cpts t, const uint32_t* tkeys,
                          const bk_tables& tb, int64_t w, int64_t g, int r,
                          int chunk, int T, bk_thread<C::Fp::N>& st) {
  constexpr int N = C::Fp::N;
  const int64_t m = tb.m, n = tb.W * m, row = w * m;
  const uint32_t* keys = tkeys + row;
  const int64_t nominal = g * T * chunk;
  const int64_t b0 = bk_run_start(keys, m, nominal);
  st.end = bk_run_start(keys, m, nominal + (int64_t)T * chunk);
  const int64_t c = (st.end - b0 + T - 1) / T;       // chunk' >= chunk
  st.lo = b0 + r * c < st.end ? b0 + r * c : st.end;
  st.hi = st.lo + c < st.end ? st.lo + c : st.end;
  st.head = false;
  st.S = pt_identity<C>();
  if (st.lo >= st.hi) {                 // past the block's last lane
    st.key = st.prev_key = kBkNone;
    st.flag = true;
    return;
  }
  st.prev_key = st.lo > b0 ? keys[st.lo - 1] : kBkNone;
  st.head_key = keys[st.lo];
  uint32_t key = st.head_key;
  bool first = true;
  xyz_t<N> acc = load_pt<N>(t.x, t.y, t.z, row + st.lo, n);
  for (int64_t q = st.lo + 1; q < st.hi; ++q) {
    const uint32_t k = keys[q];
    if (k == key) {
      if (bk_live(k, tb.D))
        acc = pt_add<C>(acc, load_pt<N>(t.x, t.y, t.z, row + q, n));
      continue;
    }
    if (bk_live(key, tb.D)) {
      if (first) st.head = st.prev_key == key;   // began before the chunk
      bk_store<N>(tb, w, key, acc);
    }
    first = false;
    key = k;
    acc = load_pt<N>(t.x, t.y, t.z, row + q, n);
  }
  st.S = acc;
  st.key = key;
  st.flag = !first || st.prev_key != key;
}

// Launch 1, phase 2: the segmented scan over the block's carries, T points
// word-major in shared memory (stride T) and T flags after them.
template <int N>
PT_FN void bk_scan_store(uint32_t* sh, int r, int T,
                         const bk_thread<N>& st) {
  const int64_t s = (int64_t)N * T;
  store_pt(sh, sh + s, sh + 2 * s, r, T, st.S);
  sh[3 * s + r] = st.flag;
}

template <int N>
PT_FN void bk_scan_load(const uint32_t* sh, int j, int T, xyz_t<N>& v,
                        bool& flag) {
  const int64_t s = (int64_t)N * T;
  v = load_pt<N>(sh, sh + s, sh + 2 * s, j, T);
  flag = sh[3 * s + j] != 0;
}

// Round k for thread r >= k, given thread r - k's (S, flag) before the
// round: a carry whose run began before its chunk takes the sum before it.
template <class C>
PT_FN void bk_scan_apply(bk_thread<C::Fp::N>& st,
                         const xyz_t<C::Fp::N>& v, bool flag, int D) {
  if (st.flag) return;
  if (bk_live(st.key, D)) st.S = pt_add<C>(v, st.S);
  st.flag = flag;
}

PT_HD constexpr int64_t bk_smem_words(int T, int n_words) {
  return (int64_t)(3 * n_words + 1) * T;
}

// Launch 1, phase 3, with the scan's results in shared memory: the chunk's
// first run, where it began before the chunk, adds thread r - 1's carry to
// its slot; the run open at the chunk's end goes to its slot where it ends
// there (always at the block's end).  Then every run this thread ended
// (each ends in one chunk) has its total in its slot.
template <class C>
PT_FN void bk_tails_finish(const uint32_t* sh, const uint32_t* tkeys,
                           const bk_tables& tb, int64_t w, int r, int T,
                           const bk_thread<C::Fp::N>& st) {
  constexpr int N = C::Fp::N;
  if (st.lo >= st.hi) return;
  if (st.head) {
    xyz_t<N> before;
    bool f;
    bk_scan_load<N>(sh, r - 1, T, before, f);
    bk_store<N>(tb, w, st.head_key,
                pt_add<C>(before, bk_load<N>(tb, w, st.head_key)));
  }
  if (bk_live(st.key, tb.D) &&
      (st.hi == st.end || tkeys[w * tb.m + st.hi] != st.key))
    bk_store<N>(tb, w, st.key, st.S);
}

// Launch 1, phase 4: each bucket whose tails this thread ended takes its
// interior emission, where there is one: one add.
template <class C>
PT_FN void bk_tails_interior(const uint32_t* tkeys, const bk_tables& tb,
                             int64_t w, const bk_thread<C::Fp::N>& st) {
  constexpr int N = C::Fp::N;
  const uint32_t* keys = tkeys + w * tb.m;
  for (int64_t q = st.lo; q < st.hi; ++q) {
    const uint32_t b = keys[q];
    if (!bk_live(b, tb.D) || (q + 1 < st.end && keys[q + 1] == b)) continue;
    xyz_t<N> ip;
    if (bk_interior<N>(tb, w, b, ip))
      bk_store<N>(tb, w, b, pt_add<C>(ip, bk_load<N>(tb, w, b)));
  }
}

// Launch 2: bucket i = w D + (b - 1) unless it has tails (launch 1 stores
// those): its interior emission, or the identity.
template <class C>
PT_FN void bk_fill_elem(const bk_tables& tb, const uint32_t* tkeys,
                        int64_t i) {
  constexpr int N = C::Fp::N;
  const int64_t w = i / tb.D;
  const uint32_t b = (uint32_t)(i % tb.D) + 1u;
  const int64_t q = tb.hi[i] / tb.S - 1;   // the last lane ending before hi_b
  if (q >= 0 && tkeys[w * tb.m + q] == b) return;
  xyz_t<N> v;
  if (!bk_interior<N>(tb, w, b, v)) v = pt_identity<C>();
  store_pt(tb.out.x, tb.out.y, tb.out.z, i, tb.W * tb.D, v);
}

#if !defined(__CUDACC__)
// Launch 1's blocks one after another on the host, phase by phase: each
// phase (and each scan round's reads, then its writes) runs for every
// thread of the block before the next one starts (a __syncthreads on the
// card).
template <class C>
void bk_tails_host(cpts t, const uint32_t* tkeys, const bk_tables& tb,
                   int chunk, int T, int64_t G) {
  constexpr int N = C::Fp::N;
  std::vector<uint32_t> sh(bk_smem_words(T, N));
  std::vector<bk_thread<N>> st(T);
  std::vector<xyz_t<N>> v(T);
  std::vector<char> f(T);
  for (int64_t blk = 0; blk < tb.W * G; ++blk) {
    const int64_t w = blk / G, g = blk % G;
    for (int r = 0; r < T; ++r) {
      bk_tails_chunk<C>(t, tkeys, tb, w, g, r, chunk, T, st[r]);
      bk_scan_store<N>(sh.data(), r, T, st[r]);
    }
    for (int k = 1; k < T; k <<= 1) {
      for (int r = k; r < T; ++r) {
        bool fl;
        bk_scan_load<N>(sh.data(), r - k, T, v[r], fl);
        f[r] = fl;
      }
      for (int r = k; r < T; ++r) {
        bk_scan_apply<C>(st[r], v[r], f[r] != 0, tb.D);
        bk_scan_store<N>(sh.data(), r, T, st[r]);
      }
    }
    for (int r = 0; r < T; ++r)
      bk_tails_finish<C>(sh.data(), tkeys, tb, w, r, T, st[r]);
    for (int r = 0; r < T; ++r) bk_tails_interior<C>(tkeys, tb, w, st[r]);
  }
}
#endif

}  // namespace ptt

#if defined(__CUDACC__)

constexpr int kThreads = 128;      // launch 1: the most threads a block
constexpr int kFillThreads = 256;  // launch 2

// Blocks of kThreads an SM that launch 1 is built for (8-word and 12-word
// coordinates): 2, at most 255 registers a thread (BN254 takes ~200, the
// BLS curves 255 with ~60 bytes of spills).  A build for 4 and 3 (128 and
// 168 registers) spills 400 and 900 bytes a thread.  On near-uniform
// digits, which full-range scalars give, the two are within 8% (BN254: 4
// ahead at 2^20, 2 at 2^16); on digits of repeated scalars, whose runs are
// long, 2 is up to 1.4x faster, so 2 is the default
// (tools/occupancy_sweep.py builds and times both on both inputs).
#ifndef PTT_BUCKETS_BLOCKS_8
#define PTT_BUCKETS_BLOCKS_8 2
#endif
#ifndef PTT_BUCKETS_BLOCKS_12
#define PTT_BUCKETS_BLOCKS_12 2
#endif
template <class C>
constexpr int kTailsBlocks =
    C::Fp::N == 8 ? PTT_BUCKETS_BLOCKS_8 : PTT_BUCKETS_BLOCKS_12;

template <class C>
__global__ void __launch_bounds__(kThreads, kTailsBlocks<C>)
    buckets_tails_kernel(ptt::cpts t, const uint32_t* tkeys,
                         ptt::bk_tables tb, int chunk, int64_t G) {
  constexpr int N = C::Fp::N;
  extern __shared__ uint32_t sh[];
  const int T = blockDim.x, r = threadIdx.x;
  const int64_t w = blockIdx.x / G, g = blockIdx.x % G;
  ptt::bk_thread<N> st;
  ptt::bk_tails_chunk<C>(t, tkeys, tb, w, g, r, chunk, T, st);
  ptt::bk_scan_store<N>(sh, r, T, st);
  __syncthreads();
  for (int k = 1; k < T; k <<= 1) {
    ptt::xyz_t<N> v;
    bool f = true;
    if (r >= k) ptt::bk_scan_load<N>(sh, r - k, T, v, f);
    __syncthreads();
    if (r >= k) {
      ptt::bk_scan_apply<C>(st, v, f, tb.D);
      ptt::bk_scan_store<N>(sh, r, T, st);
    }
    __syncthreads();
  }
  ptt::bk_tails_finish<C>(sh, tkeys, tb, w, r, T, st);
  ptt::bk_tails_interior<C>(tkeys, tb, w, st);
}

template <class C>
__global__ void __launch_bounds__(kFillThreads)
    buckets_fill_kernel(ptt::bk_tables tb, const uint32_t* tkeys) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < tb.W * tb.D) ptt::bk_fill_elem<C>(tb, tkeys, i);
}

template <class C>
constexpr size_t kTailsSmem =
    (size_t)ptt::bk_smem_words(kThreads, C::Fp::N) * sizeof(uint32_t);

template <class C>
int tails_launch(ptt::cpts t, const uint32_t* tkeys,
                 const ptt::bk_tables& tb, int chunk, int T, int64_t G,
                 cudaStream_t stream) {
  if (T < 1 || T > kThreads || chunk < 1 || G * T * chunk < tb.m)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)ptt::bk_smem_words(T, C::Fp::N) * sizeof(uint32_t);
  buckets_tails_kernel<C><<<(unsigned)(tb.W * G), T, smem, stream>>>(
      t, tkeys, tb, chunk, G);
  return (int)cudaGetLastError();
}

template <class C>
int fill_launch(const ptt::bk_tables& tb, const uint32_t* tkeys,
                cudaStream_t stream) {
  buckets_fill_kernel<C>
      <<<PTT_LAUNCH_DIMS(tb.W * tb.D, kFillThreads), 0, stream>>>(tb, tkeys);
  return (int)cudaGetLastError();
}

// Launch 1 (fill = 0: G blocks of T threads a window, `chunk` lanes a
// thread) or launch 2 (fill = 1: a thread a bucket).
extern "C" int ptt_buckets(const uint32_t* ex, const uint32_t* ey,
                           const uint32_t* ez, const uint32_t* ekeys,
                           const uint32_t* tx, const uint32_t* ty,
                           const uint32_t* tz, const uint32_t* tkeys,
                           const int64_t* hi, uint32_t* ox, uint32_t* oy,
                           uint32_t* oz, int64_t W, int64_t S, int64_t m,
                           int64_t G, int D, int chunk, int T, int fill,
                           int curve, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const ptt::cpts t{tx, ty, tz};
  const ptt::bk_tables tb{{ex, ey, ez}, ekeys, hi, {ox, oy, oz}, W, S, m, D};
  if (fill) {
    switch (curve) {
      case 0: return fill_launch<ptt::Bn254>(tb, tkeys, st);
      case 1: return fill_launch<ptt::Bls12_377>(tb, tkeys, st);
      case 2: return fill_launch<ptt::Bls12_381>(tb, tkeys, st);
    }
  } else {
    switch (curve) {
      case 0: return tails_launch<ptt::Bn254>(t, tkeys, tb, chunk, T, G, st);
      case 1: return tails_launch<ptt::Bls12_377>(t, tkeys, tb, chunk, T, G,
                                                  st);
      case 2: return tails_launch<ptt::Bls12_381>(t, tkeys, tb, chunk, T, G,
                                                  st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// Threads of one full wave of the curve's launch 1, in blocks of kThreads,
// on the current device.
extern "C" int ptt_buckets_threads(int curve, int* threads) {
  switch (curve) {
    case 0: return ptt_resident(buckets_tails_kernel<ptt::Bn254>, kThreads,
                                kTailsSmem<ptt::Bn254>, threads);
    case 1: return ptt_resident(buckets_tails_kernel<ptt::Bls12_377>,
                                kThreads, kTailsSmem<ptt::Bls12_377>,
                                threads);
    case 2: return ptt_resident(buckets_tails_kernel<ptt::Bls12_381>,
                                kThreads, kTailsSmem<ptt::Bls12_381>,
                                threads);
  }
  return (int)cudaErrorInvalidValue;
}

#endif
