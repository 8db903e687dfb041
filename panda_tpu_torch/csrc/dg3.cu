// Per-column table lookup: out[g, i, c] = tab[g, idx[g, i, c], c] on int32
// (G, R, 128) tensors.
//
// Replaces the TPU kernel dg3 of tools/profile_gather4.py (a probe of
// Mosaic's in-kernel take_along_axis: block (1, R, 128), grid (G,)).  It is
// on no path of the system; the port's gather probe
// (panda_tpu_torch/tools/profile_gather4.py) runs it.
//
// Design: one block per (g, tile of TC = 32 columns).  The block copies
// tab[g, :, c0:c0 + TC] into shared memory as R rows of TC words (R TC 4
// bytes: 128 KB at R = 1024, so the launcher raises the dynamic shared
// memory limit first), then each thread looks up out[g, i, c] =
// s[idx[g, i, c]][c - c0].  Lanes run along c, so a warp reads the table and
// idx and writes out as 128 contiguous bytes, and lane l always reads bank l
// of shared memory whatever the index: no bank conflicts.  An index outside
// [0, R) reads nothing and gives 0 (take_along_axis leaves it undefined).
//
// Bound on the H100: the bytes, 3 x 4 bytes a lookup (table, index and
// output each once), 50.3 MB for the probe's 2^22 lookups a launch: 0.0150
// ms at 3.35 TB/s (H100 SXM, 700 W).  Simple, correct first version: no
// vector loads, no asynchronous staging.

#include "field.cuh"

namespace ptt {

constexpr int kDg3Cols = 128;   // columns of a (G, R, 128) tensor
constexpr int kDg3Tile = 32;    // columns a block owns (TC)

// Element e (0 <= e < R TC) of block (g, c0)'s staging copy: row e / TC,
// column e mod TC of the tile.
PT_FN void dg3_stage(const int32_t* tab, int32_t* tile, int64_t g, int R,
                     int c0, int e) {
  const int i = e / kDg3Tile, c = e % kDg3Tile;
  tile[e] = tab[((int64_t)g * R + i) * kDg3Cols + c0 + c];
}

// Element e of block (g, c0)'s lookups: out[g, i, c0 + c] for i = e / TC,
// c = e mod TC, read from the staged tile.
PT_FN void dg3_lookup(const int32_t* tile, const int32_t* idx, int32_t* out,
                      int64_t g, int R, int c0, int e) {
  const int i = e / kDg3Tile, c = e % kDg3Tile;
  const int64_t at = ((int64_t)g * R + i) * kDg3Cols + c0 + c;
  const int k = idx[at];
  out[at] = (unsigned)k < (unsigned)R ? tile[k * kDg3Tile + c] : 0;
}

}  // namespace ptt

#if defined(__CUDACC__)

constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads)
    dg3_kernel(const int32_t* tab, const int32_t* idx, int32_t* out, int R) {
  extern __shared__ int32_t tile[];   // [i][c]: R rows of TC words
  const int64_t g = blockIdx.x;
  const int c0 = blockIdx.y * ptt::kDg3Tile;
  const int total = R * ptt::kDg3Tile;
  for (int e = threadIdx.x; e < total; e += blockDim.x)
    ptt::dg3_stage(tab, tile, g, R, c0, e);
  __syncthreads();
  for (int e = threadIdx.x; e < total; e += blockDim.x)
    ptt::dg3_lookup(tile, idx, out, g, R, c0, e);
}

extern "C" int ptt_dg3(const int32_t* tab, const int32_t* idx, int32_t* out,
                       int64_t G, int R, void* stream) {
  if (R < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)R * ptt::kDg3Tile * sizeof(int32_t);
  const cudaError_t e = cudaFuncSetAttribute(
      dg3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = R * ptt::kDg3Tile < kMaxThreads
                          ? R * ptt::kDg3Tile : kMaxThreads;
  const dim3 grid((unsigned)G, ptt::kDg3Cols / ptt::kDg3Tile);
  dg3_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(tab, idx, out, R);
  return (int)cudaGetLastError();
}

#endif
