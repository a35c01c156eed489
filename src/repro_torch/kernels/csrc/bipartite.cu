// One bipartite GraphSAGE round (sum aggregation) for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/bipartite/kernel.py::_round_kernel
// (launched by bipartite_round_pallas). For each scenario b of a batch:
//
//     agg_f[i] = sum over edges e with edge_f[e] == i of mask[e] * l[edge_l[e]]
//     agg_l[s] = sum over edges e with edge_l[e] == s of mask[e] * f[edge_f[e]]
//     f' = relu([f ; agg_f] @ Wf + bf),   l' = relu([l ; agg_l] @ Wl + bl)
//
// The TPU kernel built a dense 0/1 incidence matrix M to run the
// aggregation on its matrix unit. Here the edge list is used as it is,
// with no dense M and no atomics: a block owns TR rows of f or of l (rows
// of f and rows of l are disjoint block ranges of one launch) and stages
// its scenario's edges in shared memory; one warp per row scans them in
// ascending order with a ballot and adds each matching neighbour row, so
// the sum order is fixed from run to run. An edge of mask 0 adds exact
// zeros and is skipped: m4 points every masked edge at link slot 0, and
// summing them would serialise hundreds of zero rows onto one warp.
// Out-of-range neighbour ids are clamped and out-of-range row ids match
// no row, as JAX's gather and segment_sum treat them.
//
// What bounds it: at full width (SF = 64, SL = 128, G = 300, E = 512) a
// round is ~0.07 GFLOP over 1.4 MB of weights; the fp32 FMA rate bounds
// it. Then each block computes [self ; agg] @ W for its TJ output columns
// from the two TR x G row tiles in shared memory, walking the 2G rows of W
// in chunks of KC that are staged in shared memory, the next chunk loaded
// into registers while the current one is used; plus bias and ReLU.
#include <cuda_runtime.h>

namespace {

constexpr int TJ = 32;          // output columns per block: one per lane
constexpr int RG = 8;           // warps per block
constexpr int RPT = 2;          // rows per thread
constexpr int TR = RG * RPT;    // rows per block
constexpr int KC = 32;          // rows of W per staged chunk
constexpr int NT = TJ * RG;     // threads per block
constexpr int W_PER = KC * TJ / NT;   // staged weights per thread
constexpr int NCH = 16;         // 32-column groups a lane sums per pass

struct Round {
  const float* f;            // (B, SF, G)
  const float* l;            // (B, SL, G)
  const long long* edge_f;   // (E), shared by the batch
  const long long* edge_l;   // (B, E)
  const float* edge_mask;    // (B, E)
  const float* wf;           // (2G, G)
  const float* wl;           // (2G, G)
  const float* bf;           // (G)
  const float* bl;           // (G)
  float* fo;                 // (B, SF, G)
  float* lo;                 // (B, SL, G)
  int SF, SL, G, E;
};

size_t smem_bytes(int G, int E) {
  return (2 * (size_t)TR * G + KC * TJ) * sizeof(float)
         + (size_t)E * (2 * sizeof(int) + sizeof(float));
}

__device__ __forceinline__ void load_w(const float* W, int G, int chunk,
                                       int j0, float (&r)[W_PER]) {
  const int tid = threadIdx.y * TJ + threadIdx.x;
  const int half = (G + KC - 1) / KC;          // chunks per half of W
  const int k0 = (chunk < half ? chunk : chunk - half) * KC;
  const int base = chunk < half ? 0 : G;
#pragma unroll
  for (int q = 0; q < W_PER; ++q) {
    const int idx = tid + q * NT, k = idx / TJ, j = j0 + idx % TJ;
    r[q] = (k0 + k < G && j < G)
               ? __ldg(W + (size_t)(base + k0 + k) * G + j) : 0.0f;
  }
}

__device__ __forceinline__ void store_w(const float (&r)[W_PER],
                                        float* w_s) {
  const int tid = threadIdx.y * TJ + threadIdx.x;
#pragma unroll
  for (int q = 0; q < W_PER; ++q) w_s[tid + q * NT] = r[q];
}

__global__ void __launch_bounds__(NT)
bipartite_round_kernel(Round p) {
  extern __shared__ float smem[];
  const int G = p.G, E = p.E;
  const int b = blockIdx.z;
  const int ftiles = (p.SF + TR - 1) / TR;
  const bool is_flow = blockIdx.y < ftiles;
  const int row0 = (is_flow ? blockIdx.y : blockIdx.y - ftiles) * TR;
  const int nrows = is_flow ? p.SF : p.SL;
  const int nother = is_flow ? p.SL : p.SF;
  const float* self = is_flow ? p.f + (size_t)b * p.SF * G
                              : p.l + (size_t)b * p.SL * G;
  const float* other = is_flow ? p.l + (size_t)b * p.SL * G
                               : p.f + (size_t)b * p.SF * G;
  const long long* ef = p.edge_f;
  const long long* el = p.edge_l + (size_t)b * E;
  const long long* key = is_flow ? ef : el;   // endpoint matched to a row
  const long long* nbr = is_flow ? el : ef;   // endpoint gathered from
  const float* mask = p.edge_mask + (size_t)b * E;
  const float* W = is_flow ? p.wf : p.wl;
  const float* bias = is_flow ? p.bf : p.bl;
  float* out = is_flow ? p.fo + (size_t)b * p.SF * G
                       : p.lo + (size_t)b * p.SL * G;

  float* self_s = smem;                       // [TR][G]
  float* agg_s = self_s + TR * G;             // [TR][G]
  float* w_s = agg_s + TR * G;                // [KC][TJ]
  float* mask_s = w_s + KC * TJ;              // [E]
  int* key_s = reinterpret_cast<int*>(mask_s + E);   // [E]
  int* nbr_s = key_s + E;                     // [E]

  const int tid = threadIdx.y * TJ + threadIdx.x;
  for (int idx = tid; idx < TR * G; idx += NT) {
    const int row = row0 + idx / G;
    self_s[idx] = row < nrows ? self[(size_t)row * G + idx % G] : 0.0f;
  }
  for (int e = tid; e < E; e += NT) {
    const long long k = key[e], n = nbr[e];
    key_s[e] = (k < 0 || k >= nrows) ? -1 : static_cast<int>(k);
    nbr_s[e] = static_cast<int>(n < 0 ? 0 : (n >= nother ? nother - 1 : n));
    mask_s[e] = mask[e];
  }
  __syncthreads();

  // aggregation: warp w owns rows w, w + RG, ...; lane owns columns
  // lane + 32c of the current pass of NCH * 32 columns
  const int lane = threadIdx.x, warp = threadIdx.y;
  for (int r = warp; r < TR; r += RG) {
    const int row = row0 + r;
    if (row >= nrows) break;                 // uniform over the warp
    for (int c0 = 0; c0 < G; c0 += NCH * 32) {
      float acc[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;
      for (int e0 = 0; e0 < E; e0 += 32) {
        const int e = e0 + lane;
        const bool hit = e < E && key_s[e] == row && mask_s[e] != 0.0f;
        unsigned m = __ballot_sync(0xffffffffu, hit);
        while (m) {                          // matches in ascending order
          const int ee = e0 + __ffs(m) - 1;
          m &= m - 1;
          const float wgt = mask_s[ee];
          const float* src = other + (size_t)nbr_s[ee] * G + c0;
          float v[NCH];
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            const int k = c * 32 + lane;
            v[c] = c0 + k < G ? src[k] : 0.0f;
          }
#pragma unroll
          for (int c = 0; c < NCH; ++c) acc[c] += v[c] * wgt;
        }
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int k = c0 + c * 32 + lane;
        if (k < G) agg_s[r * G + k] = acc[c];
      }
    }
  }
  for (int r = warp; r < TR; r += RG) {      // rows past the end: zeros
    if (row0 + r < nrows) continue;
    for (int k = lane; k < G; k += 32) agg_s[r * G + k] = 0.0f;
  }

  // [self ; agg] @ W for this block's columns, + bias, ReLU
  const int j0 = blockIdx.x * TJ;
  const int half = (G + KC - 1) / KC;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.0f;
  float reg[W_PER];
  load_w(W, G, 0, j0, reg);
  __syncthreads();                           // agg_s complete
  store_w(reg, w_s);
  __syncthreads();
  for (int chunk = 0; chunk < 2 * half; ++chunk) {
    if (chunk + 1 < 2 * half) load_w(W, G, chunk + 1, j0, reg);
    const float* a = chunk < half ? self_s : agg_s;
    const int k0 = (chunk < half ? chunk : chunk - half) * KC;
    const int kn = min(KC, G - k0);
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      if (k < kn) {
        const float w = w_s[k * TJ + threadIdx.x];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int rr = threadIdx.y * RPT + i;
          acc[i] = fmaf(a[rr * G + k0 + k], w, acc[i]);
        }
      }
    }
    __syncthreads();
    if (chunk + 1 < 2 * half) {
      store_w(reg, w_s);
      __syncthreads();
    }
  }
  const int j = j0 + threadIdx.x;
  if (j >= G) return;
  const float bj = bias[j];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = row0 + threadIdx.y * RPT + i;
    if (row < nrows) out[(size_t)row * G + j] = fmaxf(acc[i] + bj, 0.0f);
  }
}

size_t configured_smem = 48 * 1024;   // dynamic shared memory opted into

}  // namespace

// One round for a batch of B scenarios; device pointers, float32 / int64,
// contiguous. Returns the launch's cudaError_t (0 = launched).
extern "C" int bipartite_round_forward(
    const float* f, const float* l, const long long* edge_f,
    const long long* edge_l, const float* edge_mask,
    const float* wf, const float* wl, const float* bf, const float* bl,
    float* fo, float* lo, int B, int SF, int SL, int G, int E,
    void* stream) {
  if (B == 0 || G == 0 || SF + SL == 0) return 0;
  const size_t smem = smem_bytes(G, E);
  if (smem > configured_smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        bipartite_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured_smem = smem;
  }
  Round p{f, l, edge_f, edge_l, edge_mask, wf, wl, bf, bl,
          fo, lo, SF, SL, G, E};
  const int tiles = (SF + TR - 1) / TR + (SL + TR - 1) / TR;
  const dim3 grid((G + TJ - 1) / TJ, tiles, B);
  const dim3 block(TJ, RG);
  bipartite_round_kernel<<<grid, block, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
