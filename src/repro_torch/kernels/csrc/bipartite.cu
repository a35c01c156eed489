// All the bipartite GraphSAGE rounds (sum aggregation) of one m4 event in
// one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bipartite/kernel.py::_round_kernel
// (launched by bipartite_round_pallas, once per round). For each scenario b
// of a batch and each round r = 0 .. R-1, with the round's weights:
//
//     agg_f[i] = sum over edges e with edge_f[e] == i of mask[e] * l[edge_l[e]]
//     agg_l[s] = sum over edges e with edge_l[e] == s of mask[e] * f[edge_f[e]]
//     f' = relu([f ; agg_f] @ Wf + bf),   l' = relu([l ; agg_l] @ Wl + bl)
//
// The TPU kernel built a dense 0/1 incidence matrix M to run the
// aggregation on its matrix unit. Here the edge list is sorted into
// neighbour lists instead. An edge of mask 0 adds exact zeros and is
// skipped (m4 points every masked edge at link slot 0); out-of-range
// neighbour ids are clamped and out-of-range row ids match no row, as
// JAX's gather and segment_sum treat them.
//
// What bounds it: at full width (SF = 64, SL = 128, G = 300, E = 512) a
// round is ~0.07 GFLOP over 1.4 MB of L2-resident weights, so on the CUDA
// cores the fp32 FMA rate bounds it; the products here run on the tensor
// cores in 3xTF32 (tf32x3.cuh). What is left is latency: the rounds depend
// on each other across all columns, so an event of 3 rounds is 6 grid
// barriers (~1 us each) and 7 phases in series, and each product tile
// first waits for its ~115 KB of rows and weights from L2 (PERF.md).
//
// Design: one persistent cooperative grid (at most one wave, so every
// block is resident) runs every round, with a grid-wide barrier after each
// phase. Round outputs ping-pong through two scratch buffers that stay in
// L2; the last round writes the outputs. The phases:
//
//   0. neighbour lists, once per launch: per scenario and side a stable
//      counting sort of the live edges by row (counts, a scan, then one
//      warp places 32 edges at a time with __match_any_sync, in ascending
//      edge order), so that each row's list is a fixed, ordered slice;
//   A. aggregation, per round: a quad of 4 warps owns one (row, 160
//      columns) item; lanes cover the columns, warp q sums the q-th fixed
//      quarter of the row's list with 4 neighbour rows in flight, and the
//      quarters are added in order through shared memory. Each (row,
//      column) aggregate is computed once, a link row with 63 flows is
//      spread over 4 warps, and the sum order never changes;
//   B. product, per round: a block (16 warps) owns a 32-row x 16-column
//      output tile at a time. Four groups of 4 warps each take a quarter
//      of the depth 2G ([self ; agg], each half split at a multiple of 8),
//      copy that slab of rows and weights into shared memory with
//      cp.async, wait on their own named barrier and run their mma steps
//      with no block-wide barrier in the loop; each warp owns one m16n8
//      tile, with two accumulator sets for even and odd k steps. The
//      groups' partials are added in group order, then bias and ReLU.

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

constexpr int MAX_LAYERS = 8;
constexpr int NT = 512;             // 16 warps
constexpr int QUADS = NT / 128;     // phase A: quads of 4 warps
constexpr int BM = 32;              // phase B tile: rows
constexpr int BN = 16;              // phase B tile: columns
constexpr int NW = BN / 16;         // n8 tiles of a warp (4 warp tiles)
constexpr int KG = 4;               // phase B: depth groups of 4 warps
constexpr int KP = 160;             // depth of a group's slab (one pass)
constexpr int LDA = KP + 4;         // [row][k]: conflict-free A fragments
constexpr int LDW = BN + 8;         // [k][col]: conflict-free B fragments
constexpr int SLAB = BM * LDA + KP * LDW;    // floats of a group's slab
constexpr int RED = (KG - 1) * 4 * 32 * 4 * NW;   // groups 1..3
constexpr size_t PRODUCT_SMEM = (KG * SLAB + RED) * sizeof(float);
constexpr int CW = 160;             // aggregation item: columns (5 a lane)
constexpr int UNROLL = 4;           // neighbour rows in flight per warp

struct Layer {
  const float* wf;   // (2G, G)
  const float* wl;   // (2G, G)
  const float* bf;   // (G)
  const float* bl;   // (G)
};

struct Params {
  const float* f;              // (B, SF, G)
  const float* l;              // (B, SL, G)
  const long long* edge_f;     // (E), shared by the batch
  const long long* edge_l;     // (B, E)
  const float* edge_mask;      // (B, E)
  Layer layer[MAX_LAYERS];
  float* fo;                   // (B, SF, G), the last round's output
  float* lo;                   // (B, SL, G)
  float* tmp_f[2];             // (B, SF, G) each: rounds before the last
  float* tmp_l[2];
  float* agg_f;                // (B, SF, G)
  float* agg_l;                // (B, SL, G)
  float* wgt_f;                // (B, E): list weights (mask) per side
  float* wgt_l;
  int* nbr_f;                  // (B, E): list neighbours per side
  int* nbr_l;
  int* off_f;                  // (B, SF + 1): list offsets per side
  int* off_l;                  // (B, SL + 1)
  int R, B, SF, SL, G, E;
};

// Grid-wide barrier of a cooperative launch. One 64-bit count only ever
// grows: one thread per block adds 1 (acq_rel) and waits (acquire loads)
// until the count reaches the next multiple of the grid size. Launches of
// one grid size leave it at a multiple; the launcher zeroes it when the
// grid size changes. With the block-wide barriers around it, every write
// before the barrier is visible after it.
__device__ unsigned long long barrier_count;

__device__ __forceinline__ void grid_sync() {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long n = gridDim.x;
    unsigned long long old, now;
    asm volatile("atom.add.acq_rel.gpu.global.u64 %0, [%1], 1;"
                 : "=l"(old) : "l"(&barrier_count) : "memory");
    const unsigned long long target = old - old % n + n;
    now = old + 1;
    while (now < target) {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                   : "=l"(now) : "l"(&barrier_count) : "memory");
    }
  }
  __syncthreads();
}

// ---- phase 0: neighbour lists of scenario b, side 0 (flow rows) or 1.
// Shared memory: fill[nrows], then per edge its row (-1 when the edge is
// not live), clamped neighbour and weight.
__device__ void build_lists(const Params& p, int b, int side, int* fill) {
  const int E = p.E;
  const int nrows = side == 0 ? p.SF : p.SL;
  const int nother = side == 0 ? p.SL : p.SF;
  const long long* key = side == 0 ? p.edge_f : p.edge_l + (size_t)b * E;
  const long long* nb = side == 0 ? p.edge_l + (size_t)b * E : p.edge_f;
  const float* mask = p.edge_mask + (size_t)b * E;
  int* off = side == 0 ? p.off_f + (size_t)b * (p.SF + 1)
                       : p.off_l + (size_t)b * (p.SL + 1);
  int* nbr = (side == 0 ? p.nbr_f : p.nbr_l) + (size_t)b * E;
  float* wgt = (side == 0 ? p.wgt_f : p.wgt_l) + (size_t)b * E;
  int* e_row = fill + nrows;
  int* e_nbr = e_row + E;
  float* e_w = reinterpret_cast<float*>(e_nbr + E);
  const int tid = threadIdx.x, lane = tid & 31;

  for (int i = tid; i < nrows; i += NT) fill[i] = 0;
  __syncthreads();
  // with no row on the other side there is nothing to gather
  for (int e = tid; e < E; e += NT) {
    const long long k = key[e], n = nb[e];
    const float w = mask[e];
    const bool live = w != 0.0f && k >= 0 && k < nrows && nother > 0;
    e_row[e] = live ? static_cast<int>(k) : -1;
    e_nbr[e] = static_cast<int>(n < 0 ? 0 : (n >= nother ? nother - 1 : n));
    e_w[e] = w;
    if (live) atomicAdd(&fill[k], 1);
  }
  __syncthreads();
  if (tid < 32) {
    // exclusive scan of the counts: the lists' offsets
    int carry = 0;
    for (int i0 = 0; i0 < nrows; i0 += 32) {
      const int i = i0 + lane;
      const int v = i < nrows ? fill[i] : 0;
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += u;
      }
      if (i < nrows) fill[i] = off[i] = carry + incl - v;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) off[nrows] = carry;
    __syncwarp();
    // stable placement, 32 edges at a time in ascending order
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      const int k = e < E ? e_row[e] : -1;
      const unsigned grp = __match_any_sync(0xffffffffu, k);
      const int rank = __popc(grp & ((1u << lane) - 1u));
      if (k >= 0) {
        const int pos = fill[k] + rank;
        nbr[pos] = e_nbr[e];
        wgt[pos] = e_w[e];
      }
      __syncwarp();
      if (k >= 0 && rank == 0) fill[k] += __popc(grp);
      __syncwarp();
    }
  }
  __syncthreads();
}

// ---- phase A: aggregates of one round, (row, 128 columns) per quad
__device__ void aggregate(const Params& p, const float* cur_f,
                          const float* cur_l, float* qbuf) {
  const int G = p.G, SF = p.SF, SL = p.SL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = warp >> 2, q = warp & 3;   // quad < QUADS
  float* buf = qbuf + quad * 4 * CW;
  const int cc_n = (G + CW - 1) / CW;
  const int per_b = (SF + SL) * cc_n;
  const int nitems = p.B * per_b;
  for (int it = blockIdx.x * QUADS + quad; it < nitems;
       it += gridDim.x * QUADS) {
    const int b = it / per_b, rem = it % per_b;
    const int rr = rem / cc_n, c0 = (rem % cc_n) * CW;
    const bool flow = rr < SF;
    const int row = flow ? rr : rr - SF;
    const float* other = flow ? cur_l + (size_t)b * SL * G
                              : cur_f + (size_t)b * SF * G;
    const int* off = flow ? p.off_f + (size_t)b * (SF + 1)
                          : p.off_l + (size_t)b * (SL + 1);
    const int* nbr = (flow ? p.nbr_f : p.nbr_l) + (size_t)b * p.E;
    const float* wgt = (flow ? p.wgt_f : p.wgt_l) + (size_t)b * p.E;
    const int beg = off[row], n = off[row + 1] - beg;
    const int s0 = beg + q * n / 4, s1 = beg + (q + 1) * n / 4;
    float acc[CW / 32];
#pragma unroll
    for (int v = 0; v < CW / 32; ++v) acc[v] = 0.0f;
    for (int s = s0; s < s1; s += UNROLL) {
      float val[UNROLL][CW / 32], w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const bool ok = s + u < s1;
        const int nn = ok ? nbr[s + u] : 0;
        w[u] = ok ? wgt[s + u] : 0.0f;
        const float* src = other + (size_t)nn * G;
#pragma unroll
        for (int v = 0; v < CW / 32; ++v) {
          const int col = c0 + v * 32 + lane;
          val[u][v] = ok && col < G ? __ldcg(src + col) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int v = 0; v < CW / 32; ++v)
          acc[v] = fmaf(w[u], val[u][v], acc[v]);
    }
#pragma unroll
    for (int v = 0; v < CW / 32; ++v) buf[q * CW + v * 32 + lane] = acc[v];
    asm volatile("bar.sync %0, 128;" :: "r"(1 + quad));
    float* agg = flow ? p.agg_f + ((size_t)b * SF + row) * G
                      : p.agg_l + ((size_t)b * SL + row) * G;
    for (int k = q * 32 + lane; k < CW && c0 + k < G; k += 128)
      agg[c0 + k] = ((buf[k] + buf[CW + k]) + buf[2 * CW + k])
                    + buf[3 * CW + k];
    asm volatile("bar.sync %0, 128;" :: "r"(1 + quad));
  }
}

// ---- phase B helpers. A block's tile t: scenario, side, rows, columns
struct Tile {
  int b, nrows, row0, j0;
  bool flow;
};

__device__ __forceinline__ int tiles_per_b(const Params& p) {
  return ((p.SF + BM - 1) / BM + (p.SL + BM - 1) / BM) * ((p.G + BN - 1) / BN);
}

__device__ __forceinline__ Tile tile_of(const Params& p, int t) {
  const int ft = (p.SF + BM - 1) / BM, ct_n = (p.G + BN - 1) / BN;
  const int per_b = tiles_per_b(p);
  const int rem = t % per_b, rt = rem / ct_n;
  Tile x;
  x.b = t / per_b;
  x.j0 = rem % ct_n * BN;
  x.flow = rt < ft;
  x.nrows = x.flow ? p.SF : p.SL;
  x.row0 = (x.flow ? rt : rt - ft) * BM;
  return x;
}

// depth group kg takes [kb, ke) of half kg / 2 (self, then agg), the
// halves split at a multiple of 8
__device__ __forceinline__ void group_range(int G, int kg, int& kb,
                                            int& ke) {
  const int split = ((G + 1) / 2 + 7) & ~7;
  kb = (kg & 1) ? split : 0;
  ke = (kg & 1) ? G : min(split, G);
}

// cp.async weight rows wrow .. wrow + len of columns [j0, j0 + BN) into
// the slab's [k][col] part, zero-filled up to a multiple of 8 rows; gt:
// the thread's index in its group of 128
__device__ __forceinline__ void load_w(const float* W, int G, int j0,
                                       int wrow, int len, float* ws,
                                       int gt) {
  const int lp = (len + 7) & ~7;
  const float* wk = W + (size_t)wrow * G + j0;
  if (G % 4 == 0 && tf32x3::aligned16(W)) {
    for (int idx = gt; idx < lp * BN / 4; idx += 128) {
      const int k = idx / (BN / 4), col = idx % (BN / 4) * 4;
      const bool ok = k < len && j0 + col < G;
      tf32x3::cp_async16(ws + k * LDW + col,
                         ok ? wk + (size_t)k * G + col : W, ok);
    }
  } else {
    for (int idx = gt; idx < lp * BN; idx += 128) {
      const int k = idx / BN, col = idx % BN;
      const bool ok = k < len && j0 + col < G;
      tf32x3::cp_async4(ws + k * LDW + col,
                        ok ? wk + (size_t)k * G + col : W, ok);
    }
  }
}

// cp.async rows [row0, row0 + BM) x depth [k0, k0 + len) of `a` (row
// stride G) into the slab's [row][k] part, zero-filled as load_w
__device__ __forceinline__ void load_a(const float* a, int G, int nrows,
                                       int row0, int k0, int len, float* as,
                                       int gt) {
  const int lp = (len + 7) & ~7;
  if (G % 4 == 0 && tf32x3::aligned16(a)) {
    for (int idx = gt; idx < BM * lp / 4; idx += 128) {
      const int r = idx / (lp / 4), k = idx % (lp / 4) * 4;
      const bool ok = row0 + r < nrows && k < len;
      tf32x3::cp_async16(as + r * LDA + k,
                         ok ? a + (size_t)(row0 + r) * G + k0 + k : a, ok);
    }
  } else {
    for (int idx = gt; idx < BM * lp; idx += 128) {
      const int r = idx / lp, k = idx % lp;
      const bool ok = row0 + r < nrows && k < len;
      tf32x3::cp_async4(as + r * LDA + k,
                        ok ? a + (size_t)(row0 + r) * G + k0 + k : a, ok);
    }
  }
}

// acc += the k8 step ks of the slab, for warp tile (wm, wn): rows
// wm * 16 .. + 16, columns wn * BN / 2 .. as NW n8 tiles
__device__ __forceinline__ void slab_step(const float* slab, int wm, int wn,
                                          int ks, float (&big)[NW][4],
                                          float (&small)[NW][4]) {
  tf32x3::FragA fa;
  tf32x3::load_a(fa, slab + wm * 16 * LDA + ks * 8, LDA);
  const float* ws = slab + BM * LDA + ks * 8 * LDW + wn * (BN / 2);
#pragma unroll
  for (int nt = 0; nt < NW; ++nt) {
    tf32x3::FragB fb;
    tf32x3::load_b(fb, ws + nt * 8, LDW);
    tf32x3::mma3(big[nt], small[nt], fa, fb);
  }
}

// ---- phase B: relu([self ; agg] @ W + b) of one round, a BM x BN tile
// per block at a time. Depth group kg (4 warps) takes a quarter of the
// depth 2G; each warp owns one 16 x BN/2 quarter of the tile. A group
// copies its slab (passes of KP) with cp.async, waits on its own barrier
// and runs the mma steps with no block-wide barrier; the four groups'
// partials are added in group order.
__device__ void product(const Params& p, const Layer& layer,
                        const float* cur_f, const float* cur_l, float* out_f,
                        float* out_l, float* smem) {
  const int G = p.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kg = warp >> 2, wt = warp & 3, wm = wt & 1, wn = wt >> 1;
  const int gt = threadIdx.x & 127;
  float* slab = smem + kg * SLAB;
  float* red = smem + KG * SLAB;
  const int half = kg >> 1;
  int kb, ke;
  group_range(G, kg, kb, ke);
  const int ntiles = p.B * tiles_per_b(p);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile x = tile_of(p, t);
    const size_t base = (size_t)x.b * x.nrows * G;
    const float* a = half == 0 ? (x.flow ? cur_f : cur_l) + base
                               : (x.flow ? p.agg_f : p.agg_l) + base;
    const float* W = x.flow ? layer.wf : layer.wl;
    const float* bias = x.flow ? layer.bf : layer.bl;
    float* out = (x.flow ? out_f : out_l) + base;

    // two accumulator sets (even and odd k steps) of big and small terms
    float big0[NW][4] = {}, small0[NW][4] = {}, big1[NW][4] = {},
          small1[NW][4] = {};
    for (int k0 = kb; k0 < ke; k0 += KP) {
      const int len = min(KP, ke - k0);
      load_w(W, G, x.j0, half * G + k0, len, slab + BM * LDA, gt);
      load_a(a, G, x.nrows, x.row0, k0, len, slab, gt);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<0>();
      asm volatile("bar.sync %0, 128;" :: "r"(1 + kg));   // slab complete
      const int nks = (len + 7) >> 3;
      int ks = 0;
      for (; ks + 1 < nks; ks += 2) {
        slab_step(slab, wm, wn, ks, big0, small0);
        slab_step(slab, wm, wn, ks + 1, big1, small1);
      }
      if (ks < nks) slab_step(slab, wm, wn, ks, big0, small0);
      asm volatile("bar.sync %0, 128;" :: "r"(1 + kg));   // slab free
    }
    float part[NW][4];
#pragma unroll
    for (int nt = 0; nt < NW; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        part[nt][i] = (big0[nt][i] + small0[nt][i])
                      + (big1[nt][i] + small1[nt][i]);
    if (kg > 0) {
      float* mine = red + (((kg - 1) * 4 + wt) * 32 + lane) * 4 * NW;
#pragma unroll
      for (int i = 0; i < 4 * NW; ++i) mine[i] = part[i >> 2][i & 3];
    }
    __syncthreads();
    if (kg == 0) {
      const int g = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int i = 0; i < 4 * NW; ++i) {
        float v = part[i >> 2][i & 3];
#pragma unroll
        for (int q = 0; q < KG - 1; ++q)
          v += red[((q * 4 + wt) * 32 + lane) * 4 * NW + i];
        const int r = x.row0 + wm * 16 + g + ((i & 3) >= 2 ? 8 : 0);
        const int j = x.j0 + wn * (BN / 2) + (i >> 2) * 8 + 2 * tq + (i & 1);
        if (r < x.nrows && j < G)
          out[(size_t)r * G + j] = fmaxf(v + bias[j], 0.0f);
      }
    }
    __syncthreads();                   // red free for the next tile
  }
}

__global__ void __launch_bounds__(NT, 1) bipartite_rounds_kernel(Params p) {
  extern __shared__ float smem[];
  for (int it = blockIdx.x; it < 2 * p.B; it += gridDim.x)
    build_lists(p, it >> 1, it & 1, reinterpret_cast<int*>(smem));
  grid_sync();
  for (int r = 0; r < p.R; ++r) {
    const float* cur_f = r == 0 ? p.f : p.tmp_f[(r - 1) & 1];
    const float* cur_l = r == 0 ? p.l : p.tmp_l[(r - 1) & 1];
    aggregate(p, cur_f, cur_l, smem);
    grid_sync();
    const bool last = r == p.R - 1;
    product(p, p.layer[r], cur_f, cur_l, last ? p.fo : p.tmp_f[r & 1],
            last ? p.lo : p.tmp_l[r & 1], smem);
    if (!last) grid_sync();
  }
}

size_t configured_smem = 48 * 1024;   // dynamic shared memory opted into
int grid_blocks = 0;                  // one wave of resident blocks

}  // namespace

// R rounds for a batch of B scenarios in one cooperative launch. Device
// pointers, float32 / int64, contiguous; wf/wl/bf/bl are host arrays of
// the R layers' device pointers. fscratch holds
// (min(R - 1, 2) + 1) * B * (SF + SL) * G + 2 * B * E floats, iscratch
// 2 * B * E + B * (SF + SL + 2) ints. Launches on one device must not
// overlap (they share the grid barrier's count). Returns the launch's
// cudaError_t (0 = launched).
extern "C" int bipartite_rounds_forward(
    const float* f, const float* l, const long long* edge_f,
    const long long* edge_l, const float* edge_mask,
    const float* const* wf, const float* const* wl, const float* const* bf,
    const float* const* bl, int R, float* fo, float* lo, float* fscratch,
    int* iscratch, int B, int SF, int SL, int G, int E, void* stream) {
  if (R < 1 || R > MAX_LAYERS) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || G == 0 || SF + SL == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int maxrows = SF > SL ? SF : SL;
  size_t smem = PRODUCT_SMEM;
  const size_t agg_smem = QUADS * 4 * CW * sizeof(float);
  const size_t list_smem = ((size_t)maxrows + 3 * (size_t)E) * sizeof(int);
  if (agg_smem > smem) smem = agg_smem;
  if (list_smem > smem) smem = list_smem;
  if (smem > configured_smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        bipartite_rounds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured_smem = smem;
    grid_blocks = 0;
  }
  if (grid_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    void* count = nullptr;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bipartite_rounds_kernel, NT, configured_smem);
    // a new grid size: the barrier's count restarts from 0
    if (err == cudaSuccess) err = cudaGetSymbolAddress(&count, barrier_count);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(count, 0, sizeof(unsigned long long), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    grid_blocks = sms * (per_sm < 2 ? per_sm : 2);
  }

  Params p;
  p.f = f;
  p.l = l;
  p.edge_f = edge_f;
  p.edge_l = edge_l;
  p.edge_mask = edge_mask;
  for (int r = 0; r < MAX_LAYERS; ++r)
    p.layer[r] = r < R ? Layer{wf[r], wl[r], bf[r], bl[r]}
                       : Layer{nullptr, nullptr, nullptr, nullptr};
  p.fo = fo;
  p.lo = lo;
  const size_t nf = (size_t)B * SF * G, nl = (size_t)B * SL * G;
  float* fs = fscratch;
  p.agg_f = fs;
  p.agg_l = fs + nf;
  fs += nf + nl;
  for (int i = 0; i < 2; ++i) {       // rounds before the last
    const bool used = i < R - 1;
    p.tmp_f[i] = used ? fs : nullptr;
    p.tmp_l[i] = used ? fs + nf : nullptr;
    if (used) fs += nf + nl;
  }
  p.wgt_f = fs;
  p.wgt_l = fs + (size_t)B * E;
  p.nbr_f = iscratch;
  p.nbr_l = iscratch + (size_t)B * E;
  p.off_f = iscratch + 2 * (size_t)B * E;
  p.off_l = p.off_f + (size_t)B * (SF + 1);
  p.R = R;
  p.B = B;
  p.SF = SF;
  p.SL = SL;
  p.G = G;
  p.E = E;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = configured_smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, bipartite_rounds_kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
