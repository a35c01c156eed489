// Fused GRU cell pair for Hopper (sm_90a), error-compensated TF32 on the
// tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/fused_gru/kernel.py::_gru_kernel
// (launched by gru_cell_pallas). One launch advances both cells of one m4
// stage — the flow GRU and the link GRU, as repro_torch.kernels.dispatch.
// gru_cell_pair pairs them — blockIdx.z selecting the cell:
//
//     gi = x @ Wi + bi,  gh = h @ Wh + bh          (gate order r, z, n)
//     r = sigmoid(ir + hr),  z = sigmoid(iz + hz),  n = tanh(in + r * hn)
//     h' = (1 - z) * n + z * h
//
// What bounds it: at m4's full width (H = 400; 64 flow rows and 128 link
// rows per scenario; x of width 13/11 or 309) a launch is 0.2-0.3 GFLOP
// over 4-7 MB of L2-resident weights, so on the CUDA cores the fp32 FMA
// rate bounds it. Here the products run on the tensor cores in 3xTF32
// (tf32x3.cuh: three TF32 mma terms, float32 accuracy), and what is left
// is moving the weight and x/h tiles from L2 into shared memory.
//
// Design. Four accumulators per hidden column j: r and z over x@Wi and
// h@Wh together, `in` over x@Wi only and `hn` over h@Wh only, so the gates
// fuse in the epilogue and only h' is written. The depth — Din of x, then
// H of h — is walked in chunks of KC = 32 (x and h chunks never mix); each
// chunk's 64 rows of x or h and its weight columns j, H+j, 2H+j of one
// 16-column tile are copied by cp.async into a ring of NS = 4 stages of
// shared memory, so three chunks stay in flight while one is multiplied.
// Ragged edges (rows, Din, H) are zero-filled by the copies; nothing is
// padded in memory.
//
// Grid: x = ceil(H / 16) column tiles x KS = 3 depth thirds, y =
// ceil(rows / 64) row tiles, z = the two cells; the KS blocks of one tile
// form a cluster. Each block multiplies its third of the depth chunks; the
// thirds' partial sums meet in distributed shared memory and each block
// finishes the gates of a third of the tile's rows, adding the thirds in
// rank order, so the result does not change from run to run. At B = 1
// that is 25 x 3 blocks for the flow cell and 50 x 3 for the link cell:
// 225 blocks of 8 warps, 2 on an SM, one wave on the 132 SMs. (2- and
// 4-block clusters read 29.4 and 25.0 us at stage 2 against 21.7 us here,
// on an H100 SXM at 700 W: tools/kernel_variants.py, PERF.md.)
//
// What binds it now: each block's chunks pass copy-wait -> barrier -> mma
// in series, and the card's L2 delivers the ~24 MB a stage-2 launch reads
// (x/h re-read by every column tile, weights by every row tile) at
// ~1-2.5 TB/s; the mma are ~40% of the time (PERF.md).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64;              // rows per block
constexpr int BN = 16;              // hidden columns per block
constexpr int KC = 32;              // depth of one staged chunk
constexpr int NS = 4;               // stages of the ring
constexpr int KS = 3;               // blocks of a cluster: depth thirds
constexpr int NT = 256;             // 8 warps: 4 row slices x 2 col slices
constexpr int LDA = KC + 4;         // [row][k], conflict-free A fragments
constexpr int LDW = 3 * BN + 8;     // [k][gate col], conflict-free B frags
constexpr int A_STAGE = BM * LDA;
constexpr int W_STAGE = KC * LDW;
constexpr int STAGE = A_STAGE + W_STAGE;
constexpr size_t SMEM = NS * STAGE * sizeof(float);   // 64 KB, dynamic
static_assert(4 * BM * BN <= NS * STAGE, "partial sums reuse the ring");

struct Cell {
  const float* x;    // (rows, din)
  const float* h;    // (rows, H)
  const float* wi;   // (din, 3H)
  const float* wh;   // (H, 3H)
  const float* bi;   // (3H)
  const float* bh;   // (3H)
  float* out;        // (rows, H)
  int rows;
  int din;
};

struct Pair {
  Cell cell[2];      // 0 = flow GRU, 1 = link GRU
  int H;
};

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// cp.async chunk c of the depth (c < nx: x/Wi, else h/Wh) into stage s
__device__ __forceinline__ void load_chunk(const Cell& c, int H, int nx,
                                           int chunk, int row0, int j0,
                                           float* s) {
  const bool in_x = chunk < nx;
  const float* a = in_x ? c.x : c.h;
  const float* w = in_x ? c.wi : c.wh;
  const int depth = in_x ? c.din : H;
  const int k0 = (in_x ? chunk : chunk - nx) * KC;
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < BM * KC / NT; ++q) {
    const int idx = tid + q * NT, r = idx / KC, k = idx % KC;
    const bool ok = row0 + r < c.rows && k0 + k < depth;
    tf32x3::cp_async4(s + r * LDA + k,
                      ok ? a + (size_t)(row0 + r) * depth + k0 + k : a, ok);
  }
  float* ws = s + A_STAGE;
#pragma unroll
  for (int q = 0; q < KC * 3 * BN / NT; ++q) {
    const int idx = tid + q * NT, k = idx / (3 * BN), col = idx % (3 * BN);
    const int g = col / BN, j = j0 + col % BN;
    const bool ok = k0 + k < depth && j < H;
    tf32x3::cp_async4(
        ws + k * LDW + col,
        ok ? w + (size_t)(k0 + k) * 3 * H + (size_t)g * H + j : w, ok);
  }
}

__global__ void __cluster_dims__(KS, 1, 1) __launch_bounds__(NT, 2)
gru_pair_kernel(Pair p) {
  extern __shared__ float smem[];
  const Cell c = blockIdx.z == 0 ? p.cell[0] : p.cell[1];
  const int H = p.H;
  const int row0 = blockIdx.y * BM;
  if (row0 >= c.rows) return;          // uniform over the cluster
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int j0 = (blockIdx.x / KS) * BN;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;   // 16-row slice, 8-col slice

  // accumulators: 0 = r, 1 = z, 2 = in (x part), 3 = hn (h part)
  float big[4][4], small[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) big[a][i] = small[a][i] = 0.0f;

  const int nx = (c.din + KC - 1) / KC;
  const int nchunks = nx + (H + KC - 1) / KC;
  const int c0 = rank * nchunks / KS, c1 = (rank + 1) * nchunks / KS;
  const int n = c1 - c0;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n) load_chunk(c, H, nx, c0 + s, row0, j0, smem + s * STAGE);
    tf32x3::cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    tf32x3::cp_async_wait<NS - 2>();
    __syncthreads();                   // chunk i landed; stage i-1 free
    if (i + NS - 1 < n)
      load_chunk(c, H, nx, c0 + i + NS - 1, row0, j0,
                 smem + (i + NS - 1) % NS * STAGE);
    tf32x3::cp_async_commit();
    const float* as = smem + (i % NS) * STAGE + wm * 16 * LDA;
    const float* ws = smem + (i % NS) * STAGE + A_STAGE + wn * 8;
    const int na = c0 + i < nx ? 2 : 3;      // n gate: `in` or `hn`
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      tf32x3::FragA fa;
      tf32x3::load_a(fa, as + ks * 8, LDA);
      tf32x3::FragB fb;
      tf32x3::load_b(fb, ws + ks * 8 * LDW, LDW);
      tf32x3::mma3(big[0], small[0], fa, fb);
      tf32x3::load_b(fb, ws + ks * 8 * LDW + BN, LDW);
      tf32x3::mma3(big[1], small[1], fa, fb);
      tf32x3::load_b(fb, ws + ks * 8 * LDW + 2 * BN, LDW);
      if (na == 2) {
        tf32x3::mma3(big[2], small[2], fa, fb);
      } else {
        tf32x3::mma3(big[3], small[3], fa, fb);
      }
    }
  }
  tf32x3::cp_async_wait<0>();
  __syncthreads();                     // the ring is free: partial sums

  // this block's partial sums, [accumulator][row][col]
  float* part = smem;
  {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int r = wm * 16 + g, col = wn * 8 + 2 * t;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float* pa = part + a * BM * BN;
      pa[r * BN + col] = big[a][0] + small[a][0];
      pa[r * BN + col + 1] = big[a][1] + small[a][1];
      pa[(r + 8) * BN + col] = big[a][2] + small[a][2];
      pa[(r + 8) * BN + col + 1] = big[a][3] + small[a][3];
    }
  }
  cluster.sync();

  // rank q finishes rows [q BM / KS, (q + 1) BM / KS) of the tile, adding
  // the depth parts in rank order
  const int r0 = rank * BM / KS, r1 = (rank + 1) * BM / KS;
  for (int idx = threadIdx.x; idx < (r1 - r0) * BN; idx += NT) {
    const int r = r0 + idx / BN, col = idx % BN;
    const int row = row0 + r, j = j0 + col;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < KS; ++q) {
      const float* peer = cluster.map_shared_rank(part, q);
#pragma unroll
      for (int a = 0; a < 4; ++a) v[a] += peer[a * BM * BN + r * BN + col];
    }
    if (row < c.rows && j < H) {
      const float r_g = sigmoid_f(v[0] + (c.bi[j] + c.bh[j]));
      const float z_g = sigmoid_f(v[1] + (c.bi[H + j] + c.bh[H + j]));
      const float n_g = tanhf((v[2] + c.bi[2 * H + j])
                              + r_g * (v[3] + c.bh[2 * H + j]));
      const float hv = c.h[(size_t)row * H + j];
      c.out[(size_t)row * H + j] = (1.0f - z_g) * n_g + z_g * hv;
    }
  }
  cluster.sync();                      // peers' partials stay until read
}

bool smem_configured = false;

}  // namespace

// Advance both cells of one stage; pointers are device pointers, all
// float32 and contiguous. Returns the launch's cudaError_t (0 = launched).
extern "C" int gru_pair_forward(
    const float* x0, const float* h0, const float* wi0, const float* wh0,
    const float* bi0, const float* bh0, float* out0, int rows0, int din0,
    const float* x1, const float* h1, const float* wi1, const float* wh1,
    const float* bi1, const float* bh1, float* out1, int rows1, int din1,
    int H, void* stream) {
  const int rows = rows0 > rows1 ? rows0 : rows1;
  if (rows == 0 || H == 0) return 0;
  if (!smem_configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gru_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_configured = true;
  }
  Pair p;
  p.cell[0] = Cell{x0, h0, wi0, wh0, bi0, bh0, out0, rows0, din0};
  p.cell[1] = Cell{x1, h1, wi1, wh1, bi1, bh1, out1, rows1, din1};
  p.H = H;
  const dim3 grid((H + BN - 1) / BN * KS, (rows + BM - 1) / BM, 2);
  gru_pair_kernel<<<grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
