// Flash attention for Hopper (sm_90a): bf16 operands, fp32 accumulation.
//
// Three kernels, each the counterpart of one Pallas TPU kernel in
// dlrover_tpu/ops/flash_attention.py:
//
//   flash_fwd_kernel       replaces _fwd_kernel (:71-149), launched by _flash_fwd (:199)
//   flash_bwd_dkdv_kernel  replaces _bwd_dkdv_kernel (:230-303), first pallas_call of _flash_bwd (:400)
//   flash_bwd_dq_kernel    replaces _bwd_dq_kernel (:306-368), second pallas_call of _flash_bwd (:426)
//
// Semantics are the Pallas kernels': end-aligned causal mask (query row i sees
// keys <= i + kv_len - q_len), padded keys masked with the same finite -1e30
// sentinel, the l == 0 guard, per-row logsumexp saved in fp32, and the backward's
// q_idx < q_len mask. The backward is two passes without atomics, so it is
// deterministic.
//
// Layout: q, k, v and dO are read as [B, T, H, D] through their strides (D stride
// 1), so no transpose copy is made; O, dQ, dK and dV are written as contiguous
// [B, T, H, D]; lse and delta are contiguous [B*H, q_len] fp32.
//
// Design. The TPU kernels carry their accumulators across a sequential grid axis;
// here that axis is a loop inside one thread block:
//   forward: one block per (64-row Q tile, batch*head), looping over K tiles up to
//            the causal limit;
//   dK/dV:   one block per (64-row K tile, batch*head), looping over Q tiles from
//            the causal start;
//   dQ:      one block per (64-row Q tile, batch*head), looping over K tiles.
// A block is 4 warps; each warp owns 16 rows of the block's tile. Operand tiles are
// staged in shared memory, products run on the tensor cores through nvcuda::wmma
// 16x16x16 bf16 fragments with fp32 accumulators, and the softmax and gradient
// algebra run in fp32 on the rows a warp owns (shared-memory score tiles). The
// 64x64 tiles fit Hopper's shared memory; the Pallas kernels' 1024x1024 defaults
// only keep their meaning for the plain PyTorch versions.
//
// Bounds at the training shape (B=8, T=1024, H=12, D=64, bf16, causal) on an H100
// SXM (3.35 TB/s, 989 TFLOP/s dense bf16), counting each input read once and each
// output written once, and only the query/key pairs the causal mask keeps:
//   forward: ~50 MB -> ~15 us;  ~12.9 GFLOP -> ~13 us.   Bound by bytes, barely.
//   dK/dV:   ~76 MB -> ~23 us;  ~25.8 GFLOP -> ~26 us.   Bound by operations.
//   dQ:      ~63 MB -> ~19 us;  ~19.3 GFLOP -> ~19.5 us. Bound by operations.
// All three sit near the ridge, so a kernel must both keep the score matrix out of
// device memory and keep the tensor cores fed. What this design does: the online
// softmax keeps S and P on chip (the [T, T] matrix never reaches device memory);
// the causal loop bounds skip tiles right of the diagonal (about half the work);
// the heaviest Q tiles are scheduled first so the tail of the grid is short; and
// every product is a tensor-core product. What it leaves for later: wmma lowers
// to mma.sync, well below the wgmma rate; loads are synchronous (no TMA or
// cp.async pipeline), and scores round-trip through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BM = 64;  // rows of the tile a block owns
constexpr int BN = 64;  // rows of the tile a block streams
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;  // the Pallas kernels' finite mask value

// Shared-memory row strides. The pads put the rows of a 16-row wmma load on
// different banks and keep every 16x16 fragment 32-byte aligned.
template <int D>
struct Smem {
  static constexpr int LDH = D + 8;   // bf16 [64, D] operand tile
  static constexpr int LDS = BN + 4;  // fp32 [64, 64] score tile
  static constexpr int LDP = BN + 8;  // bf16 [64, 64] probability tile
  static constexpr int LDO = D + 4;   // fp32 [64, D] accumulator tile
  static constexpr int H_TILE = BM * LDH * 2;  // bytes of each tile
  static constexpr int S_TILE = BM * LDS * 4;
  static constexpr int P_TILE = BM * LDP * 2;
  static constexpr int O_TILE = BM * LDO * 4;
  static constexpr int VEC_BYTES = BM * 4;
  static constexpr int FWD = 3 * H_TILE + S_TILE + P_TILE + O_TILE;
  static constexpr int DQ = 4 * H_TILE + 2 * S_TILE + P_TILE + 2 * VEC_BYTES;
  static constexpr int DKDV = 4 * H_TILE + 2 * S_TILE + 2 * P_TILE + 2 * VEC_BYTES;
  // the backward kernels stage their fp32 results in the two score tiles
  static_assert(2 * S_TILE >= O_TILE, "staging area too small");
};

struct Layout {  // element strides of a [B, T, H, D] tensor whose D stride is 1
  int64_t b, t, h;
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows row0 .. row0+63 of head (b, h) into a [64, D] shared tile; rows at or past
// n_rows are zero, as the Pallas wrappers zero-pad.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, Layout L,
                                          int b, int h, int row0, int n_rows) {
  constexpr int VEC = 8;  // 16 bytes
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < BM * PER_ROW; i += NTHREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    const int t = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < n_rows)
      val = __ldg(reinterpret_cast<const uint4*>(src + b * L.b + t * L.t + h * L.h + c));
    *reinterpret_cast<uint4*>(dst + r * Smem<D>::LDH + c) = val;
  }
}

__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int row0,
                                         int n_rows) {
  for (int i = threadIdx.x; i < BM; i += NTHREADS)
    dst[i] = row0 + i < n_rows ? src[row0 + i] : 0.f;
}

// out[16, 64] = a[16, D] . b[64, D]^T, both operands row-major tiles of stride LDH.
template <int D>
__device__ __forceinline__ void mm_abt(float* out, int ld_out, const bf16* a, const bf16* b) {
  constexpr int LDH = Smem<D>::LDH;
  Acc acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, LDH);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      FragBt fb;
      wmma::load_matrix_sync(fb, b + j * 16 * LDH + kk, LDH);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wmma::store_matrix_sync(out + j * 16, acc[j], ld_out, wmma::mem_row_major);
}

// acc[16, D] += a[16, 64] . b[64, D]; a of stride LDP, b of stride LDH.
template <int D>
__device__ __forceinline__ void mm_ab(Acc (&acc)[D / 16], const bf16* a, const bf16* b) {
  constexpr int LDH = Smem<D>::LDH;
#pragma unroll
  for (int kk = 0; kk < BN; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, Smem<D>::LDP);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      FragB fb;
      wmma::load_matrix_sync(fb, b + kk * LDH + j * 16, LDH);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// One row of a contiguous [B, T, H, D] bf16 output from an fp32 shared row,
// divided by div; each lane writes neighbouring pairs.
template <int D>
__device__ __forceinline__ void store_row(bf16* dst, const float* src, float div, int lane) {
#pragma unroll
  for (int c = 2 * lane; c < D; c += 64)
    *reinterpret_cast<__nv_bfloat162*>(dst + c) =
        __floats2bfloat162_rn(src[c] / div, src[c + 1] / div);
}

__device__ __forceinline__ int64_t out_row(int b, int t, int h, int T, int H, int D) {
  return ((static_cast<int64_t>(b) * T + t) * H + h) * D;
}

// A warp's 16 accumulator rows (tile rows r0 .. r0+15, global rows row0 + r0 ..)
// to a contiguous [B, T, H, D] bf16 output, through an fp32 staging tile.
template <int D>
__device__ __forceinline__ void store_acc_rows(Acc (&acc)[D / 16], float* stage, bf16* dst,
                                               int b, int h, int H, int T, int row0, int r0,
                                               int lane) {
  constexpr int LDO = Smem<D>::LDO;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(stage + r0 * LDO + j * 16, acc[j], LDO, wmma::mem_row_major);
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int t = row0 + r0 + r;
    if (t >= T) break;
    store_row<D>(dst + out_row(b, t, h, T, H, D), stage + (r0 + r) * LDO, 1.f, lane);
  }
  __syncwarp();
}

// Number of K tiles a causal Q tile starting at q0 visits: a K tile strictly right
// of the tile's last row is skipped, as in the Pallas kernels.
__device__ __forceinline__ int k_tiles(int q0, int q_len, int kv_len, int causal) {
  int n = (kv_len + BN - 1) / BN;
  if (causal) {
    const int last = q0 + BM - 1 + kv_len - q_len;
    n = min(n, last < 0 ? 0 : last / BN + 1);
  }
  return n;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, Layout lq, Layout lk, Layout lv,
                 bf16* __restrict__ o, float* __restrict__ lse, int H, int q_len, int kv_len,
                 float scale, int causal) {
  typedef Smem<D> S;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + S::H_TILE);
  bf16* sV = reinterpret_cast<bf16*>(smem + 2 * S::H_TILE);
  float* sS = reinterpret_cast<float*>(smem + 3 * S::H_TILE);
  bf16* sP = reinterpret_cast<bf16*>(smem + 3 * S::H_TILE + S::S_TILE);
  float* sO = reinterpret_cast<float*>(smem + 3 * S::H_TILE + S::S_TILE + S::P_TILE);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qt * BM, off = kv_len - q_len;

  load_rows<D>(sQ, q, lq, b, h, q0, q_len);
  for (int i = threadIdx.x; i < BM * S::LDO; i += NTHREADS) sO[i] = 0.f;
  float m_i[16], l_i[16];  // running max and normaliser of the warp's rows
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_i[r] = NEG_INF;
    l_i[r] = 0.f;
  }

  const int n_kt = k_tiles(q0, q_len, kv_len, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_rows<D>(sK, k, lk, b, h, k0, kv_len);
    load_rows<D>(sV, v, lv, b, h, k0, kv_len);
    __syncthreads();
    mm_abt<D>(sS + r0 * S::LDS, S::LDS, sQ + r0 * S::LDH, sK);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r, qi = q0 + row;
      float s[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c, ki = k0 + col;
        const bool keep = ki < kv_len && (!causal || ki <= qi + off);
        s[c] = keep ? sS[row * S::LDS + col] * scale : NEG_INF;
      }
      const float m_new = fmaxf(m_i[r], warp_max(fmaxf(s[0], s[1])));
      const float alpha = expf(m_i[r] - m_new);
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      l_i[r] = alpha * l_i[r] + warp_sum(p0 + p1);
      m_i[r] = m_new;
      sP[row * S::LDP + lane] = __float2bfloat16(p0);
      sP[row * S::LDP + lane + 32] = __float2bfloat16(p1);
#pragma unroll
      for (int c = lane; c < D; c += 32) sO[row * S::LDO + c] *= alpha;
    }
    __syncwarp();
    Acc acc[D / 16];
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wmma::load_matrix_sync(acc[j], sO + r0 * S::LDO + j * 16, S::LDO, wmma::mem_row_major);
    mm_ab<D>(acc, sP + r0 * S::LDP, sV);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wmma::store_matrix_sync(sO + r0 * S::LDO + j * 16, acc[j], S::LDO, wmma::mem_row_major);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r, qi = q0 + row;
    if (qi >= q_len) break;
    const float l_safe = l_i[r] == 0.f ? 1.f : l_i[r];
    store_row<D>(o + out_row(b, qi, h, q_len, H, D), sO + row * S::LDO, l_safe, lane);
    if (lane == 0) lse[static_cast<int64_t>(bh) * q_len + qi] = m_i[r] + logf(l_safe);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout, Layout lq,
                    Layout lk, Layout lv, Layout ldo, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int H, int q_len,
                    int kv_len, float scale, int causal) {
  typedef Smem<D> S;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = reinterpret_cast<bf16*>(smem + S::H_TILE);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * S::H_TILE);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * S::H_TILE);
  float* sS = reinterpret_cast<float*>(smem + 4 * S::H_TILE);
  float* sdP = reinterpret_cast<float*>(smem + 4 * S::H_TILE + S::S_TILE);
  bf16* sdS = reinterpret_cast<bf16*>(smem + 4 * S::H_TILE + 2 * S::S_TILE);
  float* s_lse = reinterpret_cast<float*>(smem + 4 * S::H_TILE + 2 * S::S_TILE + S::P_TILE);
  float* s_delta = s_lse + BM;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qt * BM, off = kv_len - q_len;

  load_rows<D>(sQ, q, lq, b, h, q0, q_len);
  load_rows<D>(sdO, dout, ldo, b, h, q0, q_len);
  load_vec(s_lse, lse + static_cast<int64_t>(bh) * q_len, q0, q_len);
  load_vec(s_delta, delta + static_cast<int64_t>(bh) * q_len, q0, q_len);
  Acc acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  const int n_kt = k_tiles(q0, q_len, kv_len, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_rows<D>(sK, k, lk, b, h, k0, kv_len);
    load_rows<D>(sV, v, lv, b, h, k0, kv_len);
    __syncthreads();
    mm_abt<D>(sS + r0 * S::LDS, S::LDS, sQ + r0 * S::LDH, sK);
    mm_abt<D>(sdP + r0 * S::LDS, S::LDS, sdO + r0 * S::LDH, sV);
    __syncwarp();
#pragma unroll 4
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r, qi = q0 + row;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c, ki = k0 + col;
        const bool keep = ki < kv_len && qi < q_len && (!causal || ki <= qi + off);
        const float p = keep ? expf(sS[row * S::LDS + col] * scale - s_lse[row]) : 0.f;
        const float ds = p * (sdP[row * S::LDS + col] - s_delta[row]) * scale;
        sdS[row * S::LDP + col] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    mm_ab<D>(acc, sdS + r0 * S::LDP, sK);  // dQ += dS . K
  }
  __syncthreads();
  store_acc_rows<D>(acc, sS, dq, b, h, H, q_len, q0, r0, lane);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout, Layout lq,
                      Layout lk, Layout lv, Layout ldo, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, int q_len, int kv_len, float scale,
                      int causal) {
  typedef Smem<D> S;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + S::H_TILE);
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * S::H_TILE);
  bf16* sdO = reinterpret_cast<bf16*>(smem + 3 * S::H_TILE);
  float* sST = reinterpret_cast<float*>(smem + 4 * S::H_TILE);  // scores, keys x queries
  float* sdPT = reinterpret_cast<float*>(smem + 4 * S::H_TILE + S::S_TILE);
  bf16* sPT = reinterpret_cast<bf16*>(smem + 4 * S::H_TILE + 2 * S::S_TILE);
  bf16* sdST = reinterpret_cast<bf16*>(smem + 4 * S::H_TILE + 2 * S::S_TILE + S::P_TILE);
  float* s_lse =
      reinterpret_cast<float*>(smem + 4 * S::H_TILE + 2 * S::S_TILE + 2 * S::P_TILE);
  float* s_delta = s_lse + BM;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BN, off = kv_len - q_len;

  load_rows<D>(sK, k, lk, b, h, k0, kv_len);
  load_rows<D>(sV, v, lv, b, h, k0, kv_len);
  Acc dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }

  // First Q tile with a row that may see this K tile (the Pallas run condition).
  const int n_qt = (q_len + BM - 1) / BM;
  int qt_begin = 0;
  if (causal) {
    const int first = k0 - off - (BM - 1);
    qt_begin = first <= 0 ? 0 : (first + BM - 1) / BM;
  }
  for (int qt = qt_begin; qt < n_qt; ++qt) {
    const int q0 = qt * BM;
    __syncthreads();
    load_rows<D>(sQ, q, lq, b, h, q0, q_len);
    load_rows<D>(sdO, dout, ldo, b, h, q0, q_len);
    load_vec(s_lse, lse + static_cast<int64_t>(bh) * q_len, q0, q_len);
    load_vec(s_delta, delta + static_cast<int64_t>(bh) * q_len, q0, q_len);
    __syncthreads();
    // this warp's 16 keys against the tile's 64 queries
    mm_abt<D>(sST + r0 * S::LDS, S::LDS, sK + r0 * S::LDH, sQ);
    mm_abt<D>(sdPT + r0 * S::LDS, S::LDS, sV + r0 * S::LDH, sdO);
    __syncwarp();
#pragma unroll 4
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r, ki = k0 + row;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c, qi = q0 + col;
        const bool keep = ki < kv_len && qi < q_len && (!causal || ki <= qi + off);
        const float p = keep ? expf(sST[row * S::LDS + col] * scale - s_lse[col]) : 0.f;
        const float ds = p * (sdPT[row * S::LDS + col] - s_delta[col]) * scale;
        sPT[row * S::LDP + col] = __float2bfloat16(p);
        sdST[row * S::LDP + col] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    mm_ab<D>(dv_acc, sPT + r0 * S::LDP, sdO);  // dV += P^T . dO
    mm_ab<D>(dk_acc, sdST + r0 * S::LDP, sQ);  // dK += dS^T . Q
  }
  __syncthreads();
  store_acc_rows<D>(dv_acc, sST, dv, b, h, H, kv_len, k0, r0, lane);
  store_acc_rows<D>(dk_acc, sST, dk, b, h, H, kv_len, k0, r0, lane);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, Layout lq, Layout lk,
                       Layout lv, bf16* o, float* lse, int B, int H, int q_len, int kv_len,
                       float scale, int causal, cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, Smem<D>::FWD);
  if (err != cudaSuccess) return err;
  const dim3 grid((q_len + BM - 1) / BM, B * H);
  flash_fwd_kernel<D><<<grid, NTHREADS, Smem<D>::FWD, stream>>>(
      q, k, v, lq, lk, lv, o, lse, H, q_len, kv_len, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, Layout lq,
                      Layout lk, Layout lv, Layout ldo, const float* lse, const float* delta,
                      bf16* dq, int B, int H, int q_len, int kv_len, float scale, int causal,
                      cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, Smem<D>::DQ);
  if (err != cudaSuccess) return err;
  const dim3 grid((q_len + BM - 1) / BM, B * H);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, Smem<D>::DQ, stream>>>(
      q, k, v, dout, lq, lk, lv, ldo, lse, delta, dq, H, q_len, kv_len, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                        Layout lq, Layout lk, Layout lv, Layout ldo, const float* lse,
                        const float* delta, bf16* dk, bf16* dv, int B, int H, int q_len,
                        int kv_len, float scale, int causal, cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<D>, Smem<D>::DKDV);
  if (err != cudaSuccess) return err;
  const dim3 grid((kv_len + BN - 1) / BN, B * H);
  flash_bwd_dkdv_kernel<D><<<grid, NTHREADS, Smem<D>::DKDV, stream>>>(
      q, k, v, dout, lq, lk, lv, ldo, lse, delta, dk, dv, H, q_len, kv_len, scale, causal);
  return cudaGetLastError();
}

Layout layout(int sb, int st, int sh) { return Layout{sb, st, sh}; }

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; every stride is in
// elements of a [B, T, H, D] tensor with D stride 1. Each call returns the
// cudaError_t of its launch (0 on success).
extern "C" {

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int qsb, int qst,
              int qsh, int ksb, int kst, int ksh, int vsb, int vst, int vsh, int B, int H,
              int q_len, int kv_len, int head_dim, float scale, int causal, void* stream) {
  const Layout lq = layout(qsb, qst, qsh), lk = layout(ksb, kst, ksh), lv = layout(vsb, vst, vsh);
  const bf16 *bq = static_cast<const bf16*>(q), *bk = static_cast<const bf16*>(k),
             *bv = static_cast<const bf16*>(v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_fwd<64>(bq, bk, bv, lq, lk, lv, static_cast<bf16*>(o), static_cast<float*>(lse),
                          B, H, q_len, kv_len, scale, causal, s);
  if (head_dim == 128)
    return launch_fwd<128>(bq, bk, bv, lq, lk, lv, static_cast<bf16*>(o),
                           static_cast<float*>(lse), B, H, q_len, kv_len, scale, causal, s);
  return cudaErrorInvalidValue;
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dq, int qsb, int qst, int qsh, int ksb, int kst,
                 int ksh, int vsb, int vst, int vsh, int dsb, int dst, int dsh, int B, int H,
                 int q_len, int kv_len, int head_dim, float scale, int causal, void* stream) {
  const Layout lq = layout(qsb, qst, qsh), lk = layout(ksb, kst, ksh),
               lv = layout(vsb, vst, vsh), ld = layout(dsb, dst, dsh);
  const bf16 *bq = static_cast<const bf16*>(q), *bk = static_cast<const bf16*>(k),
             *bv = static_cast<const bf16*>(v), *bd = static_cast<const bf16*>(dout);
  const float *fl = static_cast<const float*>(lse), *fd = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_dq<64>(bq, bk, bv, bd, lq, lk, lv, ld, fl, fd, static_cast<bf16*>(dq), B, H,
                         q_len, kv_len, scale, causal, s);
  if (head_dim == 128)
    return launch_dq<128>(bq, bk, bv, bd, lq, lk, lv, ld, fl, fd, static_cast<bf16*>(dq), B, H,
                          q_len, kv_len, scale, causal, s);
  return cudaErrorInvalidValue;
}

int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int qsb, int qst,
                   int qsh, int ksb, int kst, int ksh, int vsb, int vst, int vsh, int dsb,
                   int dst, int dsh, int B, int H, int q_len, int kv_len, int head_dim,
                   float scale, int causal, void* stream) {
  const Layout lq = layout(qsb, qst, qsh), lk = layout(ksb, kst, ksh),
               lv = layout(vsb, vst, vsh), ld = layout(dsb, dst, dsh);
  const bf16 *bq = static_cast<const bf16*>(q), *bk = static_cast<const bf16*>(k),
             *bv = static_cast<const bf16*>(v), *bd = static_cast<const bf16*>(dout);
  const float *fl = static_cast<const float*>(lse), *fd = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_dkdv<64>(bq, bk, bv, bd, lq, lk, lv, ld, fl, fd, static_cast<bf16*>(dk),
                           static_cast<bf16*>(dv), B, H, q_len, kv_len, scale, causal, s);
  if (head_dim == 128)
    return launch_dkdv<128>(bq, bk, bv, bd, lq, lk, lv, ld, fl, fd, static_cast<bf16*>(dk),
                            static_cast<bf16*>(dv), B, H, q_len, kv_len, scale, causal, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
