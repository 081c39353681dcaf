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
// The TPU kernels carry their accumulators across a sequential grid axis; here that
// axis is a loop inside one thread block, and the causal run condition of the
// Pallas kernels is the loop's bound, so tiles right of the diagonal cost nothing.
//
// Bounds at the training shape (B=8, T=1024, H=12, D=64, bf16, causal) on an H100
// SXM (3.35 TB/s, 989 TFLOP/s dense bf16), counting each input read once and each
// output written once, and only the query/key pairs the causal mask keeps:
//   forward: ~50 MB -> ~15 us;  ~12.9 GFLOP -> ~13 us.   Bound by bytes, barely.
//   dK/dV:   ~76 MB -> ~23 us;  ~25.8 GFLOP -> ~26 us.   Bound by operations.
//   dQ:      ~63 MB -> ~19 us;  ~19.3 GFLOP -> ~19.5 us. Bound by operations.
// All three sit near the ridge, so a kernel must both keep the score matrix out of
// device memory and keep the tensor cores fed.
//
// All three are warp-specialised wgmma kernels (hopper.cuh has the blocks). A
// block is three warpgroups. Warpgroups 0 and 1 consume: each owns 64 rows of the
// block's resident tile (query rows in the forward and dQ, keys in dK/dV), issues
// its products with wgmma and keeps its scores and accumulators in registers for
// the whole loop; they take 232 registers a thread with setmaxnreg. Warpgroup 2
// produces: it drops to 40 registers and one of its threads streams the other
// operands' tiles in by TMA (128-byte swizzle, straight from the strided
// [B, T, H, D] tensors) through a ring of full/empty mbarriers, so the next tile's
// copy overlaps this tile's products. The resident tile comes in once, by TMA too.
//   forward: S = Q.K^T (both operands in shared memory) -> online softmax on the
//     accumulator layout (quad shuffles, exp2 with scale*log2(e) folded in, masks
//     only on tiles that cross the diagonal or the ragged end) -> P as bf16
//     registers -> O += P.V (P the register operand, V read transposed). The
//     block is persistent, one per SM, and walks 128-row Q tiles longest first,
//     so the next tile's Q and K/V loads overlap this one's last products and
//     epilogue (10% faster than a block per tile at the training shape on the
//     H100). Issuing tile j+1's scores before tile j's P.V, to overlap the
//     softmax with the tensor cores inside a warpgroup, measured slower there:
//     the two consumer warpgroups already interleave.
//   dK/dV: S^T = K.Q^T and dP^T = V.dO^T -> P^T and dS^T in registers, with lse
//     and delta per query column -> dV += P^T.dO and dK += dS^T.Q. One block per
//     128-key tile, the tiles with the most causal rows first.
//   dQ: the forward's persistent walk over 128-row Q tiles, with Q and dO
//     resident and K and V streamed. S = Q.K^T and dP = dO.V^T from shared memory
//     -> one pass on the accumulator layout, with each row's lse and delta in
//     registers: p = exp2(s * scale * log2(e) - lse * log2(e)), masked only on
//     tiles that cross the diagonal or kv_len, ds = p * (dp - delta) * scale ->
//     dS as bf16 registers -> dQ += dS.K, K read transposed from the same shared
//     tile the scores read, so one K tile serves both products. 128 keys a tile
//     at D=64; 64 at D=128, where dQ alone takes 64 registers a thread.
// No fp32 score or accumulator tile touches shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;  // the Pallas kernels' finite mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// flash_error_string's code for a tensor map the driver refused
constexpr int TENSOR_MAP_ERROR = 10000;

struct Layout {  // element strides of a [B, T, H, D] tensor whose D stride is 1
  int64_t b, t, h;
};

__device__ __forceinline__ int64_t out_row(int b, int t, int h, int T, int H, int D) {
  return ((static_cast<int64_t>(b) * T + t) * H + h) * D;
}

// Number of K tiles of bn keys a Q tile of bm rows starting at q0 visits: a K tile
// strictly right of the tile's last row is skipped, as in the Pallas kernels.
__device__ __forceinline__ int k_tiles(int q0, int bm, int bn, int q_len, int kv_len,
                                       int causal) {
  int n = (kv_len + bn - 1) / bn;
  if (causal) {
    const int last = q0 + bm - 1 + kv_len - q_len;
    n = min(n, last < 0 ? 0 : last / bn + 1);
  }
  return n;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t align1024(uint32_t a) { return (a + 1023) & ~1023u; }

// Rows of a warpgroup's [64, D] accumulator to a contiguous [B, T, H, D] bf16
// output, each multiplied by its row's factor; rows at or past n_rows are dropped.
template <int D>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 2], bf16* out, int b, int h,
                                          int H, int n_rows, int row_a, float f0, float f1) {
  const int col0 = (threadIdx.x % 4) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = row_a + 8 * half;
    if (t >= n_rows) continue;
    const float f = half ? f1 : f0;
    bf16* dst = out + out_row(b, t, h, n_rows, H, D) + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(acc[4 * j + 2 * half] * f, acc[4 * j + 2 * half + 1] * f);
  }
}

constexpr int WS_THREADS = 384;   // two consumer warpgroups and one producer warpgroup
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_THREAD = 256;
constexpr int CONSUMER_REGS = 232;  // 2 x 128 x 232 + 128 x 40 <= 65536
constexpr int PRODUCER_REGS = 40;

// ---- forward -------------------------------------------------------------------

template <int D>
struct Fwd {
  static constexpr int BM = 128;  // query rows per block, 64 per consumer warpgroup
  static constexpr int BN = 128;  // keys per streamed tile
  static constexpr int STAGES = D == 64 ? 3 : 2;  // as many as shared memory holds
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;        // stage s: K, then V
  static constexpr int BAR_OFF = K_OFF + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (2 + 2 * STAGES) + 1024;  // + alignment slack
};

// Work item w of a persistent forward or dQ block: Q tiles in order of decreasing
// causal length (the longest rows first, so the grid's tail is short), then (b, h).
struct QTileWork {
  int q0, bh, b, h;
  __device__ QTileWork(int w, int BH, int H, int n_qt, int bm) {
    bh = w % BH;
    q0 = (n_qt - 1 - w / BH) * bm;
    b = bh / H;
    h = bh % H;
  }
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                 float* __restrict__ lse, int BH, int H, int q_len, int kv_len, float scale_log2,
                 int causal) {
  typedef Fwd<D> C;
  extern __shared__ unsigned char smem[];
  const uint32_t base = align1024(smem_u32(smem));
  const uint32_t sQ = base, bar = base + C::BAR_OFF;
  const uint32_t q_full = bar, q_empty = bar + 8;
  auto full = [&](int s) { return bar + 8 * (2 + s); };
  auto empty = [&](int s) { return bar + 8 * (2 + C::STAGES + s); };
  auto stage_k = [&](int s) { return base + C::K_OFF + s * 2 * C::KV_BYTES; };

  const int n_qt = (q_len + C::BM - 1) / C::BM, n_work = n_qt * BH, off = kv_len - q_len;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMER_WARPS);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // The block walks work items w = blockIdx.x, + gridDim.x, ...; the K/V ring's
  // counter g runs on across them, so the next item's loads start while the
  // consumers still finish this one.
  if (threadIdx.x >= PRODUCER_THREAD) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == PRODUCER_THREAD) {
      int g = 0, item = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++item) {
        const QTileWork it(w, BH, H, n_qt, C::BM);
        mbar_wait(q_empty, (item & 1) ^ 1);
        mbar_arrive_expect_tx(q_full, C::Q_BYTES);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sQ + c * C::BM * 128, &tm_q, q_full, 64 * c, it.q0, it.h, it.b);
        const int n_kt = k_tiles(it.q0, C::BM, C::BN, q_len, kv_len, causal);
        for (int kt = 0; kt < n_kt; ++kt, ++g) {
          const int s = g % C::STAGES;
          mbar_wait(empty(s), ((g / C::STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(full(s), 2 * C::KV_BYTES);
          const uint32_t sK = stage_k(s), sV = sK + C::KV_BYTES;
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(sK + c * C::BN * 128, &tm_k, full(s), 64 * c, kt * C::BN, it.h, it.b);
            tma_load_4d(sV + c * C::BN * 128, &tm_v, full(s), 64 * c, kt * C::BN, it.h, it.b);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
    const int row_a = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // and row_a + 8
    const int col0 = (lane % 4) * 2;
    const uint32_t sQw = sQ + wg * 64 * 128;
    float o_acc[D / 2], s_acc[C::BN / 2];

    int g = 0, item = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++item) {
      const QTileWork it(w, BH, H, n_qt, C::BM);
      const int q0 = it.q0, qr0 = q0 + wg * 64;  // the warpgroup's first query row
      const int n_kt = k_tiles(q0, C::BM, C::BN, q_len, kv_len, causal);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's partial sums

      mbar_wait(q_full, item & 1);
      for (int kt = 0; kt < n_kt; ++kt, ++g) {
        const int s = g % C::STAGES, k0 = kt * C::BN;
        mbar_wait(full(s), (g / C::STAGES) & 1);

        fence_regs(s_acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          Wgmma<C::BN>::ss(s_acc, desc_k_major(sQw, C::BM, k),
                           desc_k_major(stage_k(s), C::BN, k), k > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s_acc);

        // p = 2^(s * scale * log2(e) - m), m the running row maximum in those units.
        // Only a tile that crosses the diagonal or kv_len is scaled and masked
        // first; any other is exponentiated from the raw scores by one fma (scale
        // > 0, so the raw maximum scales to the scaled one).
        const bool need_mask = k0 + C::BN > kv_len || (causal && k0 + C::BN - 1 > qr0 + off);
        if (need_mask) {
#pragma unroll
          for (int i = 0; i < C::BN / 2; ++i) {
            const int ki = k0 + 8 * (i / 4) + col0 + (i & 1);
            const int qi = q0 + row_a + 8 * ((i / 2) & 1);
            const bool keep = ki < kv_len && (!causal || ki <= qi + off);
            s_acc[i] = keep ? s_acc[i] * scale_log2 : NEG_INF;
          }
        }
        const float c = need_mask ? 1.f : scale_log2;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < C::BN / 2; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s_acc[i]);
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(m[r], quad_max(mx[r]) * c);
          alpha[r] = exp2_approx(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < C::BN / 2; ++i) {
          const float p = exp2_approx(fmaf(s_acc[i], c, -mx[(i / 2) & 1]));
          l[(i / 2) & 1] += p;
          s_acc[i] = p;
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o_acc[i] *= alpha[(i / 2) & 1];

        fence_regs(o_acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < C::BN / 16; ++k) {
          uint32_t a[4];
          acc_to_a(s_acc, k, a);
          Wgmma<D>::rs(o_acc, a, desc_mn_major(stage_k(s) + C::KV_BYTES, C::BN, k), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o_acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
      }
      __syncwarp();  // every score product has read Q: the producer may load the next
      if (lane == 0) mbar_arrive(q_empty);

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l_row = quad_sum(l[r]);
        const float l_safe = l_row == 0.f ? 1.f : l_row;
        inv[r] = 1.f / l_safe;
        const int qi = q0 + row_a + 8 * r;
        // m is in log2 units; the sentinel of a row that saw no key stays -1e30
        if (lane % 4 == 0 && qi < q_len)
          lse[static_cast<int64_t>(it.bh) * q_len + qi] =
              (m[r] == NEG_INF ? NEG_INF : m[r] * LN2) + logf(l_safe);
      }
      store_acc<D>(o_acc, o, it.b, it.h, H, q_len, q0 + row_a, inv[0], inv[1]);
    }
  }
}

// ---- dK/dV ---------------------------------------------------------------------

template <int D>
struct Dkdv {
  static constexpr int BK = 128;               // keys per block, 64 per consumer warpgroup
  static constexpr int BQ = D == 64 ? 64 : 32;  // query rows per streamed tile (registers)
  static constexpr int STAGES = 3;
  static constexpr int KV_BYTES = BK * D * 2;  // the K or the V tile
  static constexpr int T_BYTES = BQ * D * 2;   // one streamed Q or dO tile
  static constexpr int STAGE_OFF = 2 * KV_BYTES;  // stage s: Q, then dO
  static constexpr int VEC_OFF = STAGE_OFF + STAGES * 2 * T_BYTES;  // stage s: lse*log2e, delta
  static constexpr int BAR_OFF = VEC_OFF + STAGES * 2 * BQ * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, int q_len, int kv_len, float scale,
                      float scale_log2, int causal) {
  typedef Dkdv<D> C;
  extern __shared__ unsigned char smem[];
  const uint32_t raw = smem_u32(smem), base = align1024(raw);
  float* vec = reinterpret_cast<float*>(smem + (base - raw) + C::VEC_OFF);
  const uint32_t sK = base, sV = base + C::KV_BYTES, bar_kv = base + C::BAR_OFF;
  auto full = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8 * (1 + C::STAGES + s); };
  auto stage_q = [&](int s) { return base + C::STAGE_OFF + s * 2 * C::T_BYTES; };

  // blocks start in order of x, then y: the K tiles with the most causal rows first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * C::BK, off = kv_len - q_len;
  // First Q tile with a row that may see this K tile (the Pallas run condition).
  const int n_qt = (q_len + C::BQ - 1) / C::BQ;
  int qt_begin = 0;
  if (causal) {
    const int first = k0 - off - (C::BQ - 1);
    qt_begin = first <= 0 ? 0 : (first + C::BQ - 1) / C::BQ;
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= PRODUCER_THREAD) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < PRODUCER_THREAD + 32) {  // one warp: TMA from lane 0, lse/delta from all
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_kv, 2 * C::KV_BYTES);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sK + c * C::BK * 128, &tm_k, bar_kv, 64 * c, k0, h, b);
          tma_load_4d(sV + c * C::BK * 128, &tm_v, bar_kv, 64 * c, k0, h, b);
        }
      }
      const float* lse_bh = lse + static_cast<int64_t>(bh) * q_len;
      const float* delta_bh = delta + static_cast<int64_t>(bh) * q_len;
      for (int qt = qt_begin; qt < n_qt; ++qt) {
        const int it = qt - qt_begin, s = it % C::STAGES, q0 = qt * C::BQ;
        mbar_wait(empty(s), ((it / C::STAGES) & 1) ^ 1);
        float* v = vec + s * 2 * C::BQ;
        for (int i = lane; i < C::BQ; i += 32) {
          const bool in = q0 + i < q_len;
          v[i] = in ? lse_bh[q0 + i] * LOG2E : 0.f;
          v[C::BQ + i] = in ? delta_bh[q0 + i] : 0.f;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(full(s), 2 * C::T_BYTES);
          const uint32_t sQ = stage_q(s), sdO = sQ + C::T_BYTES;
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(sQ + c * C::BQ * 128, &tm_q, full(s), 64 * c, q0, h, b);
            tma_load_4d(sdO + c * C::BQ * 128, &tm_do, full(s), 64 * c, q0, h, b);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
    const int row_a = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // and row_a + 8
    const int col0 = (lane % 4) * 2;
    const int kw0 = k0 + wg * 64;  // the warpgroup's first key
    const uint32_t sKw = sK + wg * 64 * 128, sVw = sV + wg * 64 * 128;

    float dk_acc[D / 2], dv_acc[D / 2], st[C::BQ / 2], dpt[C::BQ / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int qt = qt_begin; qt < n_qt; ++qt) {
      const int it = qt - qt_begin, s = it % C::STAGES, q0 = qt * C::BQ;
      mbar_wait(full(s), (it / C::STAGES) & 1);
      const uint32_t sQ = stage_q(s), sdO = sQ + C::T_BYTES;
      const float* v = vec + s * 2 * C::BQ;

      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k)  // S^T = K . Q^T: this warpgroup's keys x the tile's queries
        Wgmma<C::BQ>::ss(st, desc_k_major(sKw, C::BK, k), desc_k_major(sQ, C::BQ, k), k > 0);
#pragma unroll
      for (int k = 0; k < D / 16; ++k)  // dP^T = V . dO^T
        Wgmma<C::BQ>::ss(dpt, desc_k_major(sVw, C::BK, k), desc_k_major(sdO, C::BQ, k), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      const bool need_mask = q0 + C::BQ > q_len || kw0 + 64 > kv_len ||
                             (causal && kw0 + 63 > q0 + off);
#pragma unroll
      for (int i = 0; i < C::BQ / 2; ++i) {
        const int col = 8 * (i / 4) + col0 + (i & 1);  // query column within the tile
        float p = exp2_approx(fmaf(st[i], scale_log2, -v[col]));
        if (need_mask) {
          const int ki = k0 + row_a + 8 * ((i / 2) & 1), qi = q0 + col;
          if (ki >= kv_len || qi >= q_len || (causal && ki > qi + off)) p = 0.f;
        }
        dpt[i] = p * (dpt[i] - v[C::BQ + col]) * scale;
        st[i] = p;
      }

      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < C::BQ / 16; ++k) {  // dV += P^T . dO
        uint32_t a[4];
        acc_to_a(st, k, a);
        Wgmma<D>::rs(dv_acc, a, desc_mn_major(sdO, C::BQ, k), 1);
      }
#pragma unroll
      for (int k = 0; k < C::BQ / 16; ++k) {  // dK += dS^T . Q
        uint32_t a[4];
        acc_to_a(dpt, k, a);
        Wgmma<D>::rs(dk_acc, a, desc_mn_major(sQ, C::BQ, k), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }
    store_acc<D>(dv_acc, dv, b, h, H, kv_len, k0 + row_a, 1.f, 1.f);
    store_acc<D>(dk_acc, dk, b, h, H, kv_len, k0 + row_a, 1.f, 1.f);
  }
}

// ---- dQ ------------------------------------------------------------------------

template <int D>
struct Dq {
  static constexpr int BM = 128;  // query rows per work item, 64 per consumer warpgroup
  static constexpr int BN = D == 64 ? 128 : 64;  // keys per streamed tile (registers)
  static constexpr int STAGES = 2;  // 2% faster than 4 at the training shape on the H100
  static constexpr int Q_BYTES = BM * D * 2;   // the Q or the dO tile
  static constexpr int KV_BYTES = BN * D * 2;  // one K or V tile
  static constexpr int K_OFF = 2 * Q_BYTES;    // stage s: K, then V
  static constexpr int BAR_OFF = K_OFF + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (2 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int BH, int H,
                    int q_len, int kv_len, float scale, float scale_log2, int causal) {
  typedef Dq<D> C;
  extern __shared__ unsigned char smem[];
  const uint32_t base = align1024(smem_u32(smem));
  const uint32_t sQ = base, sdO = base + C::Q_BYTES, bar = base + C::BAR_OFF;
  const uint32_t q_full = bar, q_empty = bar + 8;  // guard the resident Q and dO tiles
  auto full = [&](int s) { return bar + 8 * (2 + s); };
  auto empty = [&](int s) { return bar + 8 * (2 + C::STAGES + s); };
  auto stage_k = [&](int s) { return base + C::K_OFF + s * 2 * C::KV_BYTES; };

  const int n_qt = (q_len + C::BM - 1) / C::BM, n_work = n_qt * BH, off = kv_len - q_len;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMER_WARPS);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= PRODUCER_THREAD) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == PRODUCER_THREAD) {
      int g = 0, item = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++item) {
        const QTileWork it(w, BH, H, n_qt, C::BM);
        mbar_wait(q_empty, (item & 1) ^ 1);
        mbar_arrive_expect_tx(q_full, 2 * C::Q_BYTES);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sQ + c * C::BM * 128, &tm_q, q_full, 64 * c, it.q0, it.h, it.b);
          tma_load_4d(sdO + c * C::BM * 128, &tm_do, q_full, 64 * c, it.q0, it.h, it.b);
        }
        const int n_kt = k_tiles(it.q0, C::BM, C::BN, q_len, kv_len, causal);
        for (int kt = 0; kt < n_kt; ++kt, ++g) {
          const int s = g % C::STAGES;
          mbar_wait(empty(s), ((g / C::STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(full(s), 2 * C::KV_BYTES);
          const uint32_t sK = stage_k(s), sV = sK + C::KV_BYTES;
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(sK + c * C::BN * 128, &tm_k, full(s), 64 * c, kt * C::BN, it.h, it.b);
            tma_load_4d(sV + c * C::BN * 128, &tm_v, full(s), 64 * c, kt * C::BN, it.h, it.b);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
    const int row_a = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // and row_a + 8
    const int col0 = (lane % 4) * 2;
    const uint32_t sQw = sQ + wg * 64 * 128, sdOw = sdO + wg * 64 * 128;
    float dq_acc[D / 2], s_acc[C::BN / 2], dp_acc[C::BN / 2];
    // Q and dO are read for the last time by an item's last score products: the
    // producer may then load the next item's while the last dS.K runs
    auto release_q = [&] {
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty);
    };

    int g = 0, item = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++item) {
      const QTileWork it(w, BH, H, n_qt, C::BM);
      const int q0 = it.q0, qr0 = q0 + wg * 64;  // the warpgroup's first query row
      const int n_kt = k_tiles(q0, C::BM, C::BN, q_len, kv_len, causal);
      // the thread's two rows' lse in log2 units and delta; rows at or past q_len
      // read 0 (they are never stored, and their zero Q and dO rows give ds = 0)
      float lse2[2], dlt[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = q0 + row_a + 8 * r;
        const int64_t at = static_cast<int64_t>(it.bh) * q_len + qi;
        lse2[r] = qi < q_len ? lse[at] * LOG2E : 0.f;
        dlt[r] = qi < q_len ? delta[at] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

      mbar_wait(q_full, item & 1);
      for (int kt = 0; kt < n_kt; ++kt, ++g) {
        const int s = g % C::STAGES, k0 = kt * C::BN;
        mbar_wait(full(s), (g / C::STAGES) & 1);
        const uint32_t sK = stage_k(s), sV = sK + C::KV_BYTES;

        fence_regs(s_acc);
        fence_regs(dp_acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)  // S = Q.K^T
          Wgmma<C::BN>::ss(s_acc, desc_k_major(sQw, C::BM, k), desc_k_major(sK, C::BN, k), k > 0);
#pragma unroll
        for (int k = 0; k < D / 16; ++k)  // dP = dO.V^T
          Wgmma<C::BN>::ss(dp_acc, desc_k_major(sdOw, C::BM, k), desc_k_major(sV, C::BN, k), k > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s_acc);
        fence_regs(dp_acc);
        if (kt == n_kt - 1) release_q();

        // Only a tile that crosses the diagonal or kv_len is masked. A row that sees
        // no key (causal, q_len > kv_len) has lse = -1e30, and exp2 gives +inf for
        // it; every tile of its warpgroup crosses the diagonal, so the mask always
        // replaces that by 0. Keys past kv_len, zero-filled by TMA, are masked too.
        const bool need_mask = k0 + C::BN > kv_len || (causal && k0 + C::BN - 1 > qr0 + off);
#pragma unroll
        for (int i = 0; i < C::BN / 2; ++i) {
          const int r = (i / 2) & 1;
          float p = exp2_approx(fmaf(s_acc[i], scale_log2, -lse2[r]));
          if (need_mask) {
            const int ki = k0 + 8 * (i / 4) + col0 + (i & 1), qi = q0 + row_a + 8 * r;
            if (ki >= kv_len || (causal && ki > qi + off)) p = 0.f;
          }
          s_acc[i] = p * (dp_acc[i] - dlt[r]) * scale;  // dS, in place of S
        }

        fence_regs(dq_acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < C::BN / 16; ++k) {  // dQ += dS.K, K read transposed
          uint32_t a[4];
          acc_to_a(s_acc, k, a);
          Wgmma<D>::rs(dq_acc, a, desc_mn_major(sK, C::BN, k), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq_acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
      }
      if (n_kt == 0) release_q();  // a Q tile whose rows see no key: dQ = 0
      store_acc<D>(dq_acc, dq, it.b, it.h, H, q_len, q0 + row_a, 1.f, 1.f);
    }
  }
}

// ---- launches ---------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
bool map(CUtensorMap* m, const bf16* x, Layout L, int B, int T, int H, int rows) {
  return bthd_map(m, x, L.b, L.t, L.h, B, T, H, D, rows);
}

// Streaming multiprocessors of the current device: the persistent kernels' grid.
cudaError_t sm_count(int* n_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
}

template <int D>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, Layout lq, Layout lk, Layout lv,
               bf16* o, float* lse, int B, int H, int q_len, int kv_len, float scale, int causal,
               cudaStream_t stream) {
  typedef Fwd<D> C;
  CUtensorMap mq, mk, mv;
  if (!map<D>(&mq, q, lq, B, q_len, H, C::BM) || !map<D>(&mk, k, lk, B, kv_len, H, C::BN) ||
      !map<D>(&mv, v, lv, B, kv_len, H, C::BN))
    return TENSOR_MAP_ERROR;
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, C::SMEM);
  int n_sm = 0;
  if (err != cudaSuccess || (err = sm_count(&n_sm)) != cudaSuccess) return err;
  const int n_work = (q_len + C::BM - 1) / C::BM * B * H;  // one resident block per SM
  flash_fwd_kernel<D><<<min(n_work, n_sm), WS_THREADS, C::SMEM, stream>>>(
      mq, mk, mv, o, lse, B * H, H, q_len, kv_len, scale * LOG2E, causal);
  return cudaGetLastError();
}

template <int D>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, Layout lq,
              Layout lk, Layout lv, Layout ldo, const float* lse, const float* delta, bf16* dq,
              int B, int H, int q_len, int kv_len, float scale, int causal, cudaStream_t stream) {
  typedef Dq<D> C;
  CUtensorMap mq, mk, mv, mdo;
  if (!map<D>(&mq, q, lq, B, q_len, H, C::BM) || !map<D>(&mdo, dout, ldo, B, q_len, H, C::BM) ||
      !map<D>(&mk, k, lk, B, kv_len, H, C::BN) || !map<D>(&mv, v, lv, B, kv_len, H, C::BN))
    return TENSOR_MAP_ERROR;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, C::SMEM);
  int n_sm = 0;
  if (err != cudaSuccess || (err = sm_count(&n_sm)) != cudaSuccess) return err;
  const int n_work = (q_len + C::BM - 1) / C::BM * B * H;  // one resident block per SM
  flash_bwd_dq_kernel<D><<<min(n_work, n_sm), WS_THREADS, C::SMEM, stream>>>(
      mq, mk, mv, mdo, lse, delta, dq, B * H, H, q_len, kv_len, scale, scale * LOG2E, causal);
  return cudaGetLastError();
}

template <int D>
int launch_dkdv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, Layout lq,
                Layout lk, Layout lv, Layout ldo, const float* lse, const float* delta, bf16* dk,
                bf16* dv, int B, int H, int q_len, int kv_len, float scale, int causal,
                cudaStream_t stream) {
  typedef Dkdv<D> C;
  CUtensorMap mq, mk, mv, mdo;
  if (!map<D>(&mq, q, lq, B, q_len, H, C::BQ) || !map<D>(&mdo, dout, ldo, B, q_len, H, C::BQ) ||
      !map<D>(&mk, k, lk, B, kv_len, H, C::BK) || !map<D>(&mv, v, lv, B, kv_len, H, C::BK))
    return TENSOR_MAP_ERROR;
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<D>, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (kv_len + C::BK - 1) / C::BK);
  flash_bwd_dkdv_kernel<D><<<grid, WS_THREADS, C::SMEM, stream>>>(
      mq, mk, mv, mdo, lse, delta, dk, dv, H, q_len, kv_len, scale, scale * LOG2E, causal);
  return cudaGetLastError();
}

Layout layout(int sb, int st, int sh) { return Layout{sb, st, sh}; }

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; every stride is in
// elements of a [B, T, H, D] tensor with D stride 1. Each call returns the
// cudaError_t of its launch (0 on success), or TENSOR_MAP_ERROR if the driver
// refused a tensor map.
extern "C" {

const char* flash_error_string(int code) {
  if (code == TENSOR_MAP_ERROR) return "cuTensorMapEncodeTiled refused a tensor map";
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
