// Paged flash-decode attention: for each slot b, kv-head h and query row
// (c, g), online-softmax attention over the keys the slot's block table
// maps, read in place from the pool in its storage tier:
//   out[b, c, h, g, :] = sum_k softmax_k(s) v_k,
//   s = cap * tanh(dot(q, k) * sm_scale / cap)   (no tanh when cap == 0),
// over keys with pos >= 0, pos <= q_pos (causal), pos > q_pos - window.
//
// Replaces: src/repro/kernels/attn_decode.py, flash_decode_paged
// (_make_kernel); flash_decode_contig reaches it through an identity table.
//
// Bound on the H100: at decode (C = 1, G query heads per kv-head) bytes —
// every admitted K/V row is used by only C*G query rows, so the kernel
// moves the codes and scales of those rows and does 4*C*G*Dh flops per row;
// at long prefill windows (C*G in the hundreds) the fp32 operations.
// Design:
// * A block owns (slot, kv-head, tile of 32 query rows) and walks the slot's
//   table entries in order itself, 32 keys at a time straight through the
//   table (a chunk may span several blocks of the pool); the running
//   (m, l, acc) of each query row lives in registers.  Blocks share nothing (no split-KV combine).  The
//   query-row tile keeps any C (1 at decode, 256 per prefill chunk, the
//   whole cache without chunking) within a fixed register and shared-memory
//   budget.
// * Bytes: the block stages the slot's table row in shared memory; the
//   first 32 threads read each chunk's pool_pos (one chunk ahead, so the
//   load overlaps the current chunk); a key is loaded only when its entry
//   is mapped and some row of the tile can see it (pos >= 0, the tile's
//   causal / window range), so unmapped entries, never-written rows and a
//   causal prefill tile's future move only their position words.  All K/V
//   loads of a chunk are in flight before the first shared-memory store,
//   and the dequant happens on the way in: int8 code * its 32-channel group
//   scale, 1-bit lane i of byte w -> element 8w+i, +alpha / -alpha —
//   device memory moves codes.
// * Operations: lane j scores key j of the chunk for one query row at a
//   time (the K tile is padded by one word per row, so the 32 lanes hit 32
//   banks; the query row is a broadcast), the warp reduces max and sum with
//   shuffles, and each lane accumulates Dh/32 output channels.  fp32 with
//   expf / tanhf throughout (no fast math).
// Masking follows the JAX kernel's NEG_INF = -2e38 convention, with masked
// keys left out of the softmax instead of scoring NEG_INF: for every row
// that sees at least one key the result is the same (JAX's junk weights
// from before the first visible key are wiped by exp(NEG_INF - m) == 0),
// and a row that sees none — junk for every caller — ends with l == 0 and
// emits acc / max(l, 1e-37) == 0, as an unmapped slot does in JAX.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kTileRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kChunk = 32;                        // keys per chunk (lanes)
constexpr float kNegInf = -2.0e38f;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kFp32 = 0, kBf16 = 1, kInt8 = 2, kBit1 = 3 };

struct Params {
  const int32_t* table;
  const float* q;
  const int32_t* q_pos;
  const void* pool_k;
  const void* pool_v;
  const float* k_scale;
  const float* v_scale;
  const int32_t* pool_pos;
  float* out;
  int c, kvh, g, dh, bs, bps, groups, causal, window;
  float sm_scale, cap;
};

// Element d of pool row `hr` = (block * bs + offset) * KVH + head, as fp32.
// int8 scales come in 32-channel groups, or one group when 32 does not
// divide Dh (kv_scale_groups).  Indices are 32-bit: the wrapper keeps every
// pool and scale array under 2^31 elements.
template <int KIND>
__device__ __forceinline__ float load_kv(const void* pool, const float* scale,
                                         int hr, int d, int dh, int groups) {
  if constexpr (KIND == kFp32) {
    return static_cast<const float*>(pool)[hr * dh + d];
  } else if constexpr (KIND == kBf16) {
    return __bfloat162float(
        static_cast<const __nv_bfloat16*>(pool)[hr * dh + d]);
  } else if constexpr (KIND == kInt8) {
    const float code = static_cast<float>(static_cast<const int8_t*>(pool)[hr * dh + d]);
    return code * scale[hr * groups + (groups == 1 ? 0 : d >> 5)];
  } else {
    const unsigned byte = static_cast<const uint8_t*>(pool)[hr * (dh / 8) + d / 8];
    const float alpha = scale[hr];
    return ((byte >> (d & 7)) & 1u) ? alpha : -alpha;
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// DPL = output channels per lane: ceil(Dh / 32).
template <int KIND, int DPL>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(Params p) {
  extern __shared__ float smem[];
  const int dh = p.dh;
  float* q_s = smem;                              // [kTileRows][dh]
  float* k_s = q_s + kTileRows * dh;              // [kChunk][dh + 1]
  float* v_s = k_s + kChunk * (dh + 1);           // [kChunk][dh]
  int* kpos_s = reinterpret_cast<int*>(v_s + kChunk * dh);  // [kChunk]
  int* krow_s = kpos_s + kChunk;                  // [kChunk], -1 = skip
  int* qpos_s = krow_s + kChunk;                  // [kTileRows]
  int* table_s = qpos_s + kTileRows;              // [bps]

  const int cg = p.c * p.g;
  const int n_tiles = (cg + kTileRows - 1) / kTileRows;
  const int tile = blockIdx.x % n_tiles;
  const int h = (blockIdx.x / n_tiles) % p.kvh;
  const int b = blockIdx.x / n_tiles / p.kvh;
  const int row0 = tile * kTileRows;
  const int n_rows = min(kTileRows, cg - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // stage the query tile (row r of the tile is (c, g) = divmod(row0 + r,
  // G)) and the slot's block table
  for (int e = tid; e < n_rows * dh; e += kThreads) {
    const int r = e / dh, d = e - r * dh;
    const int c = (row0 + r) / p.g, g = (row0 + r) - c * p.g;
    q_s[e] = p.q[((static_cast<long long>(b) * p.c + c) * p.kvh + h) * p.g * dh
                 + static_cast<long long>(g) * dh + d];
  }
  if (tid < n_rows) qpos_s[tid] = p.q_pos[static_cast<long long>(b) * p.c + (row0 + tid) / p.g];
  for (int j = tid; j < p.bps; j += kThreads)
    table_s[j] = p.table[static_cast<long long>(b) * p.bps + j];
  __syncthreads();
  int qp_min = qpos_s[0], qp_max = qpos_s[0];
  for (int r = 1; r < n_rows; ++r) {
    qp_min = min(qp_min, qpos_s[r]);
    qp_max = max(qp_max, qpos_s[r]);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[i][t] = 0.f;
  }

  // Lane `tid` of warp 0 owns key k0 + tid of each chunk: its pool row (-1
  // when unmapped) and, loaded one chunk ahead so that the load overlaps the
  // current chunk's work, its position.
  const int total = p.bps * p.bs;
  auto key_row = [&](int k0) {
    const int key = k0 + tid, jj = key / p.bs;
    if (tid >= kChunk || key >= total) return -1;
    const int blk = table_s[jj];
    return blk < 0 ? -1 : blk * p.bs + (key - jj * p.bs);
  };
  int next_row = key_row(0);
  int next_pos = next_row >= 0 ? p.pool_pos[next_row] : -1;
  for (int k0 = 0; k0 < total; k0 += kChunk) {
    const int nk = min(kChunk, total - k0);
    const int k_next = k0 + kChunk;
    int admitted = 0;
    if (tid < kChunk) {
      const int pos = next_pos;
      int row = next_row;
      bool ok = row >= 0 && pos >= 0;
      if (p.causal) ok = ok && pos <= qp_max;
      if (p.window > 0) ok = ok && pos > qp_min - p.window;
      kpos_s[tid] = pos;
      krow_s[tid] = ok ? row : -1;
      admitted = ok;
      if (k_next < total) {
        next_row = key_row(k_next);
        next_pos = next_row >= 0 ? p.pool_pos[next_row] : -1;
      }
    }
    if (!__syncthreads_or(admitted)) continue;

    // dequantize the chunk's admitted K/V rows into shared memory: the
    // loads are unconditional (a skipped key reads pool row 0 and is zeroed
    // after), so every load of the chunk is in flight before the first store
    constexpr int kPer = kChunk * 32 * DPL / kThreads;
    float kreg[kPer], vreg[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      const int j = min(e / dh, kChunk - 1), d = e % dh;
      const int hr = max(krow_s[j], 0) * p.kvh + h;
      kreg[i] = load_kv<KIND>(p.pool_k, p.k_scale, hr, d, dh, p.groups);
      vreg[i] = load_kv<KIND>(p.pool_v, p.v_scale, hr, d, dh, p.groups);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      const int j = e / dh, d = e % dh;
      if (j < kChunk) {
        const bool keep = krow_s[j] >= 0;
        k_s[j * (dh + 1) + d] = keep ? kreg[i] : 0.f;
        v_s[j * dh + d] = keep ? vreg[i] : 0.f;
      }
    }
    __syncthreads();

    const int krow = krow_s[lane], kp = kpos_s[lane];
    const float* kr = k_s + lane * (dh + 1);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kWarps;
      if (r >= n_rows) continue;  // warp-uniform
      const int qp = qpos_s[r];
      bool valid = krow >= 0;
      if (p.causal) valid = valid && kp <= qp;
      if (p.window > 0) valid = valid && kp > qp - p.window;
      if (!__any_sync(kFull, valid)) continue;  // row r sees no key here
      float s = kNegInf;
      if (valid) {
        const float* qr = q_s + r * dh;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * p.sm_scale;
        if (p.cap > 0.f) s = p.cap * tanhf(s / p.cap);
      }
      const float m_new = fmaxf(m[i], warp_max(s));
      const float alpha = expf(m[i] - m_new);
      const float pj = valid ? expf(s - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(pj);
      float pv[DPL];
#pragma unroll
      for (int t = 0; t < DPL; ++t) pv[t] = 0.f;
      for (int j = 0; j < nk; ++j) {
        const float w = __shfl_sync(kFull, pj, j);
        if (w == 0.f) continue;  // warp-uniform: w is a broadcast
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          const int d = lane + 32 * t;
          if (d < dh) pv[t] = fmaf(w, v_s[j * dh + d], pv[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[i][t] = acc[i][t] * alpha + pv[t];
      m[i] = m_new;
    }
    __syncthreads();  // the next chunk overwrites the tiles
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps;
    if (r < n_rows) {
      const int c = (row0 + r) / p.g, g = (row0 + r) - c * p.g;
      float* o = p.out + ((static_cast<long long>(b) * p.c + c) * p.kvh + h) * p.g * dh
                 + static_cast<long long>(g) * dh;
      const float denom = fmaxf(l[i], 1e-37f);
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int d = lane + 32 * t;
        if (d < dh) o[d] = acc[i][t] / denom;
      }
    }
  }
}

template <int KIND, int DPL>
cudaError_t launch(const Params& p, long long blocks, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(kTileRows) * p.dh
                                       + static_cast<size_t>(kChunk) * (p.dh + 1)
                                       + static_cast<size_t>(kChunk) * p.dh)
                      + sizeof(int) * (2 * kChunk + kTileRows + p.bps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<KIND, DPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  flash_decode_kernel<KIND, DPL><<<static_cast<unsigned>(blocks), kThreads,
                                   smem, stream>>>(p);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_kind(const Params& p, long long blocks,
                        cudaStream_t stream) {
  if (p.dh <= 32) return launch<KIND, 1>(p, blocks, stream);
  if (p.dh <= 64) return launch<KIND, 2>(p, blocks, stream);
  if (p.dh <= 128) return launch<KIND, 4>(p, blocks, stream);
  return launch<KIND, 8>(p, blocks, stream);
}

}  // namespace

// kind: 0 fp32 pool, 1 bf16 pool, 2 int8 codes + group scales, 3 sign bytes
// + per-head alpha.  cap == 0: no softcap; window == 0: no window.
extern "C" int repro_flash_decode(
    const int32_t* table, const float* q, const int32_t* q_pos,
    const void* pool_k, const void* pool_v, const float* k_scale,
    const float* v_scale, const int32_t* pool_pos, float* out, long long b,
    long long c, long long kvh, long long g, long long dh, long long nb,
    long long bs, long long bps, int kind, float sm_scale, float cap,
    int causal, int window, cudaStream_t stream) {
  (void)nb;
  if (dh < 1 || dh > 256 || (kind == kBit1 && dh % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{table, q, q_pos, pool_k, pool_v, k_scale, v_scale, pool_pos, out,
           static_cast<int>(c), static_cast<int>(kvh), static_cast<int>(g),
           static_cast<int>(dh), static_cast<int>(bs), static_cast<int>(bps),
           dh % 32 == 0 ? static_cast<int>(dh / 32) : 1, causal, window,
           sm_scale, cap};
  const long long tiles = (c * g + kTileRows - 1) / kTileRows;
  const long long blocks = b * kvh * tiles;
  cudaError_t err;
  switch (kind) {
    case kFp32: err = launch_kind<kFp32>(p, blocks, stream); break;
    case kBf16: err = launch_kind<kBf16>(p, blocks, stream); break;
    case kInt8: err = launch_kind<kInt8>(p, blocks, stream); break;
    case kBit1: err = launch_kind<kBit1>(p, blocks, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
