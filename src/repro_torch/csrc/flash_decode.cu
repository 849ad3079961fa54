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
// The C entry point picks one of two tiles from static shapes only:
//
// * Decode tile (C*G <= kDecodeRows, or a head the window tile does not
//   take): split-KV.  A block owns (slot, kv-head, 4 query rows, one range
//   of `split_keys` keys of the table span); the plan (split count and
//   range length) comes from the wrapper, which sizes it from B*KVH and the
//   span so that the grid holds 4 blocks per SM — never from lengths.  A
//   block walks its range straight through the block table: a first pass
//   reads the range's position words (256 keys at a time) and compacts the
//   keys that some row of the block can see; a range with none exits after
//   that pass.  The admitted keys' raw K / V rows and scales then stream
//   through a 2-3 stage cp.async ring in chunks of 32 or 64 keys (16-byte
//   copies where rows allow), so later chunks are in flight while one is
//   scored.  Warp w owns query row w (all rows share each staged K/V row):
//   lane j scores keys j and j + 32 of the chunk against the row, which
//   sits in shared memory and is read as a broadcast, dequantizing K on the
//   way (int8 scale per 16-code unit, 1-bit as +-q sums times alpha); the
//   row's max reduces over the warp, its sum stays per lane until the end;
//   then lane j accumulates P V for its consecutive channels with one
//   vector read per key, in two chains.  A block writes its partial (m, l,
//   acc) to the workspace — or, with one split, the normalised rows to
//   `out` — and a second kernel merges each row's splits in split order.
//   No atomics: the output repeats bit for bit.
// * Window tile (C*G > kDecodeRows, Dh a multiple of 16 up to 128): a
//   block owns (slot, kv-head, 64 query rows) and walks the whole span.
//   Position words are staged 512 keys at a time, with one admitted flag
//   per 64-key stage; a stage no row of the tile can see (past its causal
//   limit, before its window, unwritten) is neither loaded nor scored.
//   The next live stage's K/V are loaded into registers while the current
//   one is scored (a double buffer), then dequantized into shared memory,
//   K transposed.  S = Q K^T and O += P V run as 4 x 4 register tiles per
//   thread in fp32 FFMA; row max and sum reduce over the 16 threads that
//   share a row.
//
// fp32 with expf / tanhf throughout (no fast math).  Masking follows the
// JAX kernel's NEG_INF = -2e38 convention, with masked keys left out of the
// softmax instead of scoring NEG_INF: for every row that sees at least one
// key the result is the same (JAX's junk weights from before the first
// visible key are wiped by exp(NEG_INF - m) == 0), and a row that sees none
// — junk for every caller — ends with l == 0 and emits acc / max(l, 1e-37)
// == 0, as an unmapped slot does in JAX.  Merges weigh a partial by
// exp(m - M) only when its l > 0, so no NEG_INF - NEG_INF reaches expf.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kFp32 = 0, kBf16 = 1, kInt8 = 2, kBit1 = 3 };

// decode tile (attn_decode.DECODE_TILE_ROWS / MAX_SPLITS mirror these)
constexpr int kDecodeRows = 16;  // C*G at or below which it runs
constexpr int kMaxSplits = 64;
constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kRG = 4;      // query rows per block
constexpr int kSub = 256;   // keys per position pass
constexpr int kMaxDh = 256;
constexpr int kCombineThreads = 64;

// window tile
constexpr int kWinThreads = 256;
constexpr int kWinRows = 64;
constexpr int kWinKeys = 64;
constexpr int kPosWin = 512;  // keys whose positions are staged at once
constexpr int kPad = 68;      // row stride (floats) of the transposed tiles

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
  float* ws;  // [pairs][splits][C*G] (m, l), then [pairs][splits][C*G][Dh]
  int c, kvh, g, dh, bs, bps, groups, causal, window;
  int n_splits, split_keys;
  float sm_scale, cap;
  // decode tile: row bytes, staged row stride, copy unit, scales per row,
  // keys per ring stage, ring stages, padded query row (floats)
  int rb, ks, cu, nsc, chunk, nst, ql;
};

__device__ __forceinline__ bool sees(int pos, int qp, const Params& p) {
  return (!p.causal || pos <= qp) && (p.window <= 0 || pos > qp - p.window);
}

// cap * tanh(s / cap) over a tile of scores (the caller branches on cap > 0)
template <int M, int N>
__device__ __forceinline__ void soft_cap_all(float (&s)[M][N], float cap) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) s[i][j] = cap * tanhf(s[i][j] / cap);
}

// out offset of query row r = c * G + g of slot b, kv-head h
__device__ __forceinline__ long long out_row(const Params& p, int b, int h,
                                             int r) {
  const int c = r / p.g, g = r - c * p.g;
  return ((static_cast<long long>(b) * p.c + c) * p.kvh + h) * p.g * p.dh +
         static_cast<long long>(g) * p.dh;
}

// ---------------------------------------------------------------------------
// Storage pieces, the window tile's loads.  A piece is W consecutive
// channels of one pool row, held as raw 32-bit words (fp32 values, bf16
// pairs, int8 quads, 16 sign bits) and dequantized on the way into shared
// memory: bf16 -> fp32 by a shift, int8 code * its
// 32-channel group scale, 1-bit lane i of byte w -> element 8w+i,
// +alpha / -alpha.  Pool row `hr` = (block * bs + offset) * KVH + head;
// indices are 32-bit (the wrapper keeps every pool under 2^31 elements).
// ---------------------------------------------------------------------------

template <int KIND, int W>
struct Piece {
  static constexpr int kWords =
      KIND == kFp32 ? W : KIND == kBf16 ? W / 2 : KIND == kInt8 ? W / 4 : 1;
  uint32_t w[kWords];
};

// W channels from c0 of row hr, in one aligned vector load (the window
// tile runs only on 16-byte aligned pools with Dh a multiple of 16)
template <int KIND, int W>
__device__ __forceinline__ void load_piece(const void* pool, int hr, int c0,
                                           int dh, Piece<KIND, W>& out) {
  constexpr int kWords = Piece<KIND, W>::kWords;
  if constexpr (KIND == kBit1) {
    static_assert(W == 16, "1-bit pieces are 2 bytes");
    out.w[0] = __ldg(reinterpret_cast<const uint16_t*>(
        static_cast<const uint8_t*>(pool) + hr * (dh / 8) + c0 / 8));
  } else {
    static_assert(kWords == 4, "16-byte pieces");
    constexpr int kBytes = KIND == kFp32 ? 4 : KIND == kBf16 ? 2 : 1;
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const uint8_t*>(pool) +
        (static_cast<size_t>(hr) * dh + c0) * kBytes));
    out.w[0] = x.x;
    out.w[1] = x.y;
    out.w[2] = x.z;
    out.w[3] = x.w;
  }
}

template <int KIND, int W>
__device__ __forceinline__ void zero_piece(Piece<KIND, W>& out) {
#pragma unroll
  for (int k = 0; k < Piece<KIND, W>::kWords; ++k) out.w[k] = 0u;
}

// the scale of the piece at c0 of row hr (1 when the tier has none)
template <int KIND>
__device__ __forceinline__ float load_scale(const float* scale, int hr, int c0,
                                            int groups) {
  if constexpr (KIND == kInt8) {
    return __ldg(scale + hr * groups + (groups == 1 ? 0 : c0 >> 5));
  } else if constexpr (KIND == kBit1) {
    return __ldg(scale + hr);
  } else {
    return 1.f;
  }
}

template <int KIND, int W>
__device__ __forceinline__ void dequant(const Piece<KIND, W>& x, float scale,
                                        float (&f)[W]) {
  if constexpr (KIND == kFp32) {
#pragma unroll
    for (int i = 0; i < W; ++i) f[i] = __uint_as_float(x.w[i]);
  } else if constexpr (KIND == kBf16) {
#pragma unroll
    for (int k = 0; k < W / 2; ++k) {
      f[2 * k] = __uint_as_float(x.w[k] << 16);
      f[2 * k + 1] = __uint_as_float(x.w[k] & 0xffff0000u);
    }
  } else if constexpr (KIND == kInt8) {
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int code = static_cast<int>(x.w[k] << (24 - 8 * t)) >> 24;
        f[4 * k + t] = static_cast<float>(code) * scale;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) f[i] = ((x.w[0] >> i) & 1u) ? scale : -scale;
  }
}

// ---------------------------------------------------------------------------
// Decode tile
// ---------------------------------------------------------------------------

constexpr int kChunk = 64;  // most admitted keys per ring stage: two per lane

// cp.async: 16-, 8- and 4-byte copies into shared memory, in groups; a
// 1-byte unit is copied by the thread itself
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  } else if (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  } else {
    *static_cast<uint8_t*>(dst) = *static_cast<const uint8_t*>(src);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// dot(q, k) of one staged K row (raw storage, `rb` bytes, zero past them)
// with a zero-padded fp32 query row; `sc`: the row's scales
template <int KIND>
__device__ __forceinline__ float score(const uint8_t* kr, const float* q,
                                       const float* sc, int rb, int groups) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  if constexpr (KIND == kFp32) {
#pragma unroll 4
    for (int u = 0; u < (rb + 15) >> 4; ++u) {
      const float4 k = reinterpret_cast<const float4*>(kr)[u];
      const float4 x = reinterpret_cast<const float4*>(q)[u];
      s0 = fmaf(x.x, k.x, s0);
      s1 = fmaf(x.y, k.y, s1);
      s2 = fmaf(x.z, k.z, s2);
      s3 = fmaf(x.w, k.w, s3);
    }
  } else if constexpr (KIND == kBf16) {
#pragma unroll 2
    for (int u = 0; u < (rb + 15) >> 4; ++u) {
      const uint4 k = reinterpret_cast<const uint4*>(kr)[u];
      const float4 x = reinterpret_cast<const float4*>(q)[2 * u];
      const float4 y = reinterpret_cast<const float4*>(q)[2 * u + 1];
      s0 = fmaf(x.x, __uint_as_float(k.x << 16), s0);
      s1 = fmaf(x.y, __uint_as_float(k.x & 0xffff0000u), s1);
      s2 = fmaf(x.z, __uint_as_float(k.y << 16), s2);
      s3 = fmaf(x.w, __uint_as_float(k.y & 0xffff0000u), s3);
      s0 = fmaf(y.x, __uint_as_float(k.z << 16), s0);
      s1 = fmaf(y.y, __uint_as_float(k.z & 0xffff0000u), s1);
      s2 = fmaf(y.z, __uint_as_float(k.w << 16), s2);
      s3 = fmaf(y.w, __uint_as_float(k.w & 0xffff0000u), s3);
    }
  } else if constexpr (KIND == kInt8) {
    // 16 codes a unit, inside one 32-channel scale group
    for (int u = 0; u < (rb + 15) >> 4; ++u) {
      const uint4 k = reinterpret_cast<const uint4*>(kr)[u];
      const uint32_t w[4] = {k.x, k.y, k.z, k.w};
      float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = reinterpret_cast<const float4*>(q)[4 * u + i];
        t0 = fmaf(x.x, static_cast<float>(static_cast<int>(w[i] << 24) >> 24), t0);
        t1 = fmaf(x.y, static_cast<float>(static_cast<int>(w[i] << 16) >> 24), t1);
        t2 = fmaf(x.z, static_cast<float>(static_cast<int>(w[i] << 8) >> 24), t2);
        t3 = fmaf(x.w, static_cast<float>(static_cast<int>(w[i]) >> 24), t3);
      }
      const float scale = sc[groups == 1 ? 0 : u >> 1];
      s0 = fmaf(scale, (t0 + t1) + (t2 + t3), s0);
    }
  } else {
    // 64 signs a unit: sum of q over set bits minus over clear bits, * alpha
    for (int u = 0; u < (rb + 7) >> 3; ++u) {
      const uint2 k = reinterpret_cast<const uint2*>(kr)[u];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float4 x = reinterpret_cast<const float4*>(q)[16 * u + i];
        const uint32_t w = (i < 8 ? k.x : k.y) >> (4 * (i & 7));
        s0 += (w & 1u) ? x.x : -x.x;
        s1 += (w & 2u) ? x.y : -x.y;
        s2 += (w & 4u) ? x.z : -x.z;
        s3 += (w & 8u) ? x.w : -x.w;
      }
    }
    return sc[0] * ((s0 + s1) + (s2 + s3));
  }
  return (s0 + s1) + (s2 + s3);
}

// channels c0 .. c0 + DPL - 1 of one staged V row, dequantized (c0 a
// multiple of DPL, so the piece is one aligned load inside one scale group)
template <int KIND, int DPL>
__device__ __forceinline__ void v_load(const uint8_t* vr, int c0, const float* sc,
                                       int groups, float (&v)[DPL]) {
  if constexpr (KIND == kFp32) {
#pragma unroll
    for (int i = 0; i < DPL; i += 2) {
      const float2 x = *reinterpret_cast<const float2*>(vr + 4 * (c0 + i));
      v[i] = x.x;
      v[i + 1] = x.y;
    }
  } else if constexpr (KIND == kBf16) {
#pragma unroll
    for (int i = 0; i < DPL; i += 2) {
      const uint32_t x = *reinterpret_cast<const uint32_t*>(vr + 2 * (c0 + i));
      v[i] = __uint_as_float(x << 16);
      v[i + 1] = __uint_as_float(x & 0xffff0000u);
    }
  } else if constexpr (KIND == kInt8) {
    const float scale = sc[groups == 1 ? 0 : c0 >> 5];
#pragma unroll
    for (int i = 0; i < DPL; i += 2) {
      const uint32_t x = *reinterpret_cast<const uint16_t*>(vr + c0 + i);
      v[i] = static_cast<float>(static_cast<int>(x << 24) >> 24) * scale;
      v[i + 1] = static_cast<float>(static_cast<int>(x << 16) >> 24) * scale;
    }
  } else {
    const uint32_t bits = vr[c0 >> 3] >> (c0 & 7);
#pragma unroll
    for (int i = 0; i < DPL; ++i) v[i] = ((bits >> i) & 1u) ? sc[0] : -sc[0];
  }
}

// DPL = output channels per lane (lane * DPL ..): 2, 4 or 8
template <int KIND, int DPL>
__global__ void __launch_bounds__(kDecThreads) flash_decode_split(Params p) {
  extern __shared__ float4 dec_shared[];
  const int chunk = p.chunk, stage_bytes = 2 * chunk * (p.ks + 4 * p.nsc);
  float* qs = reinterpret_cast<float*>(dec_shared);  // [kRG][ql], zero-padded
  uint8_t* ring = reinterpret_cast<uint8_t*>(qs + kRG * p.ql);
  float* ps = reinterpret_cast<float*>(ring + p.nst * stage_bytes);  // [kRG][kChunk]
  int* adm_row = reinterpret_cast<int*>(ps + kRG * kChunk);
  int* adm_pos = adm_row + kSub;
  int* wcnt = adm_pos + kSub;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, pair = blockIdx.y;
  const int b = pair / p.kvh, h = pair - b * p.kvh;
  const int cg = p.c * p.g, dh = p.dh;
  const int row0 = blockIdx.z * kRG, nrows = min(kRG, cg - row0);
  const int total = p.bps * p.bs;
  const int lo = split * p.split_keys;
  const int hi = min(total, lo + p.split_keys);
  const bool live = warp < nrows;  // warp w owns query row row0 + w

  // pass 1 reads the table entries of up to kSub keys, then their position
  // words; the first pass's entries are requested before anything else
  constexpr int kPer = kSub / kDecThreads;
  int krow[kPer], kpos[kPer];
  auto load_rows = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int key = k0 + i * kDecThreads + tid;
      krow[i] = -1;
      if (key < hi) {
        const int e = key / p.bs;
        const int blk = __ldg(p.table + static_cast<long long>(b) * p.bps + e);
        if (blk >= 0) krow[i] = blk * p.bs + (key - e * p.bs);
      }
    }
  };
  load_rows(lo);

  // the query rows, zero-padded; where a row's bytes end inside the last
  // unit score() reads (16 bytes, 8 at 1 bit), the ring is zeroed, since a
  // staged row's padding is never written (rows past a chunk's last key
  // hold stale bytes, which only masked lanes read)
  for (int i = tid; i < kRG * p.ql; i += kDecThreads) {
    const int r = i / p.ql, d = i - r * p.ql;
    qs[i] = r < nrows && d < dh ? __ldg(p.q + out_row(p, b, h, row0 + r) + d) : 0.f;
  }
  if (p.rb % (KIND == kBit1 ? 8 : 16) != 0)
    for (int i = tid; i < p.nst * stage_bytes / 16; i += kDecThreads)
      reinterpret_cast<float4*>(ring)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  int qp = 0, qp_min = INT_MAX, qp_max = INT_MIN;
  for (int r = 0; r < nrows; ++r) {
    const int v = __ldg(p.q_pos + static_cast<long long>(b) * p.c + (row0 + r) / p.g);
    qp_min = min(qp_min, v);
    qp_max = max(qp_max, v);
    if (r == warp) qp = v;
  }

  // copy units: rb / cu per row, a power of two for every tier at Dh 64
  const int units = p.rb / p.cu;
  const bool upow2 = (units & (units - 1)) == 0;
  const int ush = __ffs(units) - 1;

  // running max, this lane's share of the sum (reduced at the end), and
  // the lane's channels c0 .. c0 + DPL - 1, two chains (even / odd keys)
  const int c0 = lane * DPL;
  float m = kNegInf, l = 0.f, acc[DPL], acc2[DPL];
#pragma unroll
  for (int t = 0; t < DPL; ++t) acc[t] = acc2[t] = 0.f;

  int seen = 0;  // admitted keys over all passes (block-uniform)
  for (int k0 = lo; k0 < hi; k0 += kSub) {
    // pass 1: the positions of up to kSub keys, straight through the table;
    // admitted keys (mapped, written, visible to some row) are compacted in
    // key order
    if (k0 != lo) load_rows(k0);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      kpos[i] = krow[i] >= 0 ? __ldg(p.pool_pos + krow[i]) : -1;
    __syncthreads();  // the previous pass is done with the ring and adm_*
    int n_adm = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (k0 + i * kDecThreads >= hi) break;  // block-uniform
      const bool adm = krow[i] >= 0 && kpos[i] >= 0 &&
                       (!p.causal || kpos[i] <= qp_max) &&
                       (p.window <= 0 || kpos[i] > qp_min - p.window);
      const unsigned bal = __ballot_sync(kFull, adm);
      if (lane == 0) wcnt[warp] = __popc(bal);
      __syncthreads();
      int off = n_adm;
      for (int w = 0; w < kDecWarps; ++w) {
        off += w < warp ? wcnt[w] : 0;
        n_adm += wcnt[w];
      }
      if (adm) {
        const int at = off + __popc(bal & ((1u << lane) - 1u));
        adm_row[at] = krow[i];
        adm_pos[at] = kpos[i];
      }
      __syncthreads();
    }
    seen += n_adm;
    if (n_adm == 0) continue;

    // pass 2: chunks of `chunk` admitted keys through an nst-stage cp.async
    // ring of raw K / V rows and their scales
    const int n_chunks = (n_adm + chunk - 1) / chunk;
    auto issue = [&](int c) {
      if (c < n_chunks) {
        uint8_t* st = ring + (c % p.nst) * stage_bytes;
        const int per = chunk * units;
        for (int e = tid; e < 2 * per; e += kDecThreads) {
          const int which = e >= per, rem = e - which * per;
          const int jj = upow2 ? rem >> ush : rem / units;
          const int u = rem - jj * units;
          const int a = c * chunk + jj;
          if (a < n_adm) {
            const int hr = adm_row[a] * p.kvh + h;
            cp_async(st + (which * chunk + jj) * p.ks + u * p.cu,
                     static_cast<const uint8_t*>(which ? p.pool_v : p.pool_k) +
                         static_cast<size_t>(hr) * p.rb + u * p.cu,
                     p.cu);
          }
        }
        float* scs = reinterpret_cast<float*>(st + 2 * chunk * p.ks);
        for (int e = tid; e < 2 * chunk * p.nsc; e += kDecThreads) {
          const int which = e >= chunk * p.nsc, rem = e - which * chunk * p.nsc;
          const int jj = rem / p.nsc, gi = rem - jj * p.nsc;
          const int a = c * chunk + jj;
          if (a < n_adm) {
            const int hr = adm_row[a] * p.kvh + h;
            cp_async(scs + which * chunk * p.nsc + rem,
                     (which ? p.v_scale : p.k_scale) + hr * p.nsc + gi, 4);
          }
        }
      }
      cp_async_commit();  // empty groups keep the count uniform
    };
    for (int c = 0; c < p.nst - 1; ++c) issue(c);
    for (int c = 0; c < n_chunks; ++c) {
      if (p.nst == 3) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // chunk c landed; every warp is done with chunk c-1
      issue(c + p.nst - 1);
      if (!live) continue;  // warp-uniform
      const uint8_t* st = ring + (c % p.nst) * stage_bytes;
      const uint8_t* vst = st + chunk * p.ks;
      const float* kss = reinterpret_cast<const float*>(st + 2 * chunk * p.ks);
      const float* vss = kss + chunk * p.nsc;
      const int nj = min(chunk, n_adm - c * chunk);
      // lane j scores keys j (and j + 32) of the chunk for this warp's row
      float sc[2] = {0.f, 0.f};
      bool ok[2] = {false, false};
      float mx = kNegInf;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int j = lane + 32 * k;
        if (j >= chunk) break;  // block-uniform
        sc[k] = score<KIND>(st + j * p.ks, qs + warp * p.ql, kss + j * p.nsc,
                            p.rb, p.groups) * p.sm_scale;
        if (p.cap > 0.f) sc[k] = p.cap * tanhf(sc[k] / p.cap);
        ok[k] = j < nj && sees(adm_pos[c * chunk + j], qp, p);
        if (ok[k]) mx = fmaxf(mx, sc[k]);
      }
      const float mn = fmaxf(m, warp_max(mx));
      const float alpha = expf(m - mn);
      l *= alpha;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float pj = ok[k] ? expf(sc[k] - mn) : 0.f;
        l += pj;
        ps[warp * kChunk + lane + 32 * k] = pj;  // unread past the chunk
      }
      m = mn;
      __syncwarp();
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        acc[t] *= alpha;
        acc2[t] *= alpha;
      }
      const float* pw = ps + warp * kChunk;
      int jj = 0;
#pragma unroll 2
      for (; jj + 1 < nj; jj += 2) {
        float v[DPL], v2[DPL];
        v_load<KIND, DPL>(vst + jj * p.ks, c0, vss + jj * p.nsc, p.groups, v);
        v_load<KIND, DPL>(vst + (jj + 1) * p.ks, c0, vss + (jj + 1) * p.nsc,
                          p.groups, v2);
        const float w = pw[jj], w2 = pw[jj + 1];
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          acc[t] = fmaf(w, v[t], acc[t]);
          acc2[t] = fmaf(w2, v2[t], acc2[t]);
        }
      }
      if (jj < nj) {  // an odd chunk's last key
        float v[DPL];
        v_load<KIND, DPL>(vst + jj * p.ks, c0, vss + jj * p.nsc, p.groups, v);
#pragma unroll
        for (int t = 0; t < DPL; ++t) acc[t] = fmaf(pw[jj], v[t], acc[t]);
      }
      __syncwarp();  // ps is rewritten by the next chunk
    }
  }

  const long long ml0 = (static_cast<long long>(pair) * p.n_splits + split) * cg;
  float* ws_acc = p.ws + static_cast<long long>(gridDim.y) * p.n_splits * cg * 2;
  if (seen == 0) {  // no admitted key in the range: positions only
    for (int r = tid; r < nrows; r += kDecThreads) {
      if (p.n_splits == 1) {
        float* o = p.out + out_row(p, b, h, row0 + r);
        for (int d = 0; d < dh; ++d) o[d] = 0.f;
      } else {
        p.ws[(ml0 + row0 + r) * 2] = kNegInf;
        p.ws[(ml0 + row0 + r) * 2 + 1] = 0.f;
      }
    }
    return;
  }
  if (!live) return;
  l = warp_sum(l);
  const long long row = ml0 + row0 + warp;
  if (p.n_splits == 1) {
    float* o = p.out + out_row(p, b, h, row0 + warp);
    const float denom = fmaxf(l, 1e-37f);
#pragma unroll
    for (int t = 0; t < DPL; ++t)
      if (c0 + t < dh) o[c0 + t] = (acc[t] + acc2[t]) / denom;
  } else {
#pragma unroll
    for (int t = 0; t < DPL; ++t)
      if (c0 + t < dh) ws_acc[row * dh + c0 + t] = acc[t] + acc2[t];
    if (lane == 0) {
      p.ws[row * 2] = m;
      p.ws[row * 2 + 1] = l;
    }
  }
}

// One block per (slot, kv-head, query row): the splits' partials merged in
// split order.  Thread s reads split s's (m, l), and each thread the first
// 16 splits' acc of its first channel, in one round of loads; M = the max m
// over splits with l > 0; each channel sums its splits' acc in split order
// (a split with l == 0 wrote no acc: its load is dropped).
__global__ void __launch_bounds__(kCombineThreads) flash_decode_combine(Params p) {
  static_assert(kCombineThreads >= kMaxSplits, "one thread per split");
  constexpr int kPre = 16;
  __shared__ float sm[kMaxSplits], sl[kMaxSplits], wt[kMaxSplits];
  const int cg = p.c * p.g, ns = p.n_splits, dh = p.dh, t = threadIdx.x;
  const int pair = blockIdx.x / cg, r = blockIdx.x - pair * cg;
  const int b = pair / p.kvh, h = pair - b * p.kvh;
  const float* accw = p.ws + static_cast<long long>(gridDim.x) * ns * 2;
  const long long base = static_cast<long long>(pair) * ns * cg + r;  // split 0
  const long long step = static_cast<long long>(cg) * dh;  // split to split
  float pre[kPre];
#pragma unroll
  for (int s = 0; s < kPre; ++s)
    pre[s] = s < ns && t < dh ? accw[base * dh + t + s * step] : 0.f;
  if (t < ns) {
    const long long at = (base + static_cast<long long>(t) * cg) * 2;
    sl[t] = p.ws[at + 1];
    sm[t] = sl[t] > 0.f ? p.ws[at] : kNegInf;
  }
  __syncthreads();
  float mm = kNegInf;
  for (int s = 0; s < ns; ++s) mm = fmaxf(mm, sm[s]);
  if (t < ns) wt[t] = sl[t] > 0.f ? expf(sm[t] - mm) : 0.f;
  __syncthreads();
  float ls = 0.f;
  for (int s = 0; s < ns; ++s) ls = fmaf(sl[s], wt[s], ls);
  const float denom = fmaxf(ls, 1e-37f);
  float* o = p.out + out_row(p, b, h, r);
  for (int d = t; d < dh; d += kCombineThreads) {
    const float* src = accw + base * dh + d;
    float a = 0.f;
    int s = 0;
    if (d == t) {
#pragma unroll
      for (int i = 0; i < kPre; ++i)
        if (i < ns && wt[i] != 0.f) a = fmaf(pre[i], wt[i], a);
      s = kPre;
    }
#pragma unroll 8
    for (; s < ns; ++s) {
      const float x = src[s * step];
      a = wt[s] != 0.f ? fmaf(x, wt[s], a) : a;
    }
    o[d] = a / denom;
  }
}

// ---------------------------------------------------------------------------
// Window tile
// ---------------------------------------------------------------------------

// channels per staged piece: 16 bytes of fp32 / bf16 / int8, 2 sign bytes
template <int KIND>
__host__ __device__ constexpr int win_width() {
  return KIND == kFp32 ? 4 : KIND == kBf16 ? 8 : 16;
}

template <int DC>
constexpr size_t win_smem() {
  return sizeof(float) * (2 * DC * kPad + kWinKeys * (DC + 4)) +
         sizeof(int) * (2 * kPosWin + kPosWin / 32 + kWinRows);
}

// DC = channels staged (64 or 128; Dh <= DC, zero-padded)
template <int KIND, int DC>
__global__ void __launch_bounds__(kWinThreads) flash_decode_window(Params p) {
  constexpr int VW = win_width<KIND>();
  constexpr int kItems = kWinKeys * (DC / VW) / kWinThreads;  // pieces per thread
  constexpr int DG = DC / 64;  // 4-channel groups per thread in O
  static_assert(kItems >= 1 && kWinKeys * (DC / VW) % kWinThreads == 0, "");
  using P = Piece<KIND, VW>;
  extern __shared__ float4 win_shared[];
  float* q_t = reinterpret_cast<float*>(win_shared);  // [DC][kPad]  Q^T
  float* k_t = q_t + DC * kPad;                   // [DC][kPad]  K^T, then P^T
  float* v_s = k_t + DC * kPad;                   // [kWinKeys][DC + 4]
  int* pw_pos = reinterpret_cast<int*>(v_s + kWinKeys * (DC + 4));
  int* pw_row = pw_pos + kPosWin;                 // -1: not admitted
  int* wflag = pw_row + kPosWin;                  // [kPosWin / 32]
  int* qpos_s = wflag + kPosWin / 32;             // [kWinRows]

  const int tid = threadIdx.x, lane = tid & 31;
  const int ty = tid >> 4, tx = tid & 15;  // rows 4ty.., keys / channels 4tx..
  const int pair = blockIdx.x;
  const int b = pair / p.kvh, h = pair - b * p.kvh;
  const int cg = p.c * p.g, dh = p.dh;
  const int row0 = blockIdx.y * kWinRows, nrows = min(kWinRows, cg - row0);
  const int total = p.bps * p.bs;

  for (int e = tid; e < kWinRows * DC; e += kWinThreads) {
    const int r = e / DC, d = e - r * DC;
    q_t[d * kPad + r] =
        r < nrows && d < dh ? __ldg(p.q + out_row(p, b, h, row0 + r) + d) : 0.f;
  }
  if (tid < kWinRows)
    qpos_s[tid] = tid < nrows
        ? __ldg(p.q_pos + static_cast<long long>(b) * p.c + (row0 + tid) / p.g)
        : 0;
  __syncthreads();
  int qp_min = INT_MAX, qp_max = INT_MIN;
  for (int r = 0; r < nrows; ++r) {
    qp_min = min(qp_min, qpos_s[r]);
    qp_max = max(qp_max, qpos_s[r]);
  }
  int qp[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    live[i] = 4 * ty + i < nrows;
    qp[i] = qpos_s[4 * ty + i];
  }

  float m[4], l[4], o[4][DG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dg = 0; dg < DG; ++dg)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][dg][c] = 0.f;
  }

  P rk[kItems], rv[kItems];
  float sk[kItems], sv[kItems];
  // piece `it` of a stage: key (it * threads + tid) % 64, channels VW *
  // ((it * threads + tid) / 64) — a warp covers 32 keys of one piece
  auto issue = [&](int st) {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int e = it * kWinThreads + tid;
      const int kk = e & (kWinKeys - 1), c0 = (e / kWinKeys) * VW;
      const int row = pw_row[st * kWinKeys + kk];
      if (row >= 0 && c0 < dh) {
        const int hr = row * p.kvh + h;
        load_piece<KIND, VW>(p.pool_k, hr, c0, dh, rk[it]);
        load_piece<KIND, VW>(p.pool_v, hr, c0, dh, rv[it]);
        sk[it] = load_scale<KIND>(p.k_scale, hr, c0, p.groups);
        sv[it] = load_scale<KIND>(p.v_scale, hr, c0, p.groups);
      } else {
        zero_piece(rk[it]);
        zero_piece(rv[it]);
        sk[it] = 0.f;
        sv[it] = 0.f;
      }
    }
  };

  for (int w0 = 0; w0 < total; w0 += kPosWin) {
    __syncthreads();  // the previous window's stages are done with pw_*
    for (int j = tid; j < kPosWin; j += kWinThreads) {
      const int key = w0 + j;
      int row = -1, pos = -1;
      if (key < total) {
        const int e = key / p.bs;
        const int blk = __ldg(p.table + static_cast<long long>(b) * p.bps + e);
        if (blk >= 0) {
          row = blk * p.bs + (key - e * p.bs);
          pos = __ldg(p.pool_pos + row);
        }
      }
      const bool adm = row >= 0 && pos >= 0 && (!p.causal || pos <= qp_max) &&
                       (p.window <= 0 || pos > qp_min - p.window);
      pw_pos[j] = pos;
      pw_row[j] = adm ? row : -1;
      const unsigned bal = __ballot_sync(kFull, adm);
      if (lane == 0) wflag[j >> 5] = bal != 0u;
    }
    __syncthreads();
    const int n_st = (min(kPosWin, total - w0) + kWinKeys - 1) / kWinKeys;
    auto next_live = [&](int st) {
      while (st < n_st && !(wflag[2 * st] | wflag[2 * st + 1])) ++st;
      return st;
    };
    int cur = next_live(0);
    if (cur < n_st) issue(cur);
    while (cur < n_st) {
      __syncthreads();  // the previous stage's P V is done with k_t / v_s
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int e = it * kWinThreads + tid;
        const int kk = e & (kWinKeys - 1), c0 = (e / kWinKeys) * VW;
        float f[VW];
        dequant<KIND, VW>(rk[it], sk[it], f);
#pragma unroll
        for (int i = 0; i < VW; ++i) k_t[(c0 + i) * kPad + kk] = f[i];
        dequant<KIND, VW>(rv[it], sv[it], f);
#pragma unroll
        for (int i = 0; i < VW; i += 4)
          *reinterpret_cast<float4*>(v_s + kk * (DC + 4) + c0 + i) =
              make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
      }
      __syncthreads();
      const int nxt = next_live(cur + 1);
      if (nxt < n_st) issue(nxt);  // in flight while this stage is scored

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < dh; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(q_t + d * kPad + 4 * ty);
        const float4 k = *reinterpret_cast<const float4*>(k_t + d * kPad + 4 * tx);
        const float av[4] = {a.x, a.y, a.z, a.w}, kv[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
      }
      int kpos[4];
      bool kon[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int at = cur * kWinKeys + 4 * tx + j;
        kpos[j] = pw_pos[at];
        kon[j] = pw_row[at] >= 0;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] *= p.sm_scale;
      if (p.cap > 0.f) soft_cap_all(s, p.cap);
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool ok[4];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ok[j] = kon[j] && live[i] && sees(kpos[j], qp[i], p);
          if (ok[j]) mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int x = 1; x < 16; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, x));
        const float mn = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - mn);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pr[i][j] = ok[j] ? expf(s[i][j] - mn) : 0.f;
          rs += pr[i][j];
        }
#pragma unroll
        for (int x = 1; x < 16; x <<= 1) rs += __shfl_xor_sync(kFull, rs, x);
        l[i] = l[i] * alpha + rs;
        m[i] = mn;
#pragma unroll
        for (int dg = 0; dg < DG; ++dg)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[i][dg][c] *= alpha;
      }
      __syncthreads();  // every thread is done reading K^T
      float* p_t = k_t;  // [kWinKeys][kPad]  P^T
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(p_t + (4 * tx + j) * kPad + 4 * ty) =
            make_float4(pr[0][j], pr[1][j], pr[2][j], pr[3][j]);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kWinKeys; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(p_t + kk * kPad + 4 * ty);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int dg = 0; dg < DG; ++dg) {
          const float4 v = *reinterpret_cast<const float4*>(
              v_s + kk * (DC + 4) + dg * 64 + 4 * tx);
          const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) o[i][dg][c] = fmaf(av[i], vv[c], o[i][dg][c]);
        }
      }
      cur = nxt;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!live[i]) continue;
    float* orow = p.out + out_row(p, b, h, row0 + 4 * ty + i);
    const float denom = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int dg = 0; dg < DG; ++dg) {
      const int c0 = dg * 64 + 4 * tx;
      if (c0 < dh)
        *reinterpret_cast<float4*>(orow + c0) =
            make_float4(o[i][dg][0] / denom, o[i][dg][1] / denom,
                        o[i][dg][2] / denom, o[i][dg][3] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// allow a kernel the whole 227 KB of dynamic shared memory, once per device
template <auto Kernel>
cudaError_t set_smem() {
  static uint64_t set_on = 0;  // devices whose attribute is set, per kernel
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && ((set_on >> dev) & 1u))) return err;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             227 * 1024);
  if (err == cudaSuccess && dev < 64) set_on |= uint64_t{1} << dev;
  return err;
}

template <int KIND, int DC>
cudaError_t launch_window(const Params& p, long long pairs, long long tiles,
                          cudaStream_t stream) {
  constexpr size_t smem = win_smem<DC>();
  static_assert(smem <= 227 * 1024, "window tile exceeds shared memory");
  const cudaError_t err = set_smem<flash_decode_window<KIND, DC>>();
  if (err != cudaSuccess) return err;
  flash_decode_window<KIND, DC><<<dim3(static_cast<unsigned>(pairs),
                                 static_cast<unsigned>(tiles)),
                            kWinThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the decode tile's dynamic shared memory (flash_decode_split's layout)
size_t dec_smem(const Params& p) {
  return sizeof(float) * kRG * p.ql +
         static_cast<size_t>(p.nst) * 2 * p.chunk * (p.ks + 4 * p.nsc) +
         sizeof(float) * kRG * kChunk + sizeof(int) * (2 * kSub + kDecWarps);
}

template <int KIND, int DPL>
cudaError_t launch_decode(const Params& p, long long pairs, long long groups,
                          cudaStream_t stream) {
  const size_t smem = dec_smem(p);
  cudaError_t err = set_smem<flash_decode_split<KIND, DPL>>();
  if (err != cudaSuccess) return err;
  flash_decode_split<KIND, DPL><<<dim3(static_cast<unsigned>(p.n_splits),
                                  static_cast<unsigned>(pairs),
                                  static_cast<unsigned>(groups)),
                             kDecThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_splits == 1) return err;
  flash_decode_combine<<<static_cast<unsigned>(pairs * p.c * p.g), kCombineThreads,
                   0, stream>>>(p);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_kind(Params& p, bool window, long long pairs,
                        cudaStream_t stream) {
  const long long cg = static_cast<long long>(p.c) * p.g;
  if (window) {
    const long long tiles = (cg + kWinRows - 1) / kWinRows;
    return p.dh <= 64 ? launch_window<KIND, 64>(p, pairs, tiles, stream)
                      : launch_window<KIND, 128>(p, pairs, tiles, stream);
  }
  // staged rows: 16-byte aligned with an odd number of 16-byte units, so
  // the lanes' 16-byte reads of 32 rows spread over the banks
  p.rb = KIND == kFp32 ? 4 * p.dh : KIND == kBf16 ? 2 * p.dh
       : KIND == kInt8 ? p.dh : p.dh / 8;
  p.ks = (p.rb + 15) / 16 * 16;
  if ((p.ks / 16) % 2 == 0) p.ks += 16;
  p.cu = 1;
  for (int unit = 16; unit >= 4 && p.cu == 1; unit /= 2)
    if (p.rb % unit == 0 && aligned(p.pool_k, unit) && aligned(p.pool_v, unit))
      p.cu = unit;
  p.nsc = KIND == kInt8 ? p.groups : KIND == kBit1 ? 1 : 0;
  p.ql = (p.dh + 63) / 64 * 64;
  // 64-key stages where a 3-stage ring fits in 48 KB (4 blocks an SM),
  // else 32-key stages, in 3 stages or, for wide rows, 2
  const int row_bytes = 2 * (p.ks + 4 * p.nsc);
  p.chunk = 3 * 64 * row_bytes <= 48 * 1024 ? 64 : 32;
  p.nst = 3 * 32 * row_bytes <= 110 * 1024 || p.chunk == 64 ? 3 : 2;
  const long long groups = (cg + kRG - 1) / kRG;
  if (p.dh <= 64) return launch_decode<KIND, 2>(p, pairs, groups, stream);
  if (p.dh <= 128) return launch_decode<KIND, 4>(p, pairs, groups, stream);
  return launch_decode<KIND, 8>(p, pairs, groups, stream);
}

}  // namespace

// kind: 0 fp32 pool, 1 bf16 pool, 2 int8 codes + group scales, 3 sign bytes
// + per-head alpha.  cap == 0: no softcap; window == 0: no window.
// The window tile runs when C*G > 16 and Dh is a multiple of 16 up to 128
// with 16-byte aligned pools; otherwise the decode tile runs with the
// wrapper's split plan (n_splits ranges of split_keys keys covering the
// span bps * bs) and, when n_splits > 1, the workspace `ws` of
// B*KVH*n_splits*C*G*(Dh + 2) floats.
extern "C" int repro_flash_decode(
    const int32_t* table, const float* q, const int32_t* q_pos,
    const void* pool_k, const void* pool_v, const float* k_scale,
    const float* v_scale, const int32_t* pool_pos, float* out, float* ws,
    long long b, long long c, long long kvh, long long g, long long dh,
    long long nb, long long bs, long long bps, long long n_splits,
    long long split_keys, int kind, float sm_scale, float cap, int causal,
    int window, cudaStream_t stream) {
  (void)nb;
  if (dh < 1 || dh > kMaxDh || (kind == kBit1 && dh % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cg = c * g, span = bs * bps;
  const bool use_window = cg > kDecodeRows && dh % 16 == 0 && dh <= 128 &&
                          aligned(pool_k, 16) && aligned(pool_v, 16);
  if (!use_window &&
      (n_splits < 1 || n_splits > kMaxSplits || split_keys < 1 ||
       (n_splits - 1) * split_keys >= (span > 0 ? span : 1) ||
       n_splits * split_keys < span || (n_splits > 1 && ws == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{table, q, q_pos, pool_k, pool_v, k_scale, v_scale, pool_pos, out,
           ws, static_cast<int>(c), static_cast<int>(kvh), static_cast<int>(g),
           static_cast<int>(dh), static_cast<int>(bs), static_cast<int>(bps),
           dh % 32 == 0 ? static_cast<int>(dh / 32) : 1, causal, window,
           static_cast<int>(n_splits), static_cast<int>(split_keys), sm_scale,
           cap, 0, 0, 0, 0, 0, 0, 0};
  const long long pairs = b * kvh;
  cudaError_t err;
  switch (kind) {
    case kFp32: err = launch_kind<kFp32>(p, use_window, pairs, stream); break;
    case kBf16: err = launch_kind<kBf16>(p, use_window, pairs, stream); break;
    case kInt8: err = launch_kind<kInt8>(p, use_window, pairs, stream); break;
    case kBit1: err = launch_kind<kBit1>(p, use_window, pairs, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
