// k-bit GEMM on the tensor cores: (ka, M, Kw) x (kb, N, Kw) 32-bit plane
// words -> (M, N) int32 S = sum_k n_a[m, k] * n_w[n, k], the integer dot of
// the DoReFa codes n = sum_i 2^i * plane_i over exactly the Kw words given,
// for any 1 <= ka, kb <= 8 — the same S as kbit_plane_gemm.cu, bit for bit.
// The expert-batched form runs the same tiles over a leading expert axis:
// (E, ka, M, Kw) x (E, kb, N, Kw) -> (E, M, N), one expert per blockIdx.z,
// with 64-bit expert offsets.
//
// Replaces: src/repro/kernels/kbit_mxu.py, kbit_mxu_gemm_pallas
// (_mxu_kbit_kernel, _unpack_codes_i8, _offset_dot, _restore_s), the
// mxu-k2/k4/k8 backends (repro_kbit_mxu_gemm); and
// kbit_mxu_gemm_batched_pallas (_mxu_kbit_kernel_batched and its
// _restore_s), the MoE expert buckets of the mxu-k2/k4/k8 backends
// (repro_kbit_mxu_gemm_batched).  The TPU kernel contracts signed offset
// codes n - 2^(k-1) and restores S with a rank-1 correction because its
// int8 matrix unit is signed; mma.sync takes u8 x u8 -> s32, so the codes
// 0..255 go in as they are and S comes out directly.
//
// Bound on the H100.  Decode (M <= kDecodeMaxRows): the kb weight planes'
// bytes, read once.  Granite's 0.5-8 MB a call take 0.2-2.5 us at 3.35
// TB/s, so a call is bound by the launch and three load round trips in a
// row (the activation words the zero-row check waits for, the first weight
// chunk, the split-K sum); the MoE's dense 24-row buckets (64 experts, 103
// MB an up call) by the bytes and the per-warp chain of ring waits, code
// builds and mma.  Prefill: by its function the 2*M*N*K int8 operations on
// the tensor cores, and building the codes of a 128 x 64 tile's 192 rows
// costs about as many integer instructions as its mma.sync cost
// tensor-core cycles; on the card the plane-word loads bound it (each block
// reads its rows from L2, one chunk ahead), so a larger tile and deeper
// prefetch come before wgmma.
//
// Codes are built in registers from plane words by a transpose network.
// mma sums its 32 K lanes in any order, so a lane need only hold the same K
// position in A and in B.  From word x of planes 0..P-1 the network forms
// eight registers r[0..7], byte j of r[s] holding the code of bit 8j + s
// (sum_i bit 8j+s of plane i << i): zip2 pairs planes into 2-bit fields
// (even / odd bits), zip4 pairs those into nibbles (bit positions mod 4),
// and the nibbles spread to bytes (P <= 4) or meet planes 4..7's nibbles
// (P > 4): 28 integer instructions per 32 lanes at P = 4, 48 at P = 8.  A
// and B build with the same network whatever their plane counts (missing
// planes are zero), so any ka and kb share the lane order.  A register of
// 4 code bytes is a k32 fragment register: r[2h] / r[2h + 1] of one word
// are the fragment's K lanes 4t.. / 16 + 4t.. (decode), and r[0..7] of a
// word are one 32-byte code row (prefill).
//
// Two tiles, chosen in the C entry point from the shapes and the SM count:
// - Decode (M <= kDecodeMaxRows; past that in row groups of 32 where the
//   prefill grid would fill under half the SMs): swap-AB.  Weight rows fill
//   the m16 A slot (16 per warp), activation rows the n8 B slot (up to 4
//   fragments), so each weight plane word is read and built into codes
//   once per call whatever M is.  The block stages its activation words in
//   shared memory once (cp.async), builds their codes once into a table in
//   fragment order (a uint4 per lane: the B registers of two k-steps,
//   XOR-swizzled so the build's stores and the warps' loads are free of
//   bank conflicts), and
//   marks its live rows.  Each warp streams its 16 rows' kb planes through
//   a private cp.async ring of kStages slots, 8 bytes per plane and row per
//   lane (words 2t, 2t + 1 of an 8-word chunk), with no block barrier in
//   the loop; kb is a template argument, so the plane loops unroll.  Where
//   N/16 warp tiles cannot fill the SMs, the chunks are split among a
//   block's warps and their int32 partials added in shared memory in a
//   fixed order (no atomics); R row tiles share a block's codes when that
//   still leaves a block per SM.
// - Prefill: 128 weight rows x 64 activation rows per block of 8 warps,
//   each 32 x 32 (two A and four B fragments).  Each thread loads its share
//   of the next 8-word chunk into registers (one weight row's 4 words and
//   one activation row's 2 words of every plane) while the warps contract
//   the current one; the block builds each code of the chunk once into a
//   192-row u8 tile (272-byte rows: ldmatrix reads 8 rows on 32 banks), and
//   the warps load their fragments with ldmatrix.x4 and run
//   mma.sync.m16n8k32 u8 x u8 -> s32.
// Rows that are zero do no work.  A code-0 lane multiplies to 0, so a row
// zero in every plane adds exactly 0 to every S it meets: skipping it
// changes no bit.  The decode block contracts only the n8 fragments that
// hold a live row; the prefill block ORs its 64 rows' words first.  A block
// with no live row stores zeros and reads no weight word, so at decode
// only the experts that received a token (their rows are at the front of
// their buckets, zero planes or code-0 rows behind) read their planes.
// Every term is non-negative, so each int32 partial and split-K sum stays
// below the final S, which dispatch bounds by 2*K*Na*Nw < 2^31.  Words past
// Kw are zero-filled, never read, and are code 0 in both operands.  8- and
// 16-byte cp.async need Kw % 4 == 0 and 16-byte aligned operands; other Kw
// copy and load word by word.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 8;
constexpr int kChunk = 8;           // words per row per chunk (256 K lanes)
constexpr int kStages = 3;          // decode ring depth
constexpr int kDecodeMaxRows = 32;  // M at or below this runs the decode tile
constexpr int kDecodeWarps = 8;     // warps per decode block, at most
constexpr int kWarpRows = 16;       // weight rows per decode warp
constexpr int kSlot = kWarpRows * kChunk * 4;  // ring bytes per plane
constexpr int kPfN = 128;           // prefill block: weight rows
constexpr int kPfM = 64;            //   activation rows
constexpr int kPfThreads = 256;     //   8 warps, 4 (N) x 2 (M) of 32 x 32
constexpr int kCodeRow = kChunk * 32 + 16;  // bytes per prefill code row
constexpr size_t kPfSmem = static_cast<size_t>(kPfN + kPfM) * kCodeRow;
constexpr size_t kMaxSmem = 232448;  // the most an sm_90 block may opt into
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Words col..col+W-1 of one row (W = 2 or 4) into shared memory; absent
// words (row out of range, col + i >= kw) are zero-filled and never read.
// vec: Kw % 4 == 0 and the operands are 16-byte aligned.
template <int W>
__device__ __forceinline__ void copy_words(uint32_t dst,
                                           const uint32_t* __restrict__ row,
                                           long long col, long long kw,
                                           bool row_ok, bool vec,
                                           const uint32_t* __restrict__ safe) {
  if (vec) {
    const bool ok = row_ok && col < kw;
    if (W == 4)
      cp_async16(dst, ok ? row + col : safe, ok ? 16 : 0);
    else
      cp_async8(dst, ok ? row + col : safe, ok ? 8 : 0);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const bool ok = row_ok && col + i < kw;
      cp_async4(dst + 4 * i, ok ? row + col + i : safe, ok ? 4 : 0);
    }
  }
}

// The same words into registers (zero where absent).
template <int W>
__device__ __forceinline__ void load_words(uint32_t (&v)[W],
                                           const uint32_t* __restrict__ row,
                                           long long col, long long kw,
                                           bool row_ok, bool vec) {
  if (vec) {
    const bool ok = row_ok && col < kw;
    if constexpr (W == 4) {
      const uint4 x = ok ? __ldg(reinterpret_cast<const uint4*>(row + col))
                         : make_uint4(0u, 0u, 0u, 0u);
      v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    } else {
      const uint2 x = ok ? __ldg(reinterpret_cast<const uint2*>(row + col))
                         : make_uint2(0u, 0u);
      v[0] = x.x, v[1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i)
      v[i] = row_ok && col + i < kw ? __ldg(row + col + i) : 0u;
  }
}

// Planes (x, y) -> 2-bit fields: field b of e holds (x, y) at bit 2b, of o
// at bit 2b + 1.
__device__ __forceinline__ void zip2(uint32_t x, uint32_t y, uint32_t& e,
                                     uint32_t& o) {
  e = (x & 0x55555555u) | ((y << 1) & 0xAAAAAAAAu);
  o = ((x >> 1) & 0x55555555u) | (y & 0xAAAAAAAAu);
}

// 2-bit fields (planes lo, planes hi) -> nibbles: nibble q of n0 holds
// fields 2q of lo and hi, of n1 fields 2q + 1.
__device__ __forceinline__ void zip4(uint32_t lo, uint32_t hi, uint32_t& n0,
                                     uint32_t& n1) {
  n0 = (lo & 0x33333333u) | ((hi << 2) & 0xCCCCCCCCu);
  n1 = ((lo >> 2) & 0x33333333u) | (hi & 0xCCCCCCCCu);
}

// Four planes' words -> nibble words nb[c], nibble q = the 4-bit code part
// of bit 4q + c.
__device__ __forceinline__ void nibbles(uint32_t w0, uint32_t w1, uint32_t w2,
                                        uint32_t w3, uint32_t (&nb)[4]) {
  uint32_t e01, o01, e23, o23;
  zip2(w0, w1, e01, o01);
  zip2(w2, w3, e23, o23);
  zip4(e01, e23, nb[0], nb[2]);
  zip4(o01, o23, nb[1], nb[3]);
}

// The codes of one word position of P planes (w[p], p < P; planes past P
// are zero): byte j of r[s] = sum_p (bit 8j + s of w[p]) << p.
template <int P>
__device__ __forceinline__ void build_codes(const uint32_t (&w)[kMaxPlanes],
                                            uint32_t (&r)[8]) {
  uint32_t lo[4];
  nibbles(w[0], P > 1 ? w[1] : 0u, P > 2 ? w[2] : 0u, P > 3 ? w[3] : 0u, lo);
  if (P <= 4) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      r[c] = lo[c] & 0x0F0F0F0Fu;
      r[4 + c] = (lo[c] >> 4) & 0x0F0F0F0Fu;
    }
  } else {
    uint32_t hi[4];
    nibbles(w[4], P > 5 ? w[5] : 0u, P > 6 ? w[6] : 0u, P > 7 ? w[7] : 0u,
            hi);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      r[c] = (lo[c] & 0x0F0F0F0Fu) | ((hi[c] << 4) & 0xF0F0F0F0u);
      r[4 + c] = ((lo[c] >> 4) & 0x0F0F0F0Fu) | (hi[c] & 0xF0F0F0F0u);
    }
  }
}

// build_codes for a plane count known only at run time (the activations').
__device__ __forceinline__ void build_codes_rt(const uint32_t (&w)[kMaxPlanes],
                                               int planes, uint32_t (&r)[8]) {
  if (planes <= 4)
    build_codes<4>(w, r);
  else
    build_codes<8>(w, r);
}

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr)
      : "memory");
}

// C fragment (16 x 8): regs 0/1 row g, regs 2/3 row g + 8; col 2t + (i & 1).
// Rows are weight rows (N), columns activation rows (M).
__device__ __forceinline__ void store_frag(int32_t* __restrict__ out,
                                           const int (&c)[4], long long nrow,
                                           long long mcol, long long m,
                                           long long n) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = nrow + (i >= 2 ? 8 : 0), col = mcol + (i & 1);
    if (r < n && col < m) out[col * n + r] = c[i];
  }
}

// The B-code table's slot of lane (g, t) for chunk c, word i: lanes XORed
// by (2c + i) mod 4 in bits 2-3, a permutation within each 32-entry block.
__device__ __forceinline__ int code_slot(int g, int t, long long c, int i) {
  return (g * 4 + t) ^ (static_cast<int>((2 * c + i) & 3) << 2);
}

// Decode tile: a block of R x S warps (blockDim.x = 32 * R * S, S =
// `splits`); warp (r, s) owns weight rows n0..n0+15 of row tile r and the
// s-th of S equal runs of the Kw / 8 chunks; every warp contracts the
// block's up to 32 activation rows (row group blockIdx.y), `nfa` n8
// fragments.  Dynamic shared memory: the live-row word (16 bytes), the
// B-code table (per chunk c, word i < 2, step pair q < 2, fragment f: 32
// uint4, lane (g, t)'s b0 / b1 of steps 2q and 2q + 1 at its code_slot),
// then a region that holds in turn the staged activation words (plane p,
// row r, word w at (p * nfa * 8 + r) * words + w), the warps' rings
// (kStages slots of KB x 2 x 32 uint2) and the split-K partials.
template <int KB>
__device__ __forceinline__ void decode_tile(const uint32_t* __restrict__ a,
                                            const uint32_t* __restrict__ b,
                                            int32_t* __restrict__ out,
                                            long long m, long long n,
                                            long long kw, int ka, int splits,
                                            int nfa, bool vec) {
  extern __shared__ __align__(16) uint4 smem[];
  const long long m0 = static_cast<long long>(blockIdx.y) * kDecodeMaxRows;
  const int rows = static_cast<int>(
      m - m0 < kDecodeMaxRows ? m - m0 : kDecodeMaxRows);
  const int alloc_rows = nfa * 8;
  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long chunks = (kw + kChunk - 1) / kChunk;
  const int words = static_cast<int>(chunks) * kChunk;
  uint32_t& live_rows = *reinterpret_cast<uint32_t*>(smem);
  uint4* table = smem + 1;
  uint32_t* region =
      reinterpret_cast<uint32_t*>(table + alloc_rows * words * 2);

  // the block's activation words, once
  if (tid == 0) live_rows = 0;
  const int segs = words / 4;
  for (int q = tid; q < ka * alloc_rows * segs; q += blockDim.x) {
    const int pr = q / segs, s = q % segs;
    const int p = pr / alloc_rows, r = pr % alloc_rows;
    copy_words<4>(smem_addr(region + pr * words + 4 * s),
                  a + (p * m + m0 + r) * kw, 4LL * s, kw, r < rows, vec, a);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // their codes into the table, and the rows with a nonzero word (bit r)
  uint32_t mine = 0;
  for (int q = tid; q < alloc_rows * words; q += blockDim.x) {
    const int r = q / words, w = q % words;
    uint32_t x[kMaxPlanes];
    uint32_t any = 0;
#pragma unroll
    for (int p = 0; p < kMaxPlanes; ++p) {
      x[p] = p < ka ? region[(p * alloc_rows + r) * words + w] : 0u;
      any |= x[p];
    }
    if (any) mine |= 1u << r;
    uint32_t code[8];
    build_codes_rt(x, ka, code);
    const long long c = w / kChunk;
    const int i = w & 1;
    uint4* dst = table + ((c * 2 + i) * 2 * nfa + r / 8) * 32 +
                 code_slot(r & 7, (w % kChunk) >> 1, c, i);
    dst[0] = make_uint4(code[0], code[1], code[2], code[3]);
    dst[nfa * 32] = make_uint4(code[4], code[5], code[6], code[7]);
  }
  mine = __reduce_or_sync(0xFFFFFFFFu, mine);
  if (lane == 0 && mine) atomicOr(&live_rows, mine);
  __syncthreads();  // the table is complete; the staging region is free
  const uint32_t live = live_rows;
  int live_frags = 0;  // bit f: fragment f holds a live row
#pragma unroll
  for (int f = 0; f < 4; ++f)
    if ((live >> (8 * f)) & 0xFFu) live_frags |= 1 << f;

  const int split = warp % splits, tile = warp / splits;
  const long long n0 =
      (static_cast<long long>(blockIdx.x) * (warps / splits) + tile) *
      kWarpRows;
  const long long c_lo = chunks * split / splits;
  // no live row: every S of the block is 0 and no weight word is read
  const int my = live != 0 && n0 < n
                     ? static_cast<int>(chunks * (split + 1) / splits - c_lo)
                     : 0;

  // the warp's weight chunks through its ring: lane (g, t) copies, and
  // later reads, words 2t, 2t + 1 of rows g and g + 8 of every plane
  const uint32_t* row0 = b + (n0 + g) * kw;
  const uint32_t* row1 = b + (n0 + g + 8) * kw;
  const bool ok0 = n0 + g < n, ok1 = n0 + g + 8 < n;
  uint2* ring = reinterpret_cast<uint2*>(region) +
                warp * kStages * KB * 64 + lane;
  auto issue = [&](int j) {
    if (j < my) {
      const long long col = (c_lo + j) * kChunk + 2 * t;
      uint2* slot = ring + (j % kStages) * KB * 64;
#pragma unroll
      for (int p = 0; p < KB; ++p) {
        copy_words<2>(smem_addr(slot + p * 64), row0 + p * n * kw, col, kw,
                      ok0, vec, b);
        copy_words<2>(smem_addr(slot + p * 64 + 32), row1 + p * n * kw, col,
                      kw, ok1, vec, b);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);

  int acc[4][4] = {};
  for (int j = 0; j < my; ++j) {
    cp_wait<kStages - 2>();  // chunk j has landed (this lane's copies)
    issue(j + kStages - 1);  // into the slot chunk j - 1 left
    const uint2* slot = ring + (j % kStages) * KB * 64;
    uint2 w0[KB], w1[KB];
#pragma unroll
    for (int p = 0; p < KB; ++p)
      w0[p] = slot[p * 64], w1[p] = slot[p * 64 + 32];
    const long long c = c_lo + j;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t x0[kMaxPlanes] = {}, x1[kMaxPlanes] = {};
#pragma unroll
      for (int p = 0; p < KB; ++p) {
        x0[p] = i ? w0[p].y : w0[p].x;
        x1[p] = i ? w1[p].y : w1[p].x;
      }
      uint32_t c0[8], c1[8];
      build_codes<KB>(x0, c0);
      build_codes<KB>(x1, c1);
      // B registers of steps 2q, 2q + 1 of every live fragment
      const uint4* tb =
          table + (c * 2 + i) * 2 * nfa * 32 + code_slot(g, t, c, i);
      uint4 bq[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          if (live_frags >> f & 1) bq[q][f] = tb[(q * nfa + f) * 32];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        // A fragment: regs 0/2 row g, 1/3 row g + 8; K lanes 4t.. from
        // r[2h], 16 + 4t.. from r[2h + 1]; B the same registers of the
        // activation word
        const uint32_t af[4] = {c0[2 * h], c1[2 * h], c0[2 * h + 1],
                                c1[2 * h + 1]};
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          if (live_frags >> f & 1) {
            const uint4& bv = bq[h >> 1][f];
            mma_u8(acc[f], af, h & 1 ? bv.z : bv.x, h & 1 ? bv.w : bv.y);
          }
        }
      }
    }
  }

  if (splits == 1) {
#pragma unroll
    for (int f = 0; f < 4; ++f)
      if (f < nfa)
        store_frag(out, acc[f], n0 + g, m0 + f * 8 + 2 * t, m0 + rows, n);
    return;
  }
  // split-K: partials to shared memory (over the rings), then warp s = 0 of
  // each row tile adds s = 0, 1, ..., S - 1 in that order
  cp_wait<0>();
  __syncthreads();
  int* red = reinterpret_cast<int*>(region);
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[(warp * 16 + f * 4 + i) * 32 + lane] = acc[f][i];
  __syncthreads();
  if (split != 0) return;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    if (f >= nfa) break;
    int c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int sum = 0;
      for (int s = 0; s < splits; ++s)
        sum += red[((warp + s) * 16 + f * 4 + i) * 32 + lane];
      c[i] = sum;
    }
    store_frag(out, c, n0 + g, m0 + f * 8 + 2 * t, m0 + rows, n);
  }
}

// Prefill tile: weight rows n0..n0+127 x activation rows m0..m0+63; warp
// (wn, wm) = (warp % 4, warp / 4) owns weight rows wn*32.. and activation
// rows wm*32..  Thread tid loads words 4 (tid & 1).. of weight row tid / 2
// and words 2 (tid & 3).. of activation row tid / 4 of each 8-word chunk;
// the code tile holds the chunk's 128 weight rows, then its 64 activation
// rows, kCodeRow bytes apart.
template <int KB>
__device__ __forceinline__ void prefill_tile(const uint32_t* __restrict__ a,
                                             const uint32_t* __restrict__ b,
                                             int32_t* __restrict__ out,
                                             long long m, long long n,
                                             long long kw, int ka, bool vec) {
  extern __shared__ __align__(16) uint4 smem[];
  uint8_t* tile = reinterpret_cast<uint8_t*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp & 3, wm = warp >> 2;
  const long long m0 = static_cast<long long>(blockIdx.y) * kPfM;
  const long long n0 = static_cast<long long>(blockIdx.x) * kPfN;

  // the block's activation rows are contiguous in each plane: any nonzero
  // word?  Read in rounds of 4 loads a thread, planes in order, and stop at
  // the first round that finds one (a bucket's rows are at its front).  If
  // none, every S of the tile is 0 and no weight word is read.
  const long long a_words = (m - m0 < kPfM ? m - m0 : kPfM) * kw;
  const long long units = vec ? a_words / 4 : a_words;  // per plane
  bool live = false;
  for (int p = 0; p < ka && !live; ++p) {
    const uint32_t* base = a + (p * m + m0) * kw;
    for (long long q0 = 0; q0 < units && !live; q0 += 4 * kPfThreads) {
      uint32_t any = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long q = q0 + u * kPfThreads + tid;
        if (q < units && vec) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(base) + q);
          any |= v.x | v.y | v.z | v.w;
        } else if (q < units) {
          any |= __ldg(base + q);
        }
      }
      live = __syncthreads_or(any != 0);
    }
  }
  if (!live) {
    for (int q = tid; q < kPfM * kPfN; q += kPfThreads) {
      const long long row = m0 + q / kPfN, col = n0 + q % kPfN;
      if (row < m && col < n) out[row * n + col] = 0;
    }
    return;
  }

  const long long chunks = (kw + kChunk - 1) / kChunk;
  const int wr = tid >> 1, wq = 4 * (tid & 1);  // weight row, first word
  const int ar = tid >> 2, aq = 2 * (tid & 3);  // activation row, first word
  const uint32_t* wrow = b + (n0 + wr) * kw;
  const uint32_t* arow = a + (m0 + ar) * kw;
  const bool w_ok = n0 + wr < n, a_ok = m0 + ar < m;
  uint32_t wv[KB][4], av[kMaxPlanes][2];
  auto load = [&](long long c) {
#pragma unroll
    for (int p = 0; p < KB; ++p)
      load_words<4>(wv[p], wrow + p * n * kw, c * kChunk + wq, kw, w_ok, vec);
#pragma unroll
    for (int p = 0; p < kMaxPlanes; ++p) {
      if (p < ka)
        load_words<2>(av[p], arow + p * m * kw, c * kChunk + aq, kw, a_ok,
                      vec);
      else
        av[p][0] = av[p][1] = 0u;
    }
  };
  load(0);

  uint8_t* wdst = tile + wr * kCodeRow + wq * 32;
  uint8_t* adst = tile + (kPfN + ar) * kCodeRow + aq * 32;
  // ldmatrix row addresses: A, matrix l / 8 = (rows +8, bytes +16) by bits
  // 0 / 1 of l / 8; B, matrix l / 8 = (bytes +16, rows +8)
  const uint32_t a_base = smem_addr(
      tile + (wn * 32 + (lane & 15)) * kCodeRow + (lane >> 4) * 16);
  const uint32_t b_base = smem_addr(
      tile + (kPfN + wm * 32 + (lane & 7) + ((lane >> 4) << 3)) * kCodeRow +
      ((lane >> 3) & 1) * 16);
  int acc[2][4][4] = {};
  for (long long c = 0; c < chunks; ++c) {
    // build the chunk's codes, once per tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t x[kMaxPlanes] = {}, code[8];
#pragma unroll
      for (int p = 0; p < KB; ++p) x[p] = wv[p][i];
      build_codes<KB>(x, code);
      uint4* d = reinterpret_cast<uint4*>(wdst + i * 32);
      d[0] = make_uint4(code[0], code[1], code[2], code[3]);
      d[1] = make_uint4(code[4], code[5], code[6], code[7]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t x[kMaxPlanes], code[8];
#pragma unroll
      for (int p = 0; p < kMaxPlanes; ++p) x[p] = av[p][i];
      build_codes_rt(x, ka, code);
      uint4* d = reinterpret_cast<uint4*>(adst + i * 32);
      d[0] = make_uint4(code[0], code[1], code[2], code[3]);
      d[1] = make_uint4(code[4], code[5], code[6], code[7]);
    }
    if (c + 1 < chunks) load(c + 1);  // in flight while the warps contract
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {  // one word's 32 code bytes a step
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int f = 0; f < 2; ++f)
        ldmatrix_x4(af[f], a_base + f * 16 * kCodeRow + s * 32);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        ldmatrix_x4(bf[jj], b_base + jj * 16 * kCodeRow + s * 32);
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_u8(acc[f][j], af[f], bf[j >> 1][2 * (j & 1)],
                 bf[j >> 1][2 * (j & 1) + 1]);
    }
    __syncthreads();  // the tile is free for the next chunk
  }
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_frag(out, acc[f][j], n0 + wn * 32 + f * 16 + g,
                 m0 + wm * 32 + j * 8 + 2 * t, m, n);
}

template <int KB>
__global__ void __launch_bounds__(kDecodeWarps * 32, 2)
kbit_mxu_decode(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                int32_t* __restrict__ out, long long m, long long n,
                long long kw, int ka, int splits, int nfa, bool vec) {
  decode_tile<KB>(a, b, out, m, n, kw, ka, splits, nfa, vec);
}

// blockIdx.z = expert: its (ka, M, Kw), (kb, N, Kw) and (M, N) slabs.
template <int KB>
__global__ void __launch_bounds__(kDecodeWarps * 32, 2)
kbit_mxu_batched_decode(const uint32_t* __restrict__ a,
                        const uint32_t* __restrict__ b,
                        int32_t* __restrict__ out, long long m, long long n,
                        long long kw, int ka, int splits, int nfa, bool vec) {
  const long long e = blockIdx.z;
  decode_tile<KB>(a + e * ka * m * kw, b + e * KB * n * kw, out + e * m * n,
                  m, n, kw, ka, splits, nfa, vec);
}

template <int KB>
__global__ void __launch_bounds__(kPfThreads, 2)
kbit_mxu_prefill(const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ b, int32_t* __restrict__ out,
                 long long m, long long n, long long kw, int ka, bool vec) {
  prefill_tile<KB>(a, b, out, m, n, kw, ka, vec);
}

template <int KB>
__global__ void __launch_bounds__(kPfThreads, 2)
kbit_mxu_batched_prefill(const uint32_t* __restrict__ a,
                         const uint32_t* __restrict__ b,
                         int32_t* __restrict__ out, long long m, long long n,
                         long long kw, int ka, bool vec) {
  const long long e = blockIdx.z;
  prefill_tile<KB>(a + e * ka * m * kw, b + e * KB * n * kw, out + e * m * n,
                   m, n, kw, ka, vec);
}

using DecodeKernel = void (*)(const uint32_t*, const uint32_t*, int32_t*,
                              long long, long long, long long, int, int, int,
                              bool);
using PrefillKernel = void (*)(const uint32_t*, const uint32_t*, int32_t*,
                               long long, long long, long long, int, bool);

// [batched][kb - 1]
const DecodeKernel kDecode[2][kMaxPlanes] = {
    {kbit_mxu_decode<1>, kbit_mxu_decode<2>, kbit_mxu_decode<3>,
     kbit_mxu_decode<4>, kbit_mxu_decode<5>, kbit_mxu_decode<6>,
     kbit_mxu_decode<7>, kbit_mxu_decode<8>},
    {kbit_mxu_batched_decode<1>, kbit_mxu_batched_decode<2>,
     kbit_mxu_batched_decode<3>, kbit_mxu_batched_decode<4>,
     kbit_mxu_batched_decode<5>, kbit_mxu_batched_decode<6>,
     kbit_mxu_batched_decode<7>, kbit_mxu_batched_decode<8>}};
const PrefillKernel kPrefill[2][kMaxPlanes] = {
    {kbit_mxu_prefill<1>, kbit_mxu_prefill<2>, kbit_mxu_prefill<3>,
     kbit_mxu_prefill<4>, kbit_mxu_prefill<5>, kbit_mxu_prefill<6>,
     kbit_mxu_prefill<7>, kbit_mxu_prefill<8>},
    {kbit_mxu_batched_prefill<1>, kbit_mxu_batched_prefill<2>,
     kbit_mxu_batched_prefill<3>, kbit_mxu_batched_prefill<4>,
     kbit_mxu_batched_prefill<5>, kbit_mxu_batched_prefill<6>,
     kbit_mxu_batched_prefill<7>, kbit_mxu_batched_prefill<8>}};

// The SM count of a device, queried once.
cudaError_t sm_count(int dev, int* sms) {
  static int cached[kMaxDevices];  // 0: not queried yet
  if (dev < kMaxDevices && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  const cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) cached[dev] = *sms;
  return err;
}

// Lets `kernel` (index `id` of the 2 x 2 x 8 tables: [prefill][batched][kb
// - 1]) use up to kMaxSmem bytes of dynamic shared memory on `dev`, once per
// kernel and device.
cudaError_t allow_smem(const void* kernel, int id, int dev) {
  static bool done[kMaxDevices][2 * 2 * kMaxPlanes];
  if (dev < kMaxDevices && done[dev][id]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev][id] = true;
  return err;
}

int launch(bool batched, const int32_t* a32, const int32_t* b32, int32_t* out,
           long long e, long long m, long long n, long long kw, int ka, int kb,
           cudaStream_t stream) {
  if (ka < 1 || ka > kMaxPlanes || kb < 1 || kb > kMaxPlanes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (e <= 0 || m <= 0 || n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(dev, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* a = reinterpret_cast<const uint32_t*>(a32);
  const auto* b = reinterpret_cast<const uint32_t*>(b32);
  const bool vec = kw % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b)) % 16 == 0;
  const long long chunks = (kw + kChunk - 1) / kChunk;
  const long long pf_blocks =
      (n + kPfN - 1) / kPfN * ((m + kPfM - 1) / kPfM) * e;
  if (m <= kDecodeMaxRows || 2 * pf_blocks < sms) {
    // row groups of up to 32 activation rows (one at decode); past 32 rows
    // where the prefill tile's grid would leave most SMs idle
    const long long row_groups = (m + kDecodeMaxRows - 1) / kDecodeMaxRows;
    const long long g_rows = m < kDecodeMaxRows ? m : kDecodeMaxRows;
    const int nfa = static_cast<int>((g_rows + 7) / 8);
    const long long tiles = (n + kWarpRows - 1) / kWarpRows;
    const long long units = e * row_groups;  // (expert, row group) pairs
    // split K only until every SM gets a block's worth of warps: a power of
    // two, at most the block's warps, each split at least one chunk
    int splits = 1;
    while (splits < kDecodeWarps && 2 * splits <= chunks &&
           units * tiles * splits < static_cast<long long>(sms) * kDecodeWarps)
      splits *= 2;
    int row_tiles = 1;  // per block: share the codes while every SM still
                        // gets a block
    for (int r = kDecodeWarps / splits; r > 1; --r) {
      if ((tiles + r - 1) / r * units >= sms) {
        row_tiles = r;
        break;
      }
    }
    const int warps = row_tiles * splits;
    const long long words = chunks * kChunk;
    const size_t table = sizeof(uint32_t) * nfa * 8 * words * 8;
    const size_t staged = sizeof(uint32_t) * ka * nfa * 8 * words;
    const size_t rings = static_cast<size_t>(warps) * kStages * kb * kSlot;
    const size_t partials = sizeof(int) * warps * 16 * 32;
    size_t region = staged > rings ? staged : rings;
    region = region > partials ? region : partials;
    const size_t smem = sizeof(uint4) + table + region;  // + live-row word
    if (smem <= kMaxSmem) {
      const DecodeKernel kernel = kDecode[batched][kb - 1];
      err = allow_smem(reinterpret_cast<const void*>(kernel),
                       batched * kMaxPlanes + kb - 1, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      const dim3 grid(
          static_cast<unsigned>((tiles + row_tiles - 1) / row_tiles),
          static_cast<unsigned>(row_groups), static_cast<unsigned>(e));
      kernel<<<grid, warps * 32, smem, stream>>>(
          a, b, out, m, n, kw, ka, splits, nfa, vec);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const PrefillKernel kernel = kPrefill[batched][kb - 1];
  err = allow_smem(reinterpret_cast<const void*>(kernel),
                   (2 + batched) * kMaxPlanes + kb - 1, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + kPfN - 1) / kPfN),
                  static_cast<unsigned>((m + kPfM - 1) / kPfM),
                  static_cast<unsigned>(e));
  kernel<<<grid, kPfThreads, kPfSmem, stream>>>(a, b, out, m, n, kw, ka, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_kbit_mxu_gemm(const int32_t* a, const int32_t* b,
                                   int32_t* out, long long m, long long n,
                                   long long kw, int ka, int kb,
                                   cudaStream_t stream) {
  return launch(false, a, b, out, 1, m, n, kw, ka, kb, stream);
}

extern "C" int repro_kbit_mxu_gemm_batched(const int32_t* a, const int32_t* b,
                                           int32_t* out, long long e,
                                           long long m, long long n,
                                           long long kw, int ka, int kb,
                                           cudaStream_t stream) {
  return launch(true, a, b, out, e, m, n, kw, ka, kb, stream);
}
