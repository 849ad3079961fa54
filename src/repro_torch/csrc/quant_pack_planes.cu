// DoReFa activation prologue (paper Eq. 1): (M, K) float32 ->
//   planes (a_bits, M, Kw) 32-bit words: bit l of planes[i, row, w] is bit i
//     of code[row, 32w + l], LSB first; bits past K are 0 in every plane;
//   t_sum (M, 1) int32: the code row-sums sum_k code[row, k];
// with code = rint(clamp(x, 0, 1) * (2^a_bits - 1)), 2 <= a_bits <= 8.
//
// Replaces: src/repro/kernels/pack_bits.py, quant_pack_planes_pallas
// (_quant_pack_planes_kernel), the fused quantize -> plane-pack prologue
// that runs before every k-bit packed GEMM (the vpu-k* and mxu-k* backends).
//
// Bound on the H100: latency, not bytes.  A call moves 32-128 KB at decode
// (0.01-0.04 us at the HBM rate) and a few MB at prefill, so what a call
// costs is its chain: the launch, the load round trip, the pack, the
// block's row-sum and the stores; and, since a row lives on one SM, that
// SM's instruction issue on long rows.  The design keeps the chain to one
// load round trip and few instructions a word:
//
// - One block a row, so T is one block's integer sum (a warp-wide integer
//   reduction, then the warps' sums in shared memory in a fixed order; no
//   atomics, no second pass; integer adds, so two calls give the same
//   bits).  The plan (make_plan) comes from (M, Kw) alone: a warp owns
//   `words` consecutive words of a chunk (8, or 16 where a row has more
//   than 16 x 8 words or the M rows alone fill the card's 132 SMs), and a
//   row gets ceil(Kw / words) warps, at most 32 (1024 threads); a row with
//   more words loops over chunks of 32 x 16 words.  So at decode a row of
//   granite (Kw 64) runs on 8 warps of 8 words, its `down` input (Kw 256)
//   on 16 warps of 16, and deepseek-moe-16b's dense `down` (K 10944, Kw
//   342) on 22 warps of 16; at prefill (M 256 / 576) a block is 3-16 warps
//   of 16 words.  (At decode, 4 and 16 words a warp at Kw 64, and 8 at Kw
//   256, were slower on the card.)
// - No serial chain of round trips: lane l of a warp issues all its loads
//   of a chunk, x[row, 32w + l] for each of the warp's words (one coalesced
//   128-byte line a word), into a register array before it converts the
//   first one.  Lanes past K load nothing and take code 0, so the ragged
//   edge is masked here and callers need not pad.
// - Few instructions a plane word: each lane packs the codes of G = 32 /
//   a_bits consecutive words into one register (bits a_bits*i .. + a_bits-1
//   hold word i's code), and one 32 x 32 bit transpose across the warp
//   (five rounds of a rotate, a shuffle and a masked merge) turns the 32
//   lanes' registers into 32 plane words: lane c then holds plane
//   c % a_bits of word c / a_bits, and the lanes store them in one
//   instruction.  A ballot and a lane select per plane word cost more.  A
//   code is a saturating add (the clamp), a multiply and an add of 2^23
//   (the rounding), whose bits are packed with one shift-add: no
//   float-to-integer conversion, which issues at a quarter of the fp32
//   rate.  a_bits is a template argument, so the loops over words and
//   planes unroll.
//
// Rounding: clamp(x) * n is one fp32 multiply (__fmul_rn, never
// contracted), as in the JAX package; adding 2^23 to it in fp32
// (__fadd_rn) rounds half to even, as torch.round and jnp.round.  NaN is
// outside the contract (the JAX package's uint32 cast of NaN is
// undefined): fmaxf(NaN, 0) is 0, so here NaN gives code 0.  -0.0 gives
// code 0; +inf gives the top code, -inf code 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 32;    // 1024 threads a block
constexpr int kFillRows = 132;   // rows that alone give every SM a block
constexpr int kShortWords = 8;   // words a warp a chunk in a short row ...
constexpr int kShortRow = 128;   // ... of at most 16 warps of 8 words
constexpr int kLongWords = 16;   // in a longer row, or where rows fill the card

struct Plan {
  int warps;  // a block, one row a block
  int words;  // a warp a chunk; a chunk is warps * words words
};

Plan make_plan(long long m, long long kw) {
  Plan p;
  p.words = (kw > kShortRow || m >= kFillRows) ? kLongWords : kShortWords;
  const long long need = (kw + p.words - 1) / p.words;
  p.warps = static_cast<int>(need < kMaxWarps ? (need > 0 ? need : 1)
                                              : kMaxWarps);
  return p;
}

// bits whose index has bit j clear (j = 16, 8, 4, 2, 1)
__device__ constexpr uint32_t low_mask(int j) {
  return j == 16 ? 0x0000ffffu
       : j == 8  ? 0x00ff00ffu
       : j == 4  ? 0x0f0f0f0fu
       : j == 2  ? 0x33333333u
                 : 0x55555555u;
}

// Rounding without a conversion instruction: for 0 <= y <= 2^22, the fp32
// sum y + 2^23 is 2^23 + rint(y) (its ulp is 1, ties to even), so its bits
// are kRoundBits + rint(y).
constexpr float kRound = 8388608.0f;  // 2^23
constexpr uint32_t kRoundBits = 0x4b000000u;

// the sum of kRoundBits << (A * i) over the first `words` words of a group,
// which a group's packed register carries and then drops (mod 2^32)
template <int A>
__device__ constexpr uint32_t round_offset(int words) {
  uint32_t s = 0u;
  for (int i = 0; i < words; ++i) s += kRoundBits << (A * i);
  return s;
}

// Lane r holds row r of a 32 x 32 bit matrix (bit c = column c); returns
// column `lane` (bit r = row r's bit `lane`).  Each round swaps the
// off-diagonal j x j blocks: a lane with bit j of its index clear keeps its
// low-mask bits and takes its partner's, rotated left by j, in the others;
// its partner keeps the others and takes the first lane's, rotated right.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const bool top = (lane & j) == 0;
    const uint32_t keep = top ? low_mask(j) : ~low_mask(j);
    const uint32_t sent = __funnelshift_l(x, x, top ? 32 - j : j);
    const uint32_t got = __shfl_xor_sync(0xffffffffu, sent, j);
    x = (x & keep) | (got & ~keep);
  }
  return x;
}

template <int A, int W>
__global__ void __launch_bounds__(kMaxWarps * 32)
quant_pack_planes_kernel(const float* __restrict__ x,
                         uint32_t* __restrict__ planes,
                         int32_t* __restrict__ t_sum, long long m, long long k,
                         long long kw) {
  constexpr int G = 32 / A;                 // words one transpose packs
  constexpr int kGroups = (W + G - 1) / G;  // transposes a warp a chunk
  constexpr int kLast = W - (kGroups - 1) * G;  // words of the last group
  __shared__ unsigned warp_sums[kMaxWarps];
  const long long row = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const float n = static_cast<float>((1 << A) - 1);
  // after a transpose, lane c holds plane c % A of the group's word c / A
  const int my_word = lane / A;
  uint32_t* out = planes + (lane % A) * (m * kw) + row * kw + my_word;
  unsigned t = 0u;  // code sum, mod 2^32 as the int32 result
  // base is uniform across the warp, so every shuffle has all 32 lanes
  for (long long base = static_cast<long long>(warp) * W; base < kw;
       base += static_cast<long long>(warps) * W) {
    const long long col = base * 32 + lane;
    const float* xc = x + row * k + col;
    // columns left from this lane's first, capped to the chunk: > -64
    const long long left = k - col;
    const int rem = left < 32 * W ? static_cast<int>(left) : 32 * W;
    float v[W];
#pragma unroll
    for (int i = 0; i < W; ++i)  // every load of the chunk goes out first
      v[i] = 32 * i < rem ? xc[32 * i] : 0.0f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int words = g + 1 < kGroups ? G : kLast;
      uint32_t packed = 0u;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (g * G + i < W) {
          const float u = fminf(fmaxf(v[g * G + i], 0.0f), 1.0f);
          const uint32_t bits =
              __float_as_uint(__fadd_rn(__fmul_rn(u, n), kRound));
          t += bits;
          packed += bits << (A * i);
        }
      }
      packed = transpose32(packed - round_offset<A>(words), lane);
      const long long w = base + g * G;
      if (my_word < words && w + my_word < kw) out[w] = packed;
    }
    t -= W * kRoundBits;
  }
  t = __reduce_add_sync(0xffffffffu, t);
  if (lane == 0) warp_sums[warp] = t;
  __syncthreads();
  if (warp == 0) {
    const unsigned s = __reduce_add_sync(
        0xffffffffu, lane < warps ? warp_sums[lane] : 0u);
    if (lane == 0) t_sum[row] = static_cast<int32_t>(s);
  }
}

template <int A>
cudaError_t launch(const Plan& p, const float* x, uint32_t* planes,
                   int32_t* t_sum, long long m, long long k, long long kw,
                   cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(m);
  const unsigned threads = static_cast<unsigned>(p.warps) * 32u;
  if (p.words == kShortWords)
    quant_pack_planes_kernel<A, kShortWords><<<grid, threads, 0, stream>>>(
        x, planes, t_sum, m, k, kw);
  else
    quant_pack_planes_kernel<A, kLongWords><<<grid, threads, 0, stream>>>(
        x, planes, t_sum, m, k, kw);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_quant_pack_planes(const float* x, int32_t* planes,
                                       int32_t* t_sum, long long m,
                                       long long k, long long kw, int a_bits,
                                       cudaStream_t stream) {
  const Plan p = make_plan(m, kw);
  uint32_t* out = reinterpret_cast<uint32_t*>(planes);
  cudaError_t err;
  switch (a_bits) {
    case 2: err = launch<2>(p, x, out, t_sum, m, k, kw, stream); break;
    case 3: err = launch<3>(p, x, out, t_sum, m, k, kw, stream); break;
    case 4: err = launch<4>(p, x, out, t_sum, m, k, kw, stream); break;
    case 5: err = launch<5>(p, x, out, t_sum, m, k, kw, stream); break;
    case 6: err = launch<6>(p, x, out, t_sum, m, k, kw, stream); break;
    case 7: err = launch<7>(p, x, out, t_sum, m, k, kw, stream); break;
    case 8: err = launch<8>(p, x, out, t_sum, m, k, kw, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
