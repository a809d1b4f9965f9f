// Montgomery and Fp2 product kernels for BLS12-381 on Hopper (sm_90a).
//
// Replaces the three Pallas kernels of lodestar_tpu/ops/bls12_381/pallas_fp.py:
//   K1 lodestar_fp_mont_mul  <- _mont_mul_kernel / _mont_core (mont_mul)
//   K2 lodestar_fp_f2_mul    <- _f2_mul_kernel (f2_mul)
//   K3 lodestar_fp_f2_sqr    <- _f2_sqr_kernel (f2_sqr)
//
// Layout at the boundary: every operand is an int32 array of shape (n, 30),
// row-major: one field element per row as 30 canonical radix-2^13 limbs,
// little-endian, in Montgomery form with R = 2^390.  Limbs are below 2^13,
// so the int32 storage is read as uint32.  Any exact Montgomery product with
// R = 2^390 that returns the canonical residue is bit-identical to the
// reference (the canonical value is unique), so neither design below copies
// the TPU's Kogge-Stone sublane networks.
//
// What bounds them on the H100: per element K1 moves 360 bytes (two inputs,
// one output), K2 720 and K3 480.  The least work known for a product
// a b 2^-390 is 613 32-bit multiplies on 12 words of 32 bits (288 for a b,
// 325 for the reduction); K2 at its least (Karatsuba, one reduction per
// coefficient) needs 1,514 and K3 1,226.  At 3.35 TB/s and 16.7 T
// multiplies/s the bytes set the bound of all three.  On the main path
// neither is what limits a launch: launches are small (1 to ~9k elements),
// so the time is the launch itself, one element's dependent chain, and how
// many of the 132 SMs have work.
//
// ---------------------------------------------------------------------------
// K1 and K2: eight lanes per element, 26-bit digits (redesigned for Hopper)
// ---------------------------------------------------------------------------
//
// * Digits: 15 digits of 26 bits (15 x 26 = 390, so R is unchanged) in 16
//   slots, slot 15 zero.  The boundary conversion is a pair of limbs: digit
//   j = limb 2j + 2^13 limb 2j+1, and back.
// * TPI lanes of a warp cooperate on one element (threads per instance, a
//   compile-time constant); lane L holds slots L*D .. L*D+D-1, D = 16/TPI.
//   Lane L reads and writes limbs 4L .. 4L+3 of its row at TPI = 8, so the
//   lanes of an element touch its 120 contiguous bytes and a warp four
//   neighbouring rows: the accesses coalesce without staging.  Rows are 120
//   bytes; TMA would spend more on its set-up than it saves.
// * TPI = 8 was measured against 16, 4, 2 and 1 on the main path's shapes
//   (PERF.md, findings): the fewer the lanes, the longer each lane's chain and
//   the fewer SMs a small launch reaches; the more, the more shuffles an
//   element costs (the broadcasts of a_i and u_0 below are per lane).  At
//   TPI = 8 a 512-element launch runs 128 warps, a 9,234-element launch one
//   wave of ~18 warps per SM, and the 12- or 18-element launches of the
//   final exponentiation wait on a chain of 15 steps, not 30 x 61.
// * Montgomery product: CIOS over the 15 digits with lazy 64-bit
//   accumulators.  In step i every slot adds a_i b_k + m p_k (mul.wide,
//   26 x 26 -> 52 bits), where m is the step's digit (u_0 (-p^-1) mod 2^26)
//   computed in every lane from the broadcast u_0.  The accumulator is not
//   shifted across lanes: logical digit k of step i lives in slot (k + i)
//   mod 16, so each step broadcasts a_i and moves b and p up one slot (one
//   shuffle each, whatever D is; neither waits on the chain), and only the
//   broadcast of u_0 is on the chain.  Slot i then drops its digit and slot
//   i + 1 takes its carry, which every lane computes from u_0.
// * Accumulator bound: a slot adds at most 15 steps of products between two
//   drops, plus one carry below 2^32.  K1 adds two products a step:
//     30 x (2^26-1)^2 + 2^32 = 135,107,989,089,550,366 < 2^57;
//   K2 three (c0 = a0 b0 + a1 (p - b1) and c1 = a0 b1 + a1 b0, each reduced
//   once):
//     45 x (2^26-1)^2 + 2^32 = 202,661,981,486,841,901 < 2^58.
//   So the carry of a digit, u >> 26, is below 2^32.  T = (x + mu p) / R <
//   2p: x < 2p^2 and mu < R, and 2p^2/R < p.
// * The result: two carry passes between neighbouring slots (shfl_up
//   across lanes) leave digits of at most 2^26 + 2^7, whose carries are
//   single bits.  Each lane runs its D digits for a carry in of 0 and of 1;
//   a ballot of the lanes' generate and propagate bits, packed as integers
//   P + 2G, runs the chain across lanes in one addition (bit L of the sum
//   is bit L of P XOR the carry into lane L).  The conditional subtract of
//   p and K2's p - b1 resolve their borrows the same way.  Lanes past n
//   compute on zeros, so that every lane of a warp reaches every shuffle
//   and ballot, and skip only the store.
// * K2 is the schoolbook product with one reduction per coefficient, not
//   Karatsuba: Karatsuba saves one of four digit products but costs a third
//   reduction and five modular additions, each a cross-lane carry chain of
//   shuffles and ballots, and those chains, not the multiplies, set the
//   time.  The one subtraction left, p - b1, is one borrow chain.  The two
//   coefficients' chains are independent and interleave.
// * Not on the tensor cores: a_i b differs per element, so it is no matrix
//   product.  The products by constants (the digits m p) could be, as int8
//   products; that is later work (PERF.md, open questions).
//
// ---------------------------------------------------------------------------
// K3: one thread per element, 13-bit digits (the first port's design)
// ---------------------------------------------------------------------------
//
// One thread computes one element with all 30 limbs in registers, CIOS with
// 13-bit digits and 32-bit accumulators: in iteration i every limb u[j]
// gains a_i*b_j + m*p_j <= 2*(2^13-1)^2, a limb holds at most 30 such terms
// before it is shifted out, and limb 0 also takes the shifted carry
// (< 2^19):
//   2*30*(2^13-1)^2 + 2^19 = 4,026,073,148 < 2^32.
// The serial carry pass after the loop adds at most ~2^19 to a limb, still
// under 2^32.  The result T/R lies in [0, 2p) and one conditional subtract
// of p makes it canonical.  A thread reads 120 contiguous bytes, so a
// warp's loads do not coalesce.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NL = 30;
constexpr int BITS = 13;
constexpr uint32_t MASK = (1u << BITS) - 1u;

// ---------------------------------------------------------------------------
// K1, K2: TPI lanes per element, 26-bit digits
// ---------------------------------------------------------------------------

constexpr int TPI = 8;                // lanes per element
constexpr int SLOTS = 16;             // 15 digits and a zero
constexpr int D = SLOTS / TPI;        // digits per lane
constexpr int ND = 15;                // 26-bit digits per element
constexpr int DBITS = 26;
constexpr uint32_t DMASK = (1u << DBITS) - 1u;
constexpr uint32_t GROUP_LANES = (1u << TPI) - 1u;
constexpr unsigned FULL = 0xffffffffu;
constexpr int COOP_THREADS = 128;
// -p^{-1} mod 2^26, and digit 0 of p
constexpr uint32_t PINV26 = 66912253u;
constexpr uint32_t P0_26 = 67087019u;
static_assert(SLOTS % TPI == 0 && 32 % TPI == 0, "TPI divides the slots and the warp");

// p as 15 little-endian radix-2^26 digits, and a zero in slot 15
__constant__ uint32_t kP26[SLOTS] = {
    67087019, 62914559, 67107743, 66766159, 2010111,  28065161, 51194383, 4914588,
    59044741, 31006162, 3455693,  7249625,  65444427, 8031839,  106513,   0};

struct Slot {
  int64_t e;   // element of this lane's group
  int lane;    // lane in the group: it holds slots lane * D .. lane * D + D - 1
  int gshift;  // the group's first lane in the warp
  bool live;   // e < n
};

__device__ __forceinline__ Slot slot_of(int64_t n) {
  Slot s;
  s.e = (static_cast<int64_t>(blockIdx.x) * COOP_THREADS + threadIdx.x) / TPI;
  s.lane = threadIdx.x & (TPI - 1);
  s.gshift = threadIdx.x & (32 - TPI);
  s.live = s.e < n;
  return s;
}

// The lane's digits of row e: digit j = limb 2j + 2^13 limb 2j+1.  Slot 15
// and lanes past n read nothing and hold 0.
__device__ __forceinline__ void load_digits(uint32_t x[D], const int32_t* __restrict__ src,
                                            const Slot& s) {
#pragma unroll
  for (int r = 0; r < D; ++r) {
    const int j = s.lane * D + r;
    x[r] = 0;
    if (s.live && j < ND) {
      const int32_t* limb = src + s.e * NL + 2 * j;
      x[r] = static_cast<uint32_t>(limb[0]) | (static_cast<uint32_t>(limb[1]) << BITS);
    }
  }
}

__device__ __forceinline__ void store_digits(int32_t* __restrict__ dst, const Slot& s,
                                             const uint32_t x[D]) {
#pragma unroll
  for (int r = 0; r < D; ++r) {
    const int j = s.lane * D + r;
    if (s.live && j < ND) {
      int32_t* limb = dst + s.e * NL + 2 * j;
      limb[0] = static_cast<int32_t>(x[r] & MASK);
      limb[1] = static_cast<int32_t>(x[r] >> BITS);
    }
  }
}

// Move every slot up by one, slot 15 into slot 0: one shuffle.
template <typename T>
__device__ __forceinline__ void ring_up(T x[D], int lane) {
  const T top = __shfl_sync(FULL, x[D - 1], (lane + TPI - 1) & (TPI - 1), TPI);
#pragma unroll
  for (int r = D - 1; r > 0; --r) x[r] = x[r - 1];
  x[0] = top;
}

// A single-bit carry (or borrow) chain across the group's lanes.  Each lane
// gives its carry out for a carry in of 0 (out0) and of 1 (out1): it
// generates when out0 is set and passes a carry on when only out1 is.
// Packed as integers, P + 2G runs the whole chain in one addition: bit L of
// the sum is bit L of P XOR the carry into lane L, and bit TPI the carry out
// of the group.  Returns the carry into this lane.
__device__ __forceinline__ uint32_t lane_carry(uint32_t out0, uint32_t out1, const Slot& s,
                                               uint32_t* out) {
  const uint32_t G = (__ballot_sync(FULL, out0) >> s.gshift) & GROUP_LANES;
  const uint32_t P = (__ballot_sync(FULL, out1 & ~out0) >> s.gshift) & GROUP_LANES;
  const uint32_t S = P + (G << 1);
  *out = (S >> TPI) & 1u;
  return ((S ^ P) >> s.lane) & 1u;
}

// d = w + c over the lane's digits (each at most 2^26 + 2^7), canonical;
// returns the carry out of the lane, 0 or 1.
__device__ __forceinline__ uint32_t add_digits(uint32_t d[D], const uint32_t w[D], uint32_t c) {
#pragma unroll
  for (int r = 0; r < D; ++r) {
    const uint32_t t = w[r] + c;
    d[r] = t & DMASK;
    c = t >> DBITS;
  }
  return c;
}

// d = x - y - b over the lane's canonical digits; returns the borrow out.
__device__ __forceinline__ uint32_t sub_digits(uint32_t d[D], const uint32_t x[D],
                                               const uint32_t y[D], uint32_t b) {
#pragma unroll
  for (int r = 0; r < D; ++r) {
    const uint32_t yb = y[r] + b;
    d[r] = (x[r] - yb) & DMASK;
    b = x[r] < yb;
  }
  return b;
}

// d = x - y over the group for canonical x >= y - the borrow runs across
// lanes; returns the borrow out of slot 15 (set when x < y).
__device__ __forceinline__ uint32_t sub_group(uint32_t d[D], const uint32_t x[D],
                                              const uint32_t y[D], const Slot& s) {
  uint32_t out;
  const uint32_t b0 = sub_digits(d, x, y, 0u);
  const uint32_t b1 = sub_digits(d, x, y, 1u);
  sub_digits(d, x, y, lane_carry(b0, b1, s, &out));
  return out;
}

// One CIOS reduction at step i, once the step's products are in u: slot i
// holds logical digit 0.  Every lane takes u_0, computes the digit m and
// adds m p_k; slot i's digit, now u_0 + m p_0 = 0 mod 2^26, leaves as a
// carry into slot i + 1 (logical digit 1), and slot i becomes the top digit.
__device__ __forceinline__ void redc_step(uint64_t u[D], const uint32_t pk[D], int lane, int i) {
  const uint64_t u0 = __shfl_sync(FULL, u[i % D], i / D, TPI);
  const uint32_t m = (static_cast<uint32_t>(u0) * PINV26) & DMASK;
#pragma unroll
  for (int r = 0; r < D; ++r) u[r] += static_cast<uint64_t>(m) * pk[r];
  const uint64_t carry = (u0 + static_cast<uint64_t>(m) * P0_26) >> DBITS;
  if (lane == i / D) u[i % D] = 0;
  if (lane == (i + 1) / D) u[(i + 1) % D] += carry;
}

// The canonical digits of the value whose logical digit k sits, as a lazy
// accumulator below 2^58, in slot (k - 1) mod 16 (the layout after step
// 14).  The value is below 2p: it is reduced once more by p.
__device__ __forceinline__ void finish(uint32_t d[D], uint64_t u[D], const uint32_t p[D],
                                       const Slot& s) {
  ring_up(u, s.lane);  // logical digit k to slot k
  // pass 1: u < 2^58, so its carry is below 2^32
  const uint32_t c1 = __shfl_up_sync(FULL, static_cast<uint32_t>(u[D - 1] >> DBITS), 1, TPI);
  uint64_t v[D];
#pragma unroll
  for (int r = 0; r < D; ++r)
    v[r] = (u[r] & DMASK) + (r ? u[r - 1] >> DBITS : (s.lane ? c1 : 0u));
  // pass 2: v < 2^26 + 2^32, so its carry is below 2^7
  const uint32_t c2 = __shfl_up_sync(FULL, static_cast<uint32_t>(v[D - 1] >> DBITS), 1, TPI);
  uint32_t w[D];
#pragma unroll
  for (int r = 0; r < D; ++r)
    w[r] = static_cast<uint32_t>((v[r] & DMASK) + (r ? v[r - 1] >> DBITS : (s.lane ? c2 : 0u)));
  // w < 2^26 + 2^7: single-bit carries; none leaves slot 15 (value < 2^390)
  uint32_t out;
  const uint32_t o0 = add_digits(d, w, 0u);
  const uint32_t o1 = add_digits(d, w, 1u);
  add_digits(d, w, lane_carry(o0, o1, s, &out));
  // conditional subtract: a borrow out of slot 15 means d < p, keep d
  uint32_t diff[D];
  const uint32_t keep = sub_group(diff, d, p, s);
#pragma unroll
  for (int r = 0; r < D; ++r) d[r] = keep ? d[r] : diff[r];
}

__global__ void __launch_bounds__(COOP_THREADS)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, int64_t n) {
  const Slot s = slot_of(n);
  uint32_t x[D], y[D], p[D], pk[D], r[D];
  load_digits(x, a, s);
  load_digits(y, b, s);
#pragma unroll
  for (int j = 0; j < D; ++j) p[j] = pk[j] = kP26[s.lane * D + j];
  uint64_t u[D] = {};
  // step i: slot j holds logical digit (j - i) mod 16, and y and pk are
  // rotated to match, one slot a step
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const uint32_t xi = __shfl_sync(FULL, x[i % D], i / D, TPI);
#pragma unroll
    for (int j = 0; j < D; ++j) u[j] += static_cast<uint64_t>(xi) * y[j];
    redc_step(u, pk, s.lane, i);
    if (i + 1 < ND) {
      ring_up(y, s.lane);
      ring_up(pk, s.lane);
    }
  }
  finish(r, u, p, s);
  store_digits(out, s, r);
}

// Fp2 product in Fp[u]/(u^2+1): c0 = a0 b0 + a1 (p - b1), c1 = a0 b1 + a1 b0,
// each coefficient summed over both products before its one reduction.
__global__ void __launch_bounds__(COOP_THREADS)
f2_mul_kernel(const int32_t* __restrict__ a0, const int32_t* __restrict__ a1,
              const int32_t* __restrict__ b0, const int32_t* __restrict__ b1,
              int32_t* __restrict__ c0, int32_t* __restrict__ c1, int64_t n) {
  const Slot s = slot_of(n);
  uint32_t x0[D], x1[D], y0[D], y1[D], ny1[D], p[D], pk[D], r[D];
  load_digits(x0, a0, s);
  load_digits(x1, a1, s);
  load_digits(y0, b0, s);
  load_digits(y1, b1, s);
#pragma unroll
  for (int j = 0; j < D; ++j) p[j] = pk[j] = kP26[s.lane * D + j];
  sub_group(ny1, p, y1, s);  // p - b1: b1 <= p - 1, no borrow out
  uint64_t u[D] = {}, v[D] = {};
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const uint32_t x0i = __shfl_sync(FULL, x0[i % D], i / D, TPI);
    const uint32_t x1i = __shfl_sync(FULL, x1[i % D], i / D, TPI);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      u[j] += static_cast<uint64_t>(x0i) * y0[j];
      u[j] += static_cast<uint64_t>(x1i) * ny1[j];
      v[j] += static_cast<uint64_t>(x0i) * y1[j];
      v[j] += static_cast<uint64_t>(x1i) * y0[j];
    }
    redc_step(u, pk, s.lane, i);
    redc_step(v, pk, s.lane, i);
    if (i + 1 < ND) {
      ring_up(y0, s.lane);
      ring_up(y1, s.lane);
      ring_up(ny1, s.lane);
      ring_up(pk, s.lane);
    }
  }
  finish(r, u, p, s);
  store_digits(c0, s, r);
  finish(r, v, p, s);
  store_digits(c1, s, r);
}

inline unsigned coop_blocks_for(int64_t n) {
  return static_cast<unsigned>((n * TPI + COOP_THREADS - 1) / COOP_THREADS);
}

// ---------------------------------------------------------------------------
// K3: one thread per element, 13-bit digits
// ---------------------------------------------------------------------------

// -p^{-1} mod 2^13
constexpr uint32_t N0INV = 8189u;

// p as 30 little-endian radix-2^13 limbs
__constant__ uint32_t kP[NL] = {
    2731, 8189, 8191, 7679, 7071, 8191, 1359, 8150, 3071, 245,
    7561, 3425, 2575, 6249, 7580, 599,  4997, 7207, 7634, 3784,
    6861, 421,  7897, 884,  6731, 7988, 3679, 980,  17,   13};

constexpr int THREADS = 64;

__device__ __forceinline__ void load(uint32_t x[NL], const int32_t* src) {
#pragma unroll
  for (int j = 0; j < NL; ++j) x[j] = static_cast<uint32_t>(src[j]);
}

__device__ __forceinline__ void store(int32_t* dst, const uint32_t x[NL]) {
#pragma unroll
  for (int j = 0; j < NL; ++j) dst[j] = static_cast<int32_t>(x[j]);
}

// r = u - p if u >= p else u, for canonical limbs u holding a value < 2p.
// r may alias u.
__device__ __forceinline__ void cond_sub_p(uint32_t r[NL], const uint32_t u[NL]) {
  uint32_t d[NL];
  int32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const int32_t v = static_cast<int32_t>(u[j]) - static_cast<int32_t>(kP[j]) - borrow;
    borrow = v < 0;
    d[j] = static_cast<uint32_t>(v) & MASK;
  }
  // borrow set: u < p, keep u
#pragma unroll
  for (int j = 0; j < NL; ++j) r[j] = borrow ? u[j] : d[j];
}

// r = a + b mod p on canonical limbs.  r may alias a or b.
__device__ __forceinline__ void add_mod(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL]) {
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const uint32_t v = a[j] + b[j] + c;
    r[j] = v & MASK;
    c = v >> BITS;
  }
  // a + b < 2p < 2^390: no carry leaves limb 29
  cond_sub_p(r, r);
}

// r = a - b mod p on canonical limbs.  r may alias a or b.
__device__ __forceinline__ void sub_mod(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL]) {
  int32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const int32_t v = static_cast<int32_t>(a[j]) - static_cast<int32_t>(b[j]) - borrow;
    borrow = v < 0;
    r[j] = static_cast<uint32_t>(v) & MASK;
  }
  // a < b: the limbs hold a - b + 2^390; adding p and dropping the carry
  // out of limb 29 (exactly 2^390) leaves a - b + p in [0, p)
  const uint32_t pmask = 0u - static_cast<uint32_t>(borrow);
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const uint32_t v = r[j] + (kP[j] & pmask) + c;
    r[j] = v & MASK;
    c = v >> BITS;
  }
}

// r = a * b * 2^-390 mod p, canonical.  r may alias a or b: it is written
// only after the last read of the inputs.
__device__ __forceinline__ void mont_core(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL]) {
  uint32_t u[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) u[j] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t ai = a[i];
#pragma unroll
    for (int j = 0; j < NL; ++j) u[j] += ai * b[j];
    // only the low 13 bits of the product are needed, so the wrap is harmless
    const uint32_t m = (u[0] * N0INV) & MASK;
#pragma unroll
    for (int j = 0; j < NL; ++j) u[j] += m * kP[j];
    // u[0] is now a multiple of 2^13: shift the digit out
    const uint32_t carry = u[0] >> BITS;
#pragma unroll
    for (int j = 0; j < NL - 1; ++j) u[j] = u[j + 1];
    u[NL - 1] = 0;
    u[0] += carry;
  }
  // one serial carry pass: the value is below 2p < 2^390, so no carry
  // leaves limb 29 and the limbs come out canonical
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const uint32_t v = u[j] + c;
    u[j] = v & MASK;
    c = v >> BITS;
  }
  cond_sub_p(r, u);
}

// Fp2 square: c0 = (a0+a1)(a0-a1), c1 = 2 a0 a1
__global__ void __launch_bounds__(THREADS)
f2_sqr_kernel(const int32_t* __restrict__ a0, const int32_t* __restrict__ a1,
              int32_t* __restrict__ c0, int32_t* __restrict__ c1, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t off = i * NL;
  uint32_t x[NL], y[NL], s[NL];
  load(x, a0 + off);
  load(y, a1 + off);
  add_mod(s, x, y);
  sub_mod(y, x, y);
  mont_core(s, s, y);
  store(c0 + off, s);
  load(y, a1 + off);
  mont_core(x, x, y);
  add_mod(x, x, x);
  store(c1 + off, x);
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

}  // namespace

// Launchers: pointers to contiguous (n, 30) int32 arrays on the current
// device, n > 0, and the CUDA stream to launch on.  Each returns the
// cudaError_t of the launch (0 on success); none synchronises.
extern "C" int lodestar_fp_mont_mul(const void* a, const void* b, void* out,
                                    int64_t n, void* stream) {
  mont_mul_kernel<<<coop_blocks_for(n), COOP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lodestar_fp_f2_mul(const void* a0, const void* a1, const void* b0,
                                  const void* b1, void* c0, void* c1, int64_t n,
                                  void* stream) {
  f2_mul_kernel<<<coop_blocks_for(n), COOP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a0), static_cast<const int32_t*>(a1),
      static_cast<const int32_t*>(b0), static_cast<const int32_t*>(b1),
      static_cast<int32_t*>(c0), static_cast<int32_t*>(c1), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lodestar_fp_f2_sqr(const void* a0, const void* a1, void* c0, void* c1,
                                  int64_t n, void* stream) {
  f2_sqr_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a0), static_cast<const int32_t*>(a1),
      static_cast<int32_t*>(c0), static_cast<int32_t*>(c1), n);
  return static_cast<int>(cudaGetLastError());
}
