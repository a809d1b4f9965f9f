// Montgomery and Fp2 product kernels for BLS12-381 on Hopper (sm_90a), and
// the canonical modular add and subtract.
//
// Replaces the three Pallas kernels of lodestar_tpu/ops/bls12_381/pallas_fp.py:
//   K1 lodestar_fp_mont_mul  <- _mont_mul_kernel / _mont_core (mont_mul)
//   K2 lodestar_fp_f2_mul    <- _f2_mul_kernel (f2_mul)
//   K3 lodestar_fp_f2_sqr    <- _f2_sqr_kernel (f2_sqr)
// and replaces no Pallas kernel with
//   lodestar_fp_add_mod      <- fp.py::add (one XLA fusion on the TPU)
//   lodestar_fp_sub_mod      <- fp.py::sub (one XLA fusion on the TPU)
// which exist because each modular add or subtract in torch ops (their plain
// versions, fp_kernels.add_mod_plain / sub_mod_plain) is some 30 small
// kernels, and a verify program makes ~13k of them.
//
// Layout at the boundary: every operand is an int32 array of shape (n, 30),
// row-major: one field element per row as 30 canonical radix-2^13 limbs,
// little-endian, in Montgomery form with R = 2^390.  Limbs are below 2^13,
// so the int32 storage is read as uint32.  Any exact Montgomery product with
// R = 2^390 that returns the canonical residue is bit-identical to the
// reference (the canonical value is unique), so the design below does not
// copy the TPU's Kogge-Stone sublane networks.
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
// One design for the five kernels: eight lanes per element, 26-bit digits
// ---------------------------------------------------------------------------
//
// * Digits: 15 digits of 26 bits (15 x 26 = 390, so R is unchanged) in 16
//   slots, slot 15 zero.  The boundary conversion is a pair of limbs: digit
//   j = limb 2j + 2^13 limb 2j+1, and back.
// * TPI lanes of a warp cooperate on one element (threads per instance, a
//   compile-time constant shared by all five); lane L holds slots L*D ..
//   L*D+D-1, D = 16/TPI.  Lane L reads and writes limbs 4L .. 4L+3 of its
//   row at TPI = 8, so the lanes of an element touch its 120 contiguous
//   bytes and a warp four neighbouring rows: the accesses coalesce without
//   staging.  Rows are 120 bytes; TMA would spend more on its set-up than
//   it saves.
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
// * Accumulator bound: a slot adds at most 15 steps of terms between two
//   drops, plus one carry below 2^32.  A term is a product of two digits of
//   at most 2^26 - 1; a digit of an uncarried sum of two canonical values
//   is at most 2^27 - 2 = 2 (2^26 - 1), so a product by one counts as two
//   terms.  K1 adds two terms a step (a_i b_k, m p_k):
//     K1: 30 x (2^26-1)^2 + 2^32 = 135,107,989,089,550,366 < 2^57;
//   K2 three (c0 = a0 b0 + a1 (p - b1) and c1 = a0 b1 + a1 b0, each reduced
//   once):
//     K2: 45 x (2^26-1)^2 + 2^32 = 202,661,981,486,841,901 < 2^58;
//   K3 three (a canonical factor times an uncarried one, and m p_k):
//     K3: 45 x (2^26-1)^2 + 2^32 = 202,661,981,486,841,901 < 2^58.
//   So the carry of a digit, u >> 26, is below 2^32, as finish() needs.
//   With both factors of a product uncarried a step would add five terms,
//   75 x (2^26-1)^2 + 2^32 > 2^58, whose carry does not fit 32 bits.
//   T = (x + mu p) / R < 2p for factors below 2p: x < 4p^2, mu < R, and
//   4p^2/R < p/128.  So one conditional subtract of p makes T canonical.
// * The result: two carry passes between neighbouring slots (shfl_up
//   across lanes) leave digits of at most 2^26 + 2^7, whose carries are
//   single bits.  Each lane runs its D digits for a carry in of 0 and of 1;
//   a ballot of the lanes' generate and propagate bits, packed as integers
//   P + 2G, runs the chain across lanes in one addition (bit L of the sum
//   is bit L of P XOR the carry into lane L).  The conditional subtract of
//   p, the subtraction p - b and K3's sum a0 + a1 resolve their carries and
//   borrows the same way.  Lanes past n compute on zeros, so that every
//   lane of a warp reaches every shuffle and ballot, and skip only the
//   store.
// * K2 is the schoolbook product with one reduction per coefficient, not
//   Karatsuba: Karatsuba saves one of four digit products but costs a third
//   reduction and five modular additions, each a cross-lane carry chain of
//   shuffles and ballots, and those chains, not the multiplies, set the
//   time.  The one subtraction left, p - b1, is one borrow chain.  The two
//   coefficients' chains are independent and interleave.
// * K3 is c0 = (a0 + a1)(a0 + (p - a1)) and c1 = a0 (2 a1): two products,
//   each reduced once, run side by side as K2's coefficients are, with
//   half of K2's digit products a step.  A square has nothing left to share
//   between c0 and c1: a form that reuses a product (a0 a1 for both, or
//   c1 = (a0 + a1)^2 - a0^2 - a1^2) needs a third product and reduction and
//   more modular additions, each a cross-lane chain.  Of the factors only
//   a0 + a1 is resolved to canonical digits, by one carry chain that runs
//   beside the borrow chain of p - a1; a0 + (p - a1) and 2 a1 stay
//   uncarried.  So each product has one canonical factor, broadcast a digit
//   a step, and one uncarried, rotated through the slots: the K3 bound
//   above.  All four factors are below 2p < 2^383, so they fit 15 digits.
// * Add and subtract (add_mod_kernel, sub_mod_kernel) run on the same
//   lanes, digits and carry chains, with no product: per element 360 bytes
//   (two inputs, one output), so the bytes bound them, and at the programs'
//   sizes (1 to ~18k elements) a launch costs little more than any launch.  Add:
//   the digitwise sum (digits at most 2^27 - 2) resolved by one carry chain,
//   then the conditional subtract of p that finish() ends with.  Subtract:
//   one borrow chain; where a < b the 16 slots hold a - b + 2^416, and adding
//   p and resolving, with the carry out of slot 15 dropped, leaves a - b + p.
// * Not on the tensor cores: a_i b differs per element, so it is no matrix
//   product.  The products by constants (the digits m p) could be, as int8
//   products; that is later work (PERF.md, open questions).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NL = 30;
constexpr int BITS = 13;
constexpr uint32_t MASK = (1u << BITS) - 1u;

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

// d = w + c over the lane's digits (each at most 2^27 - 2), canonical;
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

// d = w over the group, canonical, for digits of at most 2^27 - 2 - the
// single-bit carries run across lanes; returns the carry out of slot 15.
__device__ __forceinline__ uint32_t resolve(uint32_t d[D], const uint32_t w[D], const Slot& s) {
  uint32_t out;
  const uint32_t o0 = add_digits(d, w, 0u);
  const uint32_t o1 = add_digits(d, w, 1u);
  add_digits(d, w, lane_carry(o0, o1, s, &out));
  return out;
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

// d = w mod p, canonical, for w < 2p with digits of at most 2^27 - 2: the
// carries resolved, then one conditional subtract of p (a borrow out of
// slot 15 means d < p, kept).
__device__ __forceinline__ void resolve_mod_p(uint32_t d[D], const uint32_t w[D],
                                              const uint32_t p[D], const Slot& s) {
  resolve(d, w, s);
  uint32_t diff[D];
  const uint32_t keep = sub_group(diff, d, p, s);
#pragma unroll
  for (int r = 0; r < D; ++r) d[r] = keep ? d[r] : diff[r];
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
  // w < 2^26 + 2^7: single-bit carries; none leaves slot 15 (value < 2p)
  resolve_mod_p(d, w, p, s);
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

// Fp2 square: c0 = (a0 + a1)(a0 + (p - a1)), c1 = a0 (2 a1), each reduced
// once.  The broadcast factors (a0 + a1, a0) are canonical, the rotated
// ones (a0 + (p - a1), 2 a1) uncarried.
__global__ void __launch_bounds__(COOP_THREADS)
f2_sqr_kernel(const int32_t* __restrict__ a0, const int32_t* __restrict__ a1,
              int32_t* __restrict__ c0, int32_t* __restrict__ c1, int64_t n) {
  const Slot s = slot_of(n);
  uint32_t x0[D], x1[D], w[D], sum[D], y0[D], p[D], pk[D], r[D];
  load_digits(x0, a0, s);
  load_digits(x1, a1, s);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    p[j] = pk[j] = kP26[s.lane * D + j];
    w[j] = x0[j] + x1[j];
  }
  resolve(sum, w, s);       // a0 + a1 < 2p: no carry out
  sub_group(y0, p, x1, s);  // p - a1: a1 <= p - 1, no borrow out
#pragma unroll
  for (int j = 0; j < D; ++j) {
    y0[j] += x0[j];  // a0 + (p - a1) < 2p
    x1[j] <<= 1;     // 2 a1 < 2p
  }
  uint64_t u[D] = {}, v[D] = {};
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const uint32_t si = __shfl_sync(FULL, sum[i % D], i / D, TPI);
    const uint32_t x0i = __shfl_sync(FULL, x0[i % D], i / D, TPI);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      u[j] += static_cast<uint64_t>(si) * y0[j];
      v[j] += static_cast<uint64_t>(x0i) * x1[j];
    }
    redc_step(u, pk, s.lane, i);
    redc_step(v, pk, s.lane, i);
    if (i + 1 < ND) {
      ring_up(y0, s.lane);
      ring_up(x1, s.lane);
      ring_up(pk, s.lane);
    }
  }
  finish(r, u, p, s);
  store_digits(c0, s, r);
  finish(r, v, p, s);
  store_digits(c1, s, r);
}

// a + b mod p on canonical limbs: the digitwise sum, a + b < 2p, reduced as
// finish() reduces a product.
__global__ void __launch_bounds__(COOP_THREADS)
add_mod_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
               int32_t* __restrict__ out, int64_t n) {
  const Slot s = slot_of(n);
  uint32_t x[D], y[D], p[D], r[D];
  load_digits(x, a, s);
  load_digits(y, b, s);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    p[j] = kP26[s.lane * D + j];
    x[j] += y[j];  // at most 2^27 - 2
  }
  resolve_mod_p(r, x, p, s);
  store_digits(out, s, r);
}

// a - b mod p on canonical limbs: where a < b the borrow leaves slot 15 and
// the slots hold a - b + 2^416 (slot 15 at 2^26 - 1); adding p carries
// exactly 2^416 out of slot 15, which resolve drops, and leaves a - b + p.
__global__ void __launch_bounds__(COOP_THREADS)
sub_mod_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
               int32_t* __restrict__ out, int64_t n) {
  const Slot s = slot_of(n);
  uint32_t x[D], y[D], diff[D], w[D], r[D];
  load_digits(x, a, s);
  load_digits(y, b, s);
  const uint32_t borrow = sub_group(diff, x, y, s);
#pragma unroll
  for (int j = 0; j < D; ++j) w[j] = diff[j] + kP26[s.lane * D + j];  // at most 2^27 - 2
  resolve(r, w, s);
#pragma unroll
  for (int j = 0; j < D; ++j) r[j] = borrow ? r[j] : diff[j];
  store_digits(out, s, r);
}

inline unsigned coop_blocks_for(int64_t n) {
  return static_cast<unsigned>((n * TPI + COOP_THREADS - 1) / COOP_THREADS);
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
  f2_sqr_kernel<<<coop_blocks_for(n), COOP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a0), static_cast<const int32_t*>(a1),
      static_cast<int32_t*>(c0), static_cast<int32_t*>(c1), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lodestar_fp_add_mod(const void* a, const void* b, void* out, int64_t n,
                                   void* stream) {
  add_mod_kernel<<<coop_blocks_for(n), COOP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lodestar_fp_sub_mod(const void* a, const void* b, void* out, int64_t n,
                                   void* stream) {
  sub_mod_kernel<<<coop_blocks_for(n), COOP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
