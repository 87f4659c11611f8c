// Fast CPU MSM oracle for BN254 G1 — the in-repo replacement for the
// reference's external `halo2curves` crate oracle (reference usage:
// src/lib.rs:45-47 `cpu_msm` -> halo2curves msm_best; naive path
// `best_multiexp` at src/naive/halo2curves/mod.rs:31-33).
//
// Design: 4x64-bit-limb Montgomery field arithmetic (CIOS with unsigned
// __int128 carries), Jacobian G1 group ops (dbl-2009-l / add-2007-bl — the
// same formula family the reference's WGSL EC library uses,
// src/cuzk/wgsl/curve/ec.template.wgsl:10-86), and a windowed Pippenger MSM
// (the role halo2curves' msm_best plays). Exposed to Python over a minimal
// C ABI (see msm_tpu/oracle/native.py).
//
// Wire format (all little-endian byte strings, standard — non-Montgomery —
// form, matching the reference's 32-byte field serialization, lib.rs:50-65):
//   points : n * 64 bytes  (x || y), x=y=0 encodes the identity
//   scalars: n * 32 bytes
//   out    : 96 bytes Jacobian (x || y || z), z=0 encodes the identity

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

using u64 = std::uint64_t;
using u128 = unsigned __int128;

// ---------------------------------------------------------------------------
// BN254 base field Fp, Montgomery form, 4x64 limbs
// ---------------------------------------------------------------------------

struct Fp {
  u64 v[4];
};

static const Fp P = {{0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                      0xb85045b68181585dULL, 0x30644e72e131a029ULL}};
static const u64 N0 = 0x87d20782e4866389ULL;  // -p^-1 mod 2^64
static const Fp R1 = {{0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL,
                       0x666ea36f7879462cULL, 0x0e0a77c19a07df2fULL}};  // R mod p
static const Fp R2 = {{0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL,
                       0x47ab1eff0a417ff6ULL, 0x06d89f71cab8351fULL}};  // R^2 mod p
static const Fp ZERO = {{0, 0, 0, 0}};

static inline bool is_zero(const Fp &a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

static inline bool eq(const Fp &a, const Fp &b) {
  return a.v[0] == b.v[0] && a.v[1] == b.v[1] && a.v[2] == b.v[2] &&
         a.v[3] == b.v[3];
}

static inline bool gte_p(const Fp &a) {
  for (int i = 3; i >= 0; --i) {
    if (a.v[i] > P.v[i]) return true;
    if (a.v[i] < P.v[i]) return false;
  }
  return true;  // equal
}

static inline void sub_p(Fp &a) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - P.v[i] - borrow;
    a.v[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
}

static inline Fp add(const Fp &a, const Fp &b) {
  Fp r;
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    r.v[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || gte_p(r)) sub_p(r);
  return r;
}

static inline Fp sub(const Fp &a, const Fp &b) {
  Fp r;
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - b.v[i] - borrow;
    r.v[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
  if (borrow) {
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)r.v[i] + P.v[i] + carry;
      r.v[i] = (u64)s;
      carry = s >> 64;
    }
  }
  return r;
}

static inline Fp neg(const Fp &a) { return is_zero(a) ? a : sub(ZERO, a); }

// Montgomery product: a*b*R^-1 mod p (CIOS). The 64-bit-limb big brother of
// the reference's 13-bit interleaved product
// (src/cuzk/wgsl/montgomery/mont_pro_product.template.wgsl:11-35).
static inline Fp mont_mul(const Fp &a, const Fp &b) {
  u64 t[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    // t += a[i] * b
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)a.v[i] * b.v[j] + t[j] + carry;
      t[j] = (u64)s;
      carry = s >> 64;
    }
    u128 t4 = (u128)t[4] + carry;
    // m = t[0] * n0 mod 2^64 ; t += m * p ; t >>= 64
    u64 m = t[0] * N0;
    u128 s = (u128)m * P.v[0] + t[0];
    carry = s >> 64;
    for (int j = 1; j < 4; ++j) {
      s = (u128)m * P.v[j] + t[j] + carry;
      t[j - 1] = (u64)s;
      carry = s >> 64;
    }
    t4 += carry;
    t[3] = (u64)t4;
    t[4] = (u64)(t4 >> 64);
  }
  Fp r = {{t[0], t[1], t[2], t[3]}};
  if (t[4] || gte_p(r)) sub_p(r);
  return r;
}

static inline Fp sqr(const Fp &a) { return mont_mul(a, a); }
static inline Fp to_mont(const Fp &a) { return mont_mul(a, R2); }
static inline Fp from_mont(const Fp &a) {
  Fp one = {{1, 0, 0, 0}};
  return mont_mul(a, one);
}

static inline Fp dbl(const Fp &a) { return add(a, a); }

// ---------------------------------------------------------------------------
// G1 Jacobian (x, y, z), Montgomery-form coordinates, identity z == 0
// ---------------------------------------------------------------------------

struct G1 {
  Fp x, y, z;
};

static const G1 G1_ID = {ZERO, R1, ZERO};  // (0 : 1 : 0) like ec.template.wgsl:4

static inline bool is_identity(const G1 &p) { return is_zero(p.z); }

// dbl-2009-l (reference: ec.template.wgsl:10-34)
static G1 g1_double(const G1 &p) {
  if (is_identity(p)) return p;
  Fp a = sqr(p.x);
  Fp b = sqr(p.y);
  Fp c = sqr(b);
  Fp t = add(p.x, b);
  Fp d = dbl(sub(sqr(t), add(a, c)));
  Fp e = add(dbl(a), a);
  Fp f = sqr(e);
  G1 r;
  r.x = sub(f, dbl(d));
  Fp c8 = dbl(dbl(dbl(c)));
  r.y = sub(mont_mul(e, sub(d, r.x)), c8);
  r.z = dbl(mont_mul(p.y, p.z));
  return r;
}

// add-2007-bl with the reference's identity/doubling branches
// (ec.template.wgsl:36-86)
static G1 g1_add(const G1 &p, const G1 &q) {
  if (is_identity(p)) return q;
  if (is_identity(q)) return p;
  Fp z1z1 = sqr(p.z);
  Fp z2z2 = sqr(q.z);
  Fp u1 = mont_mul(p.x, z2z2);
  Fp u2 = mont_mul(q.x, z1z1);
  Fp s1 = mont_mul(mont_mul(p.y, z2z2), q.z);
  Fp s2 = mont_mul(mont_mul(q.y, z1z1), p.z);
  if (eq(u1, u2)) {
    if (eq(s1, s2)) return g1_double(p);
    return G1_ID;  // P + (-P)
  }
  Fp h = sub(u2, u1);
  Fp i = sqr(dbl(h));
  Fp j = mont_mul(h, i);
  Fp rr = dbl(sub(s2, s1));
  Fp v = mont_mul(u1, i);
  G1 r;
  r.x = sub(sub(sqr(rr), j), dbl(v));
  r.y = sub(mont_mul(rr, sub(v, r.x)), dbl(mont_mul(s1, j)));
  Fp zs = add(p.z, q.z);
  r.z = mont_mul(sub(sub(sqr(zs), z1z1), z2z2), h);
  return r;
}

// mixed add: q affine (z == 1 in Montgomery form, i.e. R1) — madd-2007-bl
static G1 g1_add_affine(const G1 &p, const Fp &qx, const Fp &qy,
                        bool q_identity) {
  if (q_identity) return p;
  if (is_identity(p)) {
    G1 r = {qx, qy, R1};
    return r;
  }
  Fp z1z1 = sqr(p.z);
  Fp u2 = mont_mul(qx, z1z1);
  Fp s2 = mont_mul(mont_mul(qy, z1z1), p.z);
  if (eq(p.x, u2)) {
    if (eq(p.y, s2)) return g1_double(p);
    return G1_ID;
  }
  Fp h = sub(u2, p.x);
  Fp hh = sqr(h);
  Fp i = dbl(dbl(hh));
  Fp j = mont_mul(h, i);
  Fp rr = dbl(sub(s2, p.y));
  Fp v = mont_mul(p.x, i);
  G1 r;
  r.x = sub(sub(sqr(rr), j), dbl(v));
  r.y = sub(mont_mul(rr, sub(v, r.x)), dbl(mont_mul(p.y, j)));
  r.z = sub(sub(sqr(add(p.z, h)), z1z1), hh);
  return r;
}

static inline G1 g1_neg(const G1 &p) {
  G1 r = {p.x, neg(p.y), p.z};
  return r;
}

// ---------------------------------------------------------------------------
// Pippenger MSM (signed windows) — the halo2curves `msm_best` role
// ---------------------------------------------------------------------------

struct AffinePt {
  Fp x, y;     // Montgomery form
  bool inf;
};

static int pick_window(std::size_t n) {
  // ~ln(n) heuristic, matching halo2curves-style tables
  if (n < 4) return 1;
  if (n < 32) return 3;
  std::size_t v = n;
  int bits = 0;
  while (v) { ++bits; v >>= 1; }
  int c = bits - 3;  // ≈ log2(n) - 3
  if (c < 3) c = 3;
  if (c > 16) c = 16;
  return c;
}

static inline int get_window(const std::uint8_t *scalar, int c, int w_idx) {
  // bits [c*w_idx, c*w_idx + c) of a 256-bit LE scalar
  int bit = c * w_idx;
  int byte = bit >> 3, off = bit & 7;
  std::uint32_t acc = 0;
  for (int k = 0; k < 4 && byte + k < 32; ++k)
    acc |= (std::uint32_t)scalar[byte + k] << (8 * k);
  return (int)((acc >> off) & ((1u << c) - 1));
}

// one window's bucket accumulation + running-sum reduction
static G1 window_msm(const std::vector<AffinePt> &pts,
                     const std::uint8_t *scalars, std::size_t n, int c,
                     int w_idx, std::vector<G1> &buckets) {
  const std::size_t nb = ((std::size_t)1 << c) - 1;
  for (std::size_t b = 0; b < nb; ++b) buckets[b] = G1_ID;
  for (std::size_t i = 0; i < n; ++i) {
    int w = get_window(scalars + 32 * i, c, w_idx);
    if (w != 0)
      buckets[w - 1] =
          g1_add_affine(buckets[w - 1], pts[i].x, pts[i].y, pts[i].inf);
  }
  // descending running sum:  sum_b b * S_b
  G1 running = G1_ID, acc = G1_ID;
  for (std::size_t b = nb; b-- > 0;) {
    running = g1_add(running, buckets[b]);
    acc = g1_add(acc, running);
  }
  return acc;
}

static G1 msm(const std::vector<AffinePt> &pts, const std::uint8_t *scalars,
              std::size_t n) {
  if (n == 0) return G1_ID;
  int c = pick_window(n);
  int num_windows = (256 + c - 1) / c;

  std::vector<G1> window_sums(num_windows, G1_ID);
#if defined(_OPENMP)
#pragma omp parallel
  {
    std::vector<G1> buckets((std::size_t)1 << c);
#pragma omp for schedule(dynamic)
    for (int w = 0; w < num_windows; ++w)
      window_sums[w] = window_msm(pts, scalars, n, c, w, buckets);
  }
#else
  std::vector<G1> buckets((std::size_t)1 << c);
  for (int w = 0; w < num_windows; ++w)
    window_sums[w] = window_msm(pts, scalars, n, c, w, buckets);
#endif

  // Horner over windows (reference finishes the same way, msm.rs:409-416)
  G1 acc = window_sums[num_windows - 1];
  for (int w = num_windows - 2; w >= 0; --w) {
    for (int k = 0; k < c; ++k) acc = g1_double(acc);
    acc = g1_add(acc, window_sums[w]);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// byte helpers
// ---------------------------------------------------------------------------

static Fp load_fp(const std::uint8_t *le32) {  // standard form bytes -> mont
  Fp a;
  for (int i = 0; i < 4; ++i) std::memcpy(&a.v[i], le32 + 8 * i, 8);
  return to_mont(a);
}

static void store_fp(std::uint8_t *le32, const Fp &m) {  // mont -> bytes
  Fp a = from_mont(m);
  for (int i = 0; i < 4; ++i) std::memcpy(le32 + 8 * i, &a.v[i], 8);
}

}  // namespace

extern "C" {

// points: n*64 bytes (x||y LE, standard form; x=y=0 => identity)
// scalars: n*32 bytes LE
// out: 96 bytes Jacobian (x||y||z LE, standard form)
int msm_bn254(const std::uint8_t *points, const std::uint8_t *scalars,
              std::size_t n, std::uint8_t *out) {
  std::vector<AffinePt> pts(n);
  bool all_zero;
  for (std::size_t i = 0; i < n; ++i) {
    const std::uint8_t *px = points + 64 * i;
    all_zero = true;
    for (int k = 0; k < 64; ++k)
      if (px[k]) { all_zero = false; break; }
    pts[i].inf = all_zero;
    if (!all_zero) {
      pts[i].x = load_fp(px);
      pts[i].y = load_fp(px + 32);
    } else {
      pts[i].x = ZERO;
      pts[i].y = ZERO;
    }
  }
  G1 r = msm(pts, scalars, n);
  store_fp(out, r.x);
  store_fp(out + 32, r.y);
  store_fp(out + 64, r.z);
  return 0;
}

// single point ops for differential testing of the C++ itself
int g1_add_bn254(const std::uint8_t *p96, const std::uint8_t *q96,
                 std::uint8_t *out96) {
  G1 p = {load_fp(p96), load_fp(p96 + 32), load_fp(p96 + 64)};
  G1 q = {load_fp(q96), load_fp(q96 + 32), load_fp(q96 + 64)};
  G1 r = g1_add(p, q);
  store_fp(out96, r.x);
  store_fp(out96 + 32, r.y);
  store_fp(out96 + 64, r.z);
  return 0;
}

int g1_double_bn254(const std::uint8_t *p96, std::uint8_t *out96) {
  G1 p = {load_fp(p96), load_fp(p96 + 32), load_fp(p96 + 64)};
  G1 r = g1_double(p);
  store_fp(out96, r.x);
  store_fp(out96 + 32, r.y);
  store_fp(out96 + 64, r.z);
  return 0;
}

}  // extern "C"
