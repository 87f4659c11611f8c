// The base fields of the seven curves, one traits type each, for the
// generic word core (fe32.cuh, curve32.cuh, lanes32.cuh) and the kernels
// built on it. Every constant here is derived from msm_tpu_torch/params.py
// (tests/test_torch_fields_consts.py checks each one against it):
//
//   NW      32-bit words per element: ceil(modulus bits / 32), the dense
//           coordinate width of the packed table (params coord_words)
//   L       13-bit limbs at the kernel boundaries (MsmConfig.num_words);
//           the Montgomery radix is R = 2^(13 L), as MsmConfig.r
//   TAIL    13 L - 32 NW: the bits of the last REDC step after the word
//           REDC by 2^(32 NW)
//   N0W     -p^-1 mod 2^32;  N0T  -p^-1 mod 2^TAIL
//   B3      3b mod p as a small signed integer: a product by it is a
//           double-and-add, negated when B3 < 0 (Grumpkin's 3b = p - 51)
//   CARRY   the word core keeps a carry word: the top word of p is above
//           2^31 - 2 (the no-carry CIOS does not hold) and 2p >= 2^(32 NW)
//           (secp256k1 only)
//   REDUCE_TOP    the largest s with p 2^s < 2^(32 NW): conditional
//                 subtracts of p 2^s .. p bring any NW-word value below p
//   BALANCED_TOP  the largest s with p 2^s < 2^(13 L), the same for a
//                 (NW + 1)-word value below 2^(13 L)
//   BLOCKS_PER_SM  the word-core kernels' __launch_bounds__ minimum of
//                  128-thread blocks per SM, MSM_BLOCKS_NW<NW>: the build
//                  defines it from ops/_build.py WORD_BLOCKS_PER_SM (4: 128
//                  registers a thread at NW = 8; 2: 255 at NW = 12), the one
//                  table the launch plans also read
//   p, r, r2  the modulus, R mod p (Montgomery one) and R^2 mod p, words
//             least significant first
//   beta_r2   beta R^2 mod p, beta the cube root of unity of the curve's GLV
//             endomorphism phi(x, y) = (beta x, y) (ops/glv.py glv_params):
//             the GLV convert's constant
//
// ID is the curve's index in params.CURVES, the `curve` argument of the
// kernels' C entries (ops/_build.curve_id).
#pragma once

#include "hd.cuh"

#if !defined(MSM_BLOCKS_NW8) || !defined(MSM_BLOCKS_NW12)
#error "compile with ops/_build.py FIELD_FLAGS (the launch bounds' blocks per SM)"
#endif

namespace msm {

// bn254: 254-bit p, R = 2^260
struct FpBn254 {
  static constexpr int ID = 0, NW = 8, L = 20, TAIL = 4;
  static constexpr uint32_t N0W = 0xe4866389u, N0T = 0x9u;
  static constexpr int B3 = 9;
  static constexpr bool CARRY = false;
  static constexpr int REDUCE_TOP = 2, BALANCED_TOP = 6;
  static constexpr int BLOCKS_PER_SM = MSM_BLOCKS_NW8;
  // the modulus
  MSM_HDM static uint32_t p(int i) {
    const uint32_t t[NW] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                            0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return t[i];
  }
  // R mod p: the Montgomery form of 1
  MSM_HDM static uint32_t r(int i) {
    const uint32_t t[NW] = {0xf6fce4b4u, 0x45520880u, 0xbaa989a8u, 0x49890849u,
                            0x818f014au, 0x85a9201du, 0x1bb7724fu, 0x1f16424eu};
    return t[i];
  }
  // R^2 mod p: a product by it enters Montgomery form
  MSM_HDM static uint32_t r2(int i) {
    const uint32_t t[NW] = {0x1966eb04u, 0xb868a81du, 0x95018016u, 0x98e61561u,
                            0x0b4f898cu, 0xbfd53160u, 0x0d3a9969u, 0x0a8469a3u};
    return t[i];
  }
  // beta R^2 mod p (beta the cube root of unity that ops/glv.py's
  // glv_params pairs with lambda): a product by it takes x to beta x R, the
  // x of phi(P) = (beta x, y) in Montgomery form (the GLV convert)
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0xc5965f4du, 0x1da07d4au, 0x79524b23u, 0xaa9fd3f7u,
                            0x717abf22u, 0x928de493u, 0x1de5790cu, 0x18ab8c66u};
    return t[i];
  }
};

// bls12_377: 377-bit p, R = 2^390
struct FpBls12_377 {
  static constexpr int ID = 1, NW = 12, L = 30, TAIL = 6;
  static constexpr uint32_t N0W = 0xffffffffu, N0T = 0x3fu;
  static constexpr int B3 = 3;
  static constexpr bool CARRY = false;
  static constexpr int REDUCE_TOP = 7, BALANCED_TOP = 13;
  static constexpr int BLOCKS_PER_SM = MSM_BLOCKS_NW12;
  // the modulus
  MSM_HDM static uint32_t p(int i) {
    const uint32_t t[NW] = {0x00000001u, 0x8508c000u, 0x30000000u, 0x170b5d44u,
                            0xba094800u, 0x1ef3622fu, 0x00f5138fu, 0x1a22d9f3u,
                            0x6ca1493bu, 0xc63b05c0u, 0x17c510eau, 0x01ae3a46u};
    return t[i];
  }
  // R mod p: the Montgomery form of 1
  MSM_HDM static uint32_t r(int i) {
    const uint32_t t[NW] = {0xffffd9ebu, 0xc9c83fffu, 0x0fffec35u, 0x6c393a48u,
                            0x5c8d1492u, 0x5575dc78u, 0x8afe26aau, 0xaeca0cecu,
                            0x25e63845u, 0xfa4df717u, 0xcc52c350u, 0x000ed0b8u};
    return t[i];
  }
  // R^2 mod p: a product by it enters Montgomery form
  MSM_HDM static uint32_t r2(int i) {
    const uint32_t t[NW] = {0x0cd21be9u, 0x4fbd8940u, 0xf31b1958u, 0x6050391fu,
                            0x8f5157d4u, 0xc9aa84fbu, 0xf1e7c3d2u, 0x1346d74eu,
                            0x491d1b46u, 0x2dca7e1bu, 0xddc05807u, 0x003c5d3du};
    return t[i];
  }
  // beta R^2 mod p (beta the cube root of unity that ops/glv.py's
  // glv_params pairs with lambda): a product by it takes x to beta x R, the
  // x of phi(P) = (beta x, y) in Montgomery form (the GLV convert)
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0x976e4ecdu, 0x15872eabu, 0xcb275732u, 0xa54044e8u,
                            0xa72ee79du, 0xfe98e1c3u, 0x24415920u, 0x2ac14e5cu,
                            0x95796032u, 0x89b36bebu, 0x37f616b1u, 0x012eb58du};
    return t[i];
  }
};

// pallas: 255-bit p, R = 2^273
struct FpPallas {
  static constexpr int ID = 2, NW = 8, L = 21, TAIL = 17;
  static constexpr uint32_t N0W = 0xffffffffu, N0T = 0x1ffffu;
  static constexpr int B3 = 15;
  static constexpr bool CARRY = false;
  static constexpr int REDUCE_TOP = 1, BALANCED_TOP = 18;
  static constexpr int BLOCKS_PER_SM = MSM_BLOCKS_NW8;
  // the modulus
  MSM_HDM static uint32_t p(int i) {
    const uint32_t t[NW] = {0x00000001u, 0x992d30edu, 0x094cf91bu, 0x224698fcu,
                            0x00000000u, 0x00000000u, 0x00000000u, 0x40000000u};
    return t[i];
  }
  // R mod p: the Montgomery form of 1
  MSM_HDM static uint32_t r(int i) {
    const uint32_t t[NW] = {0xfff80001u, 0x11c530ecu, 0x40702fb2u, 0x5a664e94u,
                            0xfffeedcbu, 0xffffffffu, 0xffffffffu, 0x3fffffffu};
    return t[i];
  }
  // R^2 mod p: a product by it enters Montgomery form
  MSM_HDM static uint32_t r2(int i) {
    const uint32_t t[NW] = {0x692be509u, 0x3c29b990u, 0xf0b73785u, 0x906581cau,
                            0x4b1a733fu, 0x0f257463u, 0xde5ea66fu, 0x2e72dc51u};
    return t[i];
  }
  // beta R^2 mod p (beta the cube root of unity that ops/glv.py's
  // glv_params pairs with lambda): a product by it takes x to beta x R, the
  // x of phi(P) = (beta x, y) in Montgomery form (the GLV convert)
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0xaf226ef5u, 0x0ec2f167u, 0x42dae33fu, 0x16806065u,
                            0x023676a2u, 0x0cf9bce7u, 0x9f6b31b3u, 0x3f24de89u};
    return t[i];
  }
};

// bls12_381: 381-bit p, R = 2^390
struct FpBls12_381 {
  static constexpr int ID = 3, NW = 12, L = 30, TAIL = 6;
  static constexpr uint32_t N0W = 0xfffcfffdu, N0T = 0x3du;
  static constexpr int B3 = 12;
  static constexpr bool CARRY = false;
  static constexpr int REDUCE_TOP = 3, BALANCED_TOP = 9;
  static constexpr int BLOCKS_PER_SM = MSM_BLOCKS_NW12;
  // the modulus
  MSM_HDM static uint32_t p(int i) {
    const uint32_t t[NW] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
                            0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
                            0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
    return t[i];
  }
  // R mod p: the Montgomery form of 1
  MSM_HDM static uint32_t r(int i) {
    const uint32_t t[NW] = {0x00d1ff2eu, 0x46760000u, 0x9b4800acu, 0x84b80337u,
                            0xe882431cu, 0x0dd9a7e0u, 0xb683dcf8u, 0xc26c26d0u,
                            0x63c4a5eeu, 0x29f14576u, 0x7f3e804bu, 0x015de996u};
    return t[i];
  }
  // R^2 mod p: a product by it enters Montgomery form
  MSM_HDM static uint32_t r2(int i) {
    const uint32_t t[NW] = {0x4510070fu, 0xaec641c3u, 0xa0132243u, 0x6ea66ec3u,
                            0x1df507afu, 0x5efee07bu, 0xeed21b14u, 0x41442921u,
                            0x2d32f70au, 0x97900177u, 0x4acd918cu, 0x0f696ee0u};
    return t[i];
  }
  // beta R^2 mod p (beta the cube root of unity that ops/glv.py's
  // glv_params pairs with lambda): a product by it takes x to beta x R, the
  // x of phi(P) = (beta x, y) in Montgomery form (the GLV convert)
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0x2405157bu, 0x47c8bd29u, 0x1f3f884du, 0xc9a4ffc2u,
                            0xf4d4842cu, 0x05389ea8u, 0x40c3ca69u, 0x0299013eu,
                            0xe73e0af1u, 0x05c5e90fu, 0x4981a1f8u, 0x022ffb5cu};
    return t[i];
  }
};

// secp256k1: 256-bit p, R = 2^273
struct FpSecp256k1 {
  static constexpr int ID = 4, NW = 8, L = 21, TAIL = 17;
  static constexpr uint32_t N0W = 0xd2253531u, N0T = 0x13531u;
  static constexpr int B3 = 21;
  static constexpr bool CARRY = true;
  static constexpr int REDUCE_TOP = 0, BALANCED_TOP = 17;
  static constexpr int BLOCKS_PER_SM = MSM_BLOCKS_NW8;
  // the modulus
  MSM_HDM static uint32_t p(int i) {
    const uint32_t t[NW] = {0xfffffc2fu, 0xfffffffeu, 0xffffffffu, 0xffffffffu,
                            0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu};
    return t[i];
  }
  // R mod p: the Montgomery form of 1
  MSM_HDM static uint32_t r(int i) {
    const uint32_t t[NW] = {0x07a20000u, 0x00020000u, 0x00000000u, 0x00000000u,
                            0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u};
    return t[i];
  }
  // R^2 mod p: a product by it enters Montgomery form
  MSM_HDM static uint32_t r2(int i) {
    const uint32_t t[NW] = {0x00000000u, 0x003a4284u, 0x00001e88u, 0x00000004u,
                            0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u};
    return t[i];
  }
  // beta R^2 mod p (beta the cube root of unity that ops/glv.py's
  // glv_params pairs with lambda): a product by it takes x to beta x R, the
  // x of phi(P) = (beta x, y) in Montgomery form (the GLV convert)
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0xae483348u, 0x0e525b8fu, 0x4df91a78u, 0x53294d39u,
                            0x60d2afb9u, 0x1195f61du, 0x0dcf7c5eu, 0xfdfa5bc7u};
    return t[i];
  }
};

// grumpkin: 254-bit p, R = 2^260
struct FpGrumpkin {
  static constexpr int ID = 5, NW = 8, L = 20, TAIL = 4;
  static constexpr uint32_t N0W = 0xefffffffu, N0T = 0xfu;
  static constexpr int B3 = -51;
  static constexpr bool CARRY = false;
  static constexpr int REDUCE_TOP = 2, BALANCED_TOP = 6;
  static constexpr int BLOCKS_PER_SM = MSM_BLOCKS_NW8;
  // the modulus
  MSM_HDM static uint32_t p(int i) {
    const uint32_t t[NW] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                            0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return t[i];
  }
  // R mod p: the Montgomery form of 1
  MSM_HDM static uint32_t r(int i) {
    const uint32_t t[NW] = {0x3fffffacu, 0xb9db6b75u, 0x0f271055u, 0xcef7c838u,
                            0x818f016eu, 0x85a9201du, 0x1bb7724fu, 0x1f16424eu};
    return t[i];
  }
  // R^2 mod p: a product by it enters Montgomery form
  MSM_HDM static uint32_t r2(int i) {
    const uint32_t t[NW] = {0xd16da6f5u, 0xce30b852u, 0x21620cddu, 0x43ffb6c6u,
                            0x2af1b953u, 0x5e103e7cu, 0xa122c3c1u, 0x0281528fu};
    return t[i];
  }
  // beta R^2 mod p (beta the cube root of unity that ops/glv.py's
  // glv_params pairs with lambda): a product by it takes x to beta x R, the
  // x of phi(P) = (beta x, y) in Montgomery form (the GLV convert)
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0x900d62e7u, 0x18f202d3u, 0x42aa9e16u, 0xdcdac82fu,
                            0xd6144bc4u, 0x33399c79u, 0x00eba42eu, 0x2e7d19b8u};
    return t[i];
  }
};

// vesta: 255-bit p, R = 2^273
struct FpVesta {
  static constexpr int ID = 6, NW = 8, L = 21, TAIL = 17;
  static constexpr uint32_t N0W = 0xffffffffu, N0T = 0x1ffffu;
  static constexpr int B3 = 15;
  static constexpr bool CARRY = false;
  static constexpr int REDUCE_TOP = 1, BALANCED_TOP = 18;
  static constexpr int BLOCKS_PER_SM = MSM_BLOCKS_NW8;
  // the modulus
  MSM_HDM static uint32_t p(int i) {
    const uint32_t t[NW] = {0x00000001u, 0x8c46eb21u, 0x0994a8ddu, 0x224698fcu,
                            0x00000000u, 0x00000000u, 0x00000000u, 0x40000000u};
    return t[i];
  }
  // R mod p: the Montgomery form of 1
  MSM_HDM static uint32_t r(int i) {
    const uint32_t t[NW] = {0xfff80001u, 0x333eeb20u, 0xc2a846a6u, 0x5a664c56u,
                            0xfffeedcbu, 0xffffffffu, 0xffffffffu, 0x3fffffffu};
    return t[i];
  }
  // R^2 mod p: a product by it enters Montgomery form
  MSM_HDM static uint32_t r2(int i) {
    const uint32_t t[NW] = {0x692be509u, 0x665dc964u, 0xf31abd7au, 0x886c1d5bu,
                            0x8abb493fu, 0x1333d641u, 0xfeb88c40u, 0x333f6aa5u};
    return t[i];
  }
  // beta R^2 mod p (beta the cube root of unity that ops/glv.py's
  // glv_params pairs with lambda): a product by it takes x to beta x R, the
  // x of phi(P) = (beta x, y) in Montgomery form (the GLV convert)
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0x143c58fau, 0x45f4f4e3u, 0x5639850au, 0x8af7f06bu,
                            0xccad3091u, 0xda52e4d2u, 0x060b9975u, 0x3707c648u};
    return t[i];
  }
};

}  // namespace msm
