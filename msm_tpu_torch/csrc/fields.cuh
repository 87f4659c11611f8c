// The base fields of the seven curves, one traits type each, for the
// generic word core (fe32.cuh, curve32.cuh, lanes32.cuh) and the kernels
// built on it. Every constant here is derived from msm_tpu_torch/params.py
// (tests/test_torch_fields_consts.py checks each one against it).
//
// The limb width W of the kernel boundaries is one per build:
// MSM_LIMB_BITS, 13 unless the compile defines 12 (ops/_build.py builds one
// library per width, the same sources under the same names). Each traits
// type holds a table per width; the constants that do not depend on it
// stand before the tables.
//
//   NW      32-bit words per element: ceil(modulus bits / 32), the dense
//           coordinate width of the packed table (params coord_words)
//   W, MASK the limb width and 2^W - 1 (MsmConfig.word_size)
//   L       W-bit limbs at the kernel boundaries (MsmConfig.num_words);
//           the Montgomery radix is R = 2^(W L), as MsmConfig.r
//   TAIL    W L - 32 NW, in [0, 32): the bits of the last REDC step after
//           the word REDC by 2^(32 NW) (none at 0: R = 2^(32 NW))
//   N0W     -p^-1 mod 2^32;  N0T  -p^-1 mod 2^TAIL (0 where TAIL is 0)
//   B3      3b mod p as a small signed integer: a product by it is a
//           double-and-add, negated when B3 < 0 (Grumpkin's 3b = p - 51)
//   CARRY   the word core keeps a carry word: the top word of p is above
//           2^31 - 2 (the no-carry CIOS does not hold) and 2p >= 2^(32 NW)
//           (secp256k1 only)
//   REDUCE_TOP    the largest s with p 2^s < 2^(32 NW): conditional
//                 subtracts of p 2^s .. p bring any NW-word value below p
//   BALANCED_TOP  the largest s with p 2^s < 2^(W L), the same for a
//                 (NW + 1)-word value below 2^(W L)
//   BLOCKS_PER_SM  the word-core kernels' __launch_bounds__ minimum of
//                  128-thread blocks per SM, MSM_BLOCKS_NW<NW>: the build
//                  defines it from ops/_build.py WORD_BLOCKS_PER_SM (4: 128
//                  registers a thread at NW = 8; 2: 255 at NW = 12), the one
//                  table the launch plans also read
//   p, r, r2  the modulus, R mod p (Montgomery one) and R^2 mod p, words
//             least significant first
//   beta_r2   beta R^2 mod p, beta the cube root of unity of the curve's GLV
//             endomorphism phi(x, y) = (beta x, y) (ops/glv.py glv_params):
//             the GLV convert's constant, a product by which takes x to the
//             x of phi(P) in Montgomery form
//
// ID is the curve's index in params.CURVES, the `curve` argument of the
// kernels' C entries (ops/_build.curve_id).
#pragma once

#include "hd.cuh"

#if !defined(MSM_BLOCKS_NW8) || !defined(MSM_BLOCKS_NW12)
#error "compile with ops/_build.py FIELD_FLAGS (the launch bounds' blocks per SM)"
#endif

#ifndef MSM_LIMB_BITS
#define MSM_LIMB_BITS 13
#endif
#if MSM_LIMB_BITS != 13 && MSM_LIMB_BITS != 12
#error "fields.cuh holds traits tables for 13- and 12-bit limbs only"
#endif

namespace msm {

// bn254: 254-bit p
struct FpBn254 {
  static constexpr int ID = 0, NW = 8;
  static constexpr uint32_t N0W = 0xe4866389u;
  static constexpr int B3 = 9;
  static constexpr bool CARRY = false;
  static constexpr int REDUCE_TOP = 2;
  static constexpr int BLOCKS_PER_SM = MSM_BLOCKS_NW8;
  // the modulus
  MSM_HDM static uint32_t p(int i) {
    const uint32_t t[NW] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                            0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return t[i];
  }
#if MSM_LIMB_BITS == 13  // R = 2^260
  static constexpr int W = 13, L = 20, TAIL = 4, BALANCED_TOP = 6;
  static constexpr uint32_t MASK = 0x1fffu, N0T = 0x9u;
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
  // beta R^2 mod p: a product by it takes x to beta x R
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0xc5965f4du, 0x1da07d4au, 0x79524b23u, 0xaa9fd3f7u,
                            0x717abf22u, 0x928de493u, 0x1de5790cu, 0x18ab8c66u};
    return t[i];
  }
#elif MSM_LIMB_BITS == 12  // R = 2^264
  static constexpr int W = 12, L = 22, TAIL = 8, BALANCED_TOP = 10;
  static constexpr uint32_t MASK = 0xfffu, N0T = 0x89u;
  // R mod p: the Montgomery form of 1
  MSM_HDM static uint32_t r(int i) {
    const uint32_t t[NW] = {0xfaec667au, 0xfbdb0f2au, 0x9626b0ffu, 0xad825aedu,
                            0x09e2a0fcu, 0x276f48b7u, 0xef86e357u, 0x0d791464u};
    return t[i];
  }
  // R^2 mod p: a product by it enters Montgomery form
  MSM_HDM static uint32_t r2(int i) {
    const uint32_t t[NW] = {0xe41099bfu, 0x7daa0430u, 0x910d9260u, 0x59477c57u,
                            0x7cbf907du, 0x3bf265d5u, 0xd8f000c9u, 0x1edcc85eu};
    return t[i];
  }
  // beta R^2 mod p: a product by it takes x to beta x R
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0xa6e6aef2u, 0x17f6272bu, 0x48824765u, 0xb01bd9a2u,
                            0xb7104323u, 0xf5212cc3u, 0x8a45b762u, 0x189c8fc7u};
    return t[i];
  }
#endif
};

// bls12_377: 377-bit p
struct FpBls12_377 {
  static constexpr int ID = 1, NW = 12;
  static constexpr uint32_t N0W = 0xffffffffu;
  static constexpr int B3 = 3;
  static constexpr bool CARRY = false;
  static constexpr int REDUCE_TOP = 7;
  static constexpr int BLOCKS_PER_SM = MSM_BLOCKS_NW12;
  // the modulus
  MSM_HDM static uint32_t p(int i) {
    const uint32_t t[NW] = {0x00000001u, 0x8508c000u, 0x30000000u, 0x170b5d44u,
                            0xba094800u, 0x1ef3622fu, 0x00f5138fu, 0x1a22d9f3u,
                            0x6ca1493bu, 0xc63b05c0u, 0x17c510eau, 0x01ae3a46u};
    return t[i];
  }
#if MSM_LIMB_BITS == 13  // R = 2^390
  static constexpr int W = 13, L = 30, TAIL = 6, BALANCED_TOP = 13;
  static constexpr uint32_t MASK = 0x1fffu, N0T = 0x3fu;
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
  // beta R^2 mod p: a product by it takes x to beta x R
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0x976e4ecdu, 0x15872eabu, 0xcb275732u, 0xa54044e8u,
                            0xa72ee79du, 0xfe98e1c3u, 0x24415920u, 0x2ac14e5cu,
                            0x95796032u, 0x89b36bebu, 0x37f616b1u, 0x012eb58du};
    return t[i];
  }
#elif MSM_LIMB_BITS == 12  // R = 2^384
  static constexpr int W = 12, L = 32, TAIL = 0, BALANCED_TOP = 7;
  static constexpr uint32_t MASK = 0xfffu, N0T = 0x0u;
  // R mod p: the Montgomery form of 1
  MSM_HDM static uint32_t r(int i) {
    const uint32_t t[NW] = {0xffffff68u, 0x02cdffffu, 0x7fffffb1u, 0x51409f83u,
                            0x8a7d3ff2u, 0x9f7db3a9u, 0x6e7c6305u, 0x7b4e97b7u,
                            0x803c84e8u, 0x4cf495bfu, 0xe2fdf49au, 0x008d6661u};
    return t[i];
  }
  // R^2 mod p: a product by it enters Montgomery form
  MSM_HDM static uint32_t r2(int i) {
    const uint32_t t[NW] = {0x9400cd22u, 0xb786686cu, 0xb00431b1u, 0x0329fcaau,
                            0x62d6b46du, 0x22a5f111u, 0x827dc3acu, 0xbfdf7d03u,
                            0x41790bf9u, 0x837e92f0u, 0x1e914b88u, 0x006dfccbu};
    return t[i];
  }
  // beta R^2 mod p: a product by it takes x to beta x R
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0xeab976e5u, 0x7d19f056u, 0xdae5b275u, 0xfb947e11u,
                            0x0ffc0503u, 0xdc31c77au, 0xcc64a27cu, 0x212828cau,
                            0x1addae43u, 0x03d427b5u, 0x79bb9496u, 0x002051e9u};
    return t[i];
  }
#endif
};

// pallas: 255-bit p
struct FpPallas {
  static constexpr int ID = 2, NW = 8;
  static constexpr uint32_t N0W = 0xffffffffu;
  static constexpr int B3 = 15;
  static constexpr bool CARRY = false;
  static constexpr int REDUCE_TOP = 1;
  static constexpr int BLOCKS_PER_SM = MSM_BLOCKS_NW8;
  // the modulus
  MSM_HDM static uint32_t p(int i) {
    const uint32_t t[NW] = {0x00000001u, 0x992d30edu, 0x094cf91bu, 0x224698fcu,
                            0x00000000u, 0x00000000u, 0x00000000u, 0x40000000u};
    return t[i];
  }
#if MSM_LIMB_BITS == 13  // R = 2^273
  static constexpr int W = 13, L = 21, TAIL = 17, BALANCED_TOP = 18;
  static constexpr uint32_t MASK = 0x1fffu, N0T = 0x1ffffu;
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
  // beta R^2 mod p: a product by it takes x to beta x R
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0xaf226ef5u, 0x0ec2f167u, 0x42dae33fu, 0x16806065u,
                            0x023676a2u, 0x0cf9bce7u, 0x9f6b31b3u, 0x3f24de89u};
    return t[i];
  }
#elif MSM_LIMB_BITS == 12  // R = 2^264
  static constexpr int W = 12, L = 22, TAIL = 8, BALANCED_TOP = 9;
  static constexpr uint32_t MASK = 0xfffu, N0T = 0xffu;
  // R mod p: the Montgomery form of 1
  MSM_HDM static uint32_t r(int i) {
    const uint32_t t[NW] = {0xfffffc01u, 0xe4697cecu, 0xd5688ab6u, 0x07e2a8d6u,
                            0xffffff77u, 0xffffffffu, 0xffffffffu, 0x3fffffffu};
    return t[i];
  }
  // R^2 mod p: a product by it enters Montgomery form
  MSM_HDM static uint32_t r2(int i) {
    const uint32_t t[NW] = {0x000eda4bu, 0x17ad276fu, 0x2d7a6ed2u, 0x9db6f383u,
                            0x5d18d2c6u, 0xa99bc3c9u, 0xb7147797u, 0x01af7b9cu};
    return t[i];
  }
  // beta R^2 mod p: a product by it takes x to beta x R
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0xd225abc9u, 0x74979b55u, 0xef72ced7u, 0xab15094au,
                            0x6f39c08du, 0xcc6cc33eu, 0x37a267dau, 0x1910bfc9u};
    return t[i];
  }
#endif
};

// bls12_381: 381-bit p
struct FpBls12_381 {
  static constexpr int ID = 3, NW = 12;
  static constexpr uint32_t N0W = 0xfffcfffdu;
  static constexpr int B3 = 12;
  static constexpr bool CARRY = false;
  static constexpr int REDUCE_TOP = 3;
  static constexpr int BLOCKS_PER_SM = MSM_BLOCKS_NW12;
  // the modulus
  MSM_HDM static uint32_t p(int i) {
    const uint32_t t[NW] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
                            0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
                            0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
    return t[i];
  }
#if MSM_LIMB_BITS == 13  // R = 2^390
  static constexpr int W = 13, L = 30, TAIL = 6, BALANCED_TOP = 9;
  static constexpr uint32_t MASK = 0x1fffu, N0T = 0x3du;
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
  // beta R^2 mod p: a product by it takes x to beta x R
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0x2405157bu, 0x47c8bd29u, 0x1f3f884du, 0xc9a4ffc2u,
                            0xf4d4842cu, 0x05389ea8u, 0x40c3ca69u, 0x0299013eu,
                            0xe73e0af1u, 0x05c5e90fu, 0x4981a1f8u, 0x022ffb5cu};
    return t[i];
  }
#elif MSM_LIMB_BITS == 12  // R = 2^396
  static constexpr int W = 12, L = 33, TAIL = 12, BALANCED_TOP = 15;
  static constexpr uint32_t MASK = 0xfffu, N0T = 0xffdu;
  // R mod p: the Montgomery form of 1
  MSM_HDM static uint32_t r(int i) {
    const uint32_t t[NW] = {0x3480cb7fu, 0x6f830000u, 0xbe042b12u, 0xd1fccdeau,
                            0x3c7de4b4u, 0x40d78057u, 0xc66805c5u, 0x6da3d19eu,
                            0x2746752au, 0x9afe6676u, 0x23205efbu, 0x09772fe1u};
    return t[i];
  }
  // R^2 mod p: a product by it enters Montgomery form
  MSM_HDM static uint32_t r2(int i) {
    const uint32_t t[NW] = {0x0399ecd7u, 0x0f973451u, 0x0ac83d84u, 0x9e484666u,
                            0x90cd6e7bu, 0xa22ad5dcu, 0x73188958u, 0xcb99297cu,
                            0x3101060eu, 0xf0e875e3u, 0xb98990b2u, 0x0ec92d1du};
    return t[i];
  }
  // beta R^2 mod p: a product by it takes x to beta x R
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0x51ca5a38u, 0x9d2a9240u, 0xafa4d4dau, 0x18dc23b5u,
                            0xca780c11u, 0xe04f8701u, 0x01d55f20u, 0x8fc66965u,
                            0x72fecebau, 0x7167a189u, 0xd641a107u, 0x0e45b1dau};
    return t[i];
  }
#endif
};

// secp256k1: 256-bit p
struct FpSecp256k1 {
  static constexpr int ID = 4, NW = 8;
  static constexpr uint32_t N0W = 0xd2253531u;
  static constexpr int B3 = 21;
  static constexpr bool CARRY = true;
  static constexpr int REDUCE_TOP = 0;
  static constexpr int BLOCKS_PER_SM = MSM_BLOCKS_NW8;
  // the modulus
  MSM_HDM static uint32_t p(int i) {
    const uint32_t t[NW] = {0xfffffc2fu, 0xfffffffeu, 0xffffffffu, 0xffffffffu,
                            0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu};
    return t[i];
  }
#if MSM_LIMB_BITS == 13  // R = 2^273
  static constexpr int W = 13, L = 21, TAIL = 17, BALANCED_TOP = 17;
  static constexpr uint32_t MASK = 0x1fffu, N0T = 0x13531u;
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
  // beta R^2 mod p: a product by it takes x to beta x R
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0xae483348u, 0x0e525b8fu, 0x4df91a78u, 0x53294d39u,
                            0x60d2afb9u, 0x1195f61du, 0x0dcf7c5eu, 0xfdfa5bc7u};
    return t[i];
  }
#elif MSM_LIMB_BITS == 12  // R = 2^264
  static constexpr int W = 12, L = 22, TAIL = 8, BALANCED_TOP = 8;
  static constexpr uint32_t MASK = 0xfffu, N0T = 0x31u;
  // R mod p: the Montgomery form of 1
  MSM_HDM static uint32_t r(int i) {
    const uint32_t t[NW] = {0x0003d100u, 0x00000100u, 0x00000000u, 0x00000000u,
                            0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u};
    return t[i];
  }
  // R^2 mod p: a product by it enters Montgomery form
  MSM_HDM static uint32_t r2(int i) {
    const uint32_t t[NW] = {0x90a10000u, 0x07a2000eu, 0x00010000u, 0x00000000u,
                            0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u};
    return t[i];
  }
  // beta R^2 mod p: a product by it takes x to beta x R
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0xa8b1e805u, 0x469e0393u, 0x534e537eu, 0xabee54cau,
                            0x7d875834u, 0xdf178465u, 0x96f1c373u, 0xee323f7eu};
    return t[i];
  }
#endif
};

// grumpkin: 254-bit p
struct FpGrumpkin {
  static constexpr int ID = 5, NW = 8;
  static constexpr uint32_t N0W = 0xefffffffu;
  static constexpr int B3 = -51;
  static constexpr bool CARRY = false;
  static constexpr int REDUCE_TOP = 2;
  static constexpr int BLOCKS_PER_SM = MSM_BLOCKS_NW8;
  // the modulus
  MSM_HDM static uint32_t p(int i) {
    const uint32_t t[NW] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                            0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return t[i];
  }
#if MSM_LIMB_BITS == 13  // R = 2^260
  static constexpr int W = 13, L = 20, TAIL = 4, BALANCED_TOP = 6;
  static constexpr uint32_t MASK = 0x1fffu, N0T = 0xfu;
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
  // beta R^2 mod p: a product by it takes x to beta x R
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0x900d62e7u, 0x18f202d3u, 0x42aa9e16u, 0xdcdac82fu,
                            0xd6144bc4u, 0x33399c79u, 0x00eba42eu, 0x2e7d19b8u};
    return t[i];
  }
#elif MSM_LIMB_BITS == 12  // R = 2^264
  static constexpr int W = 12, L = 22, TAIL = 8, BALANCED_TOP = 10;
  static constexpr uint32_t MASK = 0xfffu, N0T = 0xffu;
  // R mod p: the Montgomery form of 1
  MSM_HDM static uint32_t r(int i) {
    const uint32_t t[NW] = {0x9ffffab6u, 0xf6e31f8cu, 0x31329faeu, 0x5d7570acu,
                            0x09e2a349u, 0x276f48b7u, 0xef86e357u, 0x0d791464u};
    return t[i];
  }
  // R^2 mod p: a product by it enters Montgomery form
  MSM_HDM static uint32_t r2(int i) {
    const uint32_t t[NW] = {0x3da6f4f3u, 0xbe3eda4eu, 0x33a2266du, 0xf513fa73u,
                            0x5e27d688u, 0xb42af1e6u, 0xb33e9f3fu, 0x0c3a93cbu};
    return t[i];
  }
  // beta R^2 mod p: a product by it takes x to beta x R
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0x5d62e60bu, 0xfac2ccfbu, 0x2c255b12u, 0x611ae1e6u,
                            0x238233b5u, 0xd4c9c22cu, 0x6725e645u, 0x2d1aa40fu};
    return t[i];
  }
#endif
};

// vesta: 255-bit p
struct FpVesta {
  static constexpr int ID = 6, NW = 8;
  static constexpr uint32_t N0W = 0xffffffffu;
  static constexpr int B3 = 15;
  static constexpr bool CARRY = false;
  static constexpr int REDUCE_TOP = 1;
  static constexpr int BLOCKS_PER_SM = MSM_BLOCKS_NW8;
  // the modulus
  MSM_HDM static uint32_t p(int i) {
    const uint32_t t[NW] = {0x00000001u, 0x8c46eb21u, 0x0994a8ddu, 0x224698fcu,
                            0x00000000u, 0x00000000u, 0x00000000u, 0x40000000u};
    return t[i];
  }
#if MSM_LIMB_BITS == 13  // R = 2^273
  static constexpr int W = 13, L = 21, TAIL = 17, BALANCED_TOP = 18;
  static constexpr uint32_t MASK = 0x1fffu, N0T = 0x1ffffu;
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
  // beta R^2 mod p: a product by it takes x to beta x R
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0x143c58fau, 0x45f4f4e3u, 0x5639850au, 0x8af7f06bu,
                            0xccad3091u, 0xda52e4d2u, 0x060b9975u, 0x3707c648u};
    return t[i];
  }
#elif MSM_LIMB_BITS == 12  // R = 2^264
  static constexpr int W = 12, L = 22, TAIL = 8, BALANCED_TOP = 9;
  static constexpr uint32_t MASK = 0xfffu, N0T = 0xffu;
  // R mod p: the Montgomery form of 1
  MSM_HDM static uint32_t r(int i) {
    const uint32_t t[NW] = {0xfffffc01u, 0x709a6720u, 0xb6f132acu, 0x07e2a8d5u,
                            0xffffff77u, 0xffffffffu, 0xffffffffu, 0x3fffffffu};
    return t[i];
  }
  // R^2 mod p: a product by it enters Montgomery form
  MSM_HDM static uint32_t r2(int i) {
    const uint32_t t[NW] = {0x000eda4bu, 0x0adefcabu, 0xd46092acu, 0xd336f184u,
                            0xf59062aeu, 0x231004ccu, 0xdaa97faeu, 0x01af7ccfu};
    return t[i];
  }
  // beta R^2 mod p: a product by it takes x to beta x R
  MSM_HDM static uint32_t beta_r2(int i) {
    const uint32_t t[NW] = {0xffaa4510u, 0xa964a518u, 0x0354611du, 0x6b708c58u,
                            0xb934b32bu, 0xe65d7694u, 0xf1920182u, 0x3a706dc1u};
    return t[i];
  }
#endif
};

}  // namespace msm
