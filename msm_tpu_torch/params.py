"""Curve, field and limb-geometry parameters — the port's own copy of
``msm_tpu/params.py``, with the same names and values.

- ``CurveSpec`` and the seven curves in ``CURVES``;
- Montgomery / Barrett constant derivation (``egcd``, ``calc_rinv_and_n0``,
  ``gen_mu``) and the limb-count rule ``calc_num_words``;
- ``MsmConfig``: limb geometry, window geometry and the field constants,
  all derived from (curve, word_size, chunk_size); ``DEFAULT_CONFIG``,
  ``pick_chunk_size`` and ``pick_config``.

Under ``glv=True`` the windows cover the GLV half-scalars
(``ops/glv.glv_params``): BN254 at c = 16 gives 8 of them, not 16.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass


@dataclass(frozen=True)
class CurveSpec:
    """A short-Weierstrass curve y^2 = x^3 + a*x + b over GF(modulus)."""

    name: str
    modulus: int  # base field q
    order: int  # scalar field (group order) r
    a: int
    b: int
    gx: int  # generator, affine
    gy: int
    #: group cofactor h = #E(F_q) / r; on-curve points may lie outside the
    #: prime-order subgroup when h > 1
    cofactor: int = 1

    @property
    def modulus_bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def order_bits(self) -> int:
        return self.order.bit_length()


#: BN254 G1 (alt_bn128)
BN254 = CurveSpec(
    name="bn254",
    modulus=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    order=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    a=0,
    b=3,
    gx=1,
    gy=2,
)

#: BLS12-377 G1
BLS12_377 = CurveSpec(
    name="bls12_377",
    modulus=258664426012969094010652733694893533536393512754914660539884262666720468348340822774968888139573360124440321458177,
    order=8444461749428370424248824938781546531375899335154063827935233455917409239041,
    a=0,
    b=1,
    gx=81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695,
    gy=241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030,
    cofactor=30631250834960419227450344600217059328,  # (x-1)^2/3, x = 0x8508C00000000001
)

#: Pasta/Pallas
PALLAS = CurveSpec(
    name="pallas",
    modulus=28948022309329048855892746252171976963363056481941560715954676764349967630337,
    order=28948022309329048855892746252171976963363056481941647379679742748393362948097,
    a=0,
    b=5,
    gx=28948022309329048855892746252171976963363056481941560715954676764349967630336,  # -1
    gy=2,
)

#: BLS12-381 G1
BLS12_381 = CurveSpec(
    name="bls12_381",
    modulus=4002409555221667393417789825735904156556882819939007885332058136124031650490837864442687629129015664037894272559787,
    order=52435875175126190479447740508185965837690552500527637822603658699938581184513,
    a=0,
    b=4,
    gx=3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
    gy=1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569,
    cofactor=76329603384216526031706109802092473003,  # (x-1)^2/3, x = -0xD201000000010000
)

#: secp256k1 (256-bit field with zero slack: 21 limbs at 13 bits)
SECP256K1 = CurveSpec(
    name="secp256k1",
    modulus=115792089237316195423570985008687907853269984665640564039457584007908834671663,
    order=115792089237316195423570985008687907852837564279074904382605163141518161494337,
    a=0,
    b=7,
    gx=55066263022277343669578718895168534326250603453777594175500187360389116729240,
    gy=32670510020758816978083085130507043184471273380659243275938904335757337482424,
)

#: Grumpkin, BN254's 2-cycle partner (base and scalar fields swapped)
GRUMPKIN = CurveSpec(
    name="grumpkin",
    modulus=BN254.order,
    order=BN254.modulus,
    a=0,
    b=BN254.order - 17,
    gx=1,
    gy=17631683881184975370165255887551781615748388533673675138860,
)

#: Vesta, Pallas' 2-cycle partner
VESTA = CurveSpec(
    name="vesta",
    modulus=PALLAS.order,
    order=PALLAS.modulus,
    a=0,
    b=5,
    gx=PALLAS.order - 1,
    gy=2,
)

CURVES = {
    c.name: c
    for c in (
        BN254, BLS12_377, PALLAS, BLS12_381, SECP256K1, GRUMPKIN, VESTA,
    )
}


# ---------------------------------------------------------------------------
# Montgomery / Barrett parameter derivation
# ---------------------------------------------------------------------------


def egcd(a: int, b: int) -> tuple[int, int, int]:
    """Extended gcd: returns (g, x, y) with a*x + b*y = g."""
    if a == 0:
        return b, 0, 1
    g, x, y = egcd(b % a, a)
    return g, y - (b // a) * x, x


def calc_rinv_and_n0(p: int, r: int, word_size: int) -> tuple[int, int]:
    """The Montgomery inverse of R (``r * rinv = 1 mod p``) and the REDC
    constant n0 = -p^-1 mod 2^word_size."""
    g, rinv, _ = egcd(r % p, p)
    assert g == 1
    rinv %= p
    w = 1 << word_size
    n0 = (-pow(p, -1, w)) % w
    assert (p * n0) % w == w - 1  # p * n0 = -1 (mod 2^w)
    return rinv, n0


def gen_mu(p: int, num_bits: int) -> int:
    """Barrett constant mu = floor(4^k / p), 2^k the first power of two at
    or above p."""
    x = 1 << num_bits
    while x < p:
        x <<= 1
    assert x // 2 < p <= x
    return (x * x) // p


# ---------------------------------------------------------------------------
# The full MSM configuration
# ---------------------------------------------------------------------------


def calc_num_words(word_size: int, num_bits: int) -> int:
    """ceil(num_bits / word_size)."""
    return -(-num_bits // word_size)


@dataclass(frozen=True)
class MsmConfig:
    """Static configuration of one MSM: limb geometry, window geometry and
    the field constants, all derived from (curve, word_size, chunk_size)."""

    curve: CurveSpec
    word_size: int = 13  # limb bit-width
    chunk_size: int = 16  # scalar window bit-width
    glv: bool = False  # GLV endomorphism split (ops/glv.py): 2n points,
    #                    half-length scalars
    compress: bool = False  # batched-affine pair compression of the sorted
    #                         stream before the scan; needs (n/R) even
    karatsuba: bool = False  # the JAX package's Karatsuba Montgomery
    #                          product: the same function, so the CUDA
    #                          kernels take it where that package builds it

    # ---- limb geometry -----------------------------------------------------
    @property
    def num_words(self) -> int:
        """ceil((bits + 6) / word_size): >= 6 bits of slack so R >= 64p, as
        the lazy-reduction field algebra needs. BN254 at 13 bits: 20."""
        return calc_num_words(self.word_size, self.curve.modulus_bits + 6)

    @property
    def mask(self) -> int:
        return (1 << self.word_size) - 1

    # ---- scalar-window geometry -------------------------------------------
    @property
    def scalar_bits(self) -> int:
        """Scalars are serialized as 256-bit little-endian words (wider
        orders: whole bytes)."""
        return 256 if self.curve.order_bits <= 256 else 8 * (
            (self.curve.order_bits + 7) // 8
        )

    @property
    def num_subtasks(self) -> int:
        """S = ceil((bits + 1) / chunk_size): bits is the order's, or under
        GLV the half-scalar bound's (|k_i| <= max_component, 126 bits for
        BN254); the +1 is the signed-recode headroom that keeps the top
        digit <= 2^(c-1)."""
        if self.glv:
            from msm_tpu_torch.ops.glv import glv_params

            bits = glv_params(self.curve).half_bits
        else:
            bits = self.curve.order_bits
        return -(-(bits + 1) // self.chunk_size)

    @property
    def num_buckets(self) -> int:
        """Signed-bucket count per subtask: |digit| in [0, 2^(c-1)]."""
        return (1 << (self.chunk_size - 1)) + 1

    @property
    def index_shift(self) -> int:
        return 1 << (self.chunk_size - 1)

    # ---- Montgomery / Barrett constants -----------------------------------
    @property
    def r(self) -> int:
        """Montgomery radix R = 2^(word_size*num_words) mod p."""
        return (1 << (self.word_size * self.num_words)) % self.curve.modulus

    @functools.cached_property
    def _rinv_n0(self) -> tuple[int, int]:
        return calc_rinv_and_n0(self.curve.modulus, self.r, self.word_size)

    @property
    def rinv(self) -> int:
        return self._rinv_n0[0]

    @property
    def n0(self) -> int:
        return self._rinv_n0[1]

    @property
    def r2(self) -> int:
        """R^2 mod p: mont_mul by this enters Montgomery form."""
        return (self.r * self.r) % self.curve.modulus

    @functools.cached_property
    def mu(self) -> int:
        return gen_mu(self.curve.modulus, self.curve.modulus_bits)

    @property
    def small_b3(self) -> int | None:
        """3b as a plain small integer when it fits the limb budget (a
        Montgomery value times a plain integer stays in Montgomery form)."""
        b3 = 3 * self.curve.b
        return b3 if b3 * ((1 << self.word_size) + 64) < (1 << 31) // 4 else None

    @property
    def slack(self) -> int:
        """Bits between num_words*word_size and the modulus' bit length."""
        return self.num_words * self.word_size - self.curve.modulus_bits

    def __post_init__(self) -> None:
        if not (8 <= self.word_size <= 16):
            raise ValueError("word_size must be in [8, 16] for int32 lanes")
        if not (1 <= self.chunk_size <= 16):
            raise ValueError("chunk_size must be in [1, 16]")
        if self.glv and self.curve.a != 0:
            raise ValueError("GLV needs an a=0 curve (cube-root endomorphism)")


#: 13-bit limbs (20 words for BN254), 16-bit windows, 16 subtasks
DEFAULT_CONFIG = MsmConfig(curve=BN254)


def coord_words(cfg: MsmConfig) -> int:
    """int32 words per dense-packed canonical coordinate, ceil(bits / 32)
    (BN254: 8, BLS12: 12): the packed table's width per coordinate and the
    word core's element."""
    return (cfg.curve.modulus_bits + 31) // 32


def pick_chunk_size(n: int) -> int:
    """Window width by input size, the JAX package's rule (not tuned on
    the H100): 13 up to 2^16 points, 14 up to 2^18, else 16."""
    if n <= (1 << 16):
        return 13
    if n <= (1 << 18):
        return 14
    return 16


@functools.lru_cache(maxsize=None)
def pick_config(n: int, curve: CurveSpec = BN254) -> MsmConfig:
    """The config used when the caller passes none."""
    return MsmConfig(curve=curve, chunk_size=pick_chunk_size(max(n, 16)))
