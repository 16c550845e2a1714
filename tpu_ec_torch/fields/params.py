"""Field parameter specs: per-field Montgomery constants as Python ints.

Same constants as ``tpu_ec/fields/params.py`` (a test pins them equal), in a
module with no JAX in it.  Values keep the reference layout: a field element
is ``L`` little-endian 16-bit half-limbs in Montgomery form with
R = 2^(16L), which equals arkworks' R = 2^(64*ceil(bits/64)).  The CUDA
kernels repack pairs of half-limbs into 32-bit words internally; they use
``inv32`` = -p^-1 mod 2^32 for word-serial (CIOS) reduction.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def _n_limbs(modulus: int) -> int:
    """Half-limb count. R = 2^(16*L) matches arkworks' R = 2^(64*ceil(bits/64))."""
    n64 = -(-modulus.bit_length() // 64)
    return 4 * n64


def int_to_limbs(value: int, n_limbs: int) -> np.ndarray:
    """Little-endian 16-bit half-limbs of ``value`` as uint32[n_limbs]."""
    if value < 0:
        raise ValueError("negative")
    out = np.zeros(n_limbs, dtype=np.uint32)
    for i in range(n_limbs):
        out[i] = (value >> (LIMB_BITS * i)) & LIMB_MASK
    if value >> (LIMB_BITS * n_limbs):
        raise ValueError("value does not fit in limbs")
    return out


def limbs_to_int(limbs) -> int:
    """Inverse of :func:`int_to_limbs` (accepts any int sequence)."""
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(limbs))


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static metadata for one prime field (GpuField parity, ag-types/src/lib.rs:34-50)."""

    name: str
    modulus: int
    #: multiplicative-group generator used to derive NTT roots of unity;
    #: set to the arkworks GENERATOR for each field so radix-2 evaluation
    #: domains are bit-identical to ark_poly's (ag-cuda-ec/src/ec_fft.rs:121
    #: compares against Radix2EvaluationDomain built from these).
    generator: int | None = None

    @property
    def n_limbs(self) -> int:
        return _n_limbs(self.modulus)

    @property
    def bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def r(self) -> int:
        """Montgomery radix R = 2^(16*L) (same R as arkworks 64-bit limbs)."""
        return 1 << (LIMB_BITS * self.n_limbs)

    @property
    def one(self) -> int:
        """R mod p — the Montgomery representation of 1."""
        return self.r % self.modulus

    @property
    def r2(self) -> int:
        """R^2 mod p — to-Montgomery conversion factor."""
        return (self.r * self.r) % self.modulus

    @property
    def inv(self) -> int:
        """-p^-1 mod 2^16 (limb.rs:65-72 calc_inv, for the 16-bit limb model)."""
        return (-pow(self.modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @property
    def nprime(self) -> int:
        """-p^-1 mod R (full-width, for separated SOS Montgomery reduction)."""
        return (-pow(self.modulus, -1, self.r)) % self.r

    @property
    def inv32(self) -> int:
        """-p^-1 mod 2^32: the word n' of the CUDA kernels' CIOS reduction."""
        return (-pow(self.modulus, -1, 1 << 32)) % (1 << 32)

    # -- two-adic structure (for NTT) ------------------------------------
    @property
    def two_adicity(self) -> int:
        s, t = 0, self.modulus - 1
        while t % 2 == 0:
            s, t = s + 1, t // 2
        return s

    @property
    def quadratic_nonresidue(self) -> int:
        p = self.modulus
        for g in range(2, 1000):
            if pow(g, (p - 1) // 2, p) == p - 1:
                return g
        raise RuntimeError("no small QNR found")

    @property
    def root_of_unity(self) -> int:
        """Element of order exactly 2^two_adicity (for radix-2 NTT domains);
        derived from the arkworks generator when one is pinned."""
        p = self.modulus
        g = self.generator if self.generator is not None else self.quadratic_nonresidue
        return pow(g, (p - 1) >> self.two_adicity, p)

    # -- limb-array constants (cached numpy, consumed by kernels) --------
    @functools.cached_property
    def p_limbs(self) -> np.ndarray:
        return int_to_limbs(self.modulus, self.n_limbs)

    @functools.cached_property
    def one_limbs(self) -> np.ndarray:
        return int_to_limbs(self.one, self.n_limbs)

    @functools.cached_property
    def r2_limbs(self) -> np.ndarray:
        return int_to_limbs(self.r2, self.n_limbs)

    @functools.cached_property
    def nprime_limbs(self) -> np.ndarray:
        return int_to_limbs(self.nprime, self.n_limbs)

    def to_mont(self, a: int) -> int:
        return (a * self.r) % self.modulus

    def from_mont(self, a: int) -> int:
        return (a * pow(self.r, -1, self.modulus)) % self.modulus

    def __hash__(self):
        return hash((self.name, self.modulus))


# ---------------------------------------------------------------------------
# Concrete fields — same set the reference registers (`ag-cuda-ec/build.rs:4-8`
# registers bls12-381 and bn254 G1; `pairing_suite.rs:1-12` selects by feature).
# ---------------------------------------------------------------------------

BLS12_381_FR = FieldSpec(
    name="bls12_381_fr",
    modulus=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    generator=7,  # arkworks ark_bls12_381::Fr GENERATOR
)

BLS12_381_FQ = FieldSpec(
    name="bls12_381_fq",
    modulus=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
)

BN254_FR = FieldSpec(
    name="bn254_fr",
    modulus=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    generator=5,  # arkworks ark_bn254::Fr GENERATOR
)

BN254_FQ = FieldSpec(
    name="bn254_fq",
    modulus=21888242871839275222246405745257275088696311157297823662689037894645226208583,
)

ALL_FIELDS = (BLS12_381_FR, BLS12_381_FQ, BN254_FR, BN254_FQ)
