"""Curve parameter specs: G1 and G2 of BLS12-381 and BN254.

Same constants as ``tpu_ec/curves/params.py`` (a test pins them equal).
G1 has coordinates in Fq (ext = 1), G2 in Fq2 = Fq[u]/(u^2 + 1) (ext = 2),
its constants as (c0, c1) pairs.  Every curve has a = 0, which the Jacobian
formulas (dbl-2009-l) assume.
"""

from __future__ import annotations

import dataclasses

from ..fields.params import (
    BLS12_381_FQ,
    BLS12_381_FR,
    BN254_FQ,
    BN254_FR,
    FieldSpec,
)

Fp2Int = tuple[int, int]

@dataclasses.dataclass(frozen=True)
class CurveSpec:
    """Static metadata for one short-Weierstrass group (a = 0)."""

    name: str
    base: FieldSpec  #: field the coordinates live in (Fq)
    scalar: FieldSpec  #: the group order field Fr
    ext: int  #: 1 for G1 (coords in Fq), 2 for G2 (coords in Fq2)
    b: int | Fp2Int  #: curve constant in y^2 = x^3 + b (plain int form)
    gen_x: int | Fp2Int
    gen_y: int | Fp2Int
    #: cofactor h with |E| = h * r (used only by host-side test tooling)
    cofactor: int = 1

    def __hash__(self):
        return hash((self.name, self.base.name, self.scalar.name, self.ext))


def _bn254_b2() -> Fp2Int:
    """BN254 twist constant b2 = 3 / (9 + u) in Fq2 = Fq[u]/(u^2+1)."""
    p = BN254_FQ.modulus
    # 3 (9 + u)^-1 = 3 (9 - u) / (81 + 1)
    d = pow(82, -1, p)
    return (27 * d % p, (-3 * d) % p)


BLS12_381_G1 = CurveSpec(
    name="bls12_381_g1",
    base=BLS12_381_FQ,
    scalar=BLS12_381_FR,
    ext=1,
    b=4,
    gen_x=0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    gen_y=0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    cofactor=0x396C8C005555E1568C00AAAB0000AAAB,
)

BLS12_381_G2 = CurveSpec(
    name="bls12_381_g2",
    base=BLS12_381_FQ,
    scalar=BLS12_381_FR,
    ext=2,
    b=(4, 4),  # 4(u + 1)
    gen_x=(
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    gen_y=(
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

BN254_G1 = CurveSpec(
    name="bn254_g1",
    base=BN254_FQ,
    scalar=BN254_FR,
    ext=1,
    b=3,
    gen_x=1,
    gen_y=2,
)

BN254_G2 = CurveSpec(
    name="bn254_g2",
    base=BN254_FQ,
    scalar=BN254_FR,
    ext=2,
    b=_bn254_b2(),
    gen_x=(
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    gen_y=(
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

ALL_CURVES = (BLS12_381_G1, BLS12_381_G2, BN254_G1, BN254_G2)
