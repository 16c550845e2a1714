"""Curve parameter specs (G1 of BLS12-381 and BN254).

Same constants as ``tpu_ec/curves/params.py`` (a test pins them equal).
The slice ported so far uses G1 only; the G2 specs come with the Fp2 port.
Both curves have a = 0, which the Jacobian formulas (dbl-2009-l) assume.
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

@dataclasses.dataclass(frozen=True)
class CurveSpec:
    """Static metadata for one short-Weierstrass group (a = 0)."""

    name: str
    base: FieldSpec  #: field the coordinates live in (Fq)
    scalar: FieldSpec  #: the group order field Fr
    ext: int  #: 1 for G1 (coords in Fq); tpu_ec's G2 has 2 (Fq2, not ported)
    b: int  #: curve constant in y^2 = x^3 + b (plain int form)
    gen_x: int
    gen_y: int
    #: cofactor h with |E| = h * r (used only by host-side test tooling)
    cofactor: int = 1

    def __hash__(self):
        return hash((self.name, self.base.name, self.scalar.name, self.ext))


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

BN254_G1 = CurveSpec(
    name="bn254_g1",
    base=BN254_FQ,
    scalar=BN254_FR,
    ext=1,
    b=3,
    gen_x=1,
    gen_y=2,
)

ALL_CURVES = (BLS12_381_G1, BN254_G1)
