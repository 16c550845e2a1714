"""Public constants of BLS12-381 and BN254 (moduli, generators, the Fr
multiplicative generators that fix the radix-2 domains as arkworks does)."""

from __future__ import annotations

BLS12_381_R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
BLS12_381_Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
BN254_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
BN254_Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583


class Curve:
    """One group: its base field modulus q, degree ext (1: Fq, 2: Fq2 with
    u^2 = -1), scalar field r, the generator, and the Fr multiplicative
    generator (ark's GENERATOR) from which the 2^k-th roots of unity come."""

    def __init__(self, name, q, r, ext, gen, r_generator):
        self.name, self.q, self.r, self.ext = name, q, r, ext
        self.gen = gen
        self.r_generator = r_generator

    @property
    def q_limbs(self) -> int:
        """16-bit limbs of an Fq element: 16 * ceil(bits / 64) / 4 (R = 2^(64 words))."""
        return 4 * -(-self.q.bit_length() // 64)

    @property
    def r_limbs(self) -> int:
        return 4 * -(-self.r.bit_length() // 64)

    def root_of_unity(self, log_n: int) -> int:
        """The primitive 2^log_n-th root of unity g^((r - 1) / 2^log_n)."""
        return pow(self.r_generator, (self.r - 1) >> log_n, self.r)


CURVES = {
    "bls12_381_g1": Curve(
        "bls12_381_g1", BLS12_381_Q, BLS12_381_R, 1,
        (0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
         0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1),
        7,
    ),
    "bls12_381_g2": Curve(
        "bls12_381_g2", BLS12_381_Q, BLS12_381_R, 2,
        ((0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
          0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
         (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
          0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE)),
        7,
    ),
    "bn254_g1": Curve("bn254_g1", BN254_Q, BN254_R, 1, (1, 2), 5),
    "bn254_g2": Curve(
        "bn254_g2", BN254_Q, BN254_R, 2,
        ((10857046999023057135944570762232829481370756359578518086990519993285655852781,
          11559732032986387107991004021392285783925812861821192530917403151452391805634),
         (8495653923123431417604973247489272438418190587263600148770280649306958101930,
          4082367875863433681332203403145435568316851327593401208105741076214120093531)),
        5,
    ),
}
