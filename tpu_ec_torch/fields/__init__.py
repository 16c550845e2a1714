"""Prime fields and Fq2: specs, Montgomery arithmetic, host-side table arithmetic."""

from .fp import FieldOps, field_ops
from .fp2 import Fp2Ops, fp2_ops
from .params import (
    ALL_FIELDS,
    BLS12_381_FQ,
    BLS12_381_FR,
    BN254_FQ,
    BN254_FR,
    LIMB_BITS,
    LIMB_MASK,
    FieldSpec,
    int_to_limbs,
    limbs_to_int,
)

__all__ = [
    "ALL_FIELDS",
    "BLS12_381_FQ",
    "BLS12_381_FR",
    "BN254_FQ",
    "BN254_FR",
    "LIMB_BITS",
    "LIMB_MASK",
    "FieldOps",
    "Fp2Ops",
    "FieldSpec",
    "field_ops",
    "fp2_ops",
    "int_to_limbs",
    "limbs_to_int",
]
