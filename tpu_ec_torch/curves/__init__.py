"""G1 and G2 curves: specs and batched Jacobian point arithmetic."""

from .params import ALL_CURVES, BLS12_381_G1, BLS12_381_G2, BN254_G1, BN254_G2, CurveSpec
from .point import PointOps, point_ops

__all__ = ["ALL_CURVES", "BLS12_381_G1", "BLS12_381_G2", "BN254_G1", "BN254_G2", "CurveSpec", "PointOps", "point_ops"]
