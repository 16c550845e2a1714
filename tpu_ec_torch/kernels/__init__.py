"""The hand-written CUDA kernels (csrc/), their wrappers and plain versions.

K1 ``mont.mont_mul``, K2 ``inter.inter_twiddle`` (its int8-digit entry
counted apart, ``inter_twiddle_i8``), K3 ``point.point_op``,
``point.horner``, ``point.point_scalar_mul``, ``point.ec_fft_stage`` and
``point.lattice_lanes`` (the last four also counted apart;
``point.mul_chain`` times one product of their serial bound and is on no
path; the Fq2 instances of G2 have counts of their own, ``point_fp2`` and
the ``*_fp2`` entries), K4
``ntt_leaf.ntt_leaf`` (counted apart with and without its level epilogue),
K5 ``butterfly.pease_stages`` and ``pease_stage``, K6 ``affine.coz_apply``,
K7 ``affine.affine_denom`` and ``affine.affine_apply``.
Each wrapper runs its plain PyTorch version on CPU tensors and launches its
kernel on CUDA tensors (or raises), and counts its launches.
"""

from . import affine, butterfly, inter, mont, ntt_leaf, point

_COUNTERS = (
    mont.LAUNCHES, inter.LAUNCHES, inter.LAUNCHES_I8, point.LAUNCHES, point.HORNER_LAUNCHES, point.CHAIN_LAUNCHES,
    point.STAGE_LAUNCHES, point.LATTICE_LAUNCHES, point.MUL_CHAIN_LAUNCHES, point.LAUNCHES_FP2,
    point.HORNER_LAUNCHES_FP2, point.CHAIN_LAUNCHES_FP2, point.STAGE_LAUNCHES_FP2, point.LATTICE_LAUNCHES_FP2,
    ntt_leaf.LAUNCHES, ntt_leaf.LEVEL_LAUNCHES, butterfly.LAUNCHES,
    affine.COZ_LAUNCHES, affine.DENOM_LAUNCHES, affine.APPLY_LAUNCHES,
)


def launch_counters() -> dict:
    """{kernel name: launches so far} for every kernel wrapper."""
    return {c.name: c.count for c in _COUNTERS}


def reset_launch_counters() -> None:
    for c in _COUNTERS:
        c.count = 0
