"""The parsers of the card's measurement tools on K3's kernel names and
ptxas reports (``chip_smoke.py``, ``tpu_ec_torch/utils/fp2_probe.py``), and
``chain_tile``'s argument check.  No card needed."""

import pytest

import chip_smoke
from tpu_ec_torch.fields.params import BN254_FQ
from tpu_ec_torch.kernels.point import chain_tile
from tpu_ec_torch.utils import fp2_probe

ADD2 = "_ZN12_GLOBAL__N_113point2_kernelILi12ELi0EEEvNS_9PointArgsEN3tec11FieldConstsE"
DBL2_TO = "_ZN12_GLOBAL__N_110double2_toILi12EEEvPKNS_9PointArgsExPKN3tec11FieldConstsE"
CHAIN2 = ("_ZN12_GLOBAL__N_117scalar_mul_kernelIN3tec13TileProducts2ILi12ELi16EEEEEvNS_9ChainArgsEPKixN3tec"
          "11FieldConstsE")
ADD1 = "_ZN12_GLOBAL__N_112point_kernelIN3tec4Ext1ILi12EEELi0EEEvNS_9PointArgsEN3tec11FieldConstsE"
REPORT = f"""ptxas info    : Compiling entry function '{ADD2}' for 'sm_90a'
ptxas info    : Function properties for {ADD2}
    8 bytes stack frame, 604 bytes spill stores, 604 bytes spill loads
ptxas info    : Used 128 registers, 392 bytes cmem[0]
ptxas info    : Function properties for {DBL2_TO}
    16 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Compiling entry function '{CHAIN2}' for 'sm_90a'
ptxas info    : Function properties for {CHAIN2}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 188 registers, 408 bytes cmem[0]
ptxas info    : Compiling entry function '{ADD1}' for 'sm_90a'
ptxas info    : Function properties for {ADD1}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, 392 bytes cmem[0]
"""


def test_kernel_labels_tell_fq2_from_g1():
    assert chip_smoke.kernel_label(ADD2) == "K3 add fp2<12>"
    assert chip_smoke.kernel_label(CHAIN2) == "K3 scalar_mul chain fp2<12,16>"
    assert chip_smoke.kernel_label(ADD1) == "K3 add<12>"
    assert chip_smoke.kernel_label(DBL2_TO).endswith("fp2<12>")
    # the profiler's demangled names
    assert chip_smoke.kernel_label("void (anonymous namespace)::point2_kernel<12, 1>(PointArgs, tec::FieldConsts)") \
        == "K3 add_mixed fp2<12>"


def test_fp2_build_lines_keep_a_callee_apart():
    """Registers and spills per Fq2 kernel, the non-inlined doubling's
    properties not taken for its caller's; G1 kernels left out."""
    lines = chip_smoke.fp2_build_lines(REPORT, {ADD2: 31304})
    assert lines == ["K3 add fp2<12>: 128 regs, spill stores 604 B, 31304 SASS instructions",
                     "K3 scalar_mul chain fp2<12,16>: 188 regs, spill stores 0 B, 0 SASS instructions"]


def test_probe_ptxas_parser():
    got = fp2_probe.ptxas(REPORT)
    assert got == {ADD2: (128, 604), CHAIN2: (188, 0), ADD1: (128, 0)}
    assert fp2_probe.label(ADD2) == "add<12>" and fp2_probe.label(CHAIN2) == "scalar_mul_kernel<12,16>"


@pytest.mark.parametrize("ext", [0, 3])
def test_chain_tile_rejects_ext(ext):
    with pytest.raises(ValueError):
        chain_tile(BN254_FQ, ext)
