"""``scripts/k4_anatomy.py``'s reading of ``cuobjdump -sass`` on the CPU: the
parser, the instruction classes, the hottest loop and which kernel serves
which K4 variant, on a hand-written excerpt in cuobjdump's layout (each
instruction line followed by its encoding line)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

SASS = """
	code for sm_90a
		Function : _Z24gbm_terminal_corr_kernelPKf
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
                                                                           /* 0x000fe40000000800 */
        /*0010*/                   IMAD.WIDE.U32 R2, R4, -0x2daee0ad, RZ ; /* 0x000fe40000000800 */
        /*0020*/                   LOP3.LUT R5, R2, 0x7fffff, R3, 0xea, !PT ;
        /*0030*/                   MUFU.LG2 R6, R5 ;
        /*0040*/                   FFMA R7, R6, R6, R7 ;
        /*0050*/               @P0 BRA 0x10 ;
        /*0060*/                   STS [R8], R7 ;
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0080*/                   LDS R9, [R8] ;
        /*0090*/              @!P1 BRA 0x80 ;
        /*00a0*/                   EXIT ;
		Function : _Z19gbm_terminal_kernelPKf
        /*0000*/                   I2F.U32 R1, R2 ;
        /*0010*/                   IMAD.HI.U32 R3, R4, R5, RZ ;
        /*0020*/                   IMAD.WIDE.U32 R2, R4, R5, RZ ;
        /*0030*/                   MUFU.SIN R6, R6 ;
        /*0040*/             @!UP0 BRA 0x10 ;
        /*0050*/                   EXIT ;
"""


@pytest.fixture(scope="module")
def anatomy():
    spec = importlib.util.spec_from_file_location("k4_anatomy", ROOT / "scripts" / "k4_anatomy.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_parse_sass_reads_each_kernel_and_skips_encodings(anatomy):
    kernels = anatomy.parse_sass(SASS)
    assert list(kernels) == ["_Z24gbm_terminal_corr_kernelPKf", "_Z19gbm_terminal_kernelPKf"]
    corr = kernels["_Z24gbm_terminal_corr_kernelPKf"]
    assert [a for a, _, _ in corr] == list(range(0, 0xB0, 0x10))
    assert corr[1][:2] == (0x10, "IMAD.WIDE.U32")
    assert corr[5] == (0x50, "BRA", "0x10")


def test_instruction_mix_and_hottest_loop(anatomy):
    kernels = anatomy.parse_sass(SASS)
    body, span = anatomy.hottest_loop(kernels["_Z24gbm_terminal_corr_kernelPKf"])
    # the loop with the integer multiply, not the later one of shared loads
    assert span == (0x10, 0x50)
    mix = anatomy.mix(body)
    assert mix["total"] == 5
    assert (mix["IMAD.WIDE"], mix["LOP3"], mix["MUFU"], mix["FFMA"]) == (1, 1, 1, 1)
    assert mix["BRA/BSSY/BSYNC"] == 1 and mix["mufu_ops"] == {"MUFU.LG2": 1}
    plain = anatomy.mix(kernels["_Z19gbm_terminal_kernelPKf"])
    assert (plain["I2F"], plain["IMAD.HI"], plain["IMAD.WIDE"]) == (1, 1, 1)
    assert anatomy.hottest_loop(kernels["_Z19gbm_terminal_kernelPKf"])[1] == (0x10, 0x40)


@pytest.mark.parametrize("variant, kernel", [
    ("uncorrelated", "_Z19gbm_terminal_kernelPKf"),
    ("correlated", "_Z24gbm_terminal_corr_kernelPKf"),
])
def test_kernel_of_each_variant(anatomy, variant, kernel):
    kernels = anatomy.parse_sass(SASS)
    assert anatomy.kernel_of(kernels, variant) == kernel
    # a source with one kernel for both variants
    assert anatomy.kernel_of({kernel: []}, "correlated") == kernel
