"""The SASS and ptxas parsers of seaweedfs_tpu_torch.sass_report, on
fixed text in the formats cuobjdump and `ptxas -v` print (no toolkit)."""

import pytest

from seaweedfs_tpu_torch import sass_report

SASS = """\
	code for sm_90a
		Function : _Z15gf_apply_kernelILi10ELb1EEv7GfTermsILi10EE
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   ISETP.GE.AND P0, PT, R0, 0x10, PT ;
        /*0030*/               @P0 EXIT ;
        /*0040*/                   ULDC.64 UR4, c[0x0][0x328] ;
.L_x_0:
        /*0050*/                   LOP3.LUT R2, R2, UR4, R3, 0x78, !PT ;
        /*0060*/                   IMAD R2, R2, 0x1d, RZ ;
        /*0070*/                   HMMA.16816.F32 R4, R8, R12, R4 ;
        /*0080*/              @!P1 BRA 0x50 ;
        /*0090*/                   STG.E.64 desc[UR6][R4.64], R2 ;
        /*00a0*/                   EXIT ;
		Function : _Z16gf_verify_kernelILi4ELb0EEvv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   EXIT ;
"""

PTXAS = """\
ptxas info    : Compiling entry function '_Z15gf_apply_kernelILi10ELb1EEv7GfTermsILi10EE' for 'sm_90a'
ptxas info    : Function properties for _Z15gf_apply_kernelILi10ELb1EEv7GfTermsILi10EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 36 registers, used 0 barriers, 5188 bytes cmem[0]
ptxas info    : Compiling entry function '_Z16gf_verify_kernelILi16ELb0EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z16gf_verify_kernelILi16ELb0EEvv
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""


@pytest.mark.parametrize("op,cls", [
    ("LOP3.LUT", "int_alu"), ("ISETP.GE.AND", "int_alu"), ("IMAD.SHL.U32", "int_fma"),
    ("ULDC.64", "uniform"), ("S2UR", "uniform"), ("STG.E.64", "mem"),
    ("REDG.E.ADD.STRONG.GPU", "mem"), ("BRA", "ctrl"), ("HMMA.16816.F32", "other"),
])
def test_opclass(op, cls):
    assert sass_report.opclass(op) == cls


def test_parse_sass_splits_functions_and_marks_branch_targets():
    funcs = sass_report.parse_sass(SASS)
    assert list(funcs) == ["_Z15gf_apply_kernelILi10ELb1EEv7GfTermsILi10EE",
                           "_Z16gf_verify_kernelILi4ELb0EEvv"]
    apply = funcs["_Z15gf_apply_kernelILi10ELb1EEv7GfTermsILi10EE"]
    code = [k for k, _ in apply if k != "label"]
    assert code == ["LDC", "S2R", "ISETP.GE.AND", "EXIT", "ULDC.64", "LOP3.LUT", "IMAD",
                    "HMMA.16816.F32", "BRA", "STG.E.64", "EXIT"]
    # the loop head carries its label and, as a BRA target, an address label
    labels = [b for k, b in apply if k == "label"]
    assert labels == [".L_x_0", "0x0050"]


def test_blocks_split_at_labels_and_after_branches():
    apply = sass_report.parse_sass(SASS)["_Z15gf_apply_kernelILi10ELb1EEv7GfTermsILi10EE"]
    blocks = sass_report.blocks(apply)
    sizes = [len(b["insns"]) for b in blocks]
    assert sizes == [4, 1, 4, 2]  # entry..EXIT, ULDC, loop body..BRA, store..EXIT
    assert sum(sizes) == 11
    loop = blocks[2]
    assert loop["label"] == "0x0050"
    assert sass_report.mix(loop["insns"]) == {"int_alu": 1, "int_fma": 1, "other": 1, "ctrl": 1}


def test_ptxas_regs_reads_registers_and_spills():
    assert sass_report.ptxas_regs(PTXAS) == {
        "_Z15gf_apply_kernelILi10ELb1EEv7GfTermsILi10EE": (36, 0, 0),
        "_Z16gf_verify_kernelILi16ELb0EEvv": (255, 12, 16),
    }
