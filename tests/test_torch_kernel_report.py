"""The compiler-report parsers of ``vwfd_tpu_torch.kernel_report`` on
samples of ``ptxas -v`` and ``cuobjdump -sass`` output (the tools
themselves run only where the CUDA toolkit is)."""

from vwfd_tpu_torch import kernel_report as kr

PTXAS = """\
ptxas info    : 0 bytes gmem, 256 bytes cmem[3]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113jpeg_pair_fwdEPKfPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113jpeg_pair_fwdEPKfPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111median3_bwdEPKfS1_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111median3_bwdEPKfS1_Pfiii
    72 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 40 registers, 43296 bytes smem, 388 bytes cmem[0]
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_111median3_bwdEPKfS1_Pfiii
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/              @!P0 LDS.64 R4, [R3] ;
        /*0030*/                   LDL.LU R6, [R1+0x4] ;
        /*0040*/                   STL [R1], R6 ;
        /*0050*/                   LDS.U8 R7, [R3+0x10] ;
        /*0060*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0070*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_113jpeg_pair_fwdEPKfPf
        /*0000*/                   FFMA R2, R3, c[0x3][0x4], RZ ;
        /*0010*/              @UP0 STS.128 [R4], R8 ;
"""


def test_parse_ptxas_reads_registers_stack_and_spills():
    info = kr.parse_ptxas(PTXAS)
    fwd = info["_ZN12_GLOBAL__N_113jpeg_pair_fwdEPKfPf"]
    assert fwd == {"stack_bytes": 0, "spill_store_bytes": 0,
                   "spill_load_bytes": 0, "registers": 72, "smem_bytes": 0}
    bwd = info["_ZN12_GLOBAL__N_111median3_bwdEPKfS1_Pfiii"]
    assert bwd == {"stack_bytes": 72, "spill_store_bytes": 8,
                   "spill_load_bytes": 12, "registers": 40,
                   "smem_bytes": 43296}


def test_parse_sass_counts_opcodes_per_kernel():
    ops = kr.parse_sass(SASS)
    bwd = ops["_ZN12_GLOBAL__N_111median3_bwdEPKfS1_Pfiii"]
    assert bwd["LDS"] == 2 and bwd["LDL"] == 1 and bwd["STL"] == 1
    assert bwd["BAR"] == 1 and bwd["LDC"] == 1 and sum(bwd.values()) == 8
    fwd = ops["_ZN12_GLOBAL__N_113jpeg_pair_fwdEPKfPf"]
    assert fwd == {"FFMA": 1, "STS": 1}
