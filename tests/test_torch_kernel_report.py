"""The compiler-report parsers of ``vwfd_tpu_torch.kernel_report`` on
samples of ``ptxas -v`` and ``cuobjdump -sass`` output, and the host-side
logic of the other card tools (``profile_roundtrip``'s kernel classes,
``ablate_ssim``'s patches) against the sources in ``csrc`` (the tools
themselves run only where the CUDA toolkit is)."""

import re

from vwfd_tpu_torch import ablate_ssim
from vwfd_tpu_torch import kernel_report as kr
from vwfd_tpu_torch import profile_roundtrip
from vwfd_tpu_torch.kernels import _lib

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


RES_USAGE = """\
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

Resource usage:
 Common:
  GLOBAL:0
 Function _ZN12_GLOBAL__N_111qconv_wgmmaILi3ELi128ELb1EEEvNS_4ArgsE:
  REG:168 STACK:0 SHARED:96 LOCAL:0 CONSTANT[0]:1536 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN12_GLOBAL__N_114qconv_t_kernelENS_4ArgsE:
  REG:126 STACK:8 SHARED:9216 LOCAL:8 CONSTANT[0]:480 TEXTURE:0 SURFACE:0 SAMPLER:0
"""


def test_parse_res_usage_reads_registers_and_local_memory():
    info = kr.parse_res_usage(RES_USAGE)
    assert info == {
        "_ZN12_GLOBAL__N_111qconv_wgmmaILi3ELi128ELb1EEEvNS_4ArgsE": {
            "registers": 168, "stack_bytes": 0, "smem_bytes": 96,
            "local_bytes": 0},
        "_ZN12_GLOBAL__N_114qconv_t_kernelENS_4ArgsE": {
            "registers": 126, "stack_bytes": 8, "smem_bytes": 9216,
            "local_bytes": 8}}


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")


def test_profile_classes_name_every_kernel_in_csrc():
    """Every ``__global__`` kernel of ``csrc`` falls in its port class, and
    every class names a kernel that exists (a renamed kernel would
    otherwise be counted as "other")."""
    names = [m.group(1) for src in sorted(_lib.CSRC.glob("*.cu"))
             for m in _GLOBAL.finditer(src.read_text())]
    assert "ssim_strips" in names and "f1_sweep_counts" in names
    classes = {profile_roundtrip.classify(n) for n in names}
    assert all(c.startswith("port:") for c in classes), classes
    assert classes == {f"port:{k}" for k in profile_roundtrip.PORT_KERNELS}


def test_profile_classes_pin_the_fused_kernels():
    """K9's and K10's CUDA kernels are named in their classes, and the
    kernels of ``mix.cu`` and ``splice.cu`` carry those names (so that a
    class never keeps naming a kernel that is gone)."""
    assert profile_roundtrip.PORT_KERNELS["attack_mix"] == (
        "attack_mix_fwd", "attack_mix_bwd")
    assert profile_roundtrip.PORT_KERNELS["splice"] == ("splice_fwd",
                                                        "splice_bwd")
    for src, kernel in (("mix.cu", "attack_mix"), ("splice.cu", "splice")):
        names = {m.group(1) for m in
                 _GLOBAL.finditer((_lib.CSRC / src).read_text())}
        assert names == {f"{kernel}_fwd", f"{kernel}_bwd"}, names
        for n in names:  # as the profiler sees them: mangled, templated
            mangled = f"void (anonymous namespace)::{n}<float, 4>(float*)"
            assert profile_roundtrip.classify(mangled) == f"port:{kernel}"


def test_ablate_ssim_patches_hold_on_the_source():
    """Each variant's patches find their line of ``ssim.cu`` exactly once
    and change it."""
    src = (_lib.CSRC / "ssim.cu").read_text()
    variants = ablate_ssim._variants(src)
    assert {"base", "no_vertical", "no_horizontal", "no_map", "no_sync",
            "occ3", "tw128"} == set(variants)
    for name, patches in variants.items():
        for old, new in patches:
            assert src.count(old) == 1 and old != new, (name, old)


def test_ablate_ssim_geometry_takes_the_variant_shape_and_restores():
    """A variant's grid comes from ``ssim.geometry`` with its own columns
    and CTAs an SM; the module's constants are the kernel's again after."""
    from vwfd_tpu_torch.kernels import ssim
    base = ssim.geometry(64, 256, 256, 132)
    assert ablate_ssim._geometry(64, 256, 256, 132, 128, 1)[0] == 2
    assert ablate_ssim._geometry(64, 256, 256, 132, 64, 2) == base
    assert (ssim._TW, ssim._CTAS_PER_SM) == (64, 2)
    assert ssim.geometry(64, 256, 256, 132) == base
