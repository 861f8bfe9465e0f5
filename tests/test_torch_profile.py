"""The profiling tools' bookkeeping, on the CPU: ``profile_serve`` files
every scan backward kernel under its own family and the forward's
checkpoint instance under the forward's, and ``profile_wkv_bwd`` and
``profile_scan_bwd`` read a SASS listing into opcode counts per function
and per loop."""
import pytest

from repro_torch.launch import (profile_scan_bwd, profile_serve,
                                profile_wkv_bwd)


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::wkv_bwd_cluster_kernel<64>(float const*, "
     "float const*, int, int, int)", "rwkv6_scan_bwd"),
    ("(anonymous namespace)::wkv_sum_parts_kernel(float const*, float*, "
     "int, int)", "rwkv6_scan_bwd"),
    ("void (anonymous namespace)::wkv_bwd_kernel<64>(float const*)",
     "rwkv6_scan_bwd"),
    ("void (anonymous namespace)::rwkv6_scan_kernel<64, float>(float const*)",
     "rwkv6_scan"),
    ("void (anonymous namespace)::ss_bwd_kernel<16>(float const*)",
     "selective_scan_bwd"),
    ("void (anonymous namespace)::ss_bwd_kernel<__nv_bfloat16, 16>("
     "__nv_bfloat16 const*, float const*)", "selective_scan_bwd"),
    ("(anonymous namespace)::ss_sum_parts_kernel(float const*, float*, "
     "int, unsigned long)", "selective_scan_bwd"),
    ("void (anonymous namespace)::selective_scan_kernel<__nv_bfloat16, 16, "
     "8, true>(__nv_bfloat16 const*, float const*)", "selective_scan"),
    ("void (anonymous namespace)::selective_scan_kernel<float, 64, 1, "
     "false>(float const*, float const*)", "selective_scan"),
])
def test_profile_families_file_the_wkv_backward(name, want):
    assert profile_serve.family(name) == want


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_122wkv_bwd_cluster_kernelILi64EEEvPKf
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   FFMA R2, R3, R4, R2 ;
        /*0020*/                   SHFL.BFLY PT, R5, R2, 0x1, 0x1f ;
        /*0030*/               @P0 FSEL R6, R2, R5, P1 ;
        /*0040*/                   LDGSTS.E.BYPASS.128 [R7], desc[UR4][R8.64] ;
        /*0050*/                   LDG.E R9, desc[UR4][R10.64] ;
        /*0060*/              @!P2 BRA 0x10 ;
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0080*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_122wkv_bwd_cluster_kernelILi32EEEvPKf
        /*0000*/                   FMUL R2, R3, R4 ;
"""


def test_sass_counts_by_function_and_loop(tmp_path, monkeypatch):
    monkeypatch.setattr(profile_wkv_bwd, "_dump_sass", lambda so: SASS)
    funcs = profile_wkv_bwd.sass_functions(tmp_path / "lib.so")
    assert sorted(funcs) == [
        "_ZN12_GLOBAL__N_122wkv_bwd_cluster_kernelILi32EEEvPKf",
        "_ZN12_GLOBAL__N_122wkv_bwd_cluster_kernelILi64EEEvPKf"]
    report = profile_wkv_bwd.sass_report(tmp_path / "lib.so", 64)
    (rep,) = report.values()
    fn = rep["function"]
    assert fn["total"] == 9
    assert (fn["FFMA"], fn["SHFL"], fn["LDGSTS"], fn["LDG"], fn["BAR"]) == (
        1, 1, 1, 1, 1)
    (loop,) = rep["loops"]
    assert (loop["from"], loop["to"], loop["total"]) == ("0x10", "0x60", 6)
    assert loop["FFMA"] == loop["SHFL"] == loop["LDGSTS"] == 1


@pytest.mark.parametrize("name", sorted(profile_wkv_bwd.VARIANTS))
def test_wkv_bwd_variants_edit_the_source_once(name):
    """Each variant's edits find their text in the WKV backward source
    exactly once, so a variant stays the source with one change."""
    from repro_torch.kernels.rwkv6_scan import kernel_bwd
    text = kernel_bwd.SOURCE.read_text()
    what, edits = profile_wkv_bwd.VARIANTS[name]
    assert what and edits
    for old, new in edits:
        assert text.count(old) == 1 and old != new


SCAN_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_113ss_bwd_kernelI13__nv_bfloat16Li16EEEvPKT_PKf
        /*0000*/                   LDS.64 R2, [R3] ;
        /*0010*/                   MUFU.EX2 R4, R5 ;
        /*0020*/                   FFMA R6, R4, R2, R6 ;
        /*0030*/                   SHFL.BFLY PT, R7, R6, 0x8, 0x1f ;
        /*0040*/                   BRA 0x10 ;
        /*0050*/                   UCGABAR_ARV ;
\t\tFunction : _ZN12_GLOBAL__N_113ss_bwd_kernelIfLi16EEEvPKT_PKf
        /*0000*/                   FMUL R2, R3, R4 ;
\t\tFunction : _ZN12_GLOBAL__N_113ss_bwd_kernelI13__nv_bfloat16Li64EEEvPKT_PKf
        /*0000*/                   FMUL R2, R3, R4 ;
\t\tFunction : _ZN12_GLOBAL__N_119ss_sum_parts_kernelEPKfPfim
        /*0000*/                   FADD R2, R3, R4 ;
        /*0010*/                   EXIT ;
"""


def test_scan_sass_counts_pick_the_build_and_dtype(tmp_path, monkeypatch):
    """``profile_scan_bwd.sass_report`` keeps the walk of the profiled
    state build and x dtype and the untemplated sum pass, and counts the
    walk's loop (one step's issue)."""
    monkeypatch.setattr(profile_wkv_bwd, "_dump_sass", lambda so: SCAN_SASS)
    report = profile_scan_bwd.sass_report(tmp_path / "lib.so", 16,
                                          "bfloat16")
    assert sorted(report) == [
        "_ZN12_GLOBAL__N_113ss_bwd_kernelI13__nv_bfloat16Li16EEEvPKT_PKf",
        "_ZN12_GLOBAL__N_119ss_sum_parts_kernelEPKfPfim"]
    walk = report[
        "_ZN12_GLOBAL__N_113ss_bwd_kernelI13__nv_bfloat16Li16EEEvPKT_PKf"]
    assert walk["function"]["total"] == 6
    assert walk["function"]["BAR"] == 1 and walk["function"]["LDS"] == 1
    (loop,) = walk["loops"]
    assert (loop["from"], loop["to"], loop["total"]) == ("0x10", "0x40", 4)
    assert loop["FFMA"] == loop["SHFL"] == loop["MUFU"] == 1
    assert loop["other"] == 1
    f32 = profile_scan_bwd.sass_report(tmp_path / "lib.so", 16, "float32")
    assert "_ZN12_GLOBAL__N_113ss_bwd_kernelIfLi16EEEvPKT_PKf" in f32


@pytest.mark.parametrize("name", sorted(profile_scan_bwd.VARIANTS))
def test_scan_bwd_variants_edit_the_source_once(name):
    """Each variant's edits find their text in the selective-scan backward
    source exactly once."""
    from repro_torch.kernels.selective_scan import kernel_bwd
    text = kernel_bwd.SOURCE.read_text()
    what, edits = profile_scan_bwd.VARIANTS[name]
    assert what and edits
    for old, new in edits:
        assert text.count(old) == 1 and old != new


def test_scan_profile_cases_cover_the_edges():
    """phase 3's scan-backward cases: the training shape first, then the
    short and ragged calls (S = 1, 7, 33, 1000) and a grid with more
    blocks than an H100 holds at once."""
    cases = profile_scan_bwd.CASES
    assert cases[0][1:6] == (2, 4096, 8192, 16, "bfloat16")
    assert {1, 7, 33, 1000} <= {c[2] for c in cases}
    # blocks of 64 channels: more than 132 SMs hold at two blocks an SM
    assert any(c[1] * c[3] // 64 > 132 * 2 for c in cases)
    xs = profile_scan_bwd.inputs(2, 33, 24, 13, "bfloat16", state=True,
                                 device="cpu")
    assert [tuple(t.shape) for t in xs] == [
        (2, 33, 24), (2, 33, 24), (24, 13), (2, 33, 13), (2, 33, 13), (24,),
        (2, 24, 13), (2, 33, 24), (2, 24, 13)]
    assert xs[0].dtype == xs[7].dtype == __import__("torch").bfloat16
