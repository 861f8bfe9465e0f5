"""The profiling tools' bookkeeping, on the CPU: ``profile_serve`` files
every WKV backward kernel under its own family, and ``profile_wkv_bwd``
reads a SASS listing into opcode counts per function and per loop."""
import pytest

from repro_torch.launch import profile_serve, profile_wkv_bwd


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
