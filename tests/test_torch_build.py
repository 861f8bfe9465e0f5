"""The kernels' build key: a library is keyed by the bytes of its sources
and of the shared headers, so an edited header rebuilds every kernel that
may include it.  Needs no nvcc."""
import pathlib
import re
import shutil

from repro_torch.kernels import build

KERNELS = pathlib.Path(build.__file__).resolve().parent


def _tree(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text('#include "tc_attention.cuh"\n__global__ void k() {}\n')
    inc = tmp_path / "inc"
    inc.mkdir()
    (inc / "tc_attention.cuh").write_text("#pragma once\n")
    return src, inc


def test_digest_follows_header_bytes(tmp_path):
    src, inc = _tree(tmp_path)
    base = build.source_digest([src], inc)
    assert build.source_digest([src], inc) == base        # deterministic
    (inc / "tc_attention.cuh").write_text("#pragma once\n// edited\n")
    edited = build.source_digest([src], inc)
    assert edited != base
    (inc / "extra.cuh").write_text("#pragma once\n")       # a new header
    added = build.source_digest([src], inc)
    assert added not in (base, edited)
    (inc / "notes.txt").write_text("not a header")          # not hashed
    assert build.source_digest([src], inc) == added


def test_digest_follows_source_bytes_and_names(tmp_path):
    src, inc = _tree(tmp_path)
    base = build.source_digest([src], inc)
    src.write_text(src.read_text() + "// edited\n")
    assert build.source_digest([src], inc) != base
    moved = tmp_path / "other.cu"
    shutil.copy(src, moved)
    assert build.source_digest([moved], inc) != \
        build.source_digest([src], inc)


def test_attention_kernels_include_the_shared_header():
    """Both tensor-core attention sources include the common header, and
    the default digest covers it."""
    header = build.COMMON_INCLUDE / "tc_attention.cuh"
    assert header.is_file()
    for name in ("flash_attention", "paged_attention"):
        src = KERNELS / name / "csrc" / f"{name}.cu"
        assert '#include "tc_attention.cuh"' in src.read_text()
    assert build.source_digest([src]) == build.source_digest(
        [src], build.COMMON_INCLUDE)


def test_recurrence_kernels_include_the_shared_headers():
    """Both recurrence sources include the common recurrence header, which
    takes its cp.async copies from the header the attention kernels use
    too; the default digest covers both headers."""
    for header in ("recurrence.cuh", "cp_async.cuh"):
        assert (build.COMMON_INCLUDE / header).is_file()
    assert '#include "cp_async.cuh"' in (
        build.COMMON_INCLUDE / "recurrence.cuh").read_text()
    assert '#include "cp_async.cuh"' in (
        build.COMMON_INCLUDE / "tc_attention.cuh").read_text()
    for name in ("rwkv6_scan", "selective_scan"):
        src = KERNELS / name / "csrc" / f"{name}.cu"
        assert '#include "recurrence.cuh"' in src.read_text()
        assert build.source_digest([src]) == build.source_digest(
            [src], build.COMMON_INCLUDE)


def test_scan_backward_kernels_include_the_shared_header():
    """The two recurrence backward sources take their conversions,
    reduce-scatter and cp.async copies from the shared recurrence header,
    so editing it rebuilds them too; each builds into a library of its own
    name beside its forward's."""
    for name in ("rwkv6_scan", "selective_scan"):
        src = KERNELS / name / "csrc" / f"{name}_bwd.cu"
        assert '#include "recurrence.cuh"' in src.read_text()
        assert build.source_digest([src]) == build.source_digest(
            [src], build.COMMON_INCLUDE)
        fwd = KERNELS / name / "csrc" / f"{name}.cu"
        assert build.source_digest([src]) != build.source_digest([fwd])


def test_flash_backward_alone_includes_the_hopper_header():
    """The Hopper pieces (mbarriers, TMA, wgmma descriptors) live in their
    own shared header, which the flash backward includes and neither
    serving forward does; the default digest covers it, so editing it
    rebuilds every library."""
    header = build.COMMON_INCLUDE / "hopper.cuh"
    assert header.is_file()
    bwd = KERNELS / "flash_attention" / "csrc" / "flash_attention_bwd.cu"
    assert '#include "hopper.cuh"' in bwd.read_text()
    for name in ("flash_attention", "paged_attention"):
        fwd = KERNELS / name / "csrc" / f"{name}.cu"
        assert "hopper.cuh" not in fwd.read_text()
    assert "hopper.cuh" not in (build.COMMON_INCLUDE /
                                "tc_attention.cuh").read_text()
    assert build.source_digest([bwd]) == build.source_digest(
        [bwd], build.COMMON_INCLUDE)


def test_wkv_backward_is_one_cluster_kernel():
    """The WKV backward is one cluster kernel (and the du sum): no column
    tiles' partials, no finishing pass.  Its cross-block sums go through
    the cluster helpers' header, which the default digest covers; no
    forward includes that header."""
    header = build.COMMON_INCLUDE / "cluster.cuh"
    assert header.is_file()
    text = header.read_text()
    for op in ("barrier.cluster.arrive", "barrier.cluster.wait",
               "mapa.shared::cluster", "ld.shared::cluster"):
        assert op in text, op
    src = KERNELS / "rwkv6_scan" / "csrc" / "rwkv6_scan_bwd.cu"
    body = src.read_text()
    assert '#include "cluster.cuh"' in body
    assert "wkv_bwd_cluster_kernel" in body
    assert "cudaLaunchAttributeClusterDimension" in body
    for gone in ("wkv_bwd_finish_kernel", "wkv_bwd_ckpt_kernel"):
        assert gone not in body, gone
    assert not re.search(r"\bpart\b", body)   # the column tiles' partials
    assert "atomicAdd" not in body and "red.global" not in body
    assert build.source_digest([src]) == build.source_digest(
        [src], build.COMMON_INCLUDE)
    for name in ("rwkv6_scan", "selective_scan", "flash_attention",
                 "paged_attention"):
        fwd = KERNELS / name / "csrc" / f"{name}.cu"
        assert "cluster.cuh" not in fwd.read_text(), name


def test_scan_backward_takes_the_forwards_checkpoints():
    """The selective-scan backward has no checkpoint pass of its own (the
    forward's checkpoint mode writes them) and sums dB / dC with no
    atomics and no cluster (measured slower), and the forward gains the
    mode as a template flag."""
    src = KERNELS / "selective_scan" / "csrc" / "selective_scan_bwd.cu"
    body = src.read_text()
    assert "ss_bwd_ckpt_kernel" not in body
    assert "cluster.cuh" not in body
    assert "atomicAdd" not in body and "red.global" not in body
    fwd = (KERNELS / "selective_scan" / "csrc" / "selective_scan.cu")
    text = fwd.read_text()
    assert "bool kCkpt" in text and "if constexpr (kCkpt)" in text
    assert "cluster.cuh" not in text
