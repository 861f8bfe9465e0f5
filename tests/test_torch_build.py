"""The kernels' build key: a library is keyed by the bytes of its sources
and of the shared headers, so an edited header rebuilds every kernel that
may include it.  Needs no nvcc."""
import pathlib
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
