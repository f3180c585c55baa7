"""The native C++ loader must agree record-for-record with the pure
Python parsers on every fixture (plain + gz, fasta + fastq), and the
native sanitize must match the LUT-based one."""

import os
import pathlib
import platform

import numpy as np
import pytest

FIXTURES = pathlib.Path(__file__).resolve().parent.parent / "fixtures"


@pytest.fixture(scope="module")
def lib():
    from kasa_tpu.native import get_lib
    lib = get_lib()
    if lib is None:
        pytest.skip("native loader unavailable (no compiler?)")
    return lib


@pytest.mark.parametrize("name", [
    "reads.fastq", "reads.fastq.gz", "reads.fasta", "example.fasta",
    "edge.fasta", "protein.fasta", "reads_1.fastq", "reads_2.fastq",
])
def test_native_matches_python(lib, name):
    from kasa_tpu.host import fastx

    path = str(FIXTURES / name)
    fmt = fastx.sniff_format(path)
    native = list(fastx.iter_records_native(path, fmt))
    python = list(fastx.iter_fasta(path) if fmt == "fasta"
                  else fastx.iter_fastq(path))
    assert len(native) == len(python)
    for a, b in zip(native, python):
        assert (a.name, a.seq, a.nlines) == (b.name, b.seq, b.nlines)


def test_native_sanitize(lib):
    from kasa_tpu.core.alphabet import build_sanitize_lut
    from kasa_tpu.native import sanitize_inplace

    rng = np.random.default_rng(0)
    raw = rng.integers(33, 127, size=10000).astype(np.uint8)
    for protein in (False, True):
        expect = build_sanitize_lut(protein=protein)[raw]
        got = raw.copy()
        ws = sanitize_inplace(got, protein)
        assert ws == 0
        np.testing.assert_array_equal(got, expect)
    withspace = np.frombuffer(b"AC GT\tT", np.uint8).copy()
    assert sanitize_inplace(withspace, False) == 2


def test_build_key_follows_sources_and_cpu(tmp_path):
    """The library's file name is keyed on the sources, the flags and the
    CPU, so an edited source or another host never loads a stale or
    foreign build."""
    from kasa_tpu import native
    a, b = tmp_path / "a.cpp", tmp_path / "b.cpp"
    a.write_text("int f() { return 1; }\n")
    b.write_text("int g() { return 2; }\n")
    srcs = [str(a), str(b)]
    k0 = native.build_key(srcs, cpu="cpu0")
    assert k0 == native.build_key(srcs, cpu="cpu0")
    b.write_text("int g() { return 3; }\n")
    k1 = native.build_key(srcs, cpu="cpu0")
    assert k1 != k0
    assert native.build_key(srcs, cpu="cpu1") != k1


def test_library_lives_in_keyed_build_dir():
    from kasa_tpu import native
    path = native.lib_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.build_key() in os.path.basename(path)
    assert native.host_cpu().startswith(platform.machine())
    if native.get_lib() is not None:
        assert os.path.exists(path) and native.lib_error() is None
