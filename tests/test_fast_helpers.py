"""Unit coverage for fast-path host helpers: paired-end name joining,
-e window dedup (device/host twins), and the length-bucket compile
guard."""

import numpy as np


def test_join_name_blobs():
    from kasa_tpu.match.fast import _join_name_blobs

    names1 = [b"read1", b"r2", b""]
    names2 = [b"mateA", b"", b"mC"]
    def blob(names):
        off = np.zeros(len(names) + 1, np.int64)
        np.cumsum([len(n) for n in names], out=off[1:])
        return np.frombuffer(b"".join(names), np.uint8), off
    b1, o1 = blob(names1)
    b2, o2 = blob(names2)
    buf, off = _join_name_blobs(b1, o1, b2, o2, 3)
    got = [buf[off[i]:off[i + 1]].tobytes() for i in range(3)]
    # "name1 name2" per read (the drive loop adds the trailing space)
    assert got == [b"read1 mateA", b"r2 ", b" mC"]


def test_dedup_windows_device_host_agree():
    import jax.numpy as jnp
    from kasa_tpu.match.turbo import (dedup_read_windows,
                                      dedup_windows_np, POISON_LIMB)

    rng = np.random.default_rng(9)
    R, kpr = 6, 16
    q = rng.integers(0, 1 << 20, size=(R * kpr, 2)).astype(np.int32)
    # plant duplicates inside reads
    for r in range(R):
        q[r * kpr + 3] = q[r * kpr + 7]
        q[r * kpr + 1] = q[r * kpr + 2]
    out = np.asarray(dedup_read_windows(jnp.asarray(q), R, kpr))
    for r in range(R):
        dev_rows = out[r * kpr:(r + 1) * kpr]
        live = dev_rows[~np.all(dev_rows == POISON_LIMB, axis=1)]
        host = dedup_windows_np(q[r * kpr:(r + 1) * kpr])
        # same distinct set per read
        pack = lambda a: set(map(tuple, a.tolist()))
        assert pack(live) == pack(host)
        assert len(live) == kpr - 2


def test_len_bucket_compile_guard():
    import kasa_tpu.match.fast as fast_mod

    fast_mod._LEN_BUCKETS_SEEN.clear()
    # first CAP distinct lengths get fine buckets
    fine = [fast_mod._len_bucket(100 + 16 * i, 36)
            for i in range(fast_mod._LEN_BUCKET_CAP)]
    assert len(set(fine)) == fast_mod._LEN_BUCKET_CAP
    # after the cap, an uncovered new length coarsens to power-of-two
    big = fast_mod._len_bucket(5000, 36)
    assert big == 8192 or big in fast_mod._LEN_BUCKETS_SEEN
    fast_mod._LEN_BUCKETS_SEEN.clear()


def test_build_time_sidecar(tmp_path):
    """`build --sidecar` emits the turbo .tabs directory so the first
    identify skips table construction (VERDICT r3 weak #5)."""
    import pathlib
    import shutil
    REPO = pathlib.Path(__file__).resolve().parent.parent
    from kasa_tpu.index.build import build_index

    idx = tmp_path / "scIndex"
    shutil.copy(REPO / "tests/golden/exampleIndex_content.txt",
                tmp_path / "c.txt")
    build_index(str(REPO / "fixtures/example.fasta"),
                str(tmp_path / "c.txt"), str(idx),
                temp_dir=str(tmp_path), turbo_sidecar=True)
    import os
    tabs = str(idx) + ".turbo_7_12.npz.tabs"
    assert os.path.isdir(tabs), tabs
    assert os.path.exists(os.path.join(tabs, "meta.json"))

    # identify must adopt it (no tables-build stage)
    from kasa_tpu.utils import timers
    from kasa_tpu.config import Config
    from kasa_tpu.match.pipeline import identify
    timers.reset()
    cfg = Config()
    cfg.engine = "tpu"
    cfg.content_file = str(tmp_path / "c.txt")
    identify(cfg, index_path=str(idx),
             input_path=str(REPO / "fixtures/reads.fastq"),
             out_file=str(tmp_path / "o.json"), profile_file=None)
    import kasa_tpu.utils.timers as T
    assert "turbo/tables-build" not in T._ACC, \
        "identify rebuilt tables despite the build-time sidecar"


def test_multi_packed_profiles_agree(tmp_path, monkeypatch):
    """identify_multiple with profiles on the packed stream (r5,
    turbo.fused_turbo_files): per-file count matrices and per-read
    outputs must agree with the serialized per-file loop."""
    import filecmp
    import numpy as np
    from kasa_tpu.config import Config
    from kasa_tpu.match.pipeline import identify

    monkeypatch.setenv("KASA_MESH_DP", "1")
    monkeypatch.setenv("KASA_MESH_IP", "1")
    import pathlib
    REPO = pathlib.Path(__file__).resolve().parent.parent
    multi = REPO / "fixtures" / "multi"

    def run(tag, nopack):
        if nopack:
            monkeypatch.setenv("KASA_NO_MULTIPACK", "1")
        else:
            monkeypatch.delenv("KASA_NO_MULTIPACK", raising=False)
        cfg = Config()
        cfg.engine = "tpu"
        cfg.content_file = str(
            REPO / "tests/golden/exampleIndex_content.txt")
        return identify(cfg,
                        index_path=str(REPO / "tests/golden/exampleIndex"),
                        input_path=str(multi),
                        out_file=str(tmp_path / f"{tag}q_"),
                        profile_file=str(tmp_path / f"{tag}p_"))

    r_pack = run("pk", False)
    r_ser = run("sr", True)
    assert len(r_pack) == len(r_ser) == 2
    for (ca1, cu1, n1, k1), (ca2, cu2, n2, k2) in zip(r_pack, r_ser):
        assert (n1, k1) == (n2, k2)
        np.testing.assert_array_equal(np.asarray(cu1, np.int64),
                                      np.asarray(cu2, np.int64))
        np.testing.assert_allclose(ca1, ca2, rtol=2e-5, atol=2e-3)
    for name in ("a.json", "b.json"):
        assert filecmp.cmp(tmp_path / ("pkq_" + name.split(".")[0]
                                       + ".json"),
                           tmp_path / ("srq_" + name.split(".")[0]
                                       + ".json"), shallow=False), name
    # profile CSVs: same shape, numeric agreement
    for name in ("a", "b"):
        pk = (tmp_path / f"pkp_{name}.csv").read_text().splitlines()
        sr = (tmp_path / f"srp_{name}.csv").read_text().splitlines()
        assert len(pk) == len(sr)
        for lp, ls in zip(pk, sr):
            cp, cs = lp.split(","), ls.split(",")
            assert cp[:2] == cs[:2]
            for vp, vs in zip(cp[2:], cs[2:]):
                try:
                    fp, fs = float(vp), float(vs)
                except ValueError:
                    assert vp == vs
                    continue
                np.testing.assert_allclose(fp, fs, rtol=2e-4, atol=2e-3)


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = f"fake {platform}"
        self._stats = stats

    def memory_stats(self):
        return self._stats


def _budget(monkeypatch, dev, memory_avail=10 << 30):
    import kasa_tpu.match.fast as fast_mod
    from kasa_tpu.config import Config
    monkeypatch.delenv("KASA_DEVICE_BUDGET", raising=False)
    monkeypatch.setattr(fast_mod.jax, "local_devices", lambda: [dev])
    cfg = Config()
    cfg.memory_avail = memory_avail
    return fast_mod.device_table_budget(cfg)


def test_device_budget_from_memory_stats(monkeypatch):
    dev = _FakeDevice("gpu", {"bytes_limit": 60 << 30,
                              "bytes_in_use": 4 << 30})
    assert _budget(monkeypatch, dev) == int((56 << 30) * 0.85)


def test_device_budget_without_stats_is_an_error(monkeypatch):
    import pytest
    for stats in (None, {}):
        with pytest.raises(RuntimeError, match="memory_stats"):
            _budget(monkeypatch, _FakeDevice("gpu", stats))


def test_device_budget_cpu_uses_memory_flag(monkeypatch):
    dev = _FakeDevice("cpu", {"bytes_limit": 1 << 40})
    assert _budget(monkeypatch, dev, memory_avail=5 << 30) \
        == int((5 << 30) * 0.8)
    monkeypatch.setenv("KASA_DEVICE_BUDGET", "12345")
    import kasa_tpu.match.fast as fast_mod
    from kasa_tpu.config import Config
    assert fast_mod.device_table_budget(Config()) == 12345


def test_compile_cache_obeys_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it and the code sets
    no other directory."""
    import jax
    from kasa_tpu.utils import compcache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compcache.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import pathlib
    import jax
    from kasa_tpu.utils import compcache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = pathlib.Path(__file__).resolve().parent.parent
    assert compcache.enable_compilation_cache() == str(repo / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == str(repo / ".jax_cache")
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.2
    assert jax.config.jax_persistent_cache_min_entry_size_bytes == 0
