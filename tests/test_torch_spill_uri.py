"""Spilling to a URI in the port (`_private/external_storage.py`
`UriStorage`, over pyarrow.fs): the counterparts of
tests/test_spilling.py's `test_uri_storage_s3_shaped_fake_fs` and
`test_spill_e2e_through_uri_backend`, plus the same bytes through both
packages' `UriStorage`, which must name and store them alike."""

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import worker as worker_mod

SMALL_STORE = 48 * 1024 * 1024  # 48 MB store


def test_uri_storage_s3_shaped_fake_fs(tmp_path):
    import pyarrow.fs as pafs

    from ray_tpu_torch._private.external_storage import (UriStorage,
                                                         create_storage)

    fake_s3 = pafs.SubTreeFileSystem(str(tmp_path), pafs.LocalFileSystem())
    store = UriStorage("s3://bucket/spill", filesystem=fake_s3,
                       base_path="bucket/spill")
    payload = np.arange(1000, dtype=np.float64).tobytes()
    uri = store.spill(b"\x01" * 16, memoryview(payload))
    assert uri.startswith("s3://bucket/spill/") and uri.endswith(".bin")
    assert store.restore(uri) == payload
    store.delete([uri])
    with pytest.raises(FileNotFoundError):
        store.restore(uri)

    st2 = create_storage("ab" * 8, "s3://bucket/spill", filesystem=fake_s3)
    assert isinstance(st2, UriStorage)
    uri2 = st2.spill(b"\x02" * 16, memoryview(b"xyz"))
    assert uri2.startswith("s3://bucket/spill/" + "ab" * 6 + "/")
    assert st2.restore(uri2) == b"xyz"


def test_both_packages_spill_the_same_bytes_to_the_same_paths(tmp_path):
    import pyarrow.fs as pafs

    from ray_tpu._private.external_storage import UriStorage as JaxUri
    from ray_tpu_torch._private.external_storage import UriStorage

    payload = np.random.default_rng(0).standard_normal(4096).tobytes()
    files = {}
    for name, cls in (("jax", JaxUri), ("torch", UriStorage)):
        root = tmp_path / name
        root.mkdir()
        fs = pafs.SubTreeFileSystem(str(root), pafs.LocalFileSystem())
        uri = cls("s3://bucket/spill", filesystem=fs,
                  base_path="bucket/spill").spill(b"\x03" * 16,
                                                  memoryview(payload))
        assert uri.startswith("s3://bucket/spill/" + "03" * 16 + "-")
        (f,) = (root / "bucket" / "spill").iterdir()
        files[name] = f.read_bytes()
    assert files["torch"] == files["jax"] == payload


def test_spill_e2e_through_uri_backend(tmp_path, monkeypatch):
    monkeypatch.setenv("RT_SPILL_DIR", "file://" + str(tmp_path / "spill"))
    from ray_tpu_torch._private import config as config_mod

    config_mod._config = None
    rt.init(num_cpus=2, object_store_memory=SMALL_STORE)
    try:
        arrays = [np.full(2_000_000, i, dtype=np.float64) for i in range(5)]
        refs = [rt.put(a) for a in arrays]
        raylet = worker_mod._global_node.raylet
        uris = list(raylet._spilled.values())
        assert uris, "expected at least one spilled object"
        assert all(str(u).startswith("file://") for u in uris), uris
        for i, ref in enumerate(refs):
            out = rt.get(ref, timeout=60)
            assert out[0] == i and out.shape == (2_000_000,)
            assert np.array_equal(out, arrays[i])
    finally:
        rt.shutdown()
        config_mod._config = None


def test_an_object_above_the_spill_margin_finds_room(tmp_path, monkeypatch):
    """Objects of 54% of the store: the spill pass used to stop at 60%
    utilization with one object stored, so the second never fit."""
    monkeypatch.setenv("RT_SPILL_DIR", str(tmp_path / "spill"))
    from ray_tpu_torch._private import config as config_mod

    config_mod._config = None
    rt.init(num_cpus=2, object_store_memory=SMALL_STORE)
    try:
        n = int(SMALL_STORE * 0.54) // 8

        @rt.remote
        def big(i):
            return np.full(n, i, dtype=np.float64)

        refs = [rt.put(np.full(n, 10 + i, dtype=np.float64))
                for i in range(2)]
        refs += [big.remote(i) for i in range(2)]
        want = [10, 11, 0, 1]
        for ref, v in zip(refs, want):
            out = rt.get(ref, timeout=60)  # a view into the store
            assert out.shape == (n,) and out[0] == v and out[-1] == v
            del out  # else the next restore finds no room beside it
        assert worker_mod._global_node.raylet._spilled
    finally:
        rt.shutdown()
        config_mod._config = None



@pytest.mark.parametrize("pkg", ["ray_tpu_torch", "ray_tpu"])
def test_a_restored_object_is_spilled_once_and_its_file_freed(tmp_path,
                                                              monkeypatch,
                                                              pkg):
    """Spill, restore, apply pressure again, then free. In the port each
    object is written to the spill directory once (a restored copy keeps
    its file, so the next spill pass drops it without writing), and the
    free deletes every file. The JAX package keeps the fault (ROADMAP
    §C, C3): it writes a restored object again and never deletes the
    first file."""
    import gc
    import importlib
    import os
    import time

    runtime = importlib.import_module(pkg)
    config_mod = importlib.import_module(pkg + "._private.config")
    node = importlib.import_module(pkg + "._private.worker")
    spill_dir = tmp_path / "spill"
    monkeypatch.setenv("RT_SPILL_DIR", str(spill_dir))
    config_mod._config = None
    runtime.init(num_cpus=2, object_store_memory=SMALL_STORE)
    try:
        raylet = node._global_node.raylet
        storage = raylet._get_storage()
        spills, dropped = [], set()
        spill, delete = storage.spill, storage.delete

        def counted(oid, data):
            uri = spill(oid, data)
            spills.append((oid, uri))
            return uri

        def counted_delete(uris):
            dropped.update(uris)
            return delete(uris)

        storage.spill, storage.delete = counted, counted_delete

        def kept():
            # A write whose object a reader still held is deleted at once
            # and the object stays in memory: it is not a spill.
            return [oid for oid, uri in spills if uri not in dropped]

        def files():
            return [os.path.join(d, f) for d, _, fs in os.walk(spill_dir)
                    for f in fs]

        arrays = [np.full(2_000_000, i, dtype=np.float64) for i in range(5)]
        refs = [runtime.put(a) for a in arrays]
        assert kept(), "the puts spilled nothing"
        for i, ref in enumerate(refs):  # restores every spilled object
            out = runtime.get(ref, timeout=60)
            assert out[0] == i and out[-1] == i
            del out
        more = [runtime.put(np.full(2_000_000, 10 + i, dtype=np.float64))
                for i in range(5)]  # pressure again: restored copies go
        for i, ref in enumerate(refs + more):
            out = runtime.get(ref, timeout=60)
            assert out[0] == (i if i < 5 else i + 5)
            del out
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not (
                raylet._metric_objects_spilled == len(kept())
                == len(files())):
            time.sleep(0.05)  # let a background spill pass finish
        writes = kept()
        assert raylet._metric_objects_spilled == len(writes)
        assert len(files()) == len(writes)
        if pkg == "ray_tpu":
            assert len(writes) > len(set(writes))
            return
        assert len(writes) == len(set(writes)), (
            "an object was written to the spill directory twice")
        del refs, more, ref
        gc.collect()
        deadline = time.monotonic() + 30
        while files() and time.monotonic() < deadline:
            time.sleep(0.1)
        assert files() == []
    finally:
        runtime.shutdown()
        config_mod._config = None


@pytest.mark.parametrize("pkg", ["ray_tpu_torch", "ray_tpu"])
def test_a_held_view_of_a_restored_object_survives_spill_pressure(
        tmp_path, monkeypatch, pkg):
    """A client keeps a zero-copy view of a restored object while later
    puts push the store through several spill passes. Each pass finds
    the object held and keeps it; its bytes must stay intact, as they
    must for a data feed that reads restored blocks while more are
    restored."""
    import importlib

    runtime = importlib.import_module(pkg)
    config_mod = importlib.import_module(pkg + "._private.config")
    node = importlib.import_module(pkg + "._private.worker")
    monkeypatch.setenv("RT_SPILL_DIR", str(tmp_path / "spill"))
    config_mod._config = None
    runtime.init(num_cpus=2, object_store_memory=SMALL_STORE)
    try:
        raylet = node._global_node.raylet
        refs = [runtime.put(np.full(2_000_000, i, dtype=np.float64))
                for i in range(5)]
        assert refs[0].binary() in raylet._spilled
        held = runtime.get(refs[0], timeout=60)  # restored, then viewed
        assert (held == 0).all()
        more = [runtime.put(np.full(2_000_000, 10 + i, dtype=np.float64))
                for i in range(4)]  # one spill pass for each put
        for i, ref in enumerate(more):
            out = runtime.get(ref, timeout=60)
            assert out[0] == 10 + i and out[-1] == 10 + i
            del out
        assert (held == 0).all(), "a viewed object's block was reused"
        del held
    finally:
        runtime.shutdown()
        config_mod._config = None
