"""The port's file sources and sinks against the JAX package's, one cluster
per package for the module: ``read_numpy``, ``read_text``, ``read_json``,
``read_binary_files`` and ``read_tfrecords`` read the same files into the
same rows and block boundaries; ``write_tfrecords`` and ``write_json``
of the same rows give files identical byte for byte, whichever package
wrote them, and each package reads the other's TFRecords; the TFRecord
codec (crc32c, the Example encoding) is the JAX package's to the byte."""
from __future__ import annotations

import contextlib
import gc
import json
import os

import numpy as np
import pytest


@pytest.fixture(scope="module")
def torch_rt():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def jax_rt():
    pytest.importorskip("jax")
    import ray_tpu

    if ray_tpu.is_initialized():  # left by a file run before in this process
        ray_tpu.shutdown()
    with _collector_off():
        ray_tpu.init(num_cpus=4)
    yield ray_tpu
    with _collector_off():
        ray_tpu.shutdown()


@contextlib.contextmanager
def _collector_off():
    """For calls into the JAX package's cluster (``tests/test_torch_core.py``)."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.collect()


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return [_plain(v) for v in x] if x.dtype == object else x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def _both(fn):
    """``fn(data module)`` on the port, then on the JAX package."""
    import ray_tpu.data as jd

    import ray_tpu_torch.data as td

    mine = fn(td)
    with _collector_off():
        theirs = fn(jd)
    return mine, theirs


def _blocks(ds):
    return [_plain(b) for b in ds.iter_batches(batch_size=None)]


ROWS = [{"id": i, "x": i * 0.25, "name": f"row-{i}", "tags": [i, i + 1],
         "raw": bytes([i, 255 - i])} for i in range(9)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("formats")
    rng = np.random.default_rng(0)
    (root / "npy").mkdir()
    np.save(root / "npy" / "0.npy",
            rng.integers(0, 100, (4, 3)).astype(np.int32))
    np.save(root / "npy" / "1.npy", rng.random((2, 3)))
    (root / "text").mkdir()
    (root / "text" / "0.txt").write_text("alpha\nbeta\n\ngamma")
    (root / "text" / "1.txt").write_text("delta\n")
    (root / "json").mkdir()
    for k in range(2):
        with open(root / "json" / f"{k}.json", "w") as f:
            for r in ROWS[k * 4:(k + 1) * 4]:
                f.write(json.dumps({"id": r["id"], "x": r["x"],
                                    "name": r["name"], "tags": r["tags"]})
                        + "\n")
            f.write("\n")
    (root / "bin").mkdir()
    for k in range(3):
        (root / "bin" / f"{k}.bin").write_bytes(bytes(range(k, 3 * k + 2)))
    return root


def test_read_numpy_equals_jax(torch_rt, jax_rt, files):
    mine, theirs = _both(lambda d: _blocks(d.read_numpy(str(files / "npy"))))
    assert mine == theirs and len(mine) == 2


def test_read_text_equals_jax(torch_rt, jax_rt, files):
    mine, theirs = _both(lambda d: _blocks(d.read_text(str(files / "text"))))
    assert mine == theirs
    assert mine[0] == {"text": ["alpha", "beta", "", "gamma"]}


def test_read_json_equals_jax(torch_rt, jax_rt, files):
    mine, theirs = _both(
        lambda d: _blocks(d.read_json(str(files / "json" / "*.json"))))
    assert mine == theirs and len(mine) == 2


@pytest.mark.parametrize("include_paths", [False, True])
def test_read_binary_files_equals_jax(torch_rt, jax_rt, files,
                                      include_paths):
    mine, theirs = _both(lambda d: _blocks(d.read_binary_files(
        str(files / "bin"), include_paths=include_paths)))
    assert mine == theirs and len(mine) == 3


def _write(d, root, kind):
    ds = d.from_items([dict(r) for r in ROWS], parallelism=3)
    if kind == "json":
        ds = ds.drop_columns(["raw"])  # bytes have no JSON form
    paths = getattr(ds, "write_" + kind)(str(root))
    return {os.path.basename(p): open(p, "rb").read() for p in paths}


@pytest.mark.parametrize("kind", ["tfrecords", "json"])
def test_written_bytes_equal_jax(torch_rt, jax_rt, tmp_path, kind):
    mine, theirs = _both(lambda d: _write(d, tmp_path / d.__name__, kind))
    assert sorted(mine) == ["part-00000." + kind, "part-00001." + kind,
                            "part-00002." + kind]
    assert mine == theirs


def test_read_tfrecords_across_packages(torch_rt, jax_rt, tmp_path):
    import ray_tpu.data as jd

    import ray_tpu_torch.data as td

    td.from_items([dict(r) for r in ROWS], parallelism=2).write_tfrecords(
        str(tmp_path / "torch"))
    with _collector_off():
        jd.from_items([dict(r) for r in ROWS], parallelism=2).write_tfrecords(
            str(tmp_path / "jax"))
    got = {}
    for reader, dm in (("torch", td), ("jax", jd)):
        for writer in ("torch", "jax"):
            with _collector_off():
                got[reader, writer] = _blocks(
                    dm.read_tfrecords(str(tmp_path / writer)))
    first = got["jax", "jax"]
    assert all(v == first for v in got.values())
    assert first[0]["raw"][0] == ROWS[0]["raw"]
    assert first[0]["name"][0] == b"row-0"  # strings come back as bytes


def test_tfrecord_codec_equals_jax():
    from ray_tpu.data import tfrecord as jt

    from ray_tpu_torch.data import tfrecord as tt

    for data in (b"", b"a", b"123456789", bytes(range(256)) * 3):
        assert tt.crc32c(data) == jt.crc32c(data)
    for row in ROWS + [{"t": np.arange(6, dtype=np.int64).reshape(2, 3),
                        "f": np.float32(1.5), "neg": -7}]:
        blob = tt.encode_example(row)
        assert blob == jt.encode_example(row)
        assert tt.decode_example(blob) == jt.decode_example(blob)
