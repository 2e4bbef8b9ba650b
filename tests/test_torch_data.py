"""The port's input pipeline against the JAX package's: the folder and
tar-shard sources of ``E4TDataLoader`` give the same batches bit for bit
for a seed (both loaders with their native transform off,
``E4T_DISABLE_NATIVE=1`` for the whole module, so both run the cv2
transform; ``tests/test_torch_native_ops.py`` holds the native one),
process sharding over tar shards, the threaded decode workers, undecodable
files, and ``device_prefetch``."""
import io
import json
import os
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from e4t_diffusion_tpu.data import dataset as jax_dataset
from e4t_diffusion_tpu.data.prefetch import device_prefetch as jax_prefetch

from e4t_diffusion_torch.data import dataset
from e4t_diffusion_torch.data.prefetch import device_prefetch, to_device

# (height, width) of the written images: portrait, landscape, square, and
# sides below, at and above the 32px resolution
SIZES = [(48, 40), (36, 60), (32, 32), (70, 45), (40, 90), (33, 50)]


@pytest.fixture(autouse=True)
def _cv2_transform(monkeypatch):
    monkeypatch.setenv("E4T_DISABLE_NATIVE", "1")


def _image(rng, h, w):
    return rng.integers(0, 255, (h, w, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Images of mixed sizes in two directories (one nested), PNG and JPEG,
    and a file with an image extension that does not decode."""
    root = tmp_path_factory.mktemp("folder")
    rng = np.random.default_rng(0)
    for d in ("a", "a/sub", "b"):
        os.makedirs(root / d)
    for i, (h, w) in enumerate(SIZES * 2):
        d = ("a", "a/sub", "b")[i % 3]
        ext = "jpg" if i % 2 else "png"
        Image.fromarray(_image(rng, h, w)).save(root / d / f"{i:02d}.{ext}")
    (root / "a" / "broken.png").write_bytes(b"not an image")
    (root / "a" / "notes.txt").write_text("skipped by extension")
    return root


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Three tar shards with a sizes.json; each holds images and one
    undecodable member."""
    root = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(1)
    for s in range(3):
        with tarfile.open(root / f"data-{s:02d}.tar", "w") as tf:
            for i, (h, w) in enumerate(SIZES[: 4 + s]):
                buf = io.BytesIO()
                Image.fromarray(_image(rng, h, w)).save(
                    buf, format="JPEG" if i % 2 else "PNG")
                _add(tf, f"{s}_{i}.{'jpg' if i % 2 else 'png'}",
                     buf.getvalue())
            _add(tf, f"{s}_broken.jpg", b"bad")
            _add(tf, f"{s}_meta.json", b"{}")
    with open(root / "sizes.json", "w") as f:
        json.dump({f"data-{s:02d}.tar": 4 + s for s in range(3)}, f)
    return root


def _add(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _batches(loader, n):
    it = iter(loader)
    try:
        return [next(it)["pixel_values"] for _ in range(n)]
    finally:
        it.close()


def _jax_loader(monkeypatch, *args, **kwargs):
    monkeypatch.setenv("E4T_DISABLE_NATIVE", "1")
    return jax_dataset.E4TDataLoader(*args, **kwargs)


@pytest.mark.parametrize("random_crop", [True, False])
def test_folder_loader_matches_jax(folder, monkeypatch, random_crop):
    spec = f"{folder / 'a'}::{folder / 'b'}"
    kwargs = dict(batch_size=3, resolution=32, random_crop=random_crop,
                  seed=5, process_index=0, process_count=1)
    port = dataset.E4TDataLoader(spec, **kwargs)
    ref = _jax_loader(monkeypatch, spec, **kwargs)
    got, want = _batches(port, 6), _batches(ref, 6)
    assert port.num_samples == ref.num_samples == 13  # broken.png counted
    for a, b in zip(got, want):
        assert a.shape == (3, 3, 32, 32) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(got[0], got[1])


@pytest.mark.parametrize("streaming", [False, True])
def test_hf_datasets_loader_matches_jax(monkeypatch, streaming):
    """The HF ``datasets`` source (a name that is no local path) with
    ``load_dataset`` patched to build the set here, with no download: the
    same images in the same order for a seed at dp=1, over more than one
    pass of the set (the non-streamed permutation drawn again, the stream
    shuffled by its buffer)."""
    import datasets

    rng = np.random.default_rng(2)
    images = [Image.fromarray(_image(rng, h, w)) for h, w in SIZES]

    def load_dataset(name, split, streaming):
        assert (name, split) == ("local/faces", "train")
        ds = datasets.Dataset.from_dict({"image": images})
        return ds.to_iterable_dataset() if streaming else ds

    monkeypatch.setattr(datasets, "load_dataset", load_dataset)
    kwargs = dict(batch_size=4, resolution=32, seed=7, streaming=streaming,
                  process_index=0, process_count=1)
    port = dataset.E4TDataLoader("local/faces", **kwargs)
    ref = _jax_loader(monkeypatch, "local/faces", **kwargs)
    got, want = _batches(port, 4), _batches(ref, 4)  # 16 rows, 6 images
    for a, b in zip(got, want):
        assert a.shape == (4, 3, 32, 32)
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(got[0], got[1])
    if not streaming:
        assert port.num_samples == ref.num_samples == len(SIZES)


def test_tar_loader_matches_jax(shards, monkeypatch):
    spec = str(shards / "data-{00..02}.tar")
    assert dataset.get_dataset_size(spec) == \
        jax_dataset.get_dataset_size(spec) == (15, 3)
    kwargs = dict(batch_size=4, resolution=32, seed=3, shuffle_buffer=5,
                  process_index=0, process_count=1)
    port = dataset.E4TDataLoader(spec, **kwargs)
    ref = _jax_loader(monkeypatch, spec, **kwargs)
    assert port.use_tar and port.num_samples == 15
    for a, b in zip(_batches(port, 5), _batches(ref, 5)):
        np.testing.assert_array_equal(a, b)


def test_tar_sharding_by_process(shards, monkeypatch):
    """Each of two processes reads its own shards (every second one), the
    same images the JAX loader gives that process."""
    spec = str(shards / "data-{00..02}.tar")
    seen = []
    for rank in range(2):
        port = list(dataset.iter_tar_shards(
            dataset.expand_shards(spec), rank, 2, seed=0, resample=False))
        ref = list(jax_dataset.iter_tar_shards(
            jax_dataset.expand_shards(spec), rank, 2, seed=0,
            resample=False))
        assert len(port) == len(ref) == (4 + 6 if rank == 0 else 5)
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a, b)
        seen.append({a.tobytes() for a in port})
    assert not seen[0] & seen[1]
    kwargs = dict(batch_size=2, resolution=32, seed=1, shuffle_buffer=3,
                  process_index=1, process_count=2)
    got = _batches(dataset.E4TDataLoader(spec, **kwargs), 3)
    want = _batches(_jax_loader(monkeypatch, spec, **kwargs), 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_process_index_from_torch_distributed(tmp_path):
    import torch.distributed as dist

    assert dataset.process_index_and_count() == (0, 1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        assert dataset.process_index_and_count() == (0, 1)
        loader = dataset.E4TDataLoader(str(tmp_path), batch_size=1)
        assert (loader.process_index, loader.process_count) == (0, 1)
    finally:
        dist.destroy_process_group()


def test_undecodable_file_is_skipped(folder, capsys):
    loader = dataset.E4TDataLoader(str(folder / "a"), batch_size=9,
                                   resolution=16, seed=0)
    batch = _batches(loader, 1)[0]
    assert batch.shape == (9, 3, 16, 16)  # 8 decode: one pass sees all
    assert "broken.png" in capsys.readouterr().out


def test_threaded_workers(folder):
    """Several decode threads: whole batches in range, all of them shut
    down when the iterator closes."""
    import threading

    before = threading.active_count()
    loader = dataset.E4TDataLoader(str(folder), batch_size=4, resolution=32,
                                   seed=2, num_workers=3)
    batches = _batches(loader, 5)
    for b in batches:
        assert b.shape == (4, 3, 32, 32)
        assert b.min() >= -1.0 and b.max() <= 1.0
    assert not np.array_equal(batches[0], batches[1])
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.1)
    assert threading.active_count() <= before


def test_threaded_workers_drain_a_finite_source(folder):
    """With a finite source the workers drain and the iterator ends; the
    partial last batch is dropped, as by the single-thread batcher."""

    class Finite(dataset.E4TDataLoader):
        def _raw_iter(self):
            rng = np.random.default_rng(0)
            for n in range(9):
                img = _image(rng, 70, 50)
                yield f"synthetic #{n}", (lambda img=img: img)
            yield "bad", (lambda: 1 / 0)

    for workers in (0, 2):
        batches = list(Finite(str(folder), batch_size=4, resolution=32,
                              num_workers=workers))
        assert [b["pixel_values"].shape for b in batches] == [
            (4, 3, 32, 32)] * 2


def test_shard_helpers_match_jax(tmp_path):
    for pattern in ("s-{00..02}.tar", "{a,b}/x-{8..10}.tar",
                    "a.tar::b-{1..2}.tar"):
        assert dataset.expand_shards(pattern) == \
            jax_dataset.expand_shards(pattern)
    assert dataset.braceexpand("{a,b}") == ["a", "b"]
    # no sizes.json: the per-shard stats, else an unknown size
    assert dataset.get_dataset_size(str(tmp_path / "x-{0..1}.tar")) == (
        None, 2)
    (tmp_path / "x-1_stats.json").write_text('{"successes": 7}')
    assert dataset.get_dataset_size(str(tmp_path / "x-{0..1}.tar")) == (
        7, 2)
    items = list(range(20))
    assert list(dataset._shuffled(iter(items), 4, 9)) == list(
        jax_dataset._shuffled(iter(items), 4, 9))


def test_device_prefetch_order_laziness_and_errors():
    """The JAX package's contract: order kept, ``place`` called in order
    and at most ``depth`` items ahead, short tails drained, depth checked;
    a StopIteration from ``place`` propagates (as a RuntimeError out of the
    generator) instead of ending the iteration."""
    for fn in (device_prefetch, jax_prefetch):
        calls = []

        def place(x):
            calls.append(x)
            return x * 10

        assert list(fn(range(5), place, depth=2)) == [0, 10, 20, 30, 40]
        assert calls == [0, 1, 2, 3, 4]
        calls.clear()
        gen = fn(range(5), place, depth=2)
        assert next(gen) == 0 and calls == [0, 1]
        assert next(gen) == 10 and calls == [0, 1, 2]
        assert list(gen) == [20, 30, 40]
        assert list(fn(range(1), place, depth=4)) == [0]
        assert list(fn([], place, depth=2)) == []
        with pytest.raises(ValueError):
            next(fn(range(3), place, depth=0))

        def stop_at_two(x):
            if x == 2:
                raise StopIteration
            return x

        with pytest.raises(RuntimeError):
            list(fn(range(4), stop_at_two, depth=1))


def test_device_prefetch_closes_its_source_and_places_on_the_cpu():
    closed = []

    def source():
        try:
            for i in range(10):
                yield {"x": np.full((2,), i, np.float32)}
        finally:
            closed.append(True)

    gen = device_prefetch(source(), lambda b: to_device(
        b["x"], torch.device("cpu")), depth=2, device=torch.device("cpu"))
    first = next(gen)
    assert isinstance(first, torch.Tensor) and first.tolist() == [0.0, 0.0]
    gen.close()
    assert closed == [True]
