"""The port's native image transform (``e4t_diffusion_torch/data/
native_ops.py`` over its own copy of ``csrc/e4t_image.cc``) against the
JAX package's library (``native/e4t_image.cc``, built by its module with
``make``): bit for bit on up- and down-scaled sources, both flips and edge
crops; within 2/127.5 of the port's cv2 transform; a crop outside the
image raises. The port's ``E4TDataLoader`` at its default takes the
native transform as the JAX loader does and gives its batches bit for
bit, and under ``E4T_DISABLE_NATIVE=1`` both take cv2 and still agree; a
failed native build raises unless that knob is set."""
import os

import numpy as np
import pytest
from PIL import Image

from e4t_diffusion_tpu.data import dataset as jax_dataset
from e4t_diffusion_tpu.data import native_ops as jax_native

from e4t_diffusion_torch.data import dataset, native_ops

# cv2 INTER_AREA works in fixed point: ~1.5 LSB in uint8 space
CV2_ATOL = 2.0 / 127.5
# (h, w, target): down-scaled (both orientations, odd ratios), unscaled,
# up-scaled (both orientations) and a 1-pixel short side
GEOMETRY = [(600, 800, 512), (517, 333, 256), (512, 512, 512),
            (100, 80, 224), (45, 70, 64), (1, 9, 4)]


@pytest.fixture(scope="module")
def jax_lib():
    if not jax_native.available():
        pytest.fail("the JAX package's native library did not build")
    return jax_native


def _crops(rh, rw, target):
    """Center and both edges of the resized image."""
    return sorted({((rh - target) // 2, (rw - target) // 2), (0, 0),
                   (rh - target, rw - target), (0, rw - target),
                   (rh - target, 0)})


@pytest.mark.parametrize("h,w,target", GEOMETRY)
def test_fused_equals_jax_bit_for_bit(jax_lib, h, w, target):
    rng = np.random.default_rng(h * w)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    dims = native_ops.resized_dims(h, w, target)
    assert dims == jax_lib.resized_dims(h, w, target)
    assert min(dims) == target
    for top, left in _crops(*dims, target):
        for flip in (False, True):
            ours = native_ops.fused_preprocess(img, target, top, left, flip)
            ref = jax_lib.fused_preprocess(img, target, top, left, flip)
            assert ours.shape == (3, target, target)
            assert ours.dtype == np.float32
            np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("h,w,target", GEOMETRY[:4])
def test_fused_within_cv2(h, w, target):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    rh, rw = native_ops.resized_dims(h, w, target)
    resized = dataset.smallest_max_size(img, target)
    assert resized.shape[:2] == (rh, rw)
    for top, left in _crops(rh, rw, target):
        for flip in (False, True):
            crop = resized[top:top + target, left:left + target]
            if flip:
                crop = crop[:, ::-1]
            ref = (crop.astype(np.float32) / 127.5 - 1.0).transpose(2, 0, 1)
            ours = native_ops.fused_preprocess(img, target, top, left, flip)
            np.testing.assert_allclose(ours, ref, atol=CV2_ATOL, rtol=0)


def test_bad_crop_raises(jax_lib):
    img = np.zeros((40, 60, 3), np.uint8)
    rh, rw = native_ops.resized_dims(40, 60, 32)
    for top, left in ((-1, 0), (0, -1), (rh - 31, 0), (0, rw - 31)):
        with pytest.raises(ValueError, match="fused_preprocess failed"):
            native_ops.fused_preprocess(img, 32, top, left, False)
        with pytest.raises(ValueError):
            jax_lib.fused_preprocess(img, 32, top, left, False)
    with pytest.raises(ValueError, match="HxWx3"):
        native_ops.fused_preprocess(img[..., 0], 32, 0, 0, False)


@pytest.mark.parametrize("random_crop", [True, False])
def test_native_transform_draws_as_jax(jax_lib, random_crop):
    """``make_native_transform`` draws crops and flips in ``make_transform``'s
    order: the same seed gives the JAX transform's arrays."""
    ours = native_ops.make_native_transform(48, random_crop, seed=7)
    ref = jax_lib.make_native_transform(48, random_crop, seed=7)
    rng = np.random.default_rng(1)
    outs = []
    for i in range(12):
        img = rng.integers(0, 256, (50 + 9 * i, 120 - 5 * i, 3),
                           dtype=np.uint8)
        outs.append(ours(img))
        np.testing.assert_array_equal(outs[-1], ref(img))
    assert outs[0].shape == (3, 48, 48)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Images whose short side is below, at and above the 32px resolution,
    PNG and JPEG, in two directories."""
    root = tmp_path_factory.mktemp("native_folder")
    rng = np.random.default_rng(3)
    sizes = [(48, 40), (36, 60), (32, 32), (70, 45), (24, 30), (33, 50)]
    for d in ("a", "b"):
        os.makedirs(root / d)
    for i, (h, w) in enumerate(sizes * 2):
        ext = "jpg" if i % 2 else "png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(root / "ab"[i % 2] / f"{i:02d}.{ext}")
    return root


def _batches(loader, n):
    it = iter(loader)
    try:
        return [next(it)["pixel_values"] for _ in range(n)]
    finally:
        it.close()


@pytest.mark.parametrize("native", [True, False], ids=["native", "cv2"])
@pytest.mark.parametrize("random_crop", [True, False])
def test_loader_default_equals_jax(jax_lib, folder, monkeypatch, native,
                                   random_crop):
    """One decode thread: the same batches bit for bit over a few passes."""
    if not native:
        monkeypatch.setenv("E4T_DISABLE_NATIVE", "1")
    spec = f"{folder / 'a'}::{folder / 'b'}"
    kwargs = dict(batch_size=5, resolution=32, random_crop=random_crop,
                  seed=11, process_index=0, process_count=1)
    port = dataset.E4TDataLoader(spec, **kwargs)
    ref = jax_dataset.E4TDataLoader(spec, **kwargs)
    assert port.transform_kind == ("native" if native else "cv2")
    got, want = _batches(port, 6), _batches(ref, 6)
    for a, b in zip(got, want):
        assert a.shape == (5, 3, 32, 32)
        np.testing.assert_array_equal(a, b)


class _Finite:
    """A finite source of eight images (the threaded loader then drains and
    every sample of the source is in its two batches)."""

    def _raw_iter(self):
        rng = np.random.default_rng(5)
        for n in range(8):
            img = rng.integers(0, 256, (40 + 3 * n, 70 - 4 * n, 3),
                               dtype=np.uint8)
            yield f"synthetic #{n}", (lambda img=img: img)


class _PortFinite(_Finite, dataset.E4TDataLoader):
    pass


class _JaxFinite(_Finite, jax_dataset.E4TDataLoader):
    pass


def _canonical(sample):
    """A center-cropped sample up to its flip."""
    return min(sample.tobytes(), sample[:, :, ::-1].tobytes())


@pytest.mark.parametrize("native", [True, False], ids=["native", "cv2"])
def test_threaded_loader_equals_jax(jax_lib, folder, monkeypatch, native):
    """Two decode workers: each worker's transform (seeded ``seed + 1000 *
    (worker + 1)``) gives the JAX worker's arrays bit for bit on the same
    images; and the two center-cropping loaders give the same samples up
    to each sample's flip (the order of completion, and so which worker
    draws a sample's flip, is the threads')."""
    if not native:
        monkeypatch.setenv("E4T_DISABLE_NATIVE", "1")
    for random_crop in (True, False):
        kwargs = dict(batch_size=4, resolution=32, random_crop=random_crop,
                      seed=3, process_index=0, process_count=1,
                      num_workers=2)
        port = dataset.E4TDataLoader(str(folder), **kwargs)
        ref = jax_dataset.E4TDataLoader(str(folder), **kwargs)
        assert port.transform_kind == ("native" if native else "cv2")
        images = [img for _, thunk in _Finite()._raw_iter()
                  for img in [thunk()]]
        for worker in range(2):
            seed = 3 + 1000 * (worker + 1)
            ours, theirs = port._transform(seed), ref._transform_factory(seed)
            for img in images:
                np.testing.assert_array_equal(ours(img), theirs(img))
        if random_crop:
            continue
        got = [s for b in _PortFinite(str(folder), **kwargs)
               for s in b["pixel_values"]]
        want = [s for b in _JaxFinite(str(folder), **kwargs)
                for s in b["pixel_values"]]
        assert len(got) == len(want) == 8
        assert sorted(map(_canonical, got)) == sorted(map(_canonical, want))


def test_failed_build_raises_unless_disabled(tmp_path, monkeypatch):
    """A compiler that fails: the loader raises with the compiler's
    message, and takes cv2 only under ``E4T_DISABLE_NATIVE=1``."""
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native_ops, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_ops, "_lib", None)
    with pytest.raises(RuntimeError, match="no compiler here"):
        dataset.E4TDataLoader(str(tmp_path), batch_size=1)
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setenv("E4T_DISABLE_NATIVE", "1")
    loader = dataset.E4TDataLoader(str(tmp_path), batch_size=1)
    assert loader.transform_kind == "cv2"


def test_without_openmp_the_same_bits(jax_lib, tmp_path, monkeypatch):
    """A toolchain with no OpenMP runtime (as some ship g++): the library
    builds without ``-fopenmp``, says so in its log, and gives the JAX
    library's bits single-threaded."""
    cxx = tmp_path / "cxx-without-openmp"
    cxx.write_text("#!/bin/sh\nfor a in \"$@\"; do if [ \"$a\" = -fopenmp ]; "
                   "then echo \"fatal error: cannot read spec file "
                   "'libgomp.spec'\" >&2; exit 1; fi; done\n"
                   "exec g++ \"$@\"\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native_ops, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_ops, "_lib", None)
    log = native_ops.build_log()
    assert "-fopenmp" not in log.splitlines()[0]
    assert "without -fopenmp" in log and "libgomp.spec" in log
    img = np.random.default_rng(8).integers(0, 256, (300, 200, 3),
                                            dtype=np.uint8)
    for top, left, flip in ((0, 0, False), (20, 0, True)):
        np.testing.assert_array_equal(
            native_ops.fused_preprocess(img, 128, top, left, flip),
            jax_lib.fused_preprocess(img, 128, top, left, flip))


def test_library_name_carries_the_probed_flags(monkeypatch):
    """The OpenMP probe's result is part of the library's name: a library
    built without ``-fopenmp`` is never loaded where OpenMP links."""
    cxx = native_ops._compiler()
    without = tuple(f for f in native_ops.CXX_FLAGS if f != "-fopenmp")
    monkeypatch.setitem(native_ops._probed, cxx, (native_ops.CXX_FLAGS, ""))
    with_omp = native_ops.library_path()
    monkeypatch.setitem(native_ops._probed, cxx, (without, "no libgomp"))
    assert native_ops.build_flags() == without
    assert native_ops.library_path() != with_omp


def test_library_is_built_under_build_and_named_by_its_inputs():
    path = native_ops.library_path()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path.parent == native_ops.BUILD_DIR
    assert os.path.relpath(path, repo).split(os.sep)[0] == "build"
    native_ops.load()
    assert path.exists()
