"""The port's C++ preprocessing (``tramba_tpu_torch/data/native.py`` over
``tramba_tpu_torch/native/preprocess.cpp``) against PIL and the JAX
package's ``tramba_tpu/data/native.py``.

On the CPU, images seeded with numpy: the resizes are byte-equal to PIL's
and to JAX's native ones at ``tests/test_native.py``'s shapes, at 1080p and
720p to 384, and on a grayscale image; the batch preprocessor matches the
Python path at atol 1e-6 and JAX's; the port's ``static_resize`` /
``eval_transform`` give JAX's bytes.  The build: six threads and four
processes making the first call at once all load one library and leave no
temporary file; a failed build raises, with no PIL fallback.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
from PIL import Image

from tramba_tpu.data import native as jnative
from tramba_tpu.data import transforms as jtransforms
from tramba_tpu_torch.data import native
from tramba_tpu_torch.data import transforms as ttransforms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_native.py's shapes, then 1080p and 720p frames to 384
BILINEAR = [(100, 80, 384), (500, 400, 384), (384, 384, 384), (61, 99, 32), (640, 480, 224),
            (1080, 1920, 384), (720, 1280, 384)]
NEAREST = [(100, 80, 384), (500, 400, 32), (1080, 1920, 384)]


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's module with its library loaded.  Its first load is
    made while every test worker collects ``tests/test_native.py``, all
    building one file at once; a worker that read the file half-written
    remembers the failure, so it loads once more now that the file is
    whole."""
    if not jnative.available():
        monkeypatch.setattr(jnative, "_TRIED", False)
    assert jnative.available()
    return jnative


@pytest.mark.parametrize("h,w,size", BILINEAR)
def test_bilinear_byte_equal_to_pil_and_jax(h, w, size, jax_native):
    img = np.random.default_rng(0).integers(0, 256, (h, w, 3), dtype=np.uint8)
    got = native.resize_bilinear(img, size)
    want = np.asarray(Image.fromarray(img, "RGB").resize((size, size), Image.BILINEAR))
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_native.resize_bilinear(img, size))


def test_bilinear_of_a_grayscale_image(jax_native):
    img = np.random.default_rng(1).integers(0, 256, (375, 500), dtype=np.uint8)
    got = native.resize_bilinear(img, 384)
    assert got.shape == (384, 384)
    np.testing.assert_array_equal(
        got, np.asarray(Image.fromarray(img, "L").resize((384, 384), Image.BILINEAR)))
    np.testing.assert_array_equal(got, jax_native.resize_bilinear(img, 384))


@pytest.mark.parametrize("h,w,size", NEAREST)
def test_nearest_byte_equal_to_pil_and_jax(h, w, size, jax_native):
    mask = np.random.default_rng(2).integers(0, 256, (h, w), dtype=np.uint8)
    got = native.resize_nearest(mask, size)
    want = np.asarray(Image.fromarray(mask, "L").resize((size, size), Image.NEAREST))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_native.resize_nearest(mask, size))


def test_preprocess_eval_batch_matches_python_path_and_jax(jax_native):
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in [(120, 90), (64, 64), (300, 211), (1080, 1920)]]
    masks = [rng.integers(0, 256, im.shape[:2], dtype=np.uint8) for im in images]
    size, mean, std = 96, ttransforms.IMAGENET_MEAN, ttransforms.IMAGENET_STD
    out_img, out_mask = native.preprocess_eval_batch(images, masks, size, mean, std)
    assert out_img.shape == (4, size, size, 3) and out_mask.shape == (4, size, size, 1)
    for i, (im, mk) in enumerate(zip(images, masks)):
        ref = np.asarray(Image.fromarray(im, "RGB").resize((size, size), Image.BILINEAR),
                         np.float32) / 255.0
        np.testing.assert_allclose(out_img[i], (ref - mean) / std, atol=1e-6)
        refm = np.asarray(Image.fromarray(mk, "L").resize((size, size), Image.NEAREST),
                          np.float32) / 255.0
        np.testing.assert_allclose(out_mask[i, :, :, 0], refm, atol=1e-6)
    j_img, j_mask = jax_native.preprocess_eval_batch(images, masks, size, mean, std)
    np.testing.assert_allclose(out_img, j_img, atol=1e-6)
    np.testing.assert_array_equal(out_mask, j_mask)


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="uint8"):
        native.resize_bilinear(np.zeros((8, 8, 3), np.float32), 4)
    with pytest.raises(ValueError, match="positive"):
        native.resize_bilinear(np.zeros((8, 8, 3), np.uint8), 0)
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="mask"):
        native.preprocess_eval_batch([img], [np.zeros((8, 9), np.uint8)], 4, [0] * 3, [1] * 3)


def _samples(seed):
    rng = np.random.default_rng(seed)
    for h, w in [(1080, 1920), (375, 500), (61, 99)]:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        gt = (rng.random((h, w)) > 0.5).astype(np.uint8) * 255
        yield {"image": Image.fromarray(img, "RGB"), "gt": Image.fromarray(gt, "L")}


@pytest.mark.parametrize("size", [384, 64])
def test_static_resize_and_eval_transform_equal_jax(size):
    for ours, theirs in zip(_samples(4), _samples(4)):
        got = ttransforms.static_resize(dict(ours), size)
        want = jtransforms.static_resize(dict(theirs), size)
        for key in ("image", "gt"):
            assert got[key].mode == want[key].mode
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))
    for ours, theirs in zip(_samples(5), _samples(5)):
        got, want = ttransforms.eval_transform(ours, size), jtransforms.eval_transform(theirs, size)
        for key in ("image", "gt"):
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
            assert got[key].tobytes() == want[key].tobytes()


def _built(path):
    names = sorted(os.listdir(path))
    assert len(names) == 1 and names[0].startswith("libtramba_preprocess_"), names
    return names[0]


def test_six_threads_first_use_load_one_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    img = np.random.default_rng(6).integers(0, 256, (50, 70, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img, "RGB").resize((32, 32), Image.BILINEAR))
    start, results = threading.Barrier(6), [None] * 6

    def first_use(i):
        start.wait()
        results[i] = native.resize_bilinear(img, 32)

    threads = [threading.Thread(target=first_use, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for got in results:
        np.testing.assert_array_equal(got, want)
    _built(tmp_path)


_FIRST_USE = """
import sys
import numpy as np
from tramba_tpu_torch.data import native
native.BUILD_DIR = sys.argv[1]
img = np.arange(50 * 70 * 3, dtype=np.int64).reshape(50, 70, 3).astype(np.uint8)
print(native.build(), int(native.resize_bilinear(img, 32).sum()))
"""


def test_four_processes_first_use_load_one_library(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_USE, str(tmp_path)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    lines = {out.strip() for out, _ in outs}
    assert len(lines) == 1, lines  # one library, one result
    assert lines.pop().split()[0] == os.path.join(str(tmp_path), _built(tmp_path))


def test_failed_build_raises_with_no_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "a"))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    img = np.zeros((20, 20, 3), np.uint8)
    for call in (lambda: native.resize_bilinear(img, 8), native.available,
                 lambda: native.preprocess_eval_batch([img], [img[..., 0]], 8, [0] * 3, [1] * 3)):
        with pytest.raises(RuntimeError, match="not found"):
            call()
    # a source the compiler refuses: its errors are in the message, and the
    # build directory keeps no temporary file
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed .*error: expected"):
        native.available()
    assert os.listdir(tmp_path / "b") == []
