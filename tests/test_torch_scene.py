"""The port's scene loader against acezero_tpu's: per-frame calibration
files, and the decode cache (content key, hits, its ownership and mode
checks, its size bound). Focal lengths are exact; cached canvases equal the
decoded ones byte for byte.
"""

import os
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from acezero_tpu.data.scene import load_scene as j_load_scene
from acezero_tpu_torch.data import images as ti
from acezero_tpu_torch.data.scene import load_scene

N = 5


@pytest.fixture
def frames(tmp_path):
    rng = np.random.default_rng(40)
    for i in range(N):
        Image.fromarray(rng.integers(0, 256, (30 + 2 * i, 41, 3), dtype=np.uint8)).save(tmp_path / f"f{i}.png")
    return tmp_path


@pytest.mark.parametrize("kind", ["scalar", "matrix"])
def test_calibration_files_give_jax_focals(kind, frames, tmp_path):
    """A scalar or a 3x3 K per frame (K[0, 0]), matched to the frames in
    sorted order: the JAX package's original and canvas focals; a count
    mismatch raises in both."""
    calib = tmp_path / "calib"
    calib.mkdir()
    for i in range(N):
        f = 500.0 + 10 * i
        text = f"{f}\n" if kind == "scalar" else f"{f} 0 20\n0 {f + 1} 15\n0 0 1\n"
        (calib / f"c{i}.txt").write_text(text)
    kw = dict(calibration_files=str(calib / "*.txt"), image_short_size=24)
    got = load_scene(str(frames / "*.png"), **kw)
    want = j_load_scene(str(frames / "*.png"), **kw)
    np.testing.assert_array_equal(got.focals_orig, want.focals_orig)
    np.testing.assert_array_equal(got.focals_canvas, want.focals_canvas)
    np.testing.assert_array_equal(got.focals_orig, [500, 510, 520, 530, 540])
    # an external focal still wins over the files
    ext = load_scene(str(frames / "*.png"), external_focal_length=42.0, **kw)
    assert (ext.focals_orig == 42.0).all()
    (calib / "c9.txt").write_text("1\n")
    for loader in (load_scene, j_load_scene):
        with pytest.raises(ValueError, match="calibration files"):
            loader(str(frames / "*.png"), **kw)


def _files(frames):
    return sorted(str(p) for p in frames.glob("*.png"))


def test_cache_hit_returns_equal_canvases(frames, tmp_path, monkeypatch):
    """The first decode publishes an entry under the JAX package's content
    key; the second reads it back (no PNG is read) byte for byte, writable
    (copy-on-write maps); another short side is another key."""
    cache = tmp_path / "cache"
    first = ti.decode_to_canvas(_files(frames), 24, cache_dir=cache)
    entries = [p for p in cache.iterdir() if not p.name.startswith(".")]
    assert [p.name for p in entries] == [ti._cache_key(_files(frames), 24, None)]
    assert (cache.stat().st_mode & 0o777) == 0o700

    def no_decode(path):
        raise AssertionError("decoded despite a cache hit")

    monkeypatch.setattr(ti, "read_png", no_decode)
    again = ti.decode_to_canvas(_files(frames), 24, cache_dir=cache)
    for k in ("canvases", "sizes", "orig_sizes", "scale_factors"):
        assert np.array_equal(getattr(again, k), getattr(first, k)) and getattr(again, k).dtype == getattr(first, k).dtype
    again.canvases[0, 0, 0] ^= 1  # writable, and the entry stays as it was
    monkeypatch.undo()
    assert np.array_equal(ti.decode_to_canvas(_files(frames), 24, cache_dir=cache).canvases, first.canvases)
    ti.decode_to_canvas(_files(frames), 16, cache_dir=cache)
    assert len([p for p in cache.iterdir() if not p.name.startswith(".")]) == 2
    # a changed file is a new key
    os.utime(_files(frames)[0], ns=(1, 1))
    assert ti._cache_key(_files(frames), 24, None) != entries[0].name


@pytest.mark.parametrize("fault", ["other_owner", "group_writable", "world_writable", "symlink"])
def test_untrusted_cache_is_not_used(fault, frames, tmp_path, monkeypatch):
    """A cache directory owned by another user, writable by group or world,
    or a symlink, is neither read nor written: the images decode as without a
    cache."""
    cache = tmp_path / "cache"
    plain = ti.decode_to_canvas(_files(frames), 24)
    ti.decode_to_canvas(_files(frames), 24, cache_dir=cache)  # a trusted entry exists
    key = ti._cache_key(_files(frames), 24, None)
    np.save(cache / key / "canvases.npy", np.zeros_like(plain.canvases))  # planted content
    target = cache
    if fault == "other_owner":
        real = os.getuid()
        monkeypatch.setattr(ti.os, "getuid", lambda: real + 1)
    elif fault == "group_writable":
        cache.chmod(0o770)
    elif fault == "world_writable":
        cache.chmod(0o707)
    else:
        target = tmp_path / "link"
        target.symlink_to(cache)
    got = ti.decode_to_canvas(_files(frames), 24, cache_dir=target)
    assert np.array_equal(got.canvases, plain.canvases)
    ti.decode_to_canvas(_files(frames), 16, cache_dir=target)
    assert not any(p.name == ti._cache_key(_files(frames), 16, None) for p in cache.iterdir())


def test_cache_size_bound_evicts_least_recently_used(frames, tmp_path, monkeypatch):
    """Entries past the bound go, least recently used first (a hit counts as
    a use); an entry larger than the bound is not stored."""
    cache = tmp_path / "cache"
    files = _files(frames)
    sizes = {}
    for s in (16, 24, 32, 40):
        d = cache if s < 40 else tmp_path / "sizes"
        ti.decode_to_canvas(files, s, cache_dir=d)
        sizes[s] = ti._entry_bytes(d / ti._cache_key(files, s, None))
    assert len(list(cache.iterdir())) == 3
    later = time.time_ns() + 3600 * 10**9
    os.utime(cache / ti._cache_key(files, 16, None), ns=(later, later))  # 16 used last
    # publishing 40 puts the cache over the bound: 24, then 32 go; 16 stays
    bound = sizes[16] + sizes[40]
    assert ti.CACHE_MAX_BYTES == 4 << 30
    monkeypatch.setattr(ti, "CACHE_MAX_BYTES", bound)
    ti.decode_to_canvas(files, 40, cache_dir=cache)
    names = {p.name for p in cache.iterdir()}
    assert names == {ti._cache_key(files, 16, None), ti._cache_key(files, 40, None)}
    assert sum(ti._entry_bytes(cache / n) for n in names) <= bound
    monkeypatch.setattr(ti, "CACHE_MAX_BYTES", 100)
    ti.decode_to_canvas(files, 48, cache_dir=cache)
    assert ti._cache_key(files, 48, None) not in {p.name for p in cache.iterdir()}


def test_pipeline_uses_the_per_user_cache(frames, tmp_path):
    """load_scene passes decode_cache_dir through; the config's default is a
    per-user directory under the temporary directory."""
    from acezero_tpu_torch.reconstruct import AceZeroConfig

    cache = tmp_path / "c"
    s1 = load_scene(str(frames / "*.png"), external_focal_length=50.0, image_short_size=24, decode_cache_dir=cache)
    s2 = load_scene(str(frames / "*.png"), external_focal_length=50.0, image_short_size=24, decode_cache_dir=cache)
    assert isinstance(s2.images.canvases, np.memmap) and np.array_equal(s1.images.canvases, s2.images.canvases)
    assert Path(AceZeroConfig().decode_cache_dir).name == f"acezero_canvas_cache-{os.getuid()}"
