"""The port's patch-buffer fill against acezero_tpu's.

The JAX package draws its augmentation parameters and sampled cells from a
key; the test replays its key chain (one split per 32-image chunk, then
aug/sample keys, acezero_tpu/training/buffer.py:76-100,398-407) and feeds
the same draws to the port. Sampled cells and theta/scale are read back
from the JAX rows (target pixels encode the cell). Tolerances: features
are bf16 encoder outputs of the same convolutions summed in other orders
(as tests/test_torch_models.py: max within 2% of the feature scale, 99% of
values within 2e-3 + 1%); pixel targets, image indices, theta, scale and
warped target coordinates are exact; the padded pad region repeats the
real rows exactly as the JAX package fills it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acezero_tpu.models import torch_io as jio
from acezero_tpu.training import buffer as jb
from acezero_tpu_torch.models import torch_io as tio
from acezero_tpu_torch.training import buffer as tb

ENCODER = "weights/tpu_encoder_v6.pt"


@pytest.mark.parametrize("n", [1, 5, 60, 1000])
@pytest.mark.parametrize("spi,maxbuf,passes", [(1024, 8_000_000, 10), (256, 4096, 4), (32, 400, 3)])
def test_plan_and_bucket_match_jax(n, spi, maxbuf, passes):
    kw = dict(max_buffer_size=maxbuf, samples_per_image=spi, max_dataset_passes=passes)
    cj, ct = jb.BufferConfig(**kw), tb.BufferConfig(**kw)
    assert tb.plan_buffer_size(ct, n) == jb.plan_buffer_size(cj, n)
    for pad in (True, False):
        assert tb.buffer_alloc_rows(ct, n, pad) == jb.buffer_alloc_rows(cj, n, 1, pad)
    for m in (0, 1, 7, 4096, 4097, 614_400):
        assert tb.next_bucket(m, 8) == jb.next_bucket(m, 8) and tb.next_bucket(m, 4096) == jb.next_bucket(m, 4096)


def _scene(rng, n=5, h=64, w=96):
    imgs = rng.integers(0, 256, (n, h, w)).astype(np.uint8)
    sizes = np.tile(np.array([[h, w]], np.int32), (n, 1))
    sizes[1] = [48, 80]  # one image with padding around its content
    imgs[1] = 0
    imgs[1, 8:56, 8:88] = rng.integers(0, 256, (48, 80))
    return imgs, sizes


def _replay_draws(key, cfg, n, buf_j):
    """The port's `draws` callback reproducing the JAX fill's draws."""
    chunk, S, sub = cfg.image_chunk, cfg.samples_per_image, cfg.subsample
    ws = 96 // sub
    px = np.asarray(buf_j["target_px"])
    theta, scale = np.asarray(buf_j["theta"]), np.asarray(buf_j["scale"])
    state = {"key": key, "row": 0}

    def draws(p, ci, idx):
        state["key"], sub_key = jax.random.split(state["key"])
        k_aug, _ = jax.random.split(sub_key)
        k_theta, k_scale, k_bright, k_contrast = jax.random.split(k_aug, 4)
        bw = cfg.aug_black_white
        u = lambda k: np.array(jax.random.uniform(k, (chunk,), minval=1.0 - bw, maxval=1.0 + bw))[: len(idx)]
        row = state["row"]
        rows = slice(row, row + len(idx) * S)
        cells = np.zeros((len(idx) * S,), np.int64)
        got = px[rows]
        cells[: len(got)] = ((got[:, 1] / sub - 0.5) * ws + (got[:, 0] / sub - 0.5)).round().astype(np.int64)
        state["row"] = row + len(idx) * S
        first = np.arange(len(idx)) * S
        t = np.zeros(len(idx), np.float32)
        s = np.ones(len(idx), np.float32)
        have = first < len(got)
        t[have], s[have] = theta[rows][first[have]], scale[rows][first[have]]
        return {"thetas": torch.from_numpy(t), "scales": torch.from_numpy(s),
                "brightness": torch.from_numpy(u(k_bright)), "contrast": torch.from_numpy(u(k_contrast)),
                "cell_idx": torch.from_numpy(cells.reshape(len(idx), S))}

    return draws


@pytest.mark.parametrize("use_depth", [False, True])
def test_fill_matches_jax_with_replayed_draws(use_depth):
    rng = np.random.default_rng(11)
    imgs, sizes = _scene(rng)
    # 3 passes of 5 images x 32 samples, truncated at 384 rows in the third
    # pass; chunks of 2 images leave a 1-image tail chunk each pass
    kw = dict(max_buffer_size=400, samples_per_image=32, max_dataset_passes=3, image_chunk=2)
    cfg_j, cfg_t = jb.BufferConfig(**kw), tb.BufferConfig(**kw)
    targets = rng.normal(size=(5, 8, 12, 3)).astype(np.float32) if use_depth else None
    if use_depth:
        targets[:, ::2, ::3] = 0.0
    key = jax.random.PRNGKey(7)
    enc_j = jax.tree.map(jnp.asarray, jio.load_encoder(ENCODER))
    buf_j = jax.device_get(jb.fill_training_buffer(key, enc_j, imgs, sizes, cfg_j, target_maps=targets,
                                                   pad_rows_to_bucket=True))
    buf_t = tb.fill_training_buffer(tio.load_encoder(ENCODER), imgs, sizes, cfg_t, target_maps=targets,
                                    pad_rows_to_bucket=True, draws=_replay_draws(key, cfg_j, 5, buf_j))
    assert set(buf_t) == set(buf_j)
    assert buf_t["features"].shape == (4096, 512) and buf_t["features"].dtype == torch.bfloat16
    for k in ("target_px", "img_idx", "theta", "scale", "target_crds"):
        np.testing.assert_array_equal(buf_t[k].numpy(), np.asarray(buf_j[k]), err_msg=k)
    got = buf_t["features"].float().numpy()
    want = np.asarray(buf_j["features"], np.float32)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 0.02 * scale
    assert np.mean(np.abs(got - want) <= 2e-3 + 1e-2 * np.abs(want)) > 0.99
    # the pad repeats rows from the start, in power-of-two blocks
    assert torch.equal(buf_t["features"][384:640], buf_t["features"][:256])
    if use_depth:
        assert np.abs(buf_t["target_crds"].numpy()).sum() > 0


def test_fill_with_generator_samples_inside_content():
    rng = np.random.default_rng(12)
    imgs, sizes = _scene(rng)
    cfg = tb.BufferConfig(max_buffer_size=640, samples_per_image=64, max_dataset_passes=2, image_chunk=4,
                          use_aug=False)
    enc = tio.load_encoder(ENCODER)
    a = tb.fill_training_buffer(enc, imgs, sizes, cfg, generator=torch.Generator().manual_seed(0))
    b = tb.fill_training_buffer(enc, imgs, sizes, cfg, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["features"].shape[0] == 640 and set(a["img_idx"].tolist()) == {0, 1, 2, 3, 4}
    px = a["target_px"][a["img_idx"] == 1]
    assert float(px[:, 0].min()) >= 8 and float(px[:, 0].max()) <= 88
    assert float(px[:, 1].min()) >= 8 and float(px[:, 1].max()) <= 56


def test_empty_fill_does_not_raise():
    """A budget below one image's samples fills no row; the JAX package's
    pad loop raises there (buffer.py:421-422), the port returns the zero
    buffer."""
    rng = np.random.default_rng(13)
    imgs, sizes = _scene(rng, n=2)
    kw = dict(max_buffer_size=16, samples_per_image=32, max_dataset_passes=1, image_chunk=2)
    enc_t = tio.load_encoder(ENCODER)
    buf = tb.fill_training_buffer(enc_t, imgs, sizes, tb.BufferConfig(**kw), pad_rows_to_bucket=True,
                                  generator=torch.Generator().manual_seed(0))
    assert buf["features"].shape == (4096, 512) and float(buf["features"].float().abs().sum()) == 0.0
    enc_j = jax.tree.map(jnp.asarray, jio.load_encoder(ENCODER))
    with pytest.raises(ValueError):
        jb.fill_training_buffer(jax.random.PRNGKey(0), enc_j, imgs, sizes, jb.BufferConfig(**kw),
                                pad_rows_to_bucket=True)


@pytest.mark.parametrize("use_depth,pad", [(False, True), (True, True), (True, False)])
def test_host_spill_fill_equals_device_fill(use_depth, pad):
    """host_spill writes each chunk's rows to host memory: row for row the
    same buffer as the default fill from one generator seed, bucket pad
    included (the JAX package's host buffer has no pad; the port keeps it so
    both buffers draw the same batches)."""
    rng = np.random.default_rng(14)
    imgs, sizes = _scene(rng)
    targets = rng.normal(size=(5, 8, 12, 3)).astype(np.float32) if use_depth else None
    cfg = tb.BufferConfig(max_buffer_size=400, samples_per_image=32, max_dataset_passes=3, image_chunk=2)
    enc = tio.load_encoder(ENCODER)
    dev, host = (tb.fill_training_buffer(enc, imgs, sizes, cfg, target_maps=targets, pad_rows_to_bucket=pad,
                                         generator=torch.Generator().manual_seed(4), host_spill=spill)
                 for spill in (False, True))
    assert set(host) == set(dev) and all(v.device.type == "cpu" for v in host.values())
    assert host["features"].shape[0] == (4096 if pad else 384)
    for k in dev:
        assert host[k].dtype == dev[k].dtype and torch.equal(host[k], dev[k]), k
