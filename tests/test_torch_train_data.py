"""The train slice's data path in vipers_torch against the JAX package on the
CPU: the sampler's index streams, the ImageFolder listing and its cache,
the loaders' batches (train and val, PIL and libjpeg decode, two epochs),
the host presets, each auto-augment policy, mixup/cutmix and RandomErasing.

Everything on the host is exact (uint8 bit for bit, the same numpy
generator). Mixup/cutmix and RandomErasing are fed the JAX package's own
draws (computed here from its PRNG key as its function draws them): f32
1e-6 for mixup's blend and the soft targets (XLA fuses x * lam + y * (1 -
lam) and rounds once less; 1 ulp seen), exact for cutmix's images and for
erasing (a copy and a select). Their own
draws (a torch generator) are checked by distribution on a seeded
generator.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import vipers.data.autoaugment as jaug
import vipers.data.imagefolder as jif
import vipers.data.mixup as jmix
import vipers.data.native as jnative
import vipers.data.preprocess as jpre
import vipers.data.sampler as jsamp
import vipers.train.driver as jdrv
from vipers.core.config import TrainConfig as JConfig
import vipers_torch.data.autoaugment as taug
import vipers_torch.data.imagefolder as tif
import vipers_torch.data.mixup as tmix
import vipers_torch.data.native as tnative
import vipers_torch.data.preprocess as tpre
import vipers_torch.data.sampler as tsamp
import vipers_torch.train.driver as tdrv
from vipers_torch.core.config import TrainConfig as TConfig

FIXTURE_JPEGS = os.path.join(os.path.dirname(__file__), "data", "torch_voc", "JPEGImages")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """3 classes x 7 train + 3 val images of mixed sizes and formats: JPEGs
    of 40x40 to 61x47 and one PNG a class (the loaders' PIL path)."""
    root = tmp_path_factory.mktemp("if")
    rng = np.random.default_rng(0)
    for split, n in (("train", 7), ("val", 3)):
        for c in ("b_cls", "a_cls", "c_cls"):
            d = root / split / c
            d.mkdir(parents=True)
            for i in range(n):
                h, w = int(rng.integers(40, 62)), int(rng.integers(40, 62))
                arr = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
                ext = "png" if i == 0 else "jpg"
                Image.fromarray(arr).save(d / f"img_{i}.{ext}")
            (d / "notes.txt").write_text("not an image")
    return str(root)


@pytest.mark.parametrize("kw", [
    dict(n=37, epoch=0),
    dict(n=37, epoch=3, seed=7, drop_last=True),
    dict(n=37, epoch=1, batch_size=8, drop_last=True),
    dict(n=600, epoch=1, seed=5, batch_size=128, drop_last=True),
    dict(n=37, epoch=0, shuffle=False),
    dict(n=37, epoch=2, seed=3, shuffle=False, pad_with_sentinel=True),
    dict(n=5, epoch=0, batch_size=4, drop_last=True),
], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_shard_indices_match_jax(kw):
    """The port's one-replica stream against the JAX sampler at one replica
    with the arguments its driver passes (``drop_last``, ``batch_size`` and
    the sentinel padding change nothing there)."""
    got = tsamp.epoch_indices(kw["n"], kw["epoch"], seed=kw.get("seed", 0),
                              shuffle=kw.get("shuffle", True))
    assert got == jsamp.shard_indices_for_host(num_replicas=1, rank=0, **kw)


@pytest.mark.parametrize("kw", [
    dict(n=37, epoch=0),
    dict(n=600, epoch=2, seed=3, repetitions=2),
    dict(n=600, epoch=1),
    dict(n=37, epoch=0, shuffle=False),
], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_ra_sampler_indices_match_jax(kw):
    assert tsamp.ra_sampler_indices(**kw) == jsamp.ra_sampler_indices(num_replicas=1, rank=0,
                                                                       **kw)


def test_imagefolder_listing_and_cache_match_jax(tree, tmp_path):
    root = os.path.join(tree, "train")
    t, j = tif.ImageFolder(root), jif.ImageFolder(root)
    assert (t.classes, t.class_to_idx, t.samples) == (j.classes, j.class_to_idx, j.samples)
    assert t.classes == ["a_cls", "b_cls", "c_cls"] and len(t) == 21
    # the same cache file: each package reads the listing the other wrote
    tcache, jcache = tmp_path / "t", tmp_path / "j"
    tif.ImageFolder(root, cache_dir=str(tcache))
    jif.ImageFolder(root, cache_dir=str(jcache))
    assert sorted(os.listdir(tcache)) == sorted(os.listdir(jcache))
    name = os.listdir(tcache)[0]
    assert (tcache / name).read_bytes() == (jcache / name).read_bytes()
    # the port reads the JAX package's cache without a scan: a listing
    # changed in the cache file comes back as it is there
    import pickle

    with open(jcache / name, "wb") as f:
        pickle.dump((j.classes, j.class_to_idx, j.samples[:5]), f)
    assert tif.ImageFolder(root, cache_dir=str(jcache)).samples == j.samples[:5]


def _cfgs(tree, **kw):
    base = dict(data_path=tree, train_crop_size=32, val_resize_size=40, val_crop_size=32,
                batch_size=4, workers=3, seed=11)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def _jsession(jcfg, tree):
    return types.SimpleNamespace(cfg=jcfg, train_ds=jif.ImageFolder(os.path.join(tree, "train")),
                                 val_ds=jif.ImageFolder(os.path.join(tree, "val")))


@pytest.mark.parametrize("kw", [dict(), dict(interpolation="bicubic", auto_augment="ta_wide"),
                                dict(native_decode=True), dict(ra_sampler=True, ra_reps=2)],
                         ids=["pil", "bicubic-ta_wide", "native", "ra_sampler"])
def test_loader_batches_match_jax(tree, kw):
    """Two epochs of train batches and the val batches (its tail of 1) of
    the train driver's loaders, uint8 bit for bit, labels equal."""
    if kw.get("native_decode") and not tnative.available():
        pytest.skip(f"libjpeg decoder not built here: {tnative.build_error()}")
    jcfg, tcfg = _cfgs(tree, **kw)
    js = _jsession(jcfg, tree)
    tds = tif.ImageFolder(os.path.join(tree, "train"))
    for epoch in range(2):
        got = list(tdrv.train_loader(tcfg, tds, epoch))
        want = list(jdrv._train_loader(js, epoch))
        assert len(got) == len(want) >= 4
        for (gi, gl), (wi, wl) in zip(got, want):
            assert gi.dtype == np.uint8 and gi.shape == (4, 32, 32, 3)
            assert np.array_equal(gi, wi) and np.array_equal(gl, wl)
    got = list(tdrv.val_loader(tcfg, tif.ImageFolder(os.path.join(tree, "val"))))
    want = list(jdrv._val_loader(js))
    assert [g[0].shape[0] for g in got] == [4, 4, 1]
    for (gi, gl), (wi, wl) in zip(got, want):
        assert np.array_equal(gi, wi) and np.array_equal(gl, wl)


def test_device_batches_upload_and_record(tree):
    tcfg = _cfgs(tree)[1]
    tdrv.LAST_RUN.clear()
    ds = tif.ImageFolder(os.path.join(tree, "val"))
    batches = list(tdrv.DeviceBatches(tdrv.val_loader(tcfg, ds), torch.device("cpu"), "val"))
    first = tdrv.LAST_RUN["first_val_batch"]
    assert batches[0][0].dtype == torch.uint8 and batches[0][1].dtype == torch.int64
    assert np.array_equal(batches[0][0].numpy(), first[0])
    assert tdrv.LAST_RUN["val_images"] == 9 and "t_first_decode" in tdrv.LAST_RUN


@pytest.mark.parametrize("interp", ["bilinear", "nearest", "bicubic", "lanczos", "hamming", "box"])
def test_host_presets_match_jax(tree, interp):
    paths = [os.path.join(tree, "train", "a_cls", f"img_{i}.{'png' if i == 0 else 'jpg'}")
             for i in range(3)] + [os.path.join(FIXTURE_JPEGS, f) for f in
                                   sorted(os.listdir(FIXTURE_JPEGS))[:3]]
    for p in paths:
        for resize, crop in ((40, 32), (37, 33), (256, 224)):
            got = tpre.eval_decode(p, resize, crop, interpolation=interp)
            want = jpre.eval_decode(p, resize, crop, interpolation=interp)
            assert got.shape == (crop, crop, 3) and np.array_equal(got, want), (p, resize)
        for seed in range(4):
            got = tpre.train_decode(p, np.random.default_rng(seed), 32, interpolation=interp)
            want = jpre.train_decode(p, np.random.default_rng(seed), 32, interpolation=interp)
            assert np.array_equal(got, want), (p, seed)
        # an extreme ratio reaches RandomResizedCrop's fallback box
        rng_t, rng_j = np.random.default_rng(1), np.random.default_rng(1)
        img = tpre.load_image_rgb(p).resize((200, 20))
        assert np.array_equal(tpre.random_resized_crop(img, 24, rng_t, scale=(0.99, 1.0)),
                              jpre.random_resized_crop(img, 24, rng_j, scale=(0.99, 1.0)))


@pytest.mark.parametrize("policy", ["ra", "ta_wide", "augmix", "imagenet"])
def test_autoaugment_policy_matches_jax(policy):
    arr = np.random.default_rng(3).integers(0, 256, (24, 28, 3), dtype=np.uint8)
    for seed in range(12):
        kw = dict(ra_magnitude=5 + seed % 5, augmix_severity=1 + seed % 3)
        got = taug.apply_policy(policy, arr, np.random.default_rng(seed), **kw)
        want = jaug.apply_policy(policy, arr, np.random.default_rng(seed), **kw)
        assert got.dtype == np.uint8 and np.array_equal(got, want), seed
    with pytest.raises(ValueError, match="unknown auto-augment"):
        taug.apply_policy("nope", arr, np.random.default_rng(0))


def test_native_decodes_match_jax():
    if not tnative.available():
        pytest.skip(f"libjpeg decoder not built here: {tnative.build_error()}")
    assert jnative.available()
    for f in sorted(os.listdir(FIXTURE_JPEGS)):
        p = os.path.join(FIXTURE_JPEGS, f)
        for resize, crop in ((256, 224), (73, 64)):
            assert np.array_equal(tnative.decode_eval(p, resize, crop),
                                  jnative.decode_eval(p, resize, crop)), (f, resize)
        for seed in range(3):
            kw = dict(crop_size=64, auto_augment="ra" if seed == 2 else "")
            assert np.array_equal(tnative.decode_train(p, np.random.default_rng(seed), **kw),
                                  jnative.decode_train(p, np.random.default_rng(seed), **kw))


def _jax_mix_draws(key, h, w, mixup_alpha, cutmix_alpha):
    """The draws ``vipers.data.mixup.mixup_cutmix_batch`` makes from
    ``key``: (use mixup, lam, box), in its f32 arithmetic."""
    k_choice, k_lam, k_box = jax.random.split(key, 3)
    use_mixup = mixup_alpha > 0
    if mixup_alpha > 0 and cutmix_alpha > 0:
        use_mixup = bool(jax.random.bernoulli(k_choice))
    lam = jmix._beta(k_lam, mixup_alpha if use_mixup else cutmix_alpha)
    if use_mixup:
        return True, float(lam), None
    kx, ky = jax.random.split(k_box)
    r_x = jax.random.randint(kx, (), 0, w)
    r_y = jax.random.randint(ky, (), 0, h)
    r = 0.5 * jnp.sqrt(1.0 - lam)
    rw, rh = int((r * w).astype(jnp.int32)), int((r * h).astype(jnp.int32))
    r_x, r_y = int(r_x), int(r_y)
    box = tuple(int(np.clip(v, 0, m)) for v, m in ((r_x - rw, w), (r_y - rh, h),
                                                    (r_x + rw, w), (r_y + rh, h)))
    return False, float(lam), box


@pytest.mark.parametrize("alphas", [(0.2, 0.0), (0.0, 1.0), (0.8, 1.0)],
                         ids=["mixup", "cutmix", "both"])
def test_mixup_cutmix_given_jax_draws_matches_jax(alphas):
    rng = np.random.default_rng(4)
    images = rng.normal(size=(6, 20, 24, 3)).astype(np.float32)
    labels = rng.integers(0, 5, size=(6,)).astype(np.int32)
    branches = set()
    for s in range(8):
        key = jax.random.PRNGKey(s)
        use_mixup, lam, box = _jax_mix_draws(key, 20, 24, *alphas)
        branches.add(use_mixup)
        wi, wl = jmix.mixup_cutmix_batch(key, jnp.asarray(images), jnp.asarray(labels), 5, *alphas)
        gi, gl = tmix.apply_mixup_cutmix(torch.from_numpy(images), torch.from_numpy(labels), 5,
                                         use_mixup, lam, box)
        np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-6 if use_mixup else 0,
                                   rtol=0)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-6, rtol=0)
        if not use_mixup:
            assert not np.array_equal(gi.numpy(), images) or box[0] == box[2] or box[1] == box[3]
    assert branches == ({True, False} if all(alphas) else {alphas[0] > 0})


def test_mixup_cutmix_draws_distribution():
    """On a seeded generator: both on, mixup chosen half the time; lam of
    Beta(a, a) averages 1/2 with variance 1 / (4 (2a + 1)); cutmix boxes
    lie in the image; the soft targets sum to 1."""
    gen = torch.Generator().manual_seed(0)
    draws = [tmix.draw_mixup_cutmix(gen, 32, 48, 0.8, 1.0) for _ in range(4000)]
    share = np.mean([d[0] for d in draws])
    assert abs(share - 0.5) < 0.03, share
    for use, alpha in ((True, 0.8), (False, 1.0)):
        lams = np.array([d[1] for d in draws if d[0] == use])
        assert abs(lams.mean() - 0.5) < 0.02
        assert abs(lams.var() - 1 / (4 * (2 * alpha + 1))) < 0.01
    for _, _, box in draws:
        if box is not None:
            x1, y1, x2, y2 = box
            assert 0 <= x1 <= x2 <= 48 and 0 <= y1 <= y2 <= 32
    small = np.array([tmix._beta(gen, 0.2) for _ in range(3000)])  # alpha < 1: boosted gamma
    assert abs(small.mean() - 0.5) < 0.03 and abs(small.var() - 1 / (4 * 1.4)) < 0.02
    x = torch.randn(4, 8, 8, 3)
    y = torch.tensor([0, 1, 2, 3])
    for s in range(5):
        _, t = tmix.mixup_cutmix_batch(torch.Generator().manual_seed(s), x, y, 4, 0.2, 1.0)
        assert t.shape == (4, 4) and torch.allclose(t.sum(1), torch.ones(4))


def _jax_erase_draws(key, n, h, w, prob, scale=(0.02, 0.33), ratio=(0.3, 3.3)):
    """The rectangles ``vipers.data.preprocess._random_erase`` draws from
    ``key``, in its arithmetic."""
    k_apply, k_area, k_ar, k_top, k_left = jax.random.split(key, 5)
    apply = jax.random.uniform(k_apply, (n,)) < prob
    area = jax.random.uniform(k_area, (n,), minval=scale[0], maxval=scale[1]) * h * w
    ar = jnp.exp(jax.random.uniform(k_ar, (n,), minval=jnp.log(ratio[0]),
                                    maxval=jnp.log(ratio[1])))
    eh = jnp.clip(jnp.sqrt(area / ar).astype(jnp.int32), 1, h)
    ew = jnp.clip(jnp.sqrt(area * ar).astype(jnp.int32), 1, w)
    top = (jax.random.uniform(k_top, (n,)) * (h - eh + 1)).astype(jnp.int32)
    left = (jax.random.uniform(k_left, (n,)) * (w - ew + 1)).astype(jnp.int32)
    return [torch.from_numpy(np.array(a)).long() if a.dtype != jnp.bool_
            else torch.from_numpy(np.array(a)) for a in (apply, top, left, eh, ew)]


def test_random_erase_given_jax_rectangles_matches_jax():
    x = np.random.default_rng(6).normal(size=(16, 20, 28, 3)).astype(np.float32)
    for s in range(4):
        key = jax.random.PRNGKey(s)
        want = np.asarray(jpre._random_erase(jnp.asarray(x), key, 0.6))
        got = tpre.apply_random_erase(torch.from_numpy(x), *_jax_erase_draws(key, 16, 20, 28, 0.6))
        assert np.array_equal(got.numpy(), want), s
        assert (want == 0).any()


def test_random_erase_draws_and_normalize():
    """The apply rate is the probability; each rectangle lies in the image
    with an area near the drawn share; the normalize erases only when given
    a generator (training), and is the plain normalize otherwise."""
    gen = torch.Generator().manual_seed(1)
    apply, top, left, eh, ew = tpre.draw_random_erase(gen, 20000, 32, 40, 0.25)
    assert abs(apply.float().mean().item() - 0.25) < 0.01
    assert bool(((top >= 0) & (top + eh <= 32) & (left >= 0) & (left + ew <= 40)).all())
    assert bool(((eh >= 1) & (ew >= 1)).all())
    share = (eh * ew).float() / (32 * 40)
    assert 0.02 * 0.5 < share.mean().item() < 0.33
    u8 = torch.from_numpy(np.random.default_rng(2).integers(1, 256, (64, 16, 16, 3),
                                                             dtype=np.uint8))
    plain = tpre.make_device_normalize()(u8)
    norm = tpre.make_device_normalize(random_erase_prob=0.5)
    assert torch.equal(norm(u8), plain)  # evaluation: no generator, no erasing
    erased = norm(u8, generator=torch.Generator().manual_seed(3))
    hit = (erased != plain).flatten(1).any(1)
    assert 16 < int(hit.sum()) < 48
    assert bool((erased[erased != plain] == 0).all())
