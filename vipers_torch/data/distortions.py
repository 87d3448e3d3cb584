"""Model-vs-human distortion suite (a numpy copy of
``vipers/data/distortions.py``).

The reference defers to the external ``modelvshuman`` toolbox
(its ``mvh.py:1-3``) and only post-processes its CSVs
(``mvh_performance_plot.py:44-87``).  The toolbox's 17
benchmarks split into:

  * 12 *parametric distortions* of ImageNet images — implemented here as
    deterministic numpy/FFT transforms (colour, false-colour, contrast,
    low-pass, high-pass, phase-scrambling, power-equalisation, rotation,
    uniform-noise, eidolonI/II/III),
  * 5 *stimulus datasets* (cue-conflict, edge, silhouette, sketch,
    stylized) that are fixed external image sets — consumed from a
    directory when provided (see ``eval_mvh``), not synthesizable.

Eidolon distortions implement the toolbox's partially-coherent disarray
(DOG scale space, per-band displacement fields, variance-preserving
coherence blend — see ``_eidolon``); the CSV/plot contracts match the
reference's.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

GRAY_W = np.asarray([0.2126, 0.7152, 0.0722], np.float32)


def _to_gray(img):
    g = (img * GRAY_W).sum(-1, keepdims=True)
    return np.repeat(g, 3, axis=-1)


def colour(img, rng, level=1):
    """'colour' benchmark conditions: level 0 = true colour (unchanged),
    level 1 = grayscale presentation."""
    del rng
    return _to_gray(img) if level else img


def false_colour(img, rng, level=1):
    """level 0 = true colour; level 1 = opponent-color inversion (keep
    luminance, flip chroma)."""
    del rng
    if not level:
        return img
    g = (img * GRAY_W).sum(-1, keepdims=True)
    return np.clip(2 * g - img, 0.0, 1.0)


def contrast(img, rng, level=0.3):
    del rng
    return 0.5 + (img - 0.5) * level


def uniform_noise(img, rng, level=0.2):
    return np.clip(img + rng.uniform(-level, level, img.shape).astype(np.float32), 0, 1)


def rotation(img, rng, level=90):
    del rng
    k = int(level // 90) % 4
    return np.rot90(img, k, axes=(0, 1)).copy()


def _gauss_kernel_1d(sigma: float, max_len: int):
    # cap the radius so the kernel never exceeds the axis length
    # (np.convolve 'same' returns len(k) when len(k) > len(m))
    r = min(max(int(3 * sigma), 1), max(0, (max_len - 1) // 2))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _blur(img, sigma: float):
    if sigma <= 0:
        return img
    k0 = _gauss_kernel_1d(sigma, img.shape[0])
    k1 = _gauss_kernel_1d(sigma, img.shape[1])
    out = np.apply_along_axis(lambda m: np.convolve(m, k0, mode="same"), 0, img)
    out = np.apply_along_axis(lambda m: np.convolve(m, k1, mode="same"), 1, out)
    return out.astype(np.float32)


def low_pass(img, rng, level=3.0):
    del rng
    return _blur(img, level)


def high_pass(img, rng, level=1.0):
    del rng
    g = _to_gray(img)
    if level <= 0:  # toolbox sigma=inf condition: unfiltered grayscale
        return g
    hp = g - _blur(g, level) + 0.5
    return np.clip(hp, 0, 1)


def phase_scrambling(img, rng, level=90.0):
    """Add uniform noise in [-level, level] degrees to the FFT phase
    (grayscale, per the toolbox)."""
    g = _to_gray(img)[..., 0]
    f = np.fft.fft2(g)
    noise = rng.uniform(-1, 1, f.shape) * np.deg2rad(level)
    scrambled = np.abs(f) * np.exp(1j * (np.angle(f) + noise))
    out = np.real(np.fft.ifft2(scrambled)).astype(np.float32)
    out = np.clip(out, 0, 1)
    return np.repeat(out[..., None], 3, axis=-1)


def power_equalisation(img, rng, level=1):
    """level 0 = original; level 1 = FFT amplitude spectrum replaced with
    the mean 1/f-like spectrum (here: the image's own mean amplitude)."""
    del rng
    if not level:
        return img
    g = _to_gray(img)[..., 0]
    f = np.fft.fft2(g)
    amp = np.abs(f)
    mean_amp = np.full_like(amp, amp.mean())
    out = np.real(np.fft.ifft2(mean_amp * np.exp(1j * np.angle(f))))
    out = out - out.min()
    out = (out / max(out.max(), 1e-9)).astype(np.float32)
    return np.repeat(out[..., None], 3, axis=-1)


def _displacement_field(rng, h, w, grain: float):
    """Gaussian random field low-passed at the ``grain`` scale with UNIT
    EXPECTED VARIANCE — the eidolon factory's displacement-plane math
    (the benchmark fixes grain=10.0, so ``reach`` is the per-axis RMS
    displacement in pixels).

    The factory normalizes its blurred noise ANALYTICALLY: blurring
    unit-variance white noise with a unit-integral Gaussian of width
    sigma leaves variance ``integral(G^2) = 1/(4*pi*sigma^2)``, so it
    rescales by ``2*sqrt(pi)*sigma``.  We apply the exact discrete-kernel
    value of that correction, ``1/sqrt(sum(k0^2)*sum(k1^2))`` for the
    separable kernel actually used (it converges to ``2*sqrt(pi)*grain``
    — within 0.2% at grain=10; see the fixture test), and blur a plane
    padded by the kernel radius so the statistics are stationary to the
    border (the factory's fat-plane embedding serves the same purpose).
    An EMPIRICAL per-sample normalization would pin the sample variance
    instead of the expectation, mis-scaling reach by the sampling noise
    of the field (~10% at grain=10 on a 224px image)."""
    r = max(int(3 * grain), 1)
    hp, wp = h + 2 * r, w + 2 * r
    k0 = _gauss_kernel_1d(grain, hp)
    k1 = _gauss_kernel_1d(grain, wp)
    noise = rng.normal(0, 1, (hp, wp)).astype(np.float32)
    f = np.apply_along_axis(lambda m: np.convolve(m, k0, mode="same"), 0, noise)
    f = np.apply_along_axis(lambda m: np.convolve(m, k1, mode="same"), 1, f)
    f = f[r:r + h, r:r + w]
    scale = 1.0 / np.sqrt(float((k0 ** 2).sum() * (k1 ** 2).sum()))
    return (f * scale).astype(np.float32)


def _warp_bilinear(plane, dx, dy):
    """Backward-warp a (H, W) plane by per-pixel displacements, bilinear,
    clamped at the border."""
    h, w = plane.shape
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    ys = np.clip(yy + dy, 0.0, h - 1.0)
    xs = np.clip(xx + dx, 0.0, w - 1.0)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = ys - y0
    fx = xs - x0
    return (plane[y0, x0] * (1 - fy) * (1 - fx)
            + plane[y0, x1] * (1 - fy) * fx
            + plane[y1, x0] * fy * (1 - fx)
            + plane[y1, x1] * fy * fx)


def _dog_scale_space(g):
    """Difference-of-Gaussians decomposition on a 2^(k/2) sigma ladder
    (the eidolon factory's fiducial scale space): returns (bands, residual)
    with ``sum(bands) + residual == g`` exactly."""
    h, w = g.shape
    sigmas = []
    s = 2.0 ** -0.5  # MIN_SIGMA = 1/sqrt(2)
    while s < min(h, w) / 4.0:
        sigmas.append(s)
        s *= np.sqrt(2.0)
    blurred = [g] + [
        _blur(g[..., None], sig)[..., 0] for sig in sigmas
    ]
    bands = [blurred[i] - blurred[i + 1] for i in range(len(blurred) - 1)]
    return bands, blurred[-1]


def _eidolon(img, rng, reach: float, coherence: float, grain: float = 10.0):
    """Partially-coherent disarray — the Eidolon toolbox's algorithm
    (Koenderink et al. 2017 eidolon factory; modelvshuman's
    ``partially_coherent_disarray``):

      * decompose the image into a DOG scale space,
      * draw ONE shared displacement-field pair plus an independent pair
        per scale band, every field grain(=10.0)-blurred unit-variance
        Gaussian noise,
      * per band, blend variance-preservingly:
        ``d_i = reach * (c * shared + sqrt(1 - c^2) * own_i)``,
      * warp each band with its own field and re-sum (+ warped residual).

    ``coherence=1`` makes every band share one field — identical to a
    single whole-image warp (warping is linear in the image); ``coherence=0``
    scrambles scales independently (the "fog" regime).

    Magnitude ladder: every band's field pair is drawn at the SAME grain
    and unit expected variance and scaled by the same ``reach`` — the
    factory's partially-coherent disarray applies one reach across the
    scale space, with the coherence blend ``c*shared +
    sqrt(1-c^2)*own_i`` variance-preserving so the per-axis RMS
    displacement of every band is exactly ``reach`` pixels at every
    coherence (tested in the JAX package).  Bit-level equality with
    the toolbox's own RNG stream is not a meaningful target (different
    generators); the per-band field STATISTICS match the published math
    exactly."""
    h, w = img.shape[:2]
    c = float(coherence)
    mix = np.sqrt(max(1.0 - c * c, 0.0))
    shared = (_displacement_field(rng, h, w, grain),
              _displacement_field(rng, h, w, grain))
    # One independent field pair per band + residual, shared across
    # channels (the toolbox disarrays one geometry; we apply it to each
    # channel identically). Channel 0's decomposition doubles as the band
    # count, and the fully coherent case (mix == 0) skips the dead
    # independent-field draws entirely — this consumes fewer RNG draws
    # than the c<1 path, so eidolonI streams are not cross-comparable
    # with the other coherences at the same seed (they never were:
    # distinct field sets), only distribution-identical.
    bands0, residual0 = _dog_scale_space(img[..., 0])
    n_fields = len(bands0) + 1
    displacements = []
    for _ in range(n_fields):
        if mix > 0.0:
            own = (_displacement_field(rng, h, w, grain),
                   _displacement_field(rng, h, w, grain))
            displacements.append((
                reach * (c * shared[0] + mix * own[0]),
                reach * (c * shared[1] + mix * own[1]),
            ))
        else:
            displacements.append((reach * shared[0], reach * shared[1]))
    out = np.zeros_like(img)
    for ch in range(img.shape[-1]):
        bands, residual = (
            (bands0, residual0) if ch == 0 else _dog_scale_space(img[..., ch])
        )
        acc = np.zeros((h, w), np.float32)
        for (dx, dy), band in zip(displacements, bands + [residual]):
            acc += _warp_bilinear(band, dx, dy)
        out[..., ch] = acc
    return np.clip(out, 0.0, 1.0)


# Geirhos et al. 2018 §3.5 naming: Eidolon I/II/III = coherence 1.0 / 0.3
# / 0.0 at grain 10.0, reach swept per level.
def eidolonI(img, rng, level=8.0):
    return _eidolon(img, rng, reach=level, coherence=1.0)


def eidolonII(img, rng, level=8.0):
    return _eidolon(img, rng, reach=level, coherence=0.3)


def eidolonIII(img, rng, level=8.0):
    return _eidolon(img, rng, reach=level, coherence=0.0)


PARAMETRIC_DISTORTIONS: Dict[str, Callable] = {
    "colour": colour,
    "false-colour": false_colour,
    "contrast": contrast,
    "low-pass": low_pass,
    "high-pass": high_pass,
    "phase-scrambling": phase_scrambling,
    "power-equalisation": power_equalisation,
    "rotation": rotation,
    "uniform-noise": uniform_noise,
    "eidolonI": eidolonI,
    "eidolonII": eidolonII,
    "eidolonIII": eidolonIII,
}

STIMULUS_DATASETS = ("cue-conflict", "edge", "silhouette", "sketch", "stylized")

# Per-benchmark parameter sweeps — the levels the modelvshuman toolbox
# evaluates (Geirhos et al. 2021, consumed row-wise by
# the reference's ``mvh_performance_plot.py:44-87``).  high-pass level 0
# means "no filtering" (sigma=inf in the toolbox); eidolon coherence is
# fixed per benchmark (I=0.0, II=0.3, III=1.0) with reach swept.
DISTORTION_LEVELS: Dict[str, list] = {
    "colour": [0, 1],                      # colour / grayscale
    "false-colour": [0, 1],                # colour / opponent
    "contrast": [1.0, 0.5, 0.3, 0.15, 0.10, 0.05, 0.03, 0.01],
    "low-pass": [0, 1, 3, 5, 7, 10, 15, 40],
    "high-pass": [0, 3.0, 1.5, 1.0, 0.7, 0.55, 0.45, 0.4],
    "phase-scrambling": [0, 30, 60, 90, 120, 150, 180],
    "power-equalisation": [0, 1],          # original / equalised
    "rotation": [0, 90, 180, 270],
    "uniform-noise": [0.0, 0.03, 0.05, 0.1, 0.2, 0.35, 0.6, 0.9],
    "eidolonI": [1, 2, 4, 8, 16, 32, 64, 128],
    "eidolonII": [1, 2, 4, 8, 16, 32, 64, 128],
    "eidolonIII": [1, 2, 4, 8, 16, 32, 64, 128],
}
