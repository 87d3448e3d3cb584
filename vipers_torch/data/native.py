"""JPEG decode for the LOST driver and the train driver's
``--native-decode`` path (port of ``vipers/data/native.py``).

``vipers_torch/csrc/decode.cc`` is compiled on first use with ``g++ -O3
-march=native -ljpeg`` (the JAX package's flags, so the bilinear passes
round alike) into ``build/vipers_torch/libvipers_decode-<digest>.so`` at the
repository root (``<digest>`` hashes the source and the flags, so an edited
source is rebuilt) and bound with ctypes, which releases the GIL inside the
call: a thread pool decodes on every core. A file that is not a JPEG, a
JPEG that libjpeg rejects, and a host where the library cannot be built go
through PIL instead, as in the JAX package. ``backend()`` says which
decoder a run uses.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from vipers_torch.ops._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "decode.cc")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_BUILD_ERROR: Optional[str] = None
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS + ["-ljpeg"]).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(str(BUILD_DIR), f"libvipers_decode-{h.hexdigest()[:16]}.so")


def _load() -> Optional[ctypes.CDLL]:
    """The decode library, built on first use; None (with the reason in
    ``build_error()``) when it cannot be built or loaded."""
    global _LIB, _TRIED, _BUILD_ERROR
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = library_path()
        try:
            if not os.path.exists(so):
                os.makedirs(os.path.dirname(so), exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                proc = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp, "-ljpeg"],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    _BUILD_ERROR = (proc.stdout + proc.stderr).strip()
                    return None
                os.replace(tmp, so)  # atomic: a parallel loader never sees half a file
            lib = ctypes.CDLL(so)
        except OSError as e:  # no g++, or the library does not load
            _BUILD_ERROR = str(e)
            return None
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.vipers_jpeg_dims.argtypes = [_U8P, ctypes.c_size_t, i32p, i32p]
        lib.vipers_decode_pad.argtypes = [_U8P, ctypes.c_size_t, _U8P, ctypes.c_int,
                                          ctypes.c_int, i32p, i32p]
        lib.vipers_decode_eval.argtypes = [_U8P, ctypes.c_size_t, ctypes.c_int,
                                           ctypes.c_int, _U8P]
        lib.vipers_decode_rrc.argtypes = [_U8P, ctypes.c_size_t] + [ctypes.c_int] * 6 + [_U8P]
        for fn in (lib.vipers_jpeg_dims, lib.vipers_decode_pad, lib.vipers_decode_eval,
                   lib.vipers_decode_rrc):
            fn.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def available() -> bool:
    """Whether the libjpeg decoder is built and loaded."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the libjpeg decoder could not be built or loaded, or None."""
    _load()
    return _BUILD_ERROR


def pil_available() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def backend() -> str:
    """``"libjpeg"`` or ``"pil"``: the decoder JPEGs go through here. Raises
    when there is neither."""
    if available():
        return "libjpeg"
    if pil_available():
        return "pil"
    raise RuntimeError(f"no JPEG decoder: the libjpeg decoder could not be built "
                       f"({build_error()}) and PIL is not installed")


def _pil_image(path: str):
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path}: decoding it needs PIL (not installed); the libjpeg decoder "
            f"takes JPEGs only" + (f" and could not be built ({_BUILD_ERROR})"
                                   if _BUILD_ERROR else "")) from None
    return Image.open(path)


def _dims(lib, data):
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.vipers_jpeg_dims(data.ctypes.data_as(_U8P), data.size, ctypes.byref(w),
                              ctypes.byref(h))
    return (w.value, h.value) if rc == 0 else None


def jpeg_dims(path: str):
    """(w, h) of an image; libjpeg reads the header, PIL any other file."""
    lib = _load()
    if lib is None:
        with _pil_image(path) as im:
            return im.size
    dims = _dims(lib, np.fromfile(path, dtype=np.uint8))
    if dims is None:
        raise ValueError(f"not a decodable JPEG: {path}")
    return dims


def decode_pad(path: str, pad_multiple: int = 16):
    """Full-resolution RGB decode straight into a zero-padded uint8 slab
    whose extent is the image rounded up to ``pad_multiple`` (the LOST
    tier-1 pad); normalization happens on the device. Returns ``(padded
    (PH, PW, 3) uint8, (h, w))``. A file that is not a ``.jpg``/``.jpeg``,
    or a JPEG that libjpeg rejects, goes through PIL."""
    lib = _load()
    if lib is not None and path.lower().endswith((".jpg", ".jpeg")):
        data = np.fromfile(path, dtype=np.uint8)
        dims = _dims(lib, data)
        if dims is not None:
            ph = -(-dims[1] // pad_multiple) * pad_multiple
            pw = -(-dims[0] // pad_multiple) * pad_multiple
            out = np.empty((ph, pw, 3), np.uint8)
            w, h = ctypes.c_int(), ctypes.c_int()
            rc = lib.vipers_decode_pad(data.ctypes.data_as(_U8P), data.size,
                                       out.ctypes.data_as(_U8P), ph, pw, ctypes.byref(w),
                                       ctypes.byref(h))
            if rc == 0:
                return out, (h.value, w.value)
    with _pil_image(path) as im:
        img = np.asarray(im.convert("RGB"), dtype=np.uint8)
    h, w = img.shape[:2]
    ph = -(-h // pad_multiple) * pad_multiple
    pw = -(-w // pad_multiple) * pad_multiple
    out = np.zeros((ph, pw, 3), np.uint8)
    out[:h, :w] = img
    return out, (h, w)


def _is_jpeg(path: str) -> bool:
    return path.lower().endswith((".jpg", ".jpeg"))


def decode_eval(path: str, resize: int = 256, crop: int = 224) -> np.ndarray:
    """The eval preset in C++: decode -> shorter side to ``resize``
    (bilinear, libjpeg's DCT scaling first) -> center crop, uint8 HWC. A
    non-JPEG, a JPEG libjpeg rejects or a host without the library goes
    through the PIL preset (``preprocess.eval_decode``)."""
    from vipers_torch.data.preprocess import eval_decode

    lib = _load()
    if lib is None or not _is_jpeg(path):
        return eval_decode(path, resize, crop)
    data = np.fromfile(path, dtype=np.uint8)
    out = np.empty((crop, crop, 3), np.uint8)
    if lib.vipers_decode_eval(data.ctypes.data_as(_U8P), data.size, resize, crop,
                              out.ctypes.data_as(_U8P)) != 0:
        return eval_decode(path, resize, crop)
    return out


def decode_train(path: str, rng: np.random.Generator, crop_size: int = 224,
                 hflip_prob: float = 0.5, auto_augment: str = "", scale=(0.08, 1.0),
                 ratio=(3 / 4, 4 / 3), ra_magnitude: int = 9,
                 augmix_severity: int = 3) -> np.ndarray:
    """RandomResizedCrop + flip in C++: the box drawn here from ``rng``
    (``preprocess.rrc_box``, the PIL preset's draws), the pixels cropped and
    resized bilinearly by the library, then the ``auto_augment`` policy.
    Without the library, or for a non-JPEG, the PIL preset
    (``preprocess.train_decode``)."""
    from vipers_torch.data.preprocess import rrc_box, train_decode

    lib = _load()
    if lib is None or not _is_jpeg(path):
        return train_decode(path, rng, crop_size, hflip_prob, auto_augment, ra_magnitude,
                            augmix_severity)
    w, h = jpeg_dims(path)
    box = rrc_box(w, h, rng, scale, ratio)
    flip = 1 if (hflip_prob > 0 and rng.random() < hflip_prob) else 0
    data = np.fromfile(path, dtype=np.uint8)
    out = np.empty((crop_size, crop_size, 3), np.uint8)
    if lib.vipers_decode_rrc(data.ctypes.data_as(_U8P), data.size, *box, crop_size, flip,
                             out.ctypes.data_as(_U8P)) != 0:
        # as in the JAX package, the PIL preset draws again from where rng is
        return train_decode(path, rng, crop_size, hflip_prob, auto_augment, ra_magnitude,
                            augmix_severity)
    if auto_augment:
        from vipers_torch.data.autoaugment import apply_policy

        out = apply_policy(auto_augment, out, rng, ra_magnitude=ra_magnitude,
                           augmix_severity=augmix_severity)
    return out
