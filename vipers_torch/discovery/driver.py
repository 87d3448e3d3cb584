"""LOST driver for the ViTs, the DINO ViTs, Swin-V2 and the CNN families
(port of ``vipers/discovery/driver.py``).

``LostFeatureExtractor.make_batched_pipeline`` is the product path: the
masked transformer forward, its k features (a ViT: the reference's qkv
scramble of the last ln_1 output; a DINO ViT: the true split of the last
block's qkv projection, ``--arch dino``) and the batched LOST core, all on
the device; only the 4-int boxes, seeds and background flags return to the
host. Inputs come from
``prepare_batch``: tier-1-padded images sharing one bucket shape, uint8
(normalized on the device) or already-normalized float, sent to the card
from pinned memory without a host sync, so assembling batch k+1 overlaps
batch k.

``make_batched_cnn_pipeline`` is the CNN counterpart (``--arch resnet``,
``--arch vgg16``, ``--arch mobilenet``: any arch but vit, dino and swin):
the masked CNN forward on images zero-padded to their
bucket's canonical input (``cnn_bucket_key``: the feature grid rounded up
to a ``--cnn-bucket`` multiple), the reference's whole-slab LayerNorm over
each image's valid feature cells (``masked_slab_layernorm``, in the
features' dtype: f32 for a ResNet, whose BatchNorm outputs f32, bf16 for
VGG under ``--dtype bf16``) and the batched LOST core. Feature extents
come from the module's arithmetic (``feature_extent``), where the JAX
package traces ``eval_shape``.

``extract`` is the per-image path, as the JAX package routes it: the ViTs
and DINO ViTs under ``--dinoseg`` (the image on its bucket grid with
``need_attn``: the last block's attention, which ``discovery.lost.dino_seg``
boxes; the other blocks keep the flash route), Swin (``--arch swin``: the
last block's qkv, its first window as the reference reads it, or with
``swin_all_windows`` the whole last-stage grid in image order) and the CNNs
at each image's native shape (``--exact-shapes``, ``--cnn-bucket 1``: the
reference's parity regime, the whole-slab LayerNorm), each image one
forward, then ``discovery.lost.lost`` at B = 1. ``--visualize`` sends every
family down this path (a CNN at B = 1 on its bucket's canonical input), and
``viz.draw`` draws the box, affinity and seed.

``run_lost`` is ``vipers_torch lost``: JPEGs decoded on a thread pool in
dataset order (``_prefetch_decoded``), per-bucket buffers of
``--batch-size`` images (a tail batch padded by repeating its last image),
each full buffer one pipeline call, its results copied to pinned host
memory behind a CUDA event and read a group at a time, then CorLoc and
``preds.pkl`` / ``results_iteration_NN.txt`` as ``vipers lost`` writes
them. The per-image path takes the host-normalized float feed and one
``extract`` and ``lost`` an image.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from vipers_torch.core.checkpoint import (family, infer_num_classes,
                                          infer_representation_size, infer_vit_image_size,
                                          load_pth, load_torch_state_dict,
                                          reference_sweep_stem)
from vipers_torch.core.device import resolve_device
from vipers_torch.core.registry import build_model, build_module
from vipers_torch.data import native
from vipers_torch.data.detection import DiscoveryDataset, load_image_normalized
from vipers_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD, bucket_hw
from vipers_torch.discovery.corloc import CorLocAccumulator
from vipers_torch.discovery.lost import box_feat_to_image, dino_seg, lost, lost_core
from vipers_torch.models.cnn import exact_f32_convs
from vipers_torch.models.dino_vit import split_qkv_dino
from vipers_torch.models.interpolate import resize_weight_matrix_np
from vipers_torch.models.vit import scrambled_qkv_gather
from vipers_torch.ops.flash_attention import flash_min_t
from vipers_torch.parallel import mesh as parallel
from vipers_torch.parallel.sp import sequence_parallel
from vipers_torch.pruning.structured import arch_sidecar
from vipers_torch.train.quantize import (int8_dynamic_sites, quantize_params_int8,
                                         static_qparams_from_observers)


_NORM: dict = {}


def device_normalize(images, pixel_hw):
    """uint8 (B, H, W, 3) -> normalized f32 on the images' device: x/255,
    then (x - mean)/std in f32 (the host path's op order, so the result is
    bit-equal to it), then zero beyond each image's exact pixel extent
    ``pixel_hw`` (B, 2) (the host zero-pads before normalizing)."""
    dev = images.device
    if dev not in _NORM:  # made once a device: a copy to the card syncs the host
        _NORM[dev] = tuple(torch.tensor(c, dtype=torch.float32, device=dev)
                           for c in (IMAGENET_MEAN, IMAGENET_STD))
    mean, std = _NORM[dev]
    x = (images.to(torch.float32) / 255.0 - mean) / std
    if pixel_hw is not None:
        phw = pixel_hw.to(dev)
        r = torch.arange(images.shape[1], device=dev)[None, :, None]
        c = torch.arange(images.shape[2], device=dev)[None, None, :]
        valid = (r < phw[:, 0, None, None]) & (c < phw[:, 1, None, None])
        x = torch.where(valid[..., None], x, torch.zeros((), device=dev))
    return x


def masked_slab_layernorm(f, mf, cnt):
    """The reference's LayerNorm over each image's whole (tokens, dim) slab
    with identity affine, over its VALID cells only: ``f`` (B, T, D), ``mf``
    the {0, 1} validity mask broadcastable to it, ``cnt`` the valid-element
    count (B, 1, 1), all in the features' dtype. Pad cells come out zero."""
    mu = torch.sum(f * mf, dim=(1, 2), keepdim=True) / cnt
    var = torch.sum(torch.square((f - mu) * mf), dim=(1, 2), keepdim=True) / cnt
    return ((f - mu) / torch.sqrt(var + 1e-5)) * mf


def seq_pad(img_shape, patch: int, need_attn: bool = False) -> Optional[int]:
    """128-multiple token padding where the flash kernel engages
    (T >= flash_min_t(), no attention probabilities asked for)."""
    t = (img_shape[1] // patch) * (img_shape[2] // patch) + 1
    return 128 if t >= flash_min_t() and not need_attn else None


class LostFeatureExtractor:
    """The masked model on ``device`` (default ``cuda``; ``"cpu"`` runs the
    kernels' plain versions) with the LOST feature and box pipeline.

    ``params`` is a parameter tree in the JAX package's keys and layouts
    (``spec.init`` or a flax tree converted to numpy), ``masks`` its pruning
    masks; both are baked into the module once, then the parameters are
    cast to ``compute_dtype`` (None = float32). A ResNet's running
    statistics (``batch_stats``, default mean 0 and var 1) stay f32, as the
    JAX extractor casts ``params`` only. ``cnn_bucket``: the CNN pipeline's
    feature-grid bucket (``--cnn-bucket``; 1 is the per-image exact-shape
    regime); ``swin_all_windows``: Swin LOST over the whole last-stage grid
    instead of the first window; ``need_attn``: the per-image transformer
    forward returns the last block's attention (``--dinoseg``).

    ``compute_dtype="int8"`` is the JAX package's int8 serving mode: int8
    kernels and per-channel scales baked from the masked f32 weights
    (``train.quantize.quantize_params_int8``, ``spec.quant_exclude`` left
    float), the network in bf16, and every baked Dense and Conv executed
    in real int8 (``int8_dynamic_sites``) with input qparams from the
    checkpoint's calibrated ``observers`` where given, else dynamic
    per-tensor ranges that leave bucket- and seq-pad token rows out.

    ``sequence_parallel``: the transformer forwards run inside
    ``parallel.sp.sequence_parallel`` (the tokens sharded over every rank;
    the JAX extractor's ``sequence_mesh``)."""

    def __init__(self, spec, params, masks=None, which_features: str = "k",
                 bucket: int = 4, compute_dtype=None,
                 device=None, batch_stats=None, cnn_bucket: int = 4,
                 swin_all_windows: bool = False, need_attn: bool = False,
                 observers=None, sequence_parallel: bool = False):
        self.device = resolve_device(device)
        self.sequence_parallel = sequence_parallel
        self.spec = spec
        self.which = which_features
        self.bucket = bucket
        self.need_attn = need_attn
        self.cnn_bucket = cnn_bucket
        self.swin_all_windows = swin_all_windows
        self.int8 = compute_dtype == "int8"
        if self.int8:
            compute_dtype = torch.bfloat16
        self.compute_dtype = compute_dtype or torch.float32
        model = build_module(spec)
        self.family = family(spec)
        sd = self.family.state_dict(params, batch_stats, masks)
        model.load_state_dict({**dict(model.named_buffers()), **sd})
        model.eval().requires_grad_(False)
        self.model = model.to(self.device)
        if self.int8:
            self._q, self._scales = quantize_params_int8(
                dict(self.model.named_parameters()), self.family, spec.quant_exclude)
            self._static_qparams = static_qparams_from_observers(observers, self.device)
        for p in self.model.parameters():
            p.data = p.data.to(self.compute_dtype)
        self._pos_cache: dict = {}
        self._fdim_cache: dict = {}
        self._cnn_stride = None

    def _pos_and_mask(self, gh: int, gw: int, GH: int, GW: int):
        """Pos-embeddings interpolated to the valid (gh, gw) grid, scattered
        into the (GH, GW) bucket grid as two matmuls with host-built weight
        matrices (zero rows beyond gh/gw), plus the CLS+valid token mask.
        A ViT's table resizes as torchvision does (``align_corners``), a DINO
        ViT's with half-pixel centres. Cached per key; returns ((1,
        1+GH*GW, D) f32, (1, 1+GH*GW) bool)."""
        key = (gh, gw, GH, GW)
        if key not in self._pos_cache:
            p = self.spec.patch_size
            side_h = self.spec.input_size[0] // p
            side_w = self.spec.input_size[1] // p
            vit = self.spec.family == "vit"
            mat_h = np.zeros((GH, side_h), np.float32)
            mat_h[:gh] = resize_weight_matrix_np(side_h, gh, vit)
            mat_w = np.zeros((GW, side_w), np.float32)
            mat_w[:gw] = resize_weight_matrix_np(side_w, gw, vit)
            with torch.inference_mode():
                pos = (self.model.pos_embedding if vit else self.model.pos_embed).float()
                grid = pos[0, 1:].reshape(side_h, side_w, -1)
                mh = torch.from_numpy(mat_h).to(self.device)
                mw = torch.from_numpy(mat_w).to(self.device)
                g = torch.matmul(mh, grid.reshape(side_h, -1)).reshape(GH, side_w, -1)
                g = torch.matmul(mw, g)  # (GH, GW, D)
                full = torch.cat([pos[:, :1], g.reshape(1, GH * GW, -1)], dim=1)
            rows = np.arange(GH * GW) // GW
            cols = np.arange(GH * GW) % GW
            mask = np.concatenate([[True], (rows < gh) & (cols < gw)])[None, :]
            self._pos_cache[key] = (full, mask)
        return self._pos_cache[key]

    def prepare_batch(self, imgs, patch: int, exact_hw=None):
        """Stack tier-1-padded images sharing one bucket shape into the
        pipeline inputs (images, pos, token_mask, valid_hw) on the device.
        token_mask is None when every image exactly fills the bucket. On the
        card the batch is assembled in pinned memory and sent without a host
        sync.

        uint8 images stay uint8 and are normalized on the device;
        ``exact_hw`` must then give each image's exact pixel dims, and a 5th
        element ``pixel_hw`` ((B, 2) int32, or None when every image fills
        the bucket pixel-exactly) comes back."""
        u8 = imgs[0].dtype == np.uint8
        bh, bw = bucket_hw(imgs[0].shape[0], imgs[0].shape[1], patch, self.bucket)
        GH, GW = bh // patch, bw // patch
        batch_t = torch.zeros((len(imgs), bh, bw, 3), dtype=torch.uint8 if u8 else torch.float32,
                              pin_memory=self.device.type == "cuda")
        batch = batch_t.numpy()
        order: dict = {}
        rows, mask_rows, idx, vhw = [], [], [], []
        for i, im in enumerate(imgs):
            h, w = im.shape[:2]
            batch[i, :h, :w] = im
            gh, gw = h // patch, w // patch
            key = (gh, gw, GH, GW)
            if key not in order:
                pos, mask = self._pos_and_mask(gh, gw, GH, GW)
                order[key] = len(rows)
                rows.append(pos)
                mask_rows.append(mask)
            idx.append(order[key])
            vhw.append((gh, gw))
        if len(rows) > 1:
            pos_batch = torch.cat(rows, dim=0)[self._upload(torch.tensor(idx))]
        else:
            pos_batch = rows[0].expand(len(imgs), -1, -1)
        exact_fit = all(t == (GH, GW) for t in vhw)
        token_mask = None if exact_fit else self._upload(torch.from_numpy(
            np.concatenate([mask_rows[u] for u in idx], axis=0)))
        out = (
            self._upload(batch_t),
            pos_batch,
            token_mask,
            self._upload(torch.tensor(vhw, dtype=torch.int32)),
        )
        if not u8:
            return out
        if exact_hw is None:
            raise ValueError("uint8 batches need exact_hw (pixel dims)")
        pixel_exact = all(tuple(t) == (bh, bw) for t in exact_hw)
        return out + (None if pixel_exact else self._upload(
            torch.tensor(exact_hw, dtype=torch.int32)),)

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor on the extractor's device. To the card it goes from
        pinned memory with ``non_blocking``: a copy from pageable memory
        would make the host wait for the card's queue to drain."""
        if self.device.type != "cuda":
            return t
        if not t.is_pinned():
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _int8_scope(self, token_mask=None, seq_pad_multiple=None):
        """The scope of one forward: real int8 at every baked site in the
        int8 mode (pad rows of the raw and the seq-padded token count left
        out of the dynamic ranges), nothing otherwise."""
        if not self.int8:
            return contextlib.nullcontext()
        masks = None
        if token_mask is not None:
            t = token_mask.shape[1]
            masks = {t: token_mask}
            if seq_pad_multiple:
                tp = -(-t // seq_pad_multiple) * seq_pad_multiple
                if tp != t:
                    masks[tp] = F.pad(token_mask, (0, tp - t))
        return int8_dynamic_sites(self.model, self.family, self._q, self._scales,
                                  self.spec.quant_exclude, masks, self._static_qparams)

    def _transformer_aux(self, images, pos, token_mask, need_attn: bool = False):
        """The transformer forward's aux on a bucket batch (images already
        normalized), in the compute dtype, tokens seq-padded where the flash
        kernel engages."""
        images = images.to(self.compute_dtype)
        spm = seq_pad(images.shape, self.spec.patch_size, need_attn)
        tokens = sequence_parallel() if self.sequence_parallel else contextlib.nullcontext()
        with tokens, self._int8_scope(token_mask, spm):
            return self.model(images, override_pos_embedding=pos.to(self.compute_dtype),
                              token_mask=token_mask, need_attn=need_attn,
                              seq_pad_multiple=spm)[1]

    def _transformer_features(self, aux, token_mask, valid_hw, GH: int, GW: int):
        """(B, GH*GW, D) features of a forward's aux. A DINO ViT's: the true
        split of the last qkv projection, bucket-pad rows as they come
        (``lost_core`` masks them). A ViT's: the reference's qkv scramble of
        the last ln_1 output applied to each image's tier-1 tokens (CLS +
        valid, raster order), scattered back onto the grid; bucket-pad rows
        zero."""
        if self.spec.family == "dino_vit":
            qkv = split_qkv_dino(aux["qkv"], self.spec.cfg.num_heads)
            return dict(zip("qkv", qkv))[self.which][:, 1:]
        x = aux["qkv_input"]
        if token_mask is None:
            # exact fit: every image fills its bucket, no compaction needed
            return scrambled_qkv_gather(x, 1 + GH * GW, self.which)[:, 1:]
        b, t, d = x.shape
        t1 = 1 + valid_hw[:, 0].long() * valid_hw[:, 1].long()
        perm = torch.argsort((~token_mask).to(torch.uint8), dim=1, stable=True)
        fc = scrambled_qkv_gather(
            torch.gather(x, 1, perm[:, :, None].expand(b, t, d)), t1, self.which)
        valid = token_mask[:, 1:]
        idx = torch.cumsum(valid, dim=1)  # grid position -> compact row
        g = torch.gather(fc, 1, idx[:, :, None].expand(b, t - 1, d))
        return torch.where(valid[:, :, None], g, torch.zeros((), dtype=g.dtype, device=g.device))

    @torch.inference_mode()
    def batched_features(self, images, pos, token_mask, valid_hw, pixel_hw=None):
        """(B, GH*GW, D) LOST features of a prepared batch on its bucket grid
        (``_transformer_features``)."""
        return self.traceable_features(images, pos, token_mask, valid_hw, pixel_hw)

    def traceable_features(self, images, pos, token_mask, valid_hw, pixel_hw=None):
        """``batched_features`` outside inference mode, for callers that
        trace it (``core.export``)."""
        if images.dtype == torch.uint8:
            images = device_normalize(images, pixel_hw)
        patch = self.spec.patch_size
        aux = self._transformer_aux(images, pos, token_mask)
        return self._transformer_features(aux, token_mask, valid_hw,
                                          images.shape[1] // patch, images.shape[2] // patch)

    def make_batched_pipeline(self, k_patches: int = 100):
        """Returns fn(images (B,bh,bw,3), pos (B,1+GT,D), token_mask
        (B,1+GT) bool or None, valid_hw (B,2) int32, pixel_hw=None)
        -> (box_feat (B,4), seed (B,), seed_in_background (B,)), on the
        device."""
        patch = self.spec.patch_size

        @torch.inference_mode()
        def run(images, pos, token_mask, valid_hw, pixel_hw=None):
            feats = self.batched_features(images, pos, token_mask, valid_hw, pixel_hw)
            grid = (images.shape[1] // patch, images.shape[2] // patch)
            out = lost_core(feats, valid_hw, grid, k_patches=k_patches, lean=True)
            return out["box_feat"], out["seed"], out["seed_in_background"]

        return run

    # ---------------------------- the CNN path -----------------------------

    def _cnn_fdim(self, px: int) -> int:
        """Feature cells along an input axis of ``px`` pixels (the CNNs are
        h/w-separable, so one 1-D cache covers both axes)."""
        if px not in self._fdim_cache:
            self._fdim_cache[px] = self.model.feature_extent(px)
        return self._fdim_cache[px]

    def _cnn_input_for_fdim(self, px: int, target: int) -> int:
        """The smallest input extent >= ``px`` whose feature extent is
        ``target`` (monotone in px; steps of the net's output stride)."""
        if self._cnn_stride is None:
            self._cnn_stride = max(
                round(256 / max(self._cnn_fdim(512) - self._cnn_fdim(256), 1)), 1)
        s = self._cnn_stride
        out = px + (target - self._cnn_fdim(px)) * s
        for _ in range(4):  # land anywhere inside the target step first
            f = self._cnn_fdim(out)
            if f == target:
                break
            out += (target - f) * s
        else:
            raise ValueError(f"no input extent near {px}px maps to {target} feature cells")
        # the smallest extent on the step: the canonical rule needs its boundary
        lo = out - s
        while self._cnn_fdim(lo) >= target:
            lo -= s
        hi = out
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if self._cnn_fdim(mid) >= target:
                hi = mid
            else:
                lo = mid
        return hi

    def _cnn_canon_input(self, target: int) -> int:
        """The canonical input extent of a bucket axis: the LARGEST input
        that maps to ``target`` feature cells, so every image whose feature
        extent rounds up to ``target`` fits under it (``target * stride``
        for the ResNets)."""
        key = ("canon", target)
        if key not in self._fdim_cache:
            if self._cnn_stride is None:
                self._cnn_input_for_fdim(256, self._cnn_fdim(256))
            px = self._cnn_input_for_fdim(max(target * self._cnn_stride, 33), target + 1) - 1
            if self._cnn_fdim(px) != target:
                raise ValueError(f"canonical input {px} maps to {self._cnn_fdim(px)} cells, "
                                 f"not {target}")
            self._fdim_cache[key] = px
        return self._fdim_cache[key]

    def cnn_bucket_key(self, h: int, w: int):
        """The canonical padded input (H, W) of an image: the batched CNN
        pipeline's buffer key (one batch shape a key)."""
        cb = self.cnn_bucket
        fh, fw = self._cnn_fdim(h), self._cnn_fdim(w)
        return (self._cnn_canon_input(-(-fh // cb) * cb),
                self._cnn_canon_input(-(-fw // cb) * cb))

    def cnn_scales(self, h: int, w: int):
        """Feature -> pixel scales of an image for ``box_feat_to_image``."""
        return [h / self._cnn_fdim(h), w / self._cnn_fdim(w)]

    def prepare_cnn_batch(self, imgs, canon_hw, exact_hw=None):
        """Stack same-bucket images zero-padded to the canonical extent:
        (images (B, H, W, 3), valid_fhw (B, 2) int32 exact feature dims) on
        the device, from pinned memory on the card. uint8 images stay uint8
        (normalized on the device) and need ``exact_hw``; a third element
        ``pixel_hw`` (None when every image fills the bucket) comes back."""
        u8 = imgs[0].dtype == np.uint8
        H, W = canon_hw
        batch_t = torch.zeros((len(imgs), H, W, 3), dtype=torch.uint8 if u8 else torch.float32,
                              pin_memory=self.device.type == "cuda")
        batch = batch_t.numpy()
        fhw = []
        for i, im in enumerate(imgs):
            batch[i, :im.shape[0], :im.shape[1]] = im
            fhw.append((self._cnn_fdim(im.shape[0]), self._cnn_fdim(im.shape[1])))
        out = (self._upload(batch_t), self._upload(torch.tensor(fhw, dtype=torch.int32)))
        if not u8:
            return out
        if exact_hw is None:
            raise ValueError("uint8 batches need exact_hw (pixel dims)")
        pixel_exact = all(tuple(t) == (H, W) for t in exact_hw)
        return out + (None if pixel_exact else self._upload(
            torch.tensor(exact_hw, dtype=torch.int32)),)

    @torch.inference_mode()
    def cnn_features(self, images, valid_fhw, pixel_hw=None):
        """(B, FH*FW, D) LOST features of a CNN batch: the map of a headless
        model or ``aux["features"]`` of a classifier, flattened in NHWC
        order, through ``masked_slab_layernorm`` over each image's valid
        (fh, fw) cells; pad cells are zero. An f32 forward's convolutions
        run as exact f32."""
        return self.traceable_cnn_features(images, valid_fhw, pixel_hw)

    def traceable_cnn_features(self, images, valid_fhw, pixel_hw=None):
        """``cnn_features`` outside inference mode (``core.export``)."""
        if images.dtype == torch.uint8:
            images = device_normalize(images, pixel_hw)
        with exact_f32_convs(self.compute_dtype), self._int8_scope():
            out, aux = self.model(images.to(self.compute_dtype))
        feats = out if out.dim() == 4 else aux["features"]
        b, fh, fw, d = feats.shape
        f = feats.reshape(b, fh * fw, d)
        v = valid_fhw.to(f.device).long()
        m = ((torch.arange(fh, device=f.device)[None, :, None] < v[:, 0, None, None])
             & (torch.arange(fw, device=f.device)[None, None, :] < v[:, 1, None, None]))
        cnt = (v[:, 0] * v[:, 1] * d).to(f.dtype)[:, None, None]
        return masked_slab_layernorm(f, m.reshape(b, fh * fw, 1).to(f.dtype), cnt)

    def make_batched_cnn_pipeline(self, k_patches: int = 100):
        """Returns fn(images (B, H, W, 3), valid_fhw (B, 2) int32,
        pixel_hw=None) -> (box_feat (B, 4), seed (B,), seed_in_background
        (B,)), on the device."""

        @torch.inference_mode()
        def run(images, valid_fhw, pixel_hw=None):
            feats = self.cnn_features(images, valid_fhw, pixel_hw)
            grid = (self._cnn_fdim(images.shape[1]), self._cnn_fdim(images.shape[2]))
            out = lost_core(feats, valid_fhw, grid, k_patches=k_patches, lean=True)
            return out["box_feat"], out["seed"], out["seed_in_background"]

        return run

    # -------------------------- the per-image path -------------------------

    @torch.inference_mode()
    def cnn_exact_features(self, images):
        """((1, fh*fw, D) LOST features, (fh, fw)) of a CNN at the image's
        own shape: the reference's LayerNorm over the whole (tokens, dim)
        slab with identity affine, its statistics in f32 as ``jnp.mean`` and
        ``jnp.var`` take them, the result in the features' dtype."""
        with exact_f32_convs(self.compute_dtype), self._int8_scope():
            out, aux = self.model(images.to(self.compute_dtype))
        feats = out if out.dim() == 4 else aux["features"]
        b, fh, fw, d = feats.shape
        f = feats.reshape(b, fh * fw, d)
        f32 = f.float()
        mu32 = f32.mean(dim=(1, 2), keepdim=True)
        var = torch.square(f32 - mu32).mean(dim=(1, 2), keepdim=True).to(f.dtype)
        return (f - mu32.to(f.dtype)) / torch.sqrt(var + 1e-5), (fh, fw)

    @torch.inference_mode()
    def extract(self, img_hwc: np.ndarray, patch_size: int):
        """One host-normalized float image (H, W, 3), already padded to the
        patch multiple -> (feats (1, T, D) on the device, dims (rows, cols)
        of the grid, valid_dims, scales, attn or None), the inputs of
        ``discovery.lost.lost``.

        Swin: the last block's qkv (full bias), the true (DINO-layout) split,
        no CLS token. By default the first window only, as the reference
        reads its hook: dims = the window side twice (``sqrt`` of the
        attention's rows) and scales ``[h / patch_size, w / patch_size]``;
        with ``swin_all_windows`` the whole grid (``aux["qkv_grid"]``) with
        the true scales. CNNs: at the image's shape when ``cnn_bucket`` is 1
        (``cnn_exact_features``), else on its bucket's canonical input at
        B = 1. ViTs and DINO ViTs: the image zero-padded to its bucket,
        the pos table interpolated to its valid grid, the CLS+valid token
        mask, ``need_attn`` as the extractor was built; dims = the bucket
        grid, valid_dims = the image's, scales ``[patch_size,
        patch_size]`` and the last block's attention (None without
        ``need_attn``)."""
        h, w = img_hwc.shape[:2]
        fam = self.spec.family
        if fam in ("vit", "dino_vit"):
            gh, gw = h // patch_size, w // patch_size
            bh, bw = bucket_hw(h, w, patch_size, self.bucket)
            GH, GW = bh // patch_size, bw // patch_size
            img = np.zeros((1, bh, bw, 3), np.float32)
            img[0, :h, :w] = img_hwc
            pos, mask = self._pos_and_mask(gh, gw, GH, GW)
            token_mask = self._upload(torch.from_numpy(mask))
            valid_hw = torch.tensor([[gh, gw]], dtype=torch.int32, device=self.device)
            aux = self._transformer_aux(self._upload(torch.from_numpy(img)), pos, token_mask,
                                        self.need_attn)
            feats = self._transformer_features(aux, token_mask, valid_hw, GH, GW)
            return feats, (GH, GW), (gh, gw), [patch_size, patch_size], aux["attn"]
        if fam == "swin":
            x = self._upload(torch.from_numpy(np.ascontiguousarray(img_hwc, np.float32))[None])
            with exact_f32_convs(self.compute_dtype), self._int8_scope():
                _, aux = self.model(x.to(self.compute_dtype))
            attn = aux["attn"]
            nh = attn.shape[1]
            if self.swin_all_windows:
                grid = aux["qkv_grid"]
                _, fh, fw, c3 = grid.shape
                qkv = split_qkv_dino(grid.reshape(1, fh * fw, c3), nh)
                feats = dict(zip("qkv", qkv))[self.which]
                return feats, (fh, fw), (fh, fw), [h / fh, w / fw], attn
            t_win = attn.shape[-2]
            ws = int(np.sqrt(t_win))
            qkv = split_qkv_dino(aux["qkv"][:, :t_win, :], nh)
            feats = dict(zip("qkv", qkv))[self.which]
            return feats, (ws, ws), (ws, ws), [h / patch_size, w / patch_size], attn
        fh, fw = self._cnn_fdim(h), self._cnn_fdim(w)
        if self.cnn_bucket > 1:
            key = self.cnn_bucket_key(h, w)
            feats = self.cnn_features(*self.prepare_cnn_batch([img_hwc], key))
            return (feats, (self._cnn_fdim(key[0]), self._cnn_fdim(key[1])), (fh, fw),
                    [h / fh, w / fw], None)
        x = self._upload(torch.from_numpy(np.ascontiguousarray(img_hwc, np.float32))[None])
        feats, dims = self.cnn_exact_features(x)
        return feats, dims, dims, [h / dims[0], w / dims[1]], None



def _prefetch_decoded(dataset, patch: int, no_hard: bool, workers: int = 8,
                      need_gt: bool = True, as_uint8: bool = False):
    """Decode and tier-1-pad images on a bounded thread pool, in dataset
    order, so host decode overlaps the card. Yields (path, im_name, padded
    image, init_image_size (3, h, w), gt boxes or None); images with no GT
    box are skipped under ``no_hard``.

    ``as_uint8``: the batched pipeline's feed, one libjpeg call straight
    into the patch-padded uint8 slab (``native.decode_pad``; the GIL is
    released inside it) and no float math on the host. Otherwise the
    host-normalized float32 feed (``load_image_normalized``)."""

    def load(item):
        path, im_name = item
        # runs without annotations must not read them (--no-evaluation)
        gt = dataset.extract_gt(im_name)[0] if need_gt else None
        if as_uint8:
            padded, (h, w) = native.decode_pad(path, pad_multiple=patch)
            return path, im_name, padded, (3, h, w), gt
        img = load_image_normalized(path)
        h, w = img.shape[:2]
        padded = np.zeros((-(-h // patch) * patch, -(-w // patch) * patch, 3), np.float32)
        padded[:h, :w] = img
        return path, im_name, padded, (3, h, w), gt

    depth = max(2 * workers, 8)
    with ThreadPoolExecutor(workers) as exe:
        pending: deque = deque()
        it = iter(dataset)
        done = False
        while pending or not done:
            while not done and len(pending) < depth:
                try:
                    pending.append(exe.submit(load, next(it)))
                except StopIteration:
                    done = True
            if not pending:
                break
            path, im_name, padded, init_size, gt = pending.popleft().result()
            if gt is not None and len(gt) == 0 and no_hard:
                continue
            yield path, im_name, padded, init_size, gt


class _SingleImageDataset:
    """``--image-path``: LOST on one image at native resolution, no GT."""

    def __init__(self, path: str):
        self.path = path
        self.name = os.path.basename(path)

    def __iter__(self):
        yield self.path, self.name

    def extract_gt(self, _im_name):
        return None, None


def _templated_checkpoint(models_dir: str, model: str, arch: str, iteration: int) -> str:
    """The reference sweep's checkpoint of ``iteration`` under
    ``{models_dir}/{model}/``: ViTs at epoch 299, the rest at epoch 89
    under the CNN stem (the reference branches on ``'vit' in arch``, so a
    Swin takes the CNNs' ``model_epoch_89_...``)."""
    vit = "vit" in arch or "vit" in model
    base = os.path.join(models_dir, model, reference_sweep_stem(
        model, vit, epoch=299 if vit else 89, iteration=iteration))
    for cand in (base + ".pth", base):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"no checkpoint for iteration {iteration} under "
                            f"{models_dir}/{model} (tried {base}[.pth])")


def load_lost_checkpoint(path: str, spec):
    """(flax-layout params, batch_stats or None, masks, observers or None)
    of a ``.pth``/``.pt`` checkpoint of ``spec``'s family: a reference one,
    or one ``vipers_torch train`` or ``quantize`` wrote (its ``model``
    entry); a pruned one carries its masks as ``weight_orig`` /
    ``weight_mask`` pairs; a ResNet's running statistics come back as
    ``batch_stats``; ``observers`` is the quantize calibration ({site:
    {"min", "max"}}) that ``vipers_torch quantize`` writes beside the
    weights, which the int8 serving path reads as static qparams. A checkpoint directory (the JAX package's orbax
    format) raises: the port does not read orbax, so convert it first with
    the JAX package's ``vipers.core.checkpoint.export_vit_torchvision``."""
    if os.path.isdir(path) or not str(path).endswith((".pth", ".pt")):
        raise ValueError(
            f"{path}: vipers_torch reads PyTorch .pth/.pt checkpoints only: a reference "
            "checkpoint, or the .pth `vipers_torch train` writes. An orbax checkpoint "
            "directory of the JAX package must be converted first with "
            "vipers.core.checkpoint.export_vit_torchvision and torch.save")
    obj = load_pth(path)
    observers = obj.get("observers") if isinstance(obj, dict) else None
    params, batch_stats, masks = family(spec).import_pth(load_torch_state_dict(obj), spec)
    return params, batch_stats, masks, observers


# the families `lost` runs as CNNs (every --arch but vit, dino and swin)
CNN_FAMILIES = ("resnet", "vgg", "mobilenet")

# timings and counts of the last run_lost call, for callers that time it
LAST_RUN: dict = {}


class _ProcessShardDataset:
    """Rank r's strided view of a discovery dataset over P processes:
    items r, r + P, r + 2P, ... (every image is independent work, so the
    ranks need no coordination until the merge). Everything but iteration
    (``extract_gt``, ...) is the wrapped dataset's."""

    def __init__(self, dataset, rank: int, nproc: int):
        self._ds, self._rank, self._nproc = dataset, rank, nproc

    def __iter__(self):
        for i, item in enumerate(iter(self._ds)):
            if i % self._nproc == self._rank:
                yield item

    def __getattr__(self, name):
        return getattr(self._ds, name)


def _sequence_parallel_on(args) -> bool:
    """``--sequence-parallel``'s checks and messages (the JAX driver's):
    whether the extractor's forwards shard their tokens over the ranks
    (not without the flag; not with one process, which warns and runs the
    plain forward with the kernels on)."""
    if not getattr(args, "sequence_parallel", False):
        return False
    if getattr(args, "data_parallel", False):
        raise SystemExit("--sequence-parallel and --data-parallel are mutually exclusive "
                         "(token-axis vs batch-axis sharding)")
    if args.arch not in ("vit", "dino"):
        raise SystemExit("--sequence-parallel shards the transformer token axis; "
                         f"arch {args.arch!r} has no token dimension to shard")
    if parallel.world() < 2:
        warnings.warn("--sequence-parallel ignored: only 1 device visible (token-axis "
                      "sharding needs >= 2); running single-device with the fast kernels "
                      "enabled")
        return False
    print(f"LOST sequence-parallel over {parallel.world()} devices (token axis)")
    return True


def run_lost(args) -> int:
    """``vipers_torch lost`` for ``--arch vit``, ``dino`` and ``swin``; any
    other ``--arch`` runs a CNN (ResNet, VGG16, MobileNetV2): the arguments
    of ``vipers lost`` (``vipers_torch.cli.main``) plus ``--device``. Routed
    as the JAX package routes them: the ViTs, the DINO ViTs
    (``--patch-size`` builds the model) and the bucketed CNNs through the
    batched pipelines; Swin, the CNNs' ``--exact-shapes`` / ``--cnn-bucket
    1``, ``--dinoseg`` and ``--visualize`` one image at a time (``extract``
    -> ``lost``, or ``dino_seg`` on head ``--dinoseg-head`` at bucket 4, at
    bucket 1 under ``--dinoseg-reference-bugs``), where a seed in the
    background is collected, or raised under ``--strict``, as in the
    batched drain. ``--visualize fms|seed_expansion|pred`` draws each image
    into ``--output-dir`` (``viz.draw.save_lost_visualization``; the
    affinity, scores and seed are left out under ``--dinoseg``).

    With no ``--checkpoint`` the weights come from
    ``spec.init(torch.Generator().manual_seed(0))``; they cannot equal the
    JAX package's ``PRNGKey(0)`` init, so runs of the two packages agree
    only on the same ``.pth``. (A Swin's zero initial biases give window
    pad tokens exactly-zero k features, which win the seed: as in the JAX
    package, every image then fails, so Swin LOST wants a trained or
    imported checkpoint.)

    A data-parallel run (``parallel.mesh``, one card a process) gives rank
    r the images r, r + P, ...; the ranks' hits, counts, preds and
    failures are gathered (``all_gather_object``) and rank 0 alone writes
    ``preds.pkl`` and the results txt; each rank draws its own images'
    ``--visualize`` files (one file an image), so the files are those of the
    one-process run. ``--data-parallel`` in one process is
    the plain run.

    ``--sequence-parallel`` (``parallel.sp``; vit and dino, not with
    ``--data-parallel``) shards every forward's tokens over the ranks
    instead: every rank reads every image, runs its share of the tokens
    and the whole LOST core, and rank 0 writes. With one process it warns
    and runs the plain forward, kernels on, as the JAX package does."""
    t_start = time.time()
    tokens_sharded = _sequence_parallel_on(args)
    nproc, rank = parallel.world(), parallel.rank()
    device = resolve_device(getattr(args, "device", None))
    image_path = getattr(args, "image_path", None)
    no_evaluation = bool(getattr(args, "no_evaluation", False))
    save_predictions = bool(getattr(args, "save_predictions", True))
    if image_path:
        # one image: no evaluation and no preds.pkl
        no_evaluation, save_predictions = True, False
        dataset = _SingleImageDataset(image_path)
    else:
        dataset = DiscoveryDataset(
            args.dataset, args.set, args.data_path, no_hard=args.no_hard,
            coco_annotations=getattr(args, "coco_annotations", None),
            coco20k_list=getattr(args, "coco20k_list", None))
    if tokens_sharded:
        nproc = 1  # every rank runs every image: nothing to gather
    if nproc > 1:
        dataset = _ProcessShardDataset(dataset, rank, nproc)

    pruning_iteration = getattr(args, "pruning_iteration", None)
    if getattr(args, "models_dir", "") and pruning_iteration is not None and not args.checkpoint:
        # an explicit --checkpoint wins over the filename template
        args.checkpoint = _templated_checkpoint(args.models_dir, args.model, args.arch,
                                                pruning_iteration)
        print(f"checkpoint: {args.checkpoint}")
    iteration = pruning_iteration if pruning_iteration is not None else args.iteration

    # any other --arch runs as a CNN, as in the JAX package
    families = {"vit": ("vit",), "swin": ("swin",), "dino": ("dino_vit",)}.get(
        args.arch, CNN_FAMILIES)
    fam = build_model(args.model).family
    if fam not in families:
        raise SystemExit(f"vipers_torch lost: --arch {args.arch} does not take --model "
                         f"{args.model} (a {fam})")
    model_kw = {}
    if args.arch == "dino":
        model_kw["patch_size"] = args.patch_size
    if "resnet" in args.model and getattr(args, "resnet_dilate", 1) != 1:
        model_kw["dilate"] = args.resnet_dilate
    arch_overrides = arch_sidecar(getattr(args, "checkpoint", ""))
    if arch_overrides:
        # a structurally slimmed checkpoint (`vipers_torch slim`): the
        # module at the slim widths, so parameter shapes match
        model_kw["arch_overrides"] = arch_overrides
        print(f"slim architecture: {arch_overrides}")
    spec = build_model(args.model, **model_kw)
    dinoseg = bool(getattr(args, "dinoseg", False))
    reference_bugs = bool(getattr(args, "dinoseg_reference_bugs", False))
    if dinoseg and spec.family not in ("vit", "dino_vit"):
        raise SystemExit(f"vipers_torch lost: --dinoseg reads a transformer's attention "
                         f"(--arch vit or dino), not --arch {args.arch}'s")
    cnn = spec.family in CNN_FAMILIES
    cnn_bucket = 1 if getattr(args, "exact_shapes", False) else int(
        getattr(args, "cnn_bucket", 0) or 4)
    visualize = getattr(args, "visualize", None)
    # --visualize draws from one image's affinity, scores and seed: the
    # per-image path, whatever the family
    per_image = (spec.family == "swin" or (cnn and cnn_bucket == 1) or dinoseg
                 or bool(visualize))
    masks = batch_stats = observers = None
    if args.checkpoint:
        params, batch_stats, masks, observers = load_lost_checkpoint(args.checkpoint, spec)
        # rebuild at the checkpoint's own head width (and a ViT's pre-logits
        # width and pos-table size)
        if spec.family == "vit":
            kw = {"num_classes": infer_num_classes(params) or 0,
                  "representation_size": infer_representation_size(params), **model_kw}
            size = infer_vit_image_size(params, spec.patch_size)
            if size is not None:
                kw["image_size"] = size
            spec = build_model(args.model, **kw)
        elif spec.num_classes and infer_num_classes(params) is not None:
            spec = build_model(args.model, num_classes=infer_num_classes(params), **model_kw)
    else:
        params = spec.init(torch.Generator().manual_seed(0))
    dtype = {"f32": None, "bf16": torch.bfloat16, "int8": "int8"}[
        getattr(args, "dtype", None) or "f32"]
    # dino_seg is bucket-safe (pad keys get exactly zero attention); only
    # its reference-bug mode, whose component ids follow the grid, runs at
    # exact shapes
    extractor = LostFeatureExtractor(spec, params, masks, which_features=args.which_features,
                                     bucket=1 if reference_bugs else 4, compute_dtype=dtype,
                                     device=device, batch_stats=batch_stats,
                                     cnn_bucket=cnn_bucket,
                                     swin_all_windows=bool(getattr(args, "swin_all_windows",
                                                                   False)),
                                     need_attn=dinoseg, observers=observers,
                                     sequence_parallel=tokens_sharded)
    pipeline = (None if per_image
                else extractor.make_batched_cnn_pipeline(k_patches=args.k_patches) if cnn
                else extractor.make_batched_pipeline(k_patches=args.k_patches))
    acc = CorLocAccumulator()
    p = args.patch_size
    batch_size = int(getattr(args, "batch_size", 0) or 8)
    # the batched paths' uint8 feed (libjpeg, normalized on the device)
    # unless --host-normalize; the per-image path takes the float feed
    feed_uint8 = not per_image and not getattr(args, "host_normalize", False)
    strict = bool(getattr(args, "strict", False))
    failed: list = []
    buffers: dict = {}
    # Each batch's results are copied to pinned host memory behind an event
    # as soon as its pipeline is queued; the host reads them a group of
    # VIPERS_LOST_DRAIN_DEPTH batches at a time, never an image at a time.
    drain_depth = int(os.environ.get("VIPERS_LOST_DRAIN_DEPTH", "8"))
    in_flight: deque = deque()
    n_imgs = n_batches = 0

    def drain_group():
        while in_flight:
            host, event, recs, n_real = in_flight.popleft()
            if event is not None:
                event.synchronize()
            box_feat, _seeds, seed_bg = (h.numpy() for h in host)
            for i in range(n_real):
                im_name, img, init_size, gt_i = recs[i]
                if seed_bg[i]:
                    if strict:
                        raise ValueError(f"The seed is in the background component ({im_name}).")
                    failed.append(im_name)
                    continue
                scales = extractor.cnn_scales(*img.shape[:2]) if cnn else [p, p]
                acc.add(im_name, box_feat_to_image(box_feat[i], scales, init_size), gt_i)

    def flush(key):
        nonlocal n_batches
        recs = buffers.pop(key)
        imgs = [r[1] for r in recs]
        n_real = len(imgs)
        # the tail batch repeats its last image, so a bucket has one batch shape
        imgs += [imgs[-1]] * (batch_size - n_real)
        exact_hw = None
        if feed_uint8:  # exact pixel dims: the device normalize zeroes beyond them
            exact_hw = [tuple(r[2][1:]) for r in recs]
            exact_hw += [exact_hw[-1]] * (batch_size - n_real)
        outs = pipeline(*(extractor.prepare_cnn_batch(imgs, key, exact_hw=exact_hw) if cnn
                          else extractor.prepare_batch(imgs, p, exact_hw=exact_hw)))
        event = None
        if device.type == "cuda":
            host = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs)
            for h, o in zip(host, outs):
                h.copy_(o, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            outs = host
        in_flight.append((outs, event, recs, n_real))
        n_batches += 1
        if len(in_flight) >= drain_depth:
            drain_group()

    # --workers 0 means one synchronous decode thread, not the default
    workers = getattr(args, "workers", None)
    workers = 8 if workers is None else max(int(workers), 1)
    t_decode = time.time()
    for path, im_name, padded, init_image_size, gt in _prefetch_decoded(
            dataset, p, args.no_hard, workers=workers, need_gt=not no_evaluation,
            as_uint8=feed_uint8):
        n_imgs += 1
        if per_image:
            feats, dims, valid_dims, scales, attn = extractor.extract(padded, p)
            A = scores = seed = None
            if dinoseg:
                pred = np.asarray(dino_seg(attn, dims, p, head=args.dinoseg_head,
                                           reference_bugs=reference_bugs), dtype=np.float64)
            else:
                try:
                    pred, A, scores, seed = lost(feats, dims, scales, init_image_size,
                                                 k_patches=args.k_patches,
                                                 valid_dims=valid_dims)
                except ValueError as e:
                    # the batched drain's collect-or-crash contract
                    if strict or "background" not in str(e):
                        raise
                    failed.append(im_name)
                    continue
            acc.add(im_name, pred, gt)
            if visualize:
                from vipers_torch.viz.draw import save_lost_visualization

                save_lost_visualization(visualize, path, pred, gt, A, scores, seed, dims,
                                        scales, args.output_dir, im_name)
            continue
        h, w = padded.shape[:2]
        key = (extractor.cnn_bucket_key(h, w) if cnn
               else bucket_hw(h, w, p, extractor.bucket))
        buffers.setdefault(key, []).append((im_name, padded, init_image_size, gt))
        if len(buffers[key]) == batch_size:
            flush(key)
    for key in sorted(buffers):
        flush(key)
    drain_group()

    if nproc > 1:
        # every rank's results, so rank 0 writes what one process would
        payloads = parallel.all_gather_object({"hits": acc.hits, "count": acc.count,
                                               "preds": acc.preds, "failed": failed,
                                               "n_imgs": n_imgs})
        acc, failed, n_imgs = CorLocAccumulator(), [], 0
        for pl in payloads:
            acc.hits += pl["hits"]
            acc.count += pl["count"]
            acc.preds.update(pl["preds"])
            failed += pl["failed"]
            n_imgs += pl["n_imgs"]
    if failed and rank == 0:
        print(f"WARNING: seed in background component for {len(failed)} image(s), skipped: "
              f"{', '.join(failed[:10])}" + (" ..." if len(failed) > 10 else "")
              + " (rerun with --strict for reference-parity crashing)")
    if rank == 0:
        os.makedirs(args.output_dir, exist_ok=True)
        acc.save(args.output_dir, iteration, save_preds=save_predictions,
                 save_results=not no_evaluation)
    parallel.barrier()
    t_end = time.time()
    LAST_RUN.clear()
    LAST_RUN.update(images=n_imgs, batches=n_batches, failed=list(failed), per_image=per_image,
                    seconds=t_end - t_start, decode_to_preds_seconds=t_end - t_decode,
                    decoder=native.backend() if feed_uint8 else "pil")
    dt = t_end - t_start
    print(f"LOST: {n_imgs} images in {dt:.1f}s ({n_imgs / max(dt, 1e-9):.2f} img/s)")
    return 0
