"""LOST feature driver for the ViT (port of the ``arch="vit"`` batched path of
``vipers/discovery/driver.py``).

``LostFeatureExtractor.make_batched_pipeline`` is the product path: the
masked ViT forward, the reference's qkv scramble that yields the k features
and the batched LOST core, all on the device; only the 4-int boxes, seeds
and background flags need to return to the host. Inputs come from
``prepare_batch``: tier-1-padded images sharing one bucket shape, uint8
(normalized on the device) or already-normalized float.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vipers_torch.core.checkpoint import vit_state_dict_from_flax
from vipers_torch.core.device import resolve_device
from vipers_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD, bucket_hw
from vipers_torch.discovery.lost import lost_core
from vipers_torch.models.interpolate import resize_weight_matrix_np
from vipers_torch.models.vit import scrambled_qkv_gather
from vipers_torch.ops.flash_attention import flash_min_t


def device_normalize(images, pixel_hw):
    """uint8 (B, H, W, 3) -> normalized f32 on the images' device: x/255,
    then (x - mean)/std in f32 (the host path's op order, so the result is
    bit-equal to it), then zero beyond each image's exact pixel extent
    ``pixel_hw`` (B, 2) (the host zero-pads before normalizing)."""
    dev = images.device
    x = images.to(torch.float32) / 255.0
    x = (x - torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev)) / \
        torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev)
    if pixel_hw is not None:
        phw = pixel_hw.to(dev)
        r = torch.arange(images.shape[1], device=dev)[None, :, None]
        c = torch.arange(images.shape[2], device=dev)[None, None, :]
        valid = (r < phw[:, 0, None, None]) & (c < phw[:, 1, None, None])
        x = torch.where(valid[..., None], x, torch.zeros((), device=dev))
    return x


def seq_pad(img_shape, patch: int) -> Optional[int]:
    """128-multiple token padding where the flash kernel engages
    (T >= flash_min_t(); the pipeline never asks for attention probs)."""
    t = (img_shape[1] // patch) * (img_shape[2] // patch) + 1
    return 128 if t >= flash_min_t() else None


class LostFeatureExtractor:
    """The masked ViT on ``device`` (default ``cuda``; ``"cpu"`` runs the
    kernels' plain versions) with the LOST feature and box pipeline.

    ``params`` is a ViT parameter tree in the JAX package's keys and layouts
    (``spec.init`` or a flax tree converted to numpy), ``masks`` its pruning
    masks; both are baked into the module once, then cast to
    ``compute_dtype`` (None = float32)."""

    def __init__(self, spec, params, masks=None, which_features: str = "k",
                 bucket: int = 4, compute_dtype: Optional[torch.dtype] = None,
                 device=None):
        self.device = resolve_device(device)
        self.spec = spec
        self.which = which_features
        self.bucket = bucket
        self.compute_dtype = compute_dtype or torch.float32
        model = spec.module()
        model.load_state_dict(vit_state_dict_from_flax(params, masks))
        model.eval().requires_grad_(False)
        self.model = model.to(device=self.device, dtype=self.compute_dtype)
        self._pos_cache: dict = {}

    def _pos_and_mask(self, gh: int, gw: int, GH: int, GW: int):
        """Pos-embeddings interpolated to the valid (gh, gw) grid, scattered
        into the (GH, GW) bucket grid as two matmuls with host-built weight
        matrices (zero rows beyond gh/gw), plus the CLS+valid token mask.
        Cached per key; returns ((1, 1+GH*GW, D) f32, (1, 1+GH*GW) bool)."""
        key = (gh, gw, GH, GW)
        if key not in self._pos_cache:
            p = self.spec.patch_size
            side_h = self.spec.input_size[0] // p
            side_w = self.spec.input_size[1] // p
            mat_h = np.zeros((GH, side_h), np.float32)
            mat_h[:gh] = resize_weight_matrix_np(side_h, gh, True)
            mat_w = np.zeros((GW, side_w), np.float32)
            mat_w[:gw] = resize_weight_matrix_np(side_w, gw, True)
            with torch.inference_mode():
                pos = self.model.pos_embedding.float()
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
        token_mask is None when every image exactly fills the bucket.

        uint8 images stay uint8 and are normalized on the device;
        ``exact_hw`` must then give each image's exact pixel dims, and a 5th
        element ``pixel_hw`` ((B, 2) int32, or None when every image fills
        the bucket pixel-exactly) comes back."""
        u8 = imgs[0].dtype == np.uint8
        bh, bw = bucket_hw(imgs[0].shape[0], imgs[0].shape[1], patch, self.bucket)
        GH, GW = bh // patch, bw // patch
        batch = np.zeros((len(imgs), bh, bw, 3), np.uint8 if u8 else np.float32)
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
            pos_batch = torch.cat(rows, dim=0)[torch.tensor(idx, device=self.device)]
        else:
            pos_batch = rows[0].expand(len(imgs), -1, -1)
        exact_fit = all(t == (GH, GW) for t in vhw)
        token_mask = None if exact_fit else torch.from_numpy(
            np.concatenate([mask_rows[u] for u in idx], axis=0)).to(self.device)
        out = (
            torch.from_numpy(batch).to(self.device),
            pos_batch,
            token_mask,
            torch.tensor(vhw, dtype=torch.int32, device=self.device),
        )
        if not u8:
            return out
        if exact_hw is None:
            raise ValueError("uint8 batches need exact_hw (pixel dims)")
        pixel_exact = all(tuple(t) == (bh, bw) for t in exact_hw)
        return out + (None if pixel_exact else torch.tensor(
            exact_hw, dtype=torch.int32, device=self.device),)

    @torch.inference_mode()
    def batched_features(self, images, pos, token_mask, valid_hw, pixel_hw=None):
        """(B, GH*GW, D) LOST features on the bucket grid: the ViT forward,
        then the reference's qkv scramble of the last ln_1 output applied to
        each image's tier-1 tokens (CLS + valid, raster order), scattered
        back onto the grid; bucket-pad rows are zero."""
        patch = self.spec.patch_size
        if images.dtype == torch.uint8:
            images = device_normalize(images, pixel_hw)
        images = images.to(self.compute_dtype)
        pos = pos.to(self.compute_dtype)
        _, aux = self.model(images, override_pos_embedding=pos,
                            token_mask=token_mask, need_attn=False,
                            seq_pad_multiple=seq_pad(images.shape, patch))
        GH, GW = images.shape[1] // patch, images.shape[2] // patch
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
