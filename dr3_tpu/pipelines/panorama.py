"""Multi-image panorama generation.

Parity with the reference's Panorama pipeline (reference
include/panorama.hpp:12-105, src/panorama.cpp:5-229):

* loads a directory sorted by filename; Translate mode pre-warps each image
  spherically with the given focal length (panorama.cpp:25-29),
* chains pairwise alignments into a global frame:
  ``H_i = H_{i-1} @ H(i -> i+1 inverse)`` (panorama.cpp:42-57),
* canvas = bbox over all warped image corners, shifted to positive coords
  (set_canvas_size/set_bbox, panorama.cpp:72-141),
* per-image warp to canvas + per-column feather ramp + RGBA accumulation,
  then RGB/alpha normalization (paste_images/add_img_to_canvas/
  normalize_canvas, panorama.cpp:144-229).

Alignment + warps + blending run as jitted kernels; homography chaining and
canvas sizing are host-side scalars (output shapes must be static).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from dr3_tpu.io.image import load_image_dir
from dr3_tpu.ops import blend
from dr3_tpu.ops.warp import warp_perspective, warp_spherical
from dr3_tpu.pipelines.stitch import Stitch, _warp_corners_np
from dr3_tpu.utils.config import Config
from dr3_tpu.utils.timing import Monitor


class PanType(enum.Enum):
    HOMOGRAPHY = "homography"   # plain projective chaining
    TRANSLATE = "translate"     # spherical pre-warp + translation fits


@dataclasses.dataclass
class Panorama:
    """reconstruct::Panorama equivalent (panorama.hpp:12-105)."""

    focal_length: float = 0.0
    pan_type: PanType = PanType.HOMOGRAPHY
    feathering_width: int = 20
    cfg: Config = dataclasses.field(default_factory=Config)
    monitor: Monitor = dataclasses.field(default_factory=Monitor)
    # download the finished canvas as uint8 (4x fewer device->host bytes;
    # the sources are 8-bit images, so the only loss is output
    # re-quantization). False returns the f32 canvas bit-exactly.
    transfer_uint8: bool = True

    def process_dir(self, dir_name: str) -> np.ndarray:
        images = load_image_dir(dir_name)
        return self.process(images)

    def process(self, images: Sequence[np.ndarray]) -> np.ndarray:
        if self.pan_type is PanType.TRANSLATE:
            if self.focal_length <= 0:
                raise ValueError("Translate mode needs a focal length")
            self.monitor.tic("spherical_warp")
            # pre-warp ON DEVICE and keep the handles: the warped frames
            # are only consumed by further device programs (alignment +
            # canvas paste), so they never travel to the host. Alignment
            # dispatches overlap the warp compute; the timer here records
            # dispatch only, the work lands in the align/paste fetches.
            images = [warp_spherical(jnp.asarray(im), self.focal_length)
                      for im in images]
            self.monitor.toc("spherical_warp")

        # 1. chained pairwise alignment (panorama.cpp:42-57): all pair
        # programs dispatch before any result is read, then ONE stacked
        # fetch decodes every alignment (same-shape pairs share one
        # compiled program, so dispatches overlap on device)
        self.monitor.tic("align")
        stitcher = Stitch(self.cfg, translate_only=self.pan_type is PanType.TRANSLATE)
        packed = [stitcher.align_pair_async(images[i], images[i + 1])
                  for i in range(len(images) - 1)]
        if len({p.shape for p in packed}) <= 1:
            rows = np.asarray(jnp.stack(packed)) if packed else []
        else:
            rows = [np.asarray(p) for p in packed]
        Hs: List[np.ndarray] = [np.eye(3, dtype=np.float32)]
        for row in rows:
            align = stitcher.unpack_alignment(row)
            Hinv = np.linalg.inv(align.H).astype(np.float32)
            Hinv = Hinv / Hinv[2, 2]
            Hs.append((Hs[-1] @ Hinv).astype(np.float32))
        self.monitor.toc("align")

        # 2. canvas bbox over all warped corners (panorama.cpp:72-141) —
        # host numpy: a 4-point device dispatch + fetch per image would
        # cost a device round trip each
        all_x, all_y = [], []
        bboxes = []
        for img, H in zip(images, Hs):
            h, w = img.shape[:2]
            tc = _warp_corners_np(H, w, h)
            bboxes.append((tc[:, 0].min(), tc[:, 0].max(), tc[:, 1].min(), tc[:, 1].max()))
            all_x += [tc[:, 0].min(), tc[:, 0].max()]
            all_y += [tc[:, 1].min(), tc[:, 1].max()]
        min_x, min_y = np.floor(min(all_x)), np.floor(min(all_y))
        canvas_w = int(np.ceil(max(all_x)) - min_x)
        canvas_h = int(np.ceil(max(all_y)) - min_y)
        T = np.eye(3, dtype=np.float32)
        T[0, 2], T[1, 2] = -min_x, -min_y
        # canvas origin in image-0 coordinates (for downstream registration)
        self.origin_ = (float(min_x), float(min_y))
        self.homographies_ = [np.array(H) for H in Hs]

        # 3. feathered accumulation (panorama.cpp:144-212)
        self.monitor.tic("paste")
        channels = 3 if images[0].ndim == 3 else 1
        canvas = jnp.zeros((canvas_h, canvas_w, channels + 1), jnp.float32)
        for img, H, bb in zip(images, Hs, bboxes):
            M = jnp.asarray(T @ H)
            im = jnp.asarray(img if img.ndim == 3 else img[..., None])
            warped, valid = warp_perspective(im, M, (canvas_h, canvas_w))
            if channels == 1 and warped.ndim == 2:
                warped = warped[..., None]
            col_w = blend.column_feather(canvas_w, bb[0] - min_x, bb[1] - min_x,
                                         self.feathering_width)
            canvas = blend.accumulate(canvas, warped, valid, col_w)
        out = blend.normalize(canvas)
        # the ONE device->host download of the run
        if self.transfer_uint8:
            q = jnp.clip(out * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8)
            arr = np.asarray(q).astype(np.float32) / 255.0
        else:
            arr = np.asarray(out)
        self.monitor.toc("paste")
        return arr[..., 0] if channels == 1 else arr
