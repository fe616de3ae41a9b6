"""TensorBoard logger with 4 sub-writers and a sample-scaled x axis.

Port of ``tandem_tpu/train/tb_logger.py`` (parity target
cva_mvsnet/models/utils/tb_logger.py:17-243): separate train / val /
train_epoch / val_epoch SummaryWriters, the x axis in samples
(samples_per_step * global_step, :138), scalar groups for the losses, the
11 depth metrics per stage and the learning rate; image summaries of the
multi-view strip and of the depth / confidence maps (plasma colormap) and,
on request, the views warped into the reference at GT depth.

TensorBoard is optional (``_HAS_TB``): without it nothing is written. The
image summaries need matplotlib's colormap; without it they are skipped
and the log says so once.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Dict

import numpy as np

# Imported when a logger is made (torch's SummaryWriter imports TensorFlow
# where that is installed, ~15 s).
_HAS_TB = importlib.util.find_spec("tensorboard") is not None


def _numpy(v) -> np.ndarray:
    if hasattr(v, "detach"):
        return v.detach().float().cpu().numpy()
    return np.asarray(v)


def _colorize_plasma(x: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """(H, W) -> (3, H, W) plasma-colorized float image."""
    import matplotlib
    vmin = np.nanmin(x) if vmin is None else vmin
    vmax = np.nanmax(x) if vmax is None else vmax
    normed = np.clip((x - vmin) / max(vmax - vmin, 1e-12), 0, 1)
    rgba = matplotlib.colormaps["plasma"](normed)
    return np.transpose(rgba[..., :3], (2, 0, 1)).astype(np.float32)


def _has_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


class TBLogger:
    WRITERS = ("train", "val", "train_epoch", "val_epoch")
    STAGES = ("stage1", "stage2", "stage3")

    def __init__(self, out_dir: str, samples_per_step: int = 1,
                 enabled: bool = True, log=print):
        self.enabled = enabled and _HAS_TB
        self.samples_per_step = samples_per_step
        self.writers = {}
        self.log = log
        self._images = None        # matplotlib present, decided on first use
        if enabled and not _HAS_TB:
            log("[tb] tensorboard is not installed: no summaries are "
                "written")
        if self.enabled:
            from torch.utils.tensorboard import SummaryWriter
            for name in self.WRITERS:
                self.writers[name] = SummaryWriter(
                    os.path.join(out_dir, "tb", name))

    def global_sample(self, global_step: int) -> int:
        return self.samples_per_step * global_step

    def add_scalars(self, writer: str, losses: Dict, errors: Dict,
                    global_step: int, prefix: str = ""):
        if not self.enabled:
            return
        w = self.writers[writer]
        x = self.global_sample(global_step)
        for k, v in (losses or {}).items():
            w.add_scalar(prefix + f"loss/{k}", float(_numpy(v)), x)
        for stage, metrics in (errors or {}).items():
            for k, v in metrics.items():
                w.add_scalar(prefix + f"{stage}/{k}", float(_numpy(v)), x)

    def add_lr(self, writer: str, lr: float, global_step: int):
        if not self.enabled:
            return
        self.writers[writer].add_scalar("lr", float(lr),
                                        self.global_sample(global_step))

    def add_summaries(self, writer: str, batch: Dict, outputs: Dict,
                      global_step: int, max_views: int = 7,
                      summaries=("image", "depth", "confidence")):
        """Image summaries (reference tb_logger.py:172-243 groups):

        * ``image``  — multi-view strip (+ un-augmented strip when present).
        * ``depth``  — per-stage gt / pred / abs error / relative error, all
          masked and scaled by the sample's depth_max.
        * ``confidence`` — per-stage confidence and the valid-pixel mask.
        * ``warp``   — per-stage strip of every view warped into the
          reference at GT depth + per-view photometric error, through the
          port's plane-sweep sample (``ops/warp.py``).
        """
        if not self.enabled:
            return
        if self._images is None:
            self._images = _has_matplotlib()
            if not self._images:
                self.log("[tb] matplotlib is not installed: image summaries "
                         "are skipped")
        if not self._images:
            return
        w = self.writers[writer]
        x = self.global_sample(global_step)

        if "image" in summaries:
            img = _numpy(batch["image"][0])       # (V, 3, H, W)
            strip = np.concatenate(list(img[:max_views]), axis=2)
            w.add_image("0.multi_view_image", np.clip(strip, 0, 1), x)
            if "image_noaug" in batch:
                strip0 = np.concatenate(
                    list(_numpy(batch["image_noaug"][0])[:max_views]),
                    axis=2)
                w.add_image("0.multi_view_image_noaug",
                            np.clip(strip0, 0, 1), x)

        if "depth" in summaries:
            dmax = max(float(_numpy(batch["depth_max"][0])), 1e-6)
            for stage in self.STAGES:
                gt = _numpy(batch["depth"][stage][0])
                pred = _numpy(outputs[stage]["depth"][0])
                mask = _numpy(batch["mask"][stage][0]).astype(np.float32)
                err = np.abs(gt - pred) * mask
                w.add_image(f"1.depth_gt/{stage}",
                            _colorize_plasma(gt, 0, dmax), x)
                w.add_image(f"2.depth_pred/{stage}",
                            _colorize_plasma(pred, 0, dmax), x)
                w.add_image(f"3.depth_err_abs/{stage}",
                            _colorize_plasma(err, 0, dmax), x)
                w.add_image(f"4.depth_err_rel/{stage}",
                            _colorize_plasma(err, 0, max(err.max(), 1e-12)),
                            x)

        if "confidence" in summaries:
            for stage in self.STAGES:
                conf = _numpy(outputs[stage]["confidence"][0])
                w.add_image(f"5.confidence/{stage}",
                            _colorize_plasma(conf, 0, 1), x)
                mask = _numpy(batch["mask"][stage][0]).astype(np.float32)
                w.add_image(f"6.mask/{stage}", mask[None], x)

        if "warp" in summaries:
            self._add_warp_summaries(w, batch, x, max_views)

    def _add_warp_summaries(self, w, batch: Dict, x: int, max_views: int):
        """Warp every source view into the reference at GT depth and log the
        warped strip + per-view photometric error (tb_logger.py:226-243)."""
        import torch

        from ..ops.warp import plane_sweep_warp

        img = _numpy(batch["image"][0])        # (V, 3, H, W)
        c2w = _numpy(batch["cam_to_world"][0])  # (V, 4, 4)
        dev = batch["image"].device if hasattr(batch["image"], "device") \
            else torch.device("cpu")
        V = min(img.shape[0], max_views)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device=dev)
        for stage in self.STAGES:
            gt = _numpy(batch["depth"][stage][0])   # (h, w)
            K = _numpy(batch["intrinsics"][stage]["K"][0])
            if K.ndim == 3:
                K = K[0]
            h, ww = gt.shape
            scale_y, scale_x = h / img.shape[2], ww / img.shape[3]
            warped, masks = [], []
            depth = t(gt)[None, None]                 # (1, 1, h, w)
            for v in range(V):
                src = img[v]
                if (scale_y, scale_x) != (1.0, 1.0):
                    ys = (np.arange(h) / scale_y).astype(int).clip(
                        0, img.shape[2] - 1)
                    xs = (np.arange(ww) / scale_x).astype(int).clip(
                        0, img.shape[3] - 1)
                    src = src[:, ys][:, :, xs]
                with torch.no_grad():
                    out, mask = plane_sweep_warp(
                        t(src.transpose(1, 2, 0))[None], depth,
                        src_K=t(K)[None], src_cam_to_world=t(c2w[v])[None],
                        ref_K=t(K)[None], ref_cam_to_world=t(c2w[0])[None])
                warped.append(_numpy(out[0, 0]).transpose(2, 0, 1))
                masks.append(_numpy(mask[0, 0]).astype(np.float32))
            strip = np.concatenate(warped, axis=2)
            w.add_image(f"7.warp_image/{stage}", np.clip(strip, 0, 1), x)
            w.add_image(f"8.warp_mask/{stage}",
                        np.concatenate(masks, axis=1)[None], x)
            errs = [_colorize_plasma(
                np.abs(wv - warped[0]).mean(0) * m, 0, None)
                for wv, m in zip(warped, masks)]
            w.add_image(f"9.warp_error/{stage}",
                        np.concatenate(errs, axis=2), x)

    def flush(self):
        for w in self.writers.values():
            w.flush()

    def close(self):
        for w in self.writers.values():
            w.close()
