"""Read a scene in the Replica (TANDEM) layout with numpy alone, and the
MVS training/eval dataset over such scenes.

    scene/camera.txt         "fx fy cx cy 0" then "W H"
    scene/poses_gt.txt       "id" + 16 numbers of the 4x4 camera-to-world
    scene/images/%06d.png    8-bit RGB
    scene/depths/%06d.png    16-bit depth, metres = value * depths/scale.txt
    scene/tuples_dso_optimization_windows.txt  "n id_1 .. id_n scale"

The machine with the card has no image library, so PNG files are decoded
here (zlib + the five PNG row filters: ``decode_png``, the plain version of
the C decoder ``native_bridge.decode_png_native``, which the scene and
dataset readers below use) and written by ``write_png``;
``gray`` is OpenCV's fixed-point BGR -> grey conversion, which the JAX
package's reader uses (``tandem_tpu/data/reader.py``), and
``resize_nearest`` is ``cv2.resize``'s INTER_NEAREST.

``MVSScene`` ... ``make_batches`` port ``tandem_tpu/data/replica.py:55-348``
(parity target cva_mvsnet/models/datasets.py:276-655): tuples of views
ordered reference first (for dso_optimization_windows the one before last,
else the middle view), per-stage intrinsics by half-pixel-aware resizing,
per-stage GT depths by nearest resizing, masks = depth in
[depth_min, depth_max]. Batches are numpy, equal bit for bit to the JAX
package's on the same files.

``make_batches`` records, on the consumer's thread (``utils/timer.py``),
``loader_blocked`` around its waits on the workers, ``loader_collate``
around ``collate`` and, as each batch is asked for, the counter
``loader_ready``: the batches of the lookahead with every sample decoded,
the one being taken included.
"""

from __future__ import annotations

import struct
import zlib
from os.path import exists, join, splitext
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.camera import cam_intrinsics, cam_resize, cam_stack
from ..native_bridge import read_png_native
from ..utils.timer import Timer
from .png_format import png_layout

_TIMER = Timer(enabled=False)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += stride + 1
        if ftype == 0:
            cur = line
        elif ftype == 2:                                  # up
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):                          # sub, average, paeth
            cur, up = line.tolist(), prev.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    p = a
                elif ftype == 3:
                    p = (a + up[x]) >> 1
                else:
                    b = up[x]
                    c = up[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + p) & 0xFF
            cur = np.array(cur, np.int32)
        else:
            raise ValueError(f"PNG: unknown row filter {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path) -> np.ndarray:
    """Decode a non-interlaced 8- or 16-bit grey/RGB(A) PNG file: (H, W) or
    (H, W, C), uint8 or uint16."""
    return decode_png(Path(path).read_bytes(), str(path))


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """``read_png`` of the file's bytes."""
    h, w, depth, ch, compressed = png_layout(data, path)
    bpp = ch * depth // 8
    rows = _unfilter(zlib.decompress(compressed), h, w * bpp, bpp)
    if depth == 16:
        img = rows.reshape(h, w * ch, 2).astype(np.uint16)
        img = (img[..., 0] << 8) | img[..., 1]
    else:
        img = rows
    return img.reshape(h, w, ch)[..., 0] if ch == 1 else img.reshape(h, w, ch)


def write_png(path, img: np.ndarray) -> None:
    """Write (H, W) or (H, W, 1-4) uint8 or uint16 as a PNG file (grey,
    grey+alpha, RGB or RGBA; rows unfiltered)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16) or img.ndim not in (2, 3):
        raise ValueError(f"write_png: (H, W[, C]) uint8 or uint16, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = img.astype(img.dtype.newbyteorder(">")).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rows.view(np.uint8)], 1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    hdr = struct.pack(">IIBBBBB", w, h, 8 * img.dtype.itemsize, ctype, 0, 0,
                      0)
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr)
                           + chunk(b"IDAT", zlib.compress(raw, 6))
                           + chunk(b"IEND", b""))


def gray(bgr: np.ndarray) -> np.ndarray:
    """OpenCV's COLOR_BGR2GRAY for uint8 (OpenCV 5's fixed point, equal to
    it on all 2^24 colours): Y = (3735 B + 19235 G + 9798 R + 2^14) >> 15.
    OpenCV 4's 14-bit weights (1868, 9617, 4899) differ on ~0.1% of
    colours."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((3735 * b + 19235 * g + 9798 * r + 16384) >> 15).astype(np.uint8)


class ReplicaScene:
    """One scene directory; frames are read on demand."""

    def __init__(self, scene_dir):
        self.dir = Path(scene_dir)
        lines = (self.dir / "camera.txt").read_text().split("\n")
        parts = lines[0].split()
        if parts[0].lower() == "pinhole":
            parts = parts[1:]
        self.fx, self.fy, self.cx, self.cy = (float(x) for x in parts[:4])
        self.width, self.height = (int(x) for x in lines[1].split()[:2])
        self.K = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                           [0, 0, 1]], np.float32)
        self.poses = {}
        for ln in (self.dir / "poses_gt.txt").read_text().splitlines():
            if ln.strip():
                vals = ln.split()
                self.poses[int(vals[0])] = np.array(
                    vals[1:17], np.float64).reshape(4, 4)
        self.depth_scale = float(
            (self.dir / "depths" / "scale.txt").read_text().split()[0])
        self.windows = []
        win = self.dir / "tuples_dso_optimization_windows.txt"
        if win.exists():
            for ln in win.read_text().splitlines():
                vals = ln.split()
                if vals:
                    n = int(vals[0])
                    self.windows.append([int(v) for v in vals[1:1 + n]])

    def bgr(self, i: int) -> np.ndarray:
        """(H, W, 3) uint8 BGR, as cv2.imread returns it."""
        return np.ascontiguousarray(
            read_png_native(self.dir / "images" / f"{i:06d}.png")[..., ::-1])

    def gray(self, i: int) -> np.ndarray:
        """(H, W) float32 grey intensity in [0, 255]."""
        return gray(self.bgr(i)).astype(np.float32)

    def depth(self, i: int) -> np.ndarray:
        """(H, W) float32 metres, 0 = invalid."""
        raw = read_png_native(self.dir / "depths" / f"{i:06d}.png")
        return (raw.astype(np.float64) * self.depth_scale).astype(np.float32)

    def c2w(self, i: int) -> np.ndarray:
        return self.poses[i].astype(np.float32)


def resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=INTER_NEAREST)``:
    destination pixel (y, x) takes source pixel (min(floor(y * sh / h),
    H - 1), min(floor(x * sw / w), W - 1)), with the scale as OpenCV
    computes it in double, ``1 / (w / W)`` (imgproc/src/resize.cpp,
    resizeNN)."""
    H, W = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(height) * (1.0 / (height / H))),
                    H - 1).astype(np.intp)
    xs = np.minimum(np.floor(np.arange(width) * (1.0 / (width / W))),
                    W - 1).astype(np.intp)
    return np.ascontiguousarray(img[ys[:, None], xs[None, :]])


def _readlines(path: str, num_lines: Optional[int] = None) -> List[str]:
    with open(path, "r") as fp:
        lines = [ln.rstrip() for ln in fp
                 if not ln.startswith("#") and len(ln.strip()) > 0]
    if num_lines is not None and len(lines) != num_lines:
        raise ValueError(f"{path}: expected {num_lines} lines, got {len(lines)}")
    return lines


def _resize(img, height, width):
    if height is None or width is None:
        return img
    if img.shape[0] == height and img.shape[1] == width:
        return img
    return resize_nearest(img, height, width)


def mask_depth(depth, depth_min, depth_max):
    mask = np.logical_and(depth >= depth_min, depth <= depth_max)
    depth = np.where(mask, depth, 0).astype(depth.dtype)
    return depth, mask.astype(depth.dtype)


class MVSScene:
    """One Replica scene: lazily loads (image, depth, pose) view tuples.

    Images and depths are resized with nearest neighbours, the only
    interpolation the JAX package's reader uses."""

    def __init__(self, scene_dir: str, pose_ext: str = "gt",
                 height: Optional[int] = None, width: Optional[int] = None,
                 tuples_ext: Optional[str] = "dso_optimization_windows",
                 ignore_pose_scale: bool = True,
                 tuples_default_flag: bool = False,
                 tuples_default_frame_num: int = 3,
                 tuples_default_frame_dist: int = 20,
                 depth_min: float = 0.01, depth_max: float = 10.0,
                 dtype: str = "float32"):
        self.scene_dir = scene_dir
        self.dtype = dtype
        self.depth_min = depth_min
        self.depth_max = depth_max

        tuples_ext = tuples_ext if tuples_ext is not None else pose_ext
        self.tuples_file = join(scene_dir, f"tuples_{tuples_ext}.txt")
        self.poses_file = join(scene_dir, f"poses_{pose_ext}.txt")
        self.depth_scale = float(
            _readlines(join(scene_dir, "depths", "scale.txt"), 1)[0])

        self.cam_base = self._read_camera()
        self.height = height if height is not None else self.cam_base["height"]
        self.width = width if width is not None else self.cam_base["width"]
        if self.height % 4 or self.width % 4:
            raise ValueError(f"MVSScene: {self.height}x{self.width} is not "
                             "divisible by 4")

        self.poses = self._read_poses()
        if tuples_default_flag:
            self.scales = None
            self.tuples = self._generate_tuples(
                tuples_default_frame_num, tuples_default_frame_dist)
        else:
            self.tuples, self.scales = self._read_tuples(ignore_pose_scale)

        self.num_views = len(self.tuples[0])
        if tuples_ext == "dso_optimization_windows":
            self.ref_index = self.num_views - 2  # one before last
        else:
            self.ref_index = self.num_views // 2
        self.out_indices = (self.ref_index,) + tuple(
            i for i in range(self.num_views) if i != self.ref_index)

    # --- file parsing -----------------------------------------------------
    def _read_camera(self) -> dict:
        lines = _readlines(join(self.scene_dir, "camera.txt"))
        parts = lines[0].split(" ")
        if parts[0].lower() == "pinhole":
            parts = parts[1:]
        fx, fy, cx, cy, flag = [float(x) for x in parts[:5]]
        if int(flag) != 0:
            raise ValueError("MVSScene: only half_pixel_centers=False "
                             "cameras are supported")
        w, h = [int(x) for x in lines[1].split(" ")[:2]]
        return cam_intrinsics(height=h, width=w, fx=fx, fy=fy, cx=cx, cy=cy,
                              dtype=np.dtype(self.dtype))

    def _read_poses(self) -> Dict[int, np.ndarray]:
        poses = {}
        for line in _readlines(self.poses_file):
            vals = line.split(" ")
            idx = int(vals[0])
            poses[idx] = np.array([float(v) for v in vals[1:17]],
                                  dtype=self.dtype).reshape(4, 4)
        return poses

    def _read_tuples(self, ignore_scale: bool):
        lines = _readlines(self.tuples_file)
        num_views = int(lines[0].split(" ")[0])
        has_scale = len(lines[0].split(" ")) == num_views + 2
        use_scale = has_scale and not ignore_scale
        tuples, scales = [], ([] if use_scale else None)
        for line in lines:
            vals = line.split(" ")
            if int(vals[0]) != num_views:
                raise ValueError(f"{self.tuples_file}: tuples of "
                                 f"{vals[0]} and {num_views} views")
            tuples.append(tuple(int(v) for v in vals[1:1 + num_views]))
            if use_scale:
                scales.append(float(vals[-1]))
        return tuple(tuples), (tuple(scales) if use_scale else None)

    def _generate_tuples(self, frame_num: int, frame_dist: int):
        lo, hi = min(self.poses), max(self.poses)
        spaced = 1 + (hi - lo) // frame_dist
        count = spaced - frame_num + 1
        tuples = tuple(
            tuple((i + j) * frame_dist for j in range(frame_num))
            for i in range(count))
        for tup in tuples:
            for f in tup:
                if f not in self.poses:
                    raise ValueError(f"MVSScene: frame {f} has no pose")
        return tuples

    # --- per-frame IO -----------------------------------------------------
    def read_image(self, frame_index: int) -> np.ndarray:
        """(3, H, W) RGB in [0, 1]. The JAX package reads BGR with
        cv2.imread and swaps to RGB; the PNG decoder gives RGB."""
        fname = join(self.scene_dir, "images", f"{frame_index:06d}.jpg")
        if not exists(fname):
            fname = splitext(fname)[0] + ".png"
        else:
            raise ValueError(f"{fname}: JPEG images are not supported (the "
                             "port decodes PNG only)")
        img = read_png_native(fname)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"{fname}: want an RGB image, got {img.shape}")
        img = _resize(img, self.height, self.width)
        return np.transpose(img, (2, 0, 1)).astype(self.dtype) / 255.0

    def read_depth(self, frame_index: int) -> np.ndarray:
        fname = join(self.scene_dir, "depths", f"{frame_index:06d}.png")
        depth = _resize(read_png_native(fname), self.height, self.width)
        return self.depth_scale * depth.astype(self.dtype)

    # --- dataset protocol -------------------------------------------------
    def __len__(self):
        return len(self.tuples)

    def __getitem__(self, idx: int) -> dict:
        cam_base = cam_resize(self.cam_base, self.height, self.width)
        current = self.tuples[idx]

        poses, images, depths, cams = [], [], [], []
        for view_index in self.out_indices:
            frame = current[view_index]
            p = np.copy(self.poses[frame])
            if self.scales is not None:
                p[:3, 3] *= self.scales[idx]
            poses.append(p)
            images.append(self.read_image(frame))
            depths.append(self.read_depth(frame))
            cams.append(dict(cam_base))

        poses = np.stack(poses)
        images = np.stack(images)

        depth_s3 = np.copy(depths[0])
        depth_s2 = _resize(depth_s3, self.height // 2, self.width // 2)
        depth_s1 = _resize(depth_s3, self.height // 4, self.width // 4)
        depth_s3, mask_s3 = mask_depth(depth_s3, self.depth_min, self.depth_max)
        depth_s2, mask_s2 = mask_depth(depth_s2, self.depth_min, self.depth_max)
        depth_s1, mask_s1 = mask_depth(depth_s1, self.depth_min, self.depth_max)

        return {
            "intrinsics": {
                "stage3": cam_stack(cams),
                "stage2": cam_stack([cam_resize(c, c["height"] // 2,
                                                c["width"] // 2) for c in cams]),
                "stage1": cam_stack([cam_resize(c, c["height"] // 4,
                                                c["width"] // 4) for c in cams]),
            },
            "depth": {"stage3": depth_s3, "stage2": depth_s2, "stage1": depth_s1},
            "mask": {"stage3": mask_s3, "stage2": mask_s2, "stage1": mask_s1},
            "cam_to_world": poses,
            "image": images,
            "depth_min": np.dtype(self.dtype).type(self.depth_min),
            "depth_max": np.dtype(self.dtype).type(self.depth_max),
            "view_index": np.array(self.out_indices, dtype=np.int64),
        }


class MVSDataset:
    """Concatenation of the scenes listed in <root>/<split>.txt
    (datasets.py:524-570): the split file holds space-separated scene names
    (one line, as the reference writes it, or one a line) and the scenes
    live directly under the root."""

    def __init__(self, root_dir: str, split: str, **scene_kwargs):
        lines = _readlines(join(root_dir, split if split.endswith(".txt")
                                else f"{split}.txt"))
        scene_names = [name for line in lines for name in line.split(" ")
                       if name]
        self.scenes = [MVSScene(join(root_dir, name), **scene_kwargs)
                       for name in scene_names]
        self.start = np.cumsum([0] + [len(s) for s in self.scenes])

    def __len__(self):
        return int(self.start[-1])

    def __getitem__(self, idx: int) -> dict:
        scene_idx = int(np.searchsorted(self.start, idx, side="right") - 1)
        return self.scenes[scene_idx][idx - int(self.start[scene_idx])]


class NamedDataset:
    """Tags every sample with its dataset name (datasets.py:573-593): the
    per-dataset epoch_end_mean reducers key off ``dataset_name``."""

    def __init__(self, *, name: str, dataset):
        self.name = name
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        item = self.dataset[idx]
        if not isinstance(item, dict) or "dataset_name" in item:
            raise ValueError("NamedDataset: items must be dicts without a "
                             "dataset_name")
        item["dataset_name"] = self.name
        return item

    def __repr__(self):
        return f"NamedDataset: name={self.name}, dataset={self.dataset!r}"


class TruncatedDataset:
    """Length-limited view of a dataset; ``front=True`` keeps the LAST
    ``length`` samples (datasets.py:596-615 semantics, offset included)."""

    def __init__(self, *, length: int, dataset, front: bool = False):
        self.length = min(length, len(dataset))
        self.dataset = dataset
        self.offset = len(dataset) - self.length if front else 0

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        if idx < self.length:
            return self.dataset[self.offset + idx]
        raise IndexError(f"Index {idx} out of bounds for TruncatedDataset "
                         f"of length {self.length}")

    def __repr__(self):
        return (f"TruncatedDataset: length={self.length}, "
                f"offset={self.offset}, dataset={self.dataset!r}")


def collate(items: Sequence[dict]) -> dict:
    """Stack sample dicts into batched numpy arrays (model input contract)."""
    def stack(items):
        v0 = items[0]
        if isinstance(v0, dict):
            return {k: stack([it[k] for it in items]) for k in v0}
        return np.stack([np.asarray(it) for it in items])
    return stack(list(items))


def make_batches(dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 1234,
                 num_workers: int = 0, prefetch_batches: int = 2):
    """Host-side batch iterator (the reference's torch DataLoader,
    datasets.py:622-655).

    With ``num_workers > 0`` samples are decoded by a thread pool and
    assembled into in-order batches with a lookahead of
    ``prefetch_batches`` beyond the one being consumed. Batch contents and
    order are the serial path's for the same seed (and the JAX package's:
    the same numpy shuffle)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    n = len(order)
    end = n - (n % batch_size) if drop_last else n
    batches = [order[i:i + batch_size] for i in range(0, end, batch_size)]

    if num_workers <= 0:
        for idx in batches:
            samples = [dataset[int(j)] for j in idx]
            with _TIMER.span("loader_collate"):
                batch = collate(samples)
            yield batch
        return

    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        pending = deque()   # per batch, its samples' futures
        bi = iter(batches)

        def submit():
            idx = next(bi, None)
            if idx is None:
                return False
            pending.append([ex.submit(dataset.__getitem__, int(j))
                            for j in idx])
            return True

        for _ in range(1 + prefetch_batches):
            if not submit():
                break
        while pending:
            if _TIMER.recording():
                _TIMER.count("loader_ready", sum(
                    all(f.done() for f in b) for b in pending))
            futs = pending.popleft()
            with _TIMER.span("loader_blocked"):
                samples = [f.result() for f in futs]
            with _TIMER.span("loader_collate"):
                batch = collate(samples)
            yield batch
            submit()
