"""Image-folder data pipeline (port of `stf_tpu/datasets/image_folder.py`).

Reference layout (`compressai/datasets/utils.py:21-66`): root/{train,test}/
holding images. Decoding runs on a thread pool; crops and flips draw from
the JAX loader's NumPy generators (`default_rng((seed, epoch))` for the
order, `(seed, epoch, i)` per item), so both loaders yield the same
batches. `prefetch_to_device` stages each batch in pinned host memory and
copies it to the device without blocking, one batch ahead.
"""

import os
import queue as queue_mod
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

_IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".webp"}


def load_image(path: str) -> np.ndarray:
    """Decode an image file to float32 HW3 in [0, 1]. Pillow is imported
    here, at first use."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def list_images(root: str) -> list:
    files = sorted(
        os.path.join(root, f)
        for f in os.listdir(root)
        if os.path.splitext(f)[1].lower() in _IMG_EXTS
    )
    if not files:
        raise RuntimeError(f"no images found in {root!r}")
    return files


class ImageFolder:
    """Fixed-size crops of the images in root/split: random crop and
    random horizontal flip when `train` (the default for split "train"),
    center crop otherwise; images smaller than the patch are zero-padded
    at the bottom and right first."""

    def __init__(self, root: str, split: str = "train",
                 patch_size: Tuple[int, int] = (256, 256),
                 train: Optional[bool] = None, seed: int = 0):
        self.dir = os.path.join(root, split)
        if not os.path.isdir(self.dir):
            raise RuntimeError(f'Invalid directory "{self.dir}"')
        self.files = list_images(self.dir)
        self.patch_size = tuple(patch_size)
        self.train = train if train is not None else split == "train"
        self.seed = seed

    def __len__(self):
        return len(self.files)

    def _load_patch(self, path: str, rng: np.random.Generator) -> np.ndarray:
        img = load_image(path)
        ph, pw = self.patch_size
        h, w = img.shape[:2]
        if h < ph or w < pw:
            img = np.pad(img, ((0, max(0, ph - h)), (0, max(0, pw - w)), (0, 0)))
            h, w = img.shape[:2]
        if self.train:
            top = int(rng.integers(0, h - ph + 1))
            left = int(rng.integers(0, w - pw + 1))
        else:
            top, left = (h - ph) // 2, (w - pw) // 2
        patch = img[top:top + ph, left:left + pw]
        if self.train and rng.random() < 0.5:
            patch = patch[:, ::-1]
        return np.ascontiguousarray(patch)

    def batches(self, batch_size: int, epoch: int = 0, num_workers: int = 8,
                drop_last: bool = True) -> Iterator[np.ndarray]:
        """Yield NHWC float32 batches; at most max(2 * num_workers,
        batch_size) decoded patches are in flight."""
        rng = np.random.default_rng((self.seed, epoch))
        order = np.arange(len(self.files))
        if self.train:
            rng.shuffle(order)
        item_rngs = [np.random.default_rng((self.seed, epoch, int(i)))
                     for i in order]
        window = max(2 * num_workers, batch_size)
        items = iter(zip(order, item_rngs))
        with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as pool:
            pending: deque = deque()
            for i, r in items:
                pending.append(pool.submit(self._load_patch, self.files[i], r))
                if len(pending) >= window:
                    break
            batch = []
            while pending:
                batch.append(pending.popleft().result())
                nxt = next(items, None)
                if nxt is not None:
                    i, r = nxt
                    pending.append(pool.submit(self._load_patch, self.files[i], r))
                if len(batch) == batch_size:
                    yield np.stack(batch)
                    batch = []
            if batch and not drop_last:
                yield np.stack(batch)


def prefetch_to_device(iterator, device, size: int = 2):
    """Yield the iterator's NumPy batches as tensors on `device`. A
    background thread stages each in pinned host memory (on a CUDA
    device) and starts its non-blocking copy, up to `size` batches ahead
    of the consumer; a loader error is raised in the consumer."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(batch):
        t = torch.from_numpy(batch)
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    end = object()

    def producer():
        try:
            for batch in iterator:
                q.put(put(batch))
            q.put(end)
        except BaseException as e:  # surfaced in the consumer
            q.put(e)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
