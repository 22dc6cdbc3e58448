"""The one traffic generator: a mix file of parameters -> a pool of
seeded uint8 batches and the order in which a closed loop sends them.

A mix (`codecbench/traffic/<name>.json`) holds:

  * "loop": "closed" (one client sends its next request when the last
    one has come back; the only loop so far);
  * "batch": images in a request;
  * "sizes": [[height, width, count], ...]: the images of the pool, which
    the seed orders at random and groups by size into requests of "batch";
  * "trace_requests": requests in the traced run's profiler window;
  * "check_requests": requests the correctness check samples from the
    window, drawn from the seed.

Every seed draws the same sizes; only their content and order change.
"""

import json
import os
import random
from dataclasses import dataclass
from typing import List

import torch

from ..reference.images import smooth_batch


@dataclass
class Traffic:
    name: str
    loop: str
    batch: int
    sizes: list
    trace_requests: int
    check_requests: int

    @classmethod
    def load(cls, root: str, name: str) -> "Traffic":
        with open(os.path.join(root, "traffic", f"{name}.json")) as f:
            spec = json.load(f)
        if spec["loop"] != "closed":
            raise ValueError(f"traffic {name}: loop {spec['loop']!r} is not "
                             "supported (closed only)")
        return cls(name, spec["loop"], int(spec["batch"]), spec["sizes"],
                   int(spec["trace_requests"]), int(spec["check_requests"]))

    def pool(self, seed: int, device) -> List[torch.Tensor]:
        """The requests of the pool as host uint8 (B, H, W, 3) tensors, in
        the order the loop cycles through them."""
        gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
        order = random.Random(seed)
        batches = []
        for h, w, count in self.sizes:
            if count % self.batch:
                raise ValueError(f"traffic {self.name}: {count} images of "
                                 f"{h}x{w} do not fill batches of {self.batch}")
            imgs = smooth_batch(count, h, w, gen, device).cpu()
            batches += list(imgs.split(self.batch))
        order.shuffle(batches)
        return [b.contiguous() for b in batches]
