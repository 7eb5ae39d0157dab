"""Host→device prefetching batch iterator, the counterpart of
``big_linear_algebra_tpu/data/prefetch.py``.

The reference's data path is synchronous file reads in the training thread
(lib/cifar10.c:13). Here each batch goes into pinned host memory and is
copied to the device with ``non_blocking=True``, ``size`` batches ahead of
the consumer, so the copy overlaps the previous steps' compute.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch


def _put(x, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(
        x, np.ndarray) else x
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prefetch_to_device(iterator: Iterable, device: torch.device,
                       size: int = 2) -> Iterator:
    """Yield the items of ``iterator`` (arrays or tuples of arrays) as
    tensors on ``device``, with ``size`` items already sent."""
    queue = collections.deque()
    it = iter(iterator)

    def put(item):
        if isinstance(item, tuple):
            return tuple(_put(x, device) for x in item)
        return _put(item, device)

    for item in it:
        queue.append(put(item))
        if len(queue) > size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
