"""Step-indexed random patch sampling (the PyTorch port's own copy of
``ssdn_tpu/data/sampler.py``), and the host-to-device copy that feeds the
training step on the card.

A batch is a *pure function of (seed, step)*: ``sample(step)`` derives a
fresh counter-based RNG from (seed, step), so (a) fixed-length "train for N
iterations" semantics are native, (b) preemption-resume is exact by
checkpointing only the step counter, and (c) any batch can be recomputed
for debugging. Only cropping and uint8 gathering happen on the host;
normalization, noise injection and rotation stacking run on the device
inside the training step. The samplers are numpy only: their batches are
the JAX package's, bit for bit.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from ssdn_tpu_torch.utils.debug import span


class PatchSampler:
    def __init__(self, dataset, patch_size: int, batch_size: int,
                 seed: int = 0):
        if len(dataset) == 0:
            raise ValueError("empty dataset")
        self.dataset = dataset
        self.patch = patch_size
        self.batch = batch_size
        self.seed = seed
        self.channels = dataset[0].shape[-1]

    def sample(self, step: int) -> np.ndarray:
        """(batch, patch, patch, C) uint8 — deterministic in (seed, step)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        ps = self.patch
        out = np.empty((self.batch, ps, ps, self.channels), np.uint8)
        idxs = rng.integers(0, len(self.dataset), self.batch)
        for j, i in enumerate(idxs):
            img = self.dataset[int(i)]
            h, w = img.shape[:2]
            if h < ps or w < ps:  # small image: reflect-pad up to patch size
                img = np.pad(
                    img,
                    [(0, max(0, ps - h)), (0, max(0, ps - w)), (0, 0)],
                    mode="reflect",
                )
                h, w = img.shape[:2]
            r = int(rng.integers(0, h - ps + 1))
            c = int(rng.integers(0, w - ps + 1))
            out[j] = img[r : r + ps, c : c + ps]
        return out


class StreamingPatchSampler:
    """PatchSampler for unbounded procedural datasets
    (data.StreamingSyntheticDataset): every batch is cropped from FRESH
    deterministically-generated images — no image is ever revisited across
    steps, removing the memorization confound of finite corpora.

    Same purity contract as PatchSampler: sample(step) is a pure function
    of (seed, step). Generation cost is amortized by taking
    `crops_per_image` crops from each fresh image (k = min(16,
    4 * (size // patch)^2), or 1 when size == patch) and parallelized
    over a small thread pool.
    """

    def __init__(self, dataset, patch_size: int, batch_size: int,
                 seed: int = 0, n_threads: int = 4):
        self.dataset = dataset
        self.patch = patch_size
        self.batch = batch_size
        self.seed = seed
        size = dataset.size
        # amortize generation: several (possibly overlapping) crops per
        # fresh image. 4x the non-overlapping tiling, capped at 16 — at
        # size=128/patch=64 that is 4 fresh images per batch-64 step.
        # size == patch degenerates to one crop per image (use size >=
        # 2*patch for streaming training).
        area_ratio = (size // patch_size) ** 2
        self.crops_per_image = min(16, 4 * area_ratio) if area_ratio > 1 \
            else 1
        self.channels = 1 if getattr(dataset, "grayscale", False) else \
            dataset.channels
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=n_threads)

    def sample(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        ps, k = self.patch, self.crops_per_image
        n_imgs = -(-self.batch // k)
        # each step draws image indices from a disjoint arithmetic block of
        # the virtual index space, so images are fresh at every step AND
        # deterministic in (seed, step)
        base = (step * n_imgs) % (len(self.dataset) - n_imgs)
        idxs = base + np.arange(n_imgs)
        imgs = list(self._pool.map(self.dataset.generate, idxs))
        out = np.empty((self.batch, ps, ps, self.channels), np.uint8)
        for j in range(self.batch):
            img = imgs[j // k]
            h, w = img.shape[:2]
            if h < ps or w < ps:
                img = np.pad(
                    img,
                    [(0, max(0, ps - h)), (0, max(0, ps - w)), (0, 0)],
                    mode="reflect",
                )
                h, w = img.shape[:2]
            r = int(rng.integers(0, h - ps + 1))
            c = int(rng.integers(0, w - ps + 1))
            out[j] = img[r : r + ps, c : c + ps]
        return out

    def close(self):
        self._pool.shutdown(wait=False)


class _PrefetchError:
    """Marker carrying a worker-thread exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Multi-threaded ordered prefetch of sampler batches (the host-side
    stage; replaces the reference's DataLoader worker processes).

    `transform` runs inside the worker threads, so the host-to-device copy
    of upcoming batches (``to_device``) overlaps the current step's
    compute, with several copies in flight at once.

    Ordering contract: batches are yielded in exact step order. Worker k
    produces steps start+k, start+k+T, ... into its own bounded queue and
    the consumer round-robins the queues, which reconstructs global order
    without any reordering buffer. The first sentinel met in round-robin
    order is necessarily the end of the stream (if worker k's next index
    r*T+k >= n_steps then every later queue's next index in the same
    round is larger). Samplers are safe to call concurrently: every
    `sample(step)` is a pure function of (seed, step) into fresh output
    buffers (PatchSampler/NativePatchSampler/StreamingPatchSampler).
    """

    def __init__(self, sampler, start_step: int, n_steps: int,
                 depth: int = 12, transform=None, n_threads: int = 4):
        self.sampler = sampler
        n_threads = max(1, min(n_threads, max(n_steps, 1)))
        per_depth = max(2, depth // n_threads)
        self.qs = [queue.Queue(maxsize=per_depth) for _ in range(n_threads)]
        self._stop = threading.Event()

        def put_blocking(q, item) -> bool:
            while not self._stop.is_set():
                try:
                    q.put(item, timeout=0.25)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(k: int):
            q = self.qs[k]
            try:
                for s in range(start_step + k, start_step + n_steps,
                               n_threads):
                    if self._stop.is_set():
                        return
                    with span("ssdn.data.sample"):
                        batch = self.sampler.sample(s)
                    if transform is not None:
                        batch = transform(batch)
                    if not put_blocking(q, batch):
                        return
                put_blocking(q, None)
            except BaseException as e:  # surface in the consumer thread
                put_blocking(q, _PrefetchError(e))

        self.threads = [
            threading.Thread(target=worker, args=(k,), daemon=True)
            for k in range(n_threads)
        ]
        for t in self.threads:
            t.start()

    def __iter__(self) -> Iterator:
        k, n = 0, len(self.qs)
        while True:
            item = self.qs[k].get()
            if isinstance(item, _PrefetchError):
                self.close()
                raise item.exc
            if item is None:
                return
            yield item
            k = (k + 1) % n

    def close(self):
        self._stop.set()
        for q in self.qs:
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass


class DeviceBatch:
    """A batch whose host-to-device copy was issued on a side stream.
    ``wait()`` makes the caller's current stream wait for the copy and
    returns the device tensor; read the tensor only through it."""

    def __init__(self, tensor, event, host):
        self._tensor = tensor
        self._event = event
        # the pinned source stays referenced until the consumer has ordered
        # its stream after the copy; from then on the caching host
        # allocator, which recorded the copy's stream, keeps the block from
        # reuse until the copy is done
        self._host = host

    def wait(self):
        import torch

        stream = torch.cuda.current_stream(self._tensor.device)
        stream.wait_event(self._event)
        # the tensor was allocated on the side stream: tell the caching
        # allocator it is in use on the consumer's stream too, so its
        # memory is not handed to the next copy while the step reads it
        self._tensor.record_stream(stream)
        self._host = None
        return self._tensor


def to_device(device):
    """A Prefetcher ``transform`` for a CUDA device: each worker thread pins
    its batch (each ``sample`` returns a fresh array, so a batch is pinned
    once and no buffer is shared), copies it with ``non_blocking=True`` on
    a stream of its own, records an event there and hands back a
    ``DeviceBatch``."""
    import torch

    device = torch.device(device)
    local = threading.local()

    def transform(batch: np.ndarray) -> DeviceBatch:
        stream = getattr(local, "stream", None)
        if stream is None:
            stream = local.stream = torch.cuda.Stream(device=device)
        with span("ssdn.data.to_device"):
            host = torch.from_numpy(batch).pin_memory()
            with torch.cuda.stream(stream):
                tensor = host.to(device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
        return DeviceBatch(tensor, event, host)

    return transform
