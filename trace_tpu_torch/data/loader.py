"""Prefetching batch loader: overlap host sample assembly with device steps
(a copy of trace_tpu/data/loader.py whose producer thread also ends when the
consumer stops early, and hands an error raised while a sample is made to the
consumer, where the original leaves the consumer waiting).

The reference leans on torch DataLoader worker processes to hide decode
latency (train_mt.py dataloader workers; decord decode per __getitem__).
Here a thread pool decodes/assembles samples ahead of the training loop (the
native libav decoder releases the GIL inside FFmpeg, so threads parallelize
well), and a bounded queue applies backpressure.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

from trace_tpu_torch.data.dataset import collate_batch


class PrefetchLoader:
    """Iterate batches of a map-style dataset with background workers."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        order: Optional[Sequence[int]] = None,
        num_workers: int = 4,
        prefetch_batches: int = 2,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.order = list(order) if order is not None else list(range(len(dataset)))
        self.num_workers = num_workers
        self.prefetch = prefetch_batches
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.order) // self.batch_size
        if not self.drop_last and len(self.order) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[dict]:
        batches = [
            self.order[i : i + self.batch_size]
            for i in range(0, len(self.order), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Blocks while the queue is full; False once the consumer left."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, idxs))
                        if not put(collate_batch(samples)):
                            return
                put(None)
            except Exception as e:  # hand a sample's error to the consumer
                put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
