"""Host->card prefetch: overlap batch assembly + transfer with compute.

Counterpart of `v2a_tpu/parallel/prefetch.py`. A background thread keeps
`depth` batches in flight: while step t runs on the card, batch t+1 is
sampled from the replay buffers and copied to the card. Images travel as
uint8 and are scaled on the card.

`PinnedCopier` is the copy: each host array goes into a pinned buffer kept
per ring slot and key (allocated once per shape), then one non-blocking
copy per array on one side stream; the consumer's stream waits on the
slot's event. The slots' buffers, events and the stream are made once.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


class PrefetchIterator:
    """Wraps `sample_fn() -> batch` into an iterator with a worker thread
    keeping `depth` batches ready.

    `place_fn` maps a host batch to what the consumer takes (e.g. the
    trainer's copy to the card). Errors in the worker propagate to the
    consumer."""

    def __init__(
        self,
        sample_fn: Callable[[], Any],
        place_fn: Optional[Callable[[Any], Any]] = None,
        depth: int = 2,
    ):
        self.sample_fn = sample_fn
        self.place_fn = place_fn or (lambda x: x)
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = self.place_fn(self.sample_fn())
            except Exception as e:  # propagate to consumer
                self._queue.put(("error", e))
                return
            # block until there is room, but wake up for stop()
            while not self._stop.is_set():
                try:
                    self._queue.put(("ok", batch), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        kind, payload = self._queue.get()
        if kind == "error":
            raise payload
        return payload

    def stop(self):
        self._stop.set()
        # drain so the worker is not blocked on put
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class Staged:
    """Tensors on their way to the device and the event that marks their
    copy (None on the CPU)."""

    def __init__(self, tensors: Dict[str, torch.Tensor], event=None):
        self.tensors = tensors
        self.event = event


class PinnedCopier:
    """Host numpy arrays -> device tensors.

    On a CUDA device: `n_slots` ring slots, each holding pinned host buffers
    (one per key, reallocated only when a shape changes) and an event; a
    copy waits for its slot's previous copy, fills the pinned buffers,
    issues the copies with `non_blocking=True` on the side stream, applies
    `transform` there and records the slot's event. `take` makes the
    caller's current stream wait on that event and marks the tensors as
    used by it. On the CPU: `torch.from_numpy` and `transform`."""

    def __init__(self, device: torch.device, n_slots: int = 4,
                 transform: Optional[Callable[[Dict[str, torch.Tensor]],
                                              Dict[str, torch.Tensor]]] = None):
        self.device = torch.device(device)
        self.transform = transform or (lambda t: t)
        self._lock = threading.Lock()
        self._next = 0
        self._slots: List[Tuple[Dict[str, torch.Tensor], Any]] = []
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._slots = [({}, torch.cuda.Event()) for _ in range(n_slots)]

    def put(self, arrays: Dict[str, np.ndarray]) -> Staged:
        if self._stream is None:
            return Staged(self.transform(
                {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                 for k, v in arrays.items()}))
        with self._lock:
            pinned, event = self._slots[self._next]
            self._next = (self._next + 1) % len(self._slots)
            event.synchronize()  # the slot's previous copy has left its buffers
            out = {}
            with torch.cuda.stream(self._stream):
                for k, v in arrays.items():
                    src = torch.from_numpy(np.ascontiguousarray(v))
                    buf = pinned.get(k)
                    if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                        buf = pinned[k] = torch.empty(src.shape, dtype=src.dtype,
                                                      pin_memory=True)
                    buf.copy_(src)
                    out[k] = buf.to(self.device, non_blocking=True)
                out = self.transform(out)
                event.record(self._stream)
            return Staged(out, event)

    def take(self, staged: Staged) -> Dict[str, torch.Tensor]:
        if staged.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(staged.event)
            for t in staged.tensors.values():
                t.record_stream(stream)
        return staged.tensors
