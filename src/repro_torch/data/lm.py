"""Synthetic-corpus token pipeline with background prefetch (twin of
``repro.data.lm``).

The corpus is the reference's NumPy code, so one seed gives its tokens
bit for bit: Zipfian unigrams mixed with repeated n-gram motifs, a
learnable next-token structure.  ``Prefetcher`` stages each batch on a
daemon thread (pinned host memory when the device is the card) and
copies it to the device in ``__next__``, on the consumer's current
stream: no copy crosses streams, and the pinned block is not reused
before its copy completes (PyTorch's host allocator records the copy's
stream).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class SyntheticCorpus:
    """Zipf unigrams + motif phrases; next-token predictable structure."""

    def __init__(self, vocab: int, seed: int = 0, n_motifs: int = 64,
                 motif_len: int = 8):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        self.motifs = rng.integers(2, vocab, size=(n_motifs, motif_len))
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self.p = p / p.sum()
        self.rng = rng

    def sample(self, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq + 1), np.int32)
        for b in range(batch):
            toks = []
            while len(toks) < seq + 1:
                if self.rng.random() < 0.5:
                    toks.extend(self.motifs[
                        self.rng.integers(len(self.motifs))])
                else:
                    toks.extend(self.rng.choice(
                        self.vocab, size=8, p=self.p))
            out[b] = toks[: seq + 1]
        return out


def batches(vocab: int, batch: int, seq: int, seed: int = 0
            ) -> Iterator[Dict[str, np.ndarray]]:
    corpus = SyntheticCorpus(vocab, seed)
    while True:
        chunk = corpus.sample(batch, seq)
        yield dict(tokens=chunk[:, :-1], labels=chunk[:, 1:])


class Prefetcher:
    """Host staging on a daemon thread, ``depth`` batches ahead; the copy
    to ``device`` (default: the card) in ``__next__``."""

    def __init__(self, it: Iterator[dict], depth: int = 2,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = False
        pin = self.device.type == "cuda"

        def worker():
            for item in it:
                if self._stop:
                    return
                host = {k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in item.items()}
                if pin:
                    host = {k: t.pin_memory() for k, t in host.items()}
                self.q.put(host)

        self.thread = threading.Thread(target=worker, daemon=True)
        self.thread.start()

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        host = self.q.get()
        return {k: t.to(self.device, non_blocking=True)
                for k, t in host.items()}

    def stop(self):
        self._stop = True
