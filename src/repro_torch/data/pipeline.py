"""Deterministic, sharded, prefetching LM data pipeline.

The port of ``repro/data/pipeline.py``, numpy only, kept as a copy (the
port imports nothing of the reference): every batch is bit-identical to
the reference's for the same config, seed and step.

Synthetic corpus: a mixture of Zipf-distributed unigrams with injected
n-gram structure (so the loss actually decreases — pure-uniform tokens
cannot be learned).  Deterministic per (seed, step): any host can
regenerate any batch, which is what makes the pipeline resumable and
multi-host-consistent without a data service.

For VLM/audio configs the pipeline also emits stub modality inputs
(patch/frame embeddings), as the reference does.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np

from ..models.config import ModelConfig
from ..obs import trace as _trace


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 512
    global_batch: int = 8
    seed: int = 0
    zipf_a: float = 1.2
    ngram_order: int = 3
    prefetch: int = 2


class SyntheticLMDataset:
    """Markov-chain synthetic text: learnable structure, measurable loss."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.dcfg = dcfg
        rng = np.random.RandomState(dcfg.seed)
        V = cfg.vocab
        # sparse per-state transition table: each state prefers 4 successors
        self.n_states = min(4096, V)
        self.succ = rng.randint(0, V, size=(self.n_states, 4))
        self.succ_p = np.array([0.5, 0.25, 0.15, 0.1])
        ranks = np.arange(1, V + 1, dtype=np.float64)
        zipf = 1.0 / ranks ** dcfg.zipf_a
        self.unigram = zipf / zipf.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        d, c = self.dcfg, self.cfg
        rng = np.random.RandomState((d.seed * 1_000_003 + step) % 2**31)
        B, S = d.global_batch, d.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.randint(0, c.vocab, B)
        # vectorized markov walk with 20% unigram resets
        for t in range(1, S + 1):
            state = toks[:, t - 1] % self.n_states
            choice = rng.choice(4, size=B, p=self.succ_p)
            nxt = self.succ[state, choice]
            reset = rng.rand(B) < 0.2
            nxt[reset] = rng.choice(c.vocab, size=reset.sum(),
                                    p=self.unigram)
            toks[:, t] = nxt
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if c.family == "audio":
            out["frames"] = rng.randn(B, c.n_audio_frames,
                                      c.d_model).astype(np.float32)
        if c.family == "vlm":
            out["patches"] = rng.randn(B, c.n_patch_tokens,
                                       c.d_model).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class _Prefetcher:
    """Background-thread prefetch (host-side pipeline overlap)."""

    def __init__(self, ds: SyntheticLMDataset, depth: int, start: int = 0):
        self.ds = ds
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start
        self._t = threading.Thread(target=self._work, daemon=True)
        self._t.start()

    def _work(self):
        while not self._stop.is_set():
            # a span only while a torch.profiler session runs
            # (obs/trace.py), on this producer thread, with the batch's step
            with _trace.span(_trace.DATA_BATCH, self._step):
                b = self.ds.batch(self._step)
            self._step += 1
            while not self._stop.is_set():
                try:
                    self.q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        while True:
            yield self.q.get()

    def stop(self):
        self._stop.set()


def make_dataset(cfg: ModelConfig, dcfg: DataConfig, *,
                 prefetch: bool = True, start_step: int = 0):
    ds = SyntheticLMDataset(cfg, dcfg)
    if prefetch:
        return _Prefetcher(ds, dcfg.prefetch, start=start_step)
    return ds
