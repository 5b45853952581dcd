"""Traffic made from a seed: the decide loop's stream of collectives, the
all-reduce sweep's payload sizes, and the training cell's token batches.

The decide loop's stream is ``chip_smoke.py``'s phase-5 ``traffic()``,
copied: collective types drawn uniformly from the mix's list, message
sizes ``2**k`` bytes with ``k`` uniform over the mix's range, axes drawn
uniformly, and latencies uniform over the mix's range.  It is made in
blocks, block ``b`` from ``default_rng([seed, b])``, so a window takes as
many as it has time for and the reference regenerates the same ones.

The token batches are the port's synthetic corpus (``repro_torch/data/
pipeline.py``'s ``SyntheticLMDataset.batch``), copied so the reference
reads the batches the trainer trains on without taking them from it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

COLLS = {"all_reduce": 0, "all_gather": 1, "reduce_scatter": 2,
         "all_to_all": 3}
M64 = (1 << 64) - 1


def seed_words(seed: int) -> List[int]:
    """A seed of any sign and size as the non-negative words numpy takes."""
    s = int(seed)
    return [s & M64, (s >> 64) & M64, int(s < 0)]


class DecideStream:
    """The decide loop's steps ``(coll, size, axis_index, latency_ns)``,
    as numpy arrays a block at a time."""

    def __init__(self, mix: dict, seed: int):
        self.colls = np.array([COLLS[c] for c in mix["colls"]])
        self.axes = list(mix["axes"])
        self.k_lo, self.k_hi = mix["log2_bytes"]
        self.lat_lo, self.lat_hi = mix["latency_ns"]
        self.block_len = int(mix["block"])
        self.seed = seed_words(seed)

    def block(self, b: int) -> Tuple[np.ndarray, ...]:
        rng = np.random.default_rng(self.seed + [b])
        n = self.block_len
        colls = rng.choice(self.colls, n)
        sizes = np.left_shift(np.int64(1), rng.integers(self.k_lo,
                                                        self.k_hi + 1, n))
        axes = rng.integers(0, len(self.axes), n)
        lats = rng.integers(self.lat_lo, self.lat_hi, n)
        return colls, sizes, axes, lats


def warmup_steps(mix: dict) -> List[Tuple[int, int, str, int]]:
    """The warm-up's steps, on keys outside the mix (see the mix file)."""
    out = []
    for w in mix["warmup"]:
        out += [(COLLS[w["coll"]], int(w["bytes"]), w["axis"],
                 int(w["latency_ns"]))] * int(w["repeat"])
    return out


def sweep_sizes(mix: dict, seed: int, n: int) -> np.ndarray:
    """The all-reduce sweep's first ``n`` payload sizes (elements), drawn
    uniformly from the mix's list; the same on every rank."""
    rng = np.random.default_rng(seed_words(seed))
    return rng.choice(np.array(mix["payload_elems"], dtype=np.int64), n)


# ---------------------------------------------------------------------------
# the synthetic token corpus (a copy of the port's SyntheticLMDataset)
# ---------------------------------------------------------------------------

class TokenCorpus:
    """Markov-chain tokens over ``vocab``: each state prefers 4
    successors, with 20% unigram (Zipf) resets."""

    def __init__(self, vocab: int, seed: int, zipf_a: float = 1.2):
        rng = np.random.RandomState(seed)
        self.vocab = vocab
        self.seed = seed
        self.n_states = min(4096, vocab)
        self.succ = rng.randint(0, vocab, size=(self.n_states, 4))
        self.succ_p = np.array([0.5, 0.25, 0.15, 0.1])
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        zipf = 1.0 / ranks ** zipf_a
        self.unigram = zipf / zipf.sum()

    def batch(self, step: int, batch: int, seq: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % 2**31)
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.randint(0, self.vocab, batch)
        for t in range(1, seq + 1):
            state = toks[:, t - 1] % self.n_states
            choice = rng.choice(4, size=batch, p=self.succ_p)
            nxt = self.succ[state, choice]
            reset = rng.rand(batch) < 0.2
            nxt[reset] = rng.choice(self.vocab, size=reset.sum(),
                                    p=self.unigram)
            toks[:, t] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
