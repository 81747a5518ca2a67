"""Deterministic, resumable data pipeline (a copy of ``repro.train.data``:
numpy only, so each batch is byte-equal to the reference's for the same
seed and step).

Design goals (paper C3/C8 applied to training data):
  * fully deterministic from (seed, step) — no hidden iterator state;
  * checkpointable/restorable with a single integer (the step), so
    stop-and-go restarts resume mid-epoch byte-exactly;
  * per-host sharding for multi-host launches (each host materializes only
    its slice of the global batch);
  * background prefetch thread (double buffering).

Two sources: a synthetic "LM-ish" token stream (mixture of Zipfian unigrams
and repeated n-grams, so models can actually learn structure for the e2e
example), and an optional memory-mapped token file.
"""

from __future__ import annotations

import threading
import queue
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from repro_torch.config import ModelConfig, ShapeConfig


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"        # synthetic | file
    path: Optional[str] = None
    host_id: int = 0
    num_hosts: int = 1


class SyntheticLM:
    """Zipfian unigrams + copied spans: compressible structure, so CE drops
    visibly within a few hundred steps on a ~100M model."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.p = p / p.sum()

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        per_host = cfg.global_batch // cfg.num_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id])
        )
        toks = rng.choice(
            cfg.vocab_size, size=(per_host, cfg.seq_len + 1), p=self.p
        ).astype(np.int32)
        # Repeated spans: copy a window forward (learnable induction).
        # Span sized so src < dst always fits, down to tiny test sequences.
        max_span = max(2, min(32, cfg.seq_len // 4))
        for b in range(per_host):
            span = int(rng.integers(2, max_span + 1))
            src = int(rng.integers(0, cfg.seq_len - 2 * span + 1))
            dst = int(rng.integers(src + span, cfg.seq_len - span + 1))
            toks[b, dst : dst + span] = toks[b, src : src + span]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


class FileTokens:
    """Memory-mapped flat int32 token file, strided deterministically."""

    def __init__(self, cfg: DataConfig):
        assert cfg.path, "file source needs path"
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        per_host = cfg.global_batch // cfg.num_hosts
        n = len(self.data) - cfg.seq_len - 1
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id])
        )
        starts = rng.integers(0, n, size=per_host)
        toks = np.stack([self.data[s : s + cfg.seq_len + 1] for s in starts])
        toks = np.mod(toks, cfg.vocab_size).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


class DataPipeline:
    """Prefetching iterator with explicit step state (resume = set_step)."""

    def __init__(self, cfg: DataConfig, prefetch: int = 2):
        self.cfg = cfg
        self.source = FileTokens(cfg) if cfg.source == "file" else SyntheticLM(cfg)
        self.step = 0
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- checkpointable state -------------------------------------------------

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, d: dict) -> None:
        self.set_step(int(d["step"]))

    def set_step(self, step: int) -> None:
        self._halt_thread()
        self.step = step

    # -- iteration ---------------------------------------------------------------

    def next_batch(self) -> dict[str, np.ndarray]:
        if self._thread is None:
            self._start_thread()
        while True:
            try:
                item = self._q.get(timeout=5.0)
                break
            except queue.Empty:
                # A dead worker must fail loudly, not hang the trainer.
                if self._error is not None:
                    raise RuntimeError("data worker failed") from self._error
                if not self._thread.is_alive():
                    raise RuntimeError("data worker died without error")
        step, batch = item
        self.step = step + 1
        return batch

    def _start_thread(self) -> None:
        self._stop.clear()
        self._error: Optional[BaseException] = None
        start = self.step

        def worker():
            s = start
            while not self._stop.is_set():
                try:
                    self._q.put((s, self.source.batch_at(s)), timeout=0.1)
                    s += 1
                except queue.Full:
                    continue
                except BaseException as e:   # surface in next_batch
                    self._error = e
                    return

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _halt_thread(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=2)
            self._thread = None
            while not self._q.empty():
                self._q.get_nowait()

    def close(self) -> None:
        self._halt_thread()


def pipeline_for(model_cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 host_id: int = 0, num_hosts: int = 1) -> DataPipeline:
    return DataPipeline(
        DataConfig(
            vocab_size=model_cfg.vocab_size,
            seq_len=shape.seq_len,
            global_batch=shape.global_batch,
            seed=seed,
            host_id=host_id,
            num_hosts=num_hosts,
        )
    )
