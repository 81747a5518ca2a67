"""Stop-and-go checkpointing (paper resilience feature 5; counterpart of
``repro.resilience.checkpoint``, same on-disk layout, so either package
restores what the other wrote).

  * **atomic**: write to a temp dir, fsync, single rename — a power loss
    mid-write never corrupts the latest checkpoint;
  * **versioned**: the ``keep`` newest checkpoints are retained; restore
    takes the newest *complete* one;
  * **device-agnostic**: leaves are saved as host numpy per name
    (``ckpt_<step>/arrays.npz`` beside ``meta.json``), and ``restore``
    places tensor leaves on the device it is given;
  * **background**: serialization runs off-thread; a caller blocks only on
    the previous save (or on this one with ``blocking=True``).

A tree is nested dicts and lists (``utils/tree.py``) whose leaves are
tensors, numpy arrays or numbers; a leaf's name joins its keys with "/".
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.tree import tree_flatten_with_names, tree_map_with_names


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf (never a view of memory the caller keeps
    writing).  bf16 tensors are saved as f32, which holds them exactly
    (numpy has no bfloat16); ``restore`` casts back to the template's
    dtype."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        return leaf.cpu().numpy().copy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: dict | None = None,
             blocking: bool = True) -> Path:
        """Snapshot ``tree`` + json-able ``extra`` as checkpoint ``step``."""
        # Copied to the host before the writer thread sees it.
        named = [(name, _host(leaf)) for name, leaf in tree_flatten_with_names(tree)]
        self.wait()
        target = self.dir / f"ckpt_{step:010d}"

        def write():
            tmp = self.dir / f".tmp_{step:010d}_{os.getpid()}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **{n: a for n, a in named})
            meta = {"step": step, "time": time.time(), "extra": extra or {}}
            (tmp / "meta.json").write_text(json.dumps(meta))
            # fsync the payload then atomically publish.
            for f in tmp.iterdir():
                with open(f, "rb") as fh:
                    os.fsync(fh.fileno())
            if target.exists():
                shutil.rmtree(target)
            tmp.rename(target)
            self._gc()

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()
        return target

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("ckpt_*"))
        for old in ckpts[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        ckpts = sorted(self.dir.glob("ckpt_*"))
        for c in reversed(ckpts):
            if (c / "meta.json").exists():   # complete checkpoints only
                return int(c.name.split("_")[1])
        return None

    def restore(self, template: Any, step: int | None = None, device=None) -> tuple[Any, dict]:
        """Restore into the structure of ``template`` (shape and dtype
        authority): tensor leaves come back as tensors on ``device`` (the
        template leaf's device when None), numpy leaves as numpy arrays of
        the template's dtype, other leaves as the saved numpy array."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = self.dir / f"ckpt_{step:010d}"
        meta = json.loads((path / "meta.json").read_text())
        with np.load(path / "arrays.npz") as arrays:
            def leaf(name, t):
                a = arrays[name]
                if isinstance(t, torch.Tensor):
                    return torch.as_tensor(a).to(device=device if device is not None else t.device,
                                                 dtype=t.dtype)
                if hasattr(t, "dtype"):
                    return a.astype(t.dtype)
                return a

            tree = tree_map_with_names(leaf, template)
        return tree, meta["extra"]
