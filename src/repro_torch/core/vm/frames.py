"""Code segment and code frames (paper §3.1, Fig. 6).

The code segment (CS) is a flat, statically sized cell array.  New program
code allocates a *code frame*; frames merge bytecode and private data (no
heap).  Frames can be removed after ``end`` unless locked (exported words /
pending tasks); removal of a non-top frame leaves a hole that is reused
first-fit (the paper's fragmentation + frame-linking scenario).

The PyTorch port's copy of ``repro.core.vm.frames`` (host-side, no tensors).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class CodeFrame:
    fid: int
    start: int          # first cell
    end: int            # one past last cell (grows during compile)
    entry: int          # pc to start execution
    locked: bool = False  # exported words or pending tasks keep the frame alive
    persistent: bool = False
    exports: list[str] = field(default_factory=list)
    task_id: int = -1   # owning task (multi-tasking mode)


class FrameManager:
    """Host-side allocator over the CS array."""

    def __init__(self, cs_size: int):
        self.cs_size = cs_size
        self.free_ptr = 0
        self.frames: dict[int, CodeFrame] = {}
        self.holes: list[tuple[int, int]] = []  # (start, end)
        self._next_fid = 0

    def allocate(self, ncells: int) -> CodeFrame:
        if ncells <= 0:
            raise ValueError("empty frame")
        # First-fit from holes (paper Fig. 6 right: reuse fragmented CS).
        for k, (hs, he) in enumerate(self.holes):
            if he - hs >= ncells:
                frame = CodeFrame(self._next_fid, hs, hs + ncells, hs)
                if hs + ncells < he:
                    self.holes[k] = (hs + ncells, he)
                else:
                    del self.holes[k]
                self._next_fid += 1
                self.frames[frame.fid] = frame
                return frame
        if self.free_ptr + ncells > self.cs_size:
            raise MemoryError(
                f"CS exhausted: need {ncells}, free {self.cs_size - self.free_ptr}"
            )
        frame = CodeFrame(self._next_fid, self.free_ptr, self.free_ptr + ncells, self.free_ptr)
        self._next_fid += 1
        self.free_ptr += ncells
        self.frames[frame.fid] = frame
        return frame

    def grow(self, frame: CodeFrame, ncells: int) -> None:
        """Extend the top-most frame (compiler appends uninitialized arrays)."""
        if frame.end != self.free_ptr:
            raise MemoryError("can only grow the top-most frame")
        if self.free_ptr + ncells > self.cs_size:
            raise MemoryError("CS exhausted on grow")
        frame.end += ncells
        self.free_ptr += ncells

    def remove(self, frame: CodeFrame) -> bool:
        """Remove a frame after ``end`` (paper: unless locked/persistent)."""
        if frame.locked or frame.persistent:
            return False
        if frame.fid not in self.frames:
            return False
        del self.frames[frame.fid]
        if frame.end == self.free_ptr:
            self.free_ptr = frame.start
            # Merge an adjacent trailing hole back into free space.
            self.holes.sort()
            while self.holes and self.holes[-1][1] == self.free_ptr:
                self.free_ptr = self.holes.pop()[0]
        else:
            self.holes.append((frame.start, frame.end))
        return True

    def reset(self) -> None:
        self.free_ptr = 0
        self.frames.clear()
        self.holes.clear()

    @property
    def used(self) -> int:
        return self.free_ptr - sum(e - s for s, e in self.holes)


@dataclass
class DictEntry:
    """Global dictionary entry (paper §3.11): word name -> code address."""

    name: str
    addr: int
    fid: int
    exported: bool = False


class Dictionary:
    """The global instruction-word dictionary (simple hash + host dict)."""

    def __init__(self):
        self.entries: dict[str, DictEntry] = {}

    def define(self, name: str, addr: int, fid: int) -> DictEntry:
        e = DictEntry(name, addr, fid)
        # Incremental code execution: redefinition overwrites older code
        # (paper resilience feature 7: "code updates overwriting older code
        # via the global dictionary").
        self.entries[name] = e
        return e

    def lookup(self, name: str) -> DictEntry | None:
        return self.entries.get(name)

    def export(self, name: str) -> None:
        self.entries[name].exported = True

    def drop_frame(self, fid: int) -> None:
        """Remove non-exported words of a removed frame."""
        self.entries = {
            k: v for k, v in self.entries.items() if v.fid != fid or v.exported
        }
