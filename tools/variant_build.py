"""What the phase-split tools share: a copy of a tree's CUDA sources with
some text replaced, compiled into a library of its own, and the timing of
calls on the card.

:func:`build` copies every ``.cu`` and ``.cuh`` of ``src_dir`` into a new
directory, replaces each anchor (which must occur exactly once) in its
file, compiles ``sources`` with the port's ``nvcc`` flags (``-Xptxas -v``
among them) into one shared library and loads it, with the argument types
of ``signatures`` set.  It takes ``_build`` from whichever tree is first
on ``sys.path``, so an older tree's subprocess builds with its own flags.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import tempfile
from pathlib import Path


def build(src_dir: Path, sources: list, out_dir: Path | None = None, edits: dict | None = None,
          signatures: dict | None = None):
    """``sources`` (file names in ``src_dir``) compiled after ``edits``
    (file name → pairs of anchor and replacement): ``(library, nvcc's
    output)``.  ``signatures`` maps a function name to its ctypes argument
    types; each returns an int."""
    from multimodal_trajectory_modeling_tpu_torch.ops import _build

    work = Path(tempfile.mkdtemp(dir=out_dir))
    for f in Path(src_dir).iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, work / f.name)
    for name, pairs in (edits or {}).items():
        path = work / name
        text = path.read_text()
        for anchor, replacement in pairs:
            if text.count(anchor) != 1:
                raise SystemExit(f"{name}: an edit's anchor moved: {anchor!r}")
            text = text.replace(anchor, replacement)
        path.write_text(text)
    so = work / "lib.so"
    cmd = [_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(so), *(str(work / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {sources} after {edits}:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    for name, argtypes in (signatures or {}).items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, proc.stdout + proc.stderr


def event_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` by CUDA events over ``reps`` calls,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
