"""The card a run uses: its name and count, its power limit and SM clock
from ``nvidia-smi`` sampled beside the window, and its memory peak."""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

SMI_FIELDS = ("power.limit", "clocks.sm", "power.draw", "temperature.gpu")


def cache_dirs(root: Path) -> None:
    """Point the compile caches a run may use at fixed directories inside
    the checkout (the program's own kernels build into ``build/kernels``
    there by design)."""
    base = root / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)


def smi(index: int = 0) -> Optional[Dict[str, str]]:
    """One ``nvidia-smi`` reading of the card, or None without the tool."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, f"--id={index}", "--query-gpu=" + ",".join(SMI_FIELDS),
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    vals = [v.strip() for v in out.strip().splitlines()[0].split(",")]
    return dict(zip(SMI_FIELDS, vals))


def describe(count: int) -> Dict:
    """The ``device`` field of the result line, less the memory peak."""
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(count)}
