"""The accelerator: whether a GPU is live, the compile cache, card counts.

Every device route (the ANIm/dnadiff extension kernel, the ANIb scorer,
the sourmash containment Gram) asks :func:`gpu_available` whether to
run on the card; nothing else decides it. On a GPU a device route that
fails raises -- it never falls back to the host quietly.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
COMPILE_CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def gpu_available() -> bool:
    """True when JAX's default backend is a GPU."""
    import jax

    return jax.default_backend() == "gpu"


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at its one location.

    ``$JAX_COMPILATION_CACHE_DIR`` wins whenever it is set (JAX reads it
    itself, so nothing is changed); otherwise the cache lives in
    ``<checkout>/.jax_cache``, a fixed path so later runs hit it.
    Returns the directory in use.
    """
    env = os.environ.get(COMPILE_CACHE_ENV)
    if env:
        return env
    import jax

    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def visible_gpus() -> list[str]:
    """IDs of the cards this process may use, found without starting JAX.

    Empty when JAX is told to use another platform, when
    ``CUDA_VISIBLE_DEVICES`` hides every card, or when ``nvidia-smi``
    finds none. A parent that only launches workers calls this, so it
    never reserves a card's memory itself."""
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and not {"cuda", "gpu"} & {
        p.strip() for p in platforms.split(",")
    }:
        return []
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        ids = [d.strip() for d in visible.split(",") if d.strip()]
        return [] if ids[:1] == ["-1"] else ids
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]
