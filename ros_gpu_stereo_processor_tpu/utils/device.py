"""Accelerator setup shared by the entry points (CLI, bench, chip smoke).

Nothing here runs at import: each entry point calls what it needs.
"""

from __future__ import annotations

import os
import subprocess

# fixed, gitignored directory inside the checkout: the cache is keyed by its
# path, so a directory that moved between runs would never hit
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache(default_dir: str = REPO_CACHE_DIR) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing; otherwise the cache goes to ``default_dir``."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", default_dir)
    return default_dir


def require_gpu():
    """The first JAX device, which must be a GPU.  Anything else (a
    CPU-only run, say) raises SystemExit naming the platform found, so a
    measurement never silently falls back to the host."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev} on platform "
            f"{dev.platform!r}; this entry point measures the GPU only")
    return dev


def device_record(dev) -> dict:
    """{"platform", "kind", "count"} as JAX reports them."""
    import jax

    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s card name and power limit, one line per card.  A
    card below its top power limit runs slower under load, so every
    reported time carries this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
