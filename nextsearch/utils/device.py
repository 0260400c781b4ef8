"""Which device a measurement ran on, and refusal to measure without one.

Every number a benchmark prints names its device: JAX's platform,
device_kind and device count, plus the card's name and power limit as
nvidia-smi reports them (a card set below its maximum power runs slower
under load).
"""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """`name, power.limit` of each visible card, one line per card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out


def require_gpu() -> dict:
    """JAX's view of the device; raises SystemExit when it is not a GPU."""
    import jax

    devs = jax.devices()
    info = {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
    if info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX runs on {info['platform']} ({info['kind']}); "
            "this measurement needs the card"
        )
    return info


def probe_device() -> dict:
    """JAX's device as a short child process reports it — for a parent that
    must not hold the card itself (one JAX process per card)."""
    import json
    import sys

    code = (
        "import json, jax; d = jax.devices(); print(json.dumps({"
        "'platform': d[0].platform, 'kind': d[0].device_kind, "
        "'count': len(d)}))"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    if r.returncode != 0 or not lines:
        raise RuntimeError(f"device probe failed: {r.stderr[-2000:]}")
    return json.loads(lines[-1])
