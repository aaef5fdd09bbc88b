"""Device resolution and the fingerprint every measurement carries.

Entry points run on the card unless the caller asks for the CPU: a
missing card is an error, never a silent CPU fallback. The fingerprint
names the device, its compute capability, the torch and CUDA versions
and the card's power limit, so a number is never read without the
hardware it came from.
"""

from __future__ import annotations

import platform
import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `None` means the card.

    Raises when a CUDA device is asked for (explicitly or by default)
    and none is present; only an explicit `device="cpu"` runs on the CPU.
    """
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def nvidia_smi_name_power(index: int = 0) -> str:
    """`name, power.limit` of one card, exactly as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def fingerprint(device=None) -> dict:
    """Where a number was taken: device, capability, versions, power."""
    dev = resolve_device(device)
    fp = {
        "device": str(dev),
        "torch": torch.__version__,
        "python": platform.python_version(),
    }
    if dev.type == "cuda":
        idx = dev.index or 0
        major, minor = torch.cuda.get_device_capability(idx)
        fp.update(
            name=torch.cuda.get_device_name(idx),
            capability=f"{major}.{minor}",
            cuda=torch.version.cuda,
            count=torch.cuda.device_count(),
            nvidia_smi=nvidia_smi_name_power(idx),
        )
    else:
        fp.update(name="cpu", processor=platform.processor() or "unknown")
    return fp
