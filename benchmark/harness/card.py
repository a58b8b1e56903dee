"""The card a run measures: its name, count, power limit and memory rate."""

import subprocess

#: device memory rate by card name (NVIDIA data sheets), bytes/s; the
#: first name that the card's name contains is taken
BANDWIDTH = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
             ("H100", 3.35e12))


def bandwidth(name: str) -> float:
    for key, rate in BANDWIDTH:
        if key in name:
            return rate
    raise SystemExit(f"no memory rate known for card {name!r}")


def power_limit() -> "str | None":
    """``nvidia-smi``'s power limit of card 0, as it prints it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def describe(torch) -> dict:
    """The card's name, the cards present and the memory rate (the
    power limit is read after the window: ``nvidia-smi`` is a second
    process, which set-up need not wait for)."""
    name = torch.cuda.get_device_name(0)
    return {"name": name, "cards_present": torch.cuda.device_count(),
            "bandwidth": bandwidth(name)}
