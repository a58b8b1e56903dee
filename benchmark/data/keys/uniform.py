"""Keys drawn uniformly from ``[0, spec["domain"])``."""

import torch


def draw(spec: dict, n: int, gen: torch.Generator, device) -> torch.Tensor:
    return torch.randint(0, int(spec["domain"]), (n,), dtype=torch.int64,
                         device=device, generator=gen)
