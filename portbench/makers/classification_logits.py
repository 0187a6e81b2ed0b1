"""Seeded classifier outputs: float32 logits ``[rows, C]`` and int64 labels.

Every logit is a standard normal draw, and the target class's gets
``signal`` added: a classifier with a real but imperfect signal (top-1 near
0.41 at C = 1000 and signal 3), whose top logits lie close enough together
that a lower precision reorders some of them. Made on the device from the
generator, in a few large calls (frozen from ``chip_smoke.py``'s
``_imagenet_stream``, moved onto the device).
"""
import torch


def make(inputs: dict, rows: int, gen: torch.Generator, device: torch.device):
    c = inputs["classes"]
    target = torch.randint(0, c, (rows,), generator=gen, device=device, dtype=torch.int64)
    logits = torch.randn((rows, c), generator=gen, device=device, dtype=torch.float32)
    logits[torch.arange(rows, device=device), target] += inputs["signal"]
    return logits, target
