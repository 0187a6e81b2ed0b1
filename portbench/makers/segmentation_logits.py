"""Seeded street-scene segmentation outputs: float32 logits ``[B, C, H, W]``
and int64 label maps ``[B, H, W]``.

Labels hold one class per ``block`` x ``block`` region, drawn with the
classes' pixel shares; void (label 255 in the data set) is mapped to
``void_class``. The intended prediction is the label, but for ``error`` of
the pixels and for every void pixel, which get a class drawn uniformly
from the others. Logits are ``noise`` x a standard normal draw with
``signal`` added to the intended class: no forced margin, so the argmax
departs from the intended class where the noise wins, and a lower precision
reorders some near ties (frozen from ``chip_smoke.py``'s ``_seg_batch``,
whose logits forced the predicted class to 2.0 and so did not).
"""
import torch


def make(inputs: dict, images: int, gen: torch.Generator, device: torch.device):
    c, void = inputs["classes"], inputs["void_class"]
    h, w, block = inputs["height"], inputs["width"], inputs["block"]
    shares = torch.tensor(inputs["class_shares"], dtype=torch.float64)
    shares = shares / shares.sum() * (1.0 - inputs["void_share"])
    cdf = torch.cumsum(torch.cat([shares, torch.tensor([inputs["void_share"]], dtype=torch.float64)]), 0)[:-1]
    cdf = cdf.to(torch.float32).to(device)
    blocks = torch.rand((images, h // block, w // block), generator=gen, device=device)
    target = torch.searchsorted(cdf, blocks).clamp(max=c - 1)
    target = target.repeat_interleave(block, dim=1).repeat_interleave(block, dim=2).contiguous()
    wrong = torch.rand((images, h, w), generator=gen, device=device) < inputs["error"]
    other = torch.randint(0, void, (images, h, w), generator=gen, device=device)
    intended = torch.where(wrong | (target == void), other, target)
    del wrong, other
    logits = torch.randn((images, c, h, w), generator=gen, device=device, dtype=torch.float32)
    if inputs["noise"] != 1.0:
        logits.mul_(inputs["noise"])
    logits.scatter_add_(1, intended.unsqueeze(1), torch.full((images, 1, h, w), float(inputs["signal"]), device=device))
    return logits, target.to(torch.int64)
