"""Model FLOPs (port of ``paddle_tpu/hapi/flops.py``; the reference's
``paddle.flops``).

The JAX package reads XLA's cost analysis of the compiled forward, which
no PyTorch counter reproduces: XLA counts every elementwise op, the
reductions and its own fusions too. The port counts the products with
``torch.utils.flop_counter.FlopCounterMode``: 2 x the multiply-adds of
each matmul and convolution in one eval-mode forward at ``input_size``
(ROADMAP.md Queue 3, "Decided").
"""

from __future__ import annotations

from typing import Sequence

import torch


def flops(net: torch.nn.Module, input_size: Sequence[int], custom_ops=None,
          print_detail: bool = False, dtype="float32") -> int:
    """FLOPs of one forward pass at ``input_size`` (the batch dim
    included) on the network's device, from zeros of ``dtype``.
    ``custom_ops`` is accepted for the reference's signature and unused."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..device import module_device
    from ..static.program import convert_dtype

    x = torch.zeros(tuple(input_size), dtype=convert_dtype(dtype),
                    device=module_device(net))
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            net(x)
    finally:
        net.train(was_training)
    total = int(counter.get_total_flops())
    if print_detail:
        n_params = sum(p.numel() for p in net.parameters())
        print(f"Total Flops: {total}     Total Params: {n_params}")
    return total
