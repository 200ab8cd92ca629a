"""Model FLOPs of one training sample, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the benchmark's own
reference at the cell's shapes: the work that the configuration's
reference module names in its ``flop_step`` (the frozen VAE's forward,
the predictor's forward and backward with no recomputation, LPIPS where
the mix has it; the renderer left out). The count does not depend on how
the program computes the step."""

from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode


def flops_per_sample(spec: dict, mix: dict, reference, batch=None,
                     device=None) -> float:
    samples, work = reference.flop_step(spec, mix, batch, device)
    with FlopCounterMode(display=False) as counter:
        work()
    return counter.get_total_flops() / samples
